"""The ``johnson`` configuration: FastStyleNet with 3 styles and the
evaluation's RAFT, in ``vst_torch``, with the reference's weights."""

from __future__ import annotations

import argparse
import inspect
from pathlib import Path

import torch

from vstbench.counts.flops import count
from vstbench.families.common import port
from vstbench.reference import johnson as ref_johnson
from vstbench.reference import raft as ref_raft
from vstbench.reference import seeded

STYLIZE_SCALE = 255.0  # the net's raw output spans about [-22.5, 277.5]


def reference(cfg, gen, stream: bool = False):
    """The reference nets, drawn from ``gen`` in this order; the stream has
    no RAFT."""
    nets = {"stylize": ref_johnson.make(cfg["stylize"]["n_styles"], gen)}
    if not stream:
        nets["raft"] = ref_raft.make(cfg["raft"]["iters"], gen)
    return nets


class Eval:
    """``evaluate_sintel_faststyle`` over one clip for one style."""

    def __init__(self, cfg, ref, styles, device):
        from vst_torch.flow.raft import RAFT
        from vst_torch.models.faststyle import FastStyleNet

        n_styles = cfg["stylize"]["n_styles"]
        self.styles = styles
        self.device = device
        self.net = port(lambda: FastStyleNet(3, n_styles), ref["stylize"].state_dict(), device)
        self.raft = port(lambda: RAFT(iters=cfg["raft"]["iters"]), ref["raft"].state_dict(),
                         device)
        self.stylize_modules = [self.net]
        self.capture_module = self.net

    def call(self, video, style: int, dt_iters: int, lt_len: int):
        """The evaluation of ``video`` for style ``styles[style]``."""
        from vst_torch.eval.drivers import evaluate_sintel_faststyle

        return evaluate_sintel_faststyle(self.net, self.net.state_dict(), [video], self.raft,
                                         styles=[self.styles[style]], dt_iters=dt_iters,
                                         lt_len=lt_len, device=self.device)

    @staticmethod
    def captured(inputs, output):
        """(frame, raw output) of one call of the capture module."""
        return inputs[0], output[1]


def eval_styles(cfg, gen):
    return list(range(cfg["stylize"]["n_styles"]))


def pipeline(x01):
    """Frames in [0, 1] as the evaluation feeds them to the net and to RAFT."""
    return x01 * 2.0 - 1.0


def ref_stylize(ref, x, style):
    return ref["stylize"](x, style)


def tcl_space(raw):
    return (raw / 255.0).clamp(0.0, 1.0)


def stylize_flops(cfg, hw) -> int:
    net = seeded.build(lambda: ref_johnson.FastStyleNet(cfg["stylize"]["n_styles"]), "meta")
    return count(lambda: net(torch.empty(1, 3, *hw, device="meta"), 0))


def raft_flops(cfg, batch, hw) -> int:
    net = seeded.build(lambda: ref_raft.RAFT(cfg["raft"]["iters"]), "meta")
    x = torch.empty(batch, 3, *hw, device="meta")
    return count(lambda: net(x, x))


class Stream:
    """``stylize-video``'s program (``video_stylizer``) with the reference's
    weights, read from a checkpoint file as the command reads one."""

    def __init__(self, cfg, ref, mix, device, cache: Path):
        from vst_torch.cli.__main__ import video_stylizer

        cache.mkdir(parents=True, exist_ok=True)
        path = cache / "johnson_stream_state.pt"
        torch.save(ref["stylize"].state_dict(), path)
        args = argparse.Namespace(method="johnson", n_styles=cfg["stylize"]["n_styles"], seed=0,
                                  ckpt_dir=str(path), bf16=False, sid=mix["style"],
                                  strength=cfg["stylize"]["strength"])
        self.stylize, self.dtype = video_stylizer(args, device)
        self.stylize_modules = [inspect.getclosurevars(self.stylize).nonlocals["net"]]


def ref_stream(ref, x01, style):
    """What ``stylize-video`` returns for frames in [0, 1]."""
    return (ref["stylize"](x01, style) / 255.0).clamp(0.0, 1.0)
