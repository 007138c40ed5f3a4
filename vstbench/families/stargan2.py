"""The ``stargan2`` configuration: StarGAN v2 at 256 with AdvCon's TCL term,
and the evaluation's RAFT, in ``vst_torch``, with the reference's weights."""

from __future__ import annotations

import torch

from vstbench.counts.flops import count
from vstbench.families import johnson
from vstbench.families.common import port
from vstbench.reference import raft as ref_raft
from vstbench.reference import seeded
from vstbench.reference import stargan2 as ref_sg

STYLIZE_SCALE = 1.0  # the generator's output lies about in [-1, 1]
EVAL_NETS = ("generator", "mapping")


def reference(cfg, gen):
    """The evaluation's reference nets (G, F, RAFT), drawn from ``gen`` in
    this order."""
    nets = ref_sg.make(cfg["stargan2"], gen, EVAL_NETS)
    nets["raft"] = ref_raft.make(cfg["raft"]["iters"], gen)
    return nets


def eval_styles(cfg, gen):
    """(domain y, latent z (1, latent_dim)) for y = 1 .. num_domains - 1, z
    drawn from ``gen`` after the nets."""
    c = cfg["stargan2"]
    z = torch.randn(c["num_domains"] - 1, c["latent_dim"], generator=gen, device=gen.device)
    return [(y, z[y - 1:y]) for y in range(1, c["num_domains"])]


def _port_nets(cfg, ref, names, device):
    from vst_torch.models.stargan2 import (Discriminator, Generator, MappingNetwork,
                                           StyleEncoder)

    c = cfg["stargan2"]
    make = {"generator": lambda: Generator(c["img_size"], c["style_dim"], c["max_conv_dim"]),
            "mapping": lambda: MappingNetwork(c["latent_dim"], c["style_dim"], c["num_domains"]),
            "style_enc": lambda: StyleEncoder(c["img_size"], c["style_dim"], c["num_domains"],
                                              c["max_conv_dim"]),
            "disc": lambda: Discriminator(c["img_size"], c["num_domains"], c["max_conv_dim"])}
    return {k: port(make[k], ref[k].state_dict(), device) for k in names}


class Eval:
    """``evaluate_sintel_stargan2`` over one clip for one (y, z) style."""

    def __init__(self, cfg, ref, styles, device):
        from vst_torch.flow.raft import RAFT

        nets = _port_nets(cfg, ref, EVAL_NETS, device)
        self.g, self.f = nets["generator"], nets["mapping"]
        self.raft = port(lambda: RAFT(iters=cfg["raft"]["iters"]), ref["raft"].state_dict(),
                         device)
        self.styles = [(y, z.detach().cpu()) for y, z in styles]
        self.num_domains = cfg["stargan2"]["num_domains"]
        self.device = device
        self.stylize_modules = [self.g, self.f]
        self.capture_module = self.g

    def call(self, video, style: int, dt_iters: int, lt_len: int):
        from vst_torch.eval.drivers import evaluate_sintel_stargan2

        return evaluate_sintel_stargan2(self.g, self.f, [video], self.raft,
                                        num_domains=self.num_domains,
                                        styles=[self.styles[style]], dt_iters=dt_iters,
                                        lt_len=lt_len, device=self.device)

    @staticmethod
    def captured(inputs, output):
        """(frame, output) of one generator call."""
        return inputs[0], output


pipeline = johnson.pipeline


def ref_stylize(ref, x, style):
    y, z = style
    s = ref["mapping"](z, torch.tensor([y], device=x.device))
    return ref["generator"](x, s)


def tcl_space(raw):
    return raw


def stylize_flops(cfg, hw) -> int:
    c = cfg["stargan2"]
    nets = {k: seeded.build(ref_sg.builders(c)[k], "meta") for k in EVAL_NETS}
    y = torch.zeros(1, dtype=torch.long, device="meta")

    def call():
        s = nets["mapping"](torch.empty(1, c["latent_dim"], device="meta"), y)
        nets["generator"](torch.empty(1, 3, *hw, device="meta"), s)

    return count(call)


raft_flops = johnson.raft_flops


# -- training -------------------------------------------------------------------------


def reference_train(cfg, gen):
    """The four nets, drawn from ``gen`` in the order of ``reference.stargan2.NETS``."""
    return ref_sg.make(cfg["stargan2"], gen)


def trainer(cfg, ref, device):
    """The port's ``StarGAN2Trainer`` with the reference's weights in its nets
    and their EMA copies (the trainer builds and initialises its own nets on
    the host first: it takes none)."""
    from vst_torch.train.stargan2 import EMA_NETS, StarGAN2Config, StarGAN2Trainer

    c = cfg["stargan2"]
    tcfg = StarGAN2Config(**{k: c[k] for k in (
        "img_size", "style_dim", "latent_dim", "num_domains", "w_hpf", "lambda_reg",
        "lambda_sty", "lambda_ds", "lambda_cyc", "lambda_tcl", "lr", "f_lr", "beta1", "beta2",
        "weight_decay", "ema_beta", "max_conv_dim")})
    t = StarGAN2Trainer(tcfg, seed=0, device=device)
    for k, net in t.nets.items():
        net.load_state_dict(ref[k].state_dict())
    for k in EMA_NETS:
        t.ema[k].load_state_dict(ref[k].state_dict())
    return t


def step_losses(cfg, metrics):
    """The four steps' total losses (D latent, D ref, G latent, G ref) from
    the trainer's metrics, as (4,) on the device."""
    c = cfg["stargan2"]
    out = []
    for step in ("D/latent", "D/ref"):
        out.append(metrics[f"{step}_real"] + metrics[f"{step}_fake"]
                   + c["lambda_reg"] * metrics[f"{step}_reg"])
    for step in ("G/latent", "G/ref"):
        out.append(metrics[f"{step}_adv"] + c["lambda_sty"] * metrics[f"{step}_sty"]
                   + c["lambda_cyc"] * metrics[f"{step}_cyc"]
                   + c["lambda_tcl"] * metrics[f"{step}_tcl"])
    return torch.stack(out)
