"""The Sintel harness stylizes each frame once a (video, style) pass.

``evaluate_videos`` keeps every stylized frame of a pass until no later
pair reads it, so ``stylize_fn`` runs once for each (frame, style), and its
TCL-ST / TCL-LT equal, bit for bit, what the positional ``tcl`` / ``tcl2`` /
``tcl_gt`` programs give when they re-stylize the earlier frames as the
reference's ``computeTCL`` does:

* on the CPU through RAFT's place (a deterministic flow of the two images)
  and through ``flow_fn`` (the synthetic clip's exact flows), 8 frames,
  ``lt_len`` 5, 2 styles, with a ``stylize_fn`` that records its inputs;
* with FastStyleNet, on the CPU at 32×48 and, marked ``cuda``, on the card
  at 432×1024 on 7 frames, where cuDNN's batch-1 outputs must repeat bit for
  bit (``python -m pytest --noconftest tests/test_torch_sintel_stylize_once.py
  -q -m cuda``; skips without a card).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vst_torch.core import trace
from vst_torch.eval.drivers import faststyle_stylize_fn
from vst_torch.eval.sintel import SintelVideo, evaluate_videos, make_tcl_program
from vst_torch.models.faststyle import FastStyleNet

LT = 5
STYLES = [0, 1]


@pytest.fixture(autouse=True)
def two_threads():
    """Two intra-op threads: the suite runs in several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(n, hw, seed=0):
    """A smooth random clip, each frame the last one shifted by a pixel."""
    rng = np.random.RandomState(seed)
    base = rng.rand(hw[0] // 4 + 1, hw[1] // 4 + n + 1, 3).astype(np.float32)
    base = np.repeat(np.repeat(base, 4, axis=0), 4, axis=1)
    return np.stack([base[:hw[0], i:i + hw[1]] for i in range(n)]).astype(np.float32)


def raft_apply(a, b):
    """RAFT's place: a smooth flow of both images that is the negative of
    the backward one, so the fb mask keeps most pixels. (flow_low, flow_up)."""
    d = F.avg_pool2d((a - b).mean(1, keepdim=True), 5, 1, 2)
    flow = torch.cat([30.0 * d, -15.0 * d], 1)
    return flow[..., ::8, ::8], flow


def exact_flow(video, i, j):
    """``flow_fn``: the clip moves one pixel a frame to the left."""
    h, w = video.frames.shape[1:3]
    ff = np.zeros((h, w, 2), np.float32)
    ff[..., 0] = i - j  # frame j → frame i
    return ff, -ff


class Recorder:
    """A ``stylize_fn`` that keeps each call's input and style."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, img, style):
        self.calls.append((img.detach().clone(), int(style)))
        return self.fn(img, style)

    def frames_called(self, frames):
        """(frame index, style) of every call, in order."""
        out = []
        for img, style in self.calls:
            hits = [k for k in range(frames.shape[0]) if torch.equal(img[0], frames[k])]
            assert len(hits) == 1, "a stylize input that is no single frame of the clip"
            out.append((hits[0], style))
        return out


def conv_stylize(device):
    g = torch.Generator().manual_seed(3)
    w = (torch.randn(len(STYLES), 3, 3, 3, 3, generator=g) * 0.5).to(device)

    def fn(img, style):
        return torch.sigmoid(F.conv2d(img, w[int(style)], padding=1))

    return fn


def faststyle(device):
    torch.manual_seed(0)
    net = FastStyleNet(n_styles=len(STYLES)).eval().to(device)
    with torch.no_grad():  # spread the output over [0, 255] instead of ~127.5
        net.deconv3.conv2d.weight.mul_(300.0)
    return faststyle_stylize_fn(net, net.state_dict())


def restylized(stylize_fn, frames, style, flow_fn=None, video=None):
    """TCL-ST and TCL-LT of one pass by the positional programs, which
    stylize both frames of every pair (the reference's ``computeTCL``)."""
    tcl, _, tcl_gt, tcl2 = make_tcl_program(stylize_fn, raft_apply)
    st, lt = [], []
    for i in range(1, frames.shape[0]):
        img = frames[i:i + 1]
        if flow_fn is None and i >= LT:
            _, st_v, lt_v = tcl2(img, frames[i - 1:i], frames[i - LT:i - LT + 1], style)
            st.append(float(st_v))
            lt.append(float(lt_v))
            continue
        for j, vals in ((i - 1, st), (i - LT, lt)):
            if j < 0:
                continue
            if flow_fn is None:
                vals.append(float(tcl(img, frames[j:j + 1], style)[1]))
            else:
                ff, bf = (torch.from_numpy(f).permute(2, 0, 1)[None].to(frames.device)
                          for f in flow_fn(video, i, j))
                vals.append(float(tcl_gt(img, frames[j:j + 1], style, ff, bf)[1]))
    return float(np.mean(st)), float(np.mean(lt))


def check_once_and_bit_identical(stylize_fn, n, hw, device, flow_fn=None):
    clip = _clip(n, hw)
    video = SintelVideo("clip", clip)
    rec = Recorder(stylize_fn)
    res = evaluate_videos([video], rec, raft_apply, STYLES, lt_len=LT, dt_iters=0,
                          flow_fn=flow_fn, device=device)
    frames = torch.from_numpy(clip).permute(0, 3, 1, 2).contiguous().to(device)
    called = rec.frames_called(frames)
    # the DT timing's call on frame 0, then each frame of the pairs once
    assert sorted(called) == sorted([(0, s) for s in STYLES]
                                    + [(k, s) for s in STYLES for k in range(n)])
    for d, style in enumerate(STYLES):
        st, lt = restylized(stylize_fn, frames, torch.as_tensor(style, device=device),
                            flow_fn, video)
        assert res["TCL-ST"][f"TCL-ST_mean_s{d + 1}"] == st
        assert res["TCL-LT"][f"TCL-LT_mean_s{d + 1}"] == lt
        assert st > 0 and lt > 0  # the mask kept pixels: the values say something


@pytest.mark.parametrize("flow", ["raft", "flow_fn"])
def test_each_frame_is_stylized_once_a_pass(flow):
    flow_fn = exact_flow if flow == "flow_fn" else None
    check_once_and_bit_identical(conv_stylize("cpu"), 8, (16, 24), "cpu", flow_fn)


def test_the_counters_add_up_to_the_restylizing_calls():
    """calls + reuses of the pairs = the stylizes the re-stylizing programs
    make: 2 a pair before ``lt_len``, 3 a frame from there on."""
    n = 8
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        evaluate_videos([SintelVideo("clip", _clip(n, (16, 24)))], conv_stylize("cpu"),
                        raft_apply, STYLES, lt_len=LT, dt_iters=0, device="cpu")
    counters = trace.snapshot()["counters"]
    trace.reset()
    styles = len(STYLES)
    assert counters["vst.eval.stylize_calls"] == styles * (1 + n)  # the DT call, the frames
    assert counters["vst.eval.stylize_calls"] + counters["vst.eval.stylize_reuses"] == styles * (
        1 + 2 * (LT - 1) + 3 * (n - LT))


@pytest.mark.parametrize("device,hw,n", [
    ("cpu", (32, 48), 8),
    pytest.param("cuda", (432, 1024), 7, marks=pytest.mark.cuda)])
def test_faststyle_tcl_is_bit_identical_to_restylizing(device, hw, n):
    if device == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device: cuDNN's batch-1 outputs are checked on the card")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    check_once_and_bit_identical(faststyle(device), n, hw, device)
