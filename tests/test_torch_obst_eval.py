"""vst_torch.eval.drivers.evaluate_sintel_obst against vst's on a 6-frame
16×24 synthetic clip (so TCL-LT has a frame), with the clip's analytic flow
as ``raft_apply`` on both sides, in float64 (jax's x64 mode; see
tests/test_torch_gatys.py for why the descent is held in float64), in both
``literal_mask_zero`` modes: the same TCL-ST / TCL-LT / DT / RAFT-MS keys
and files, TCL values within 1e-6 relative.

Without the temporal term (the zeroed mask), six chained L-BFGS runs on the
non-convex VGG objective can be chaotic: at 24×32 with the style of seed 6
the port disagreed with itself by 0.7 % in TCL-LT between 1, 2 and 4 torch
threads (another order of the same float64 sums), so no comparison at 1e-6
means anything there. At 16×24 (a cut of the image, for time: vst's float64
program takes about 7 s a run on a CPU) styles of seeds 6–9 agree with
themselves across those thread counts within 4e-11 in both modes (measured
on a CPU); the test holds seed ``STYLE_SEED``."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vst.models.gatys as jg
from vst.eval.drivers import evaluate_sintel_obst as vst_evaluate
from vst.eval.sintel import SintelVideo as JVideo
from vst_torch.cli.__main__ import synthetic_clip
from vst_torch.eval.drivers import evaluate_sintel_obst
from vst_torch.eval.sintel import SintelVideo
from vst_torch.models import gatys
from vst_torch.perceptual.vgg import obst_prep

TCL_RTOL = 1e-6
HW = (16, 24)
PYR = ((8, 12), (16, 24))
N_FRAMES = 6
STYLE_SEED = 7
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def x64():
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


@pytest.fixture(scope="module")
def clip():
    frames, gen = synthetic_clip(HW, N_FRAMES, seed=5)
    return frames.astype(np.float64), gen


@pytest.fixture(scope="module")
def obsts(x64):
    """(vst OBST, port OBST), float64, one seed; vst's compiled levels are
    shared by the tests of this module."""
    return (jg.OBST(max_iters=(1, 1), seed=4, compute_dtype=jnp.float64),
            gatys.OBST(max_iters=(1, 1), seed=4, compute_dtype=torch.float64, device="cpu"))


def flow_oracle(frames_prep, gen, to_nhwc, from_nhwc):
    """``raft_apply(a, b)`` → (None, the exact flow a → b): a and b are known
    by which caffe-space frame they equal."""
    def index(x):
        return int(np.argmin([np.abs(to_nhwc(x) - f).max() for f in frames_prep]))

    def raft_apply(a, b):
        i, j = index(a), index(b)
        flow = gen.pairwise_flows(i, j)[0] if i < j else gen.pairwise_flows(j, i)[1]
        return None, from_nhwc(flow[None].astype(np.float64))

    return raft_apply


def run_both(obsts, clip, literal_mask_zero, tmp_path):
    jo, to = obsts
    frames, gen = clip
    styles = np.random.RandomState(STYLE_SEED).rand(1, 48, 48, 3)
    prep = np.asarray(jg.obst_prep(jnp.asarray(frames)))
    j_raft = flow_oracle(prep, gen, np.asarray, jnp.asarray)
    t_raft = flow_oracle(prep, gen, lambda t: t.permute(0, 2, 3, 1).numpy(),
                         lambda a: torch.from_numpy(a).permute(0, 3, 1, 2))
    want = vst_evaluate(jo, [JVideo("clip", frames)], j_raft, jnp.asarray(styles), PYR,
                        weight_tcl=2000.0, out_path=str(tmp_path / "vst"),
                        literal_mask_zero=literal_mask_zero)
    got = evaluate_sintel_obst(to, [SintelVideo("clip", frames)], t_raft, styles, PYR,
                               weight_tcl=2000.0, out_path=str(tmp_path / "port"),
                               literal_mask_zero=literal_mask_zero)
    return got, want


@pytest.mark.parametrize("literal_mask_zero", [False, True], ids=["golden", "living"])
def test_matches_vst(obsts, clip, literal_mask_zero, tmp_path):
    got, want = run_both(obsts, clip, literal_mask_zero, tmp_path)
    assert set(got) == set(want) == {"TCL-ST", "TCL-LT", "DT", "RAFT-MS"}
    for metric in got:
        assert set(got[metric]) == set(want[metric]) == {f"{metric}_clip_s1"}
    for metric in ("TCL-ST", "TCL-LT"):
        g, w = got[metric][f"{metric}_clip_s1"], want[metric][f"{metric}_clip_s1"]
        assert abs(g - w) <= TCL_RTOL * max(abs(w), 1e-12), (metric, g, w)
    if literal_mask_zero:  # the zeroed mask makes TCL-ST 0 by construction
        assert got["TCL-ST"]["TCL-ST_clip_s1"] == 0.0
    else:
        assert got["TCL-ST"]["TCL-ST_clip_s1"] > 0
    assert got["TCL-LT"]["TCL-LT_clip_s1"] > 0
    for side in ("vst", "port"):
        written = sorted(p.name for p in (tmp_path / side).iterdir())
        assert written == ["DT.json", "RAFT-MS.json", "TCL-LT.json", "TCL-ST.json"]
    for name in ("DT", "TCL-ST"):
        g = json.loads((tmp_path / "port" / f"{name}.json").read_text())
        w = json.loads((tmp_path / "vst" / f"{name}.json").read_text())
        assert set(g) == set(w) and f"{name}_clip_s1" in g


def test_frame_zero_runs_under_a_zero_mask(obsts, clip):
    """Frame 0 starts from the content itself and its mask is zero, so the
    temporal weight does not reach it (``obst_eval.py:507``): its result is
    the same at λ = 0 and λ = 2000."""
    _, to = obsts
    frames, _ = clip
    to.set_style(np.random.RandomState(STYLE_SEED).rand(48, 48, 3), PYR)
    img = obst_prep(torch.from_numpy(frames[:1]).permute(0, 3, 1, 2))
    zero = torch.zeros_like(img[:, :1])
    a = to.run(img, img, zero, PYR, weight_tcl=0.0)
    b = to.run(img, img, zero, PYR, weight_tcl=2000.0)
    assert torch.equal(a, b)
