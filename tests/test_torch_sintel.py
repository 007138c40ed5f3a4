"""vst_torch's TCL programs and Sintel driver against vst's at 32×48, with
FastStyleNet (3 styles) and RAFT (2 GRU iterations) carrying the same
weights on both sides — the slice's main path end to end on the CPU.
Tolerances: stylized frames 1e-5 absolute on [0, 1]; TCL values 1e-4
relative (measured on a CPU: 2.4e-6 on the frames, ≤ 8.4e-7 relative on
TCL)."""

import types

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.data.synthetic import AffineMotionGenerator, _texture
from vst.eval.drivers import evaluate_sintel_faststyle as jevaluate_sintel_faststyle
from vst.eval.drivers import faststyle_stylize_fn as jfaststyle_stylize_fn
from vst.eval.sintel import make_tcl_program as jmake_tcl_program
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst.models.faststyle import FastStyleNet as JFastStyleNet
from vst.models.faststyle import faststyle_params_from_torch
from vst_torch.eval.drivers import evaluate_sintel_faststyle, faststyle_stylize_fn
from vst_torch.eval.sintel import SintelVideo, evaluate_videos, make_tcl_program
from vst_torch.flow.raft import RAFT
from vst_torch.models.faststyle import FastStyleNet
from vst_torch.ops.flowtools import fbc_mask

HW = (32, 48)
RTOL_TCL = 1e-4
ATOL_IMG = 1e-5


def _video(n_frames=7, hw=HW, seed=0):
    rng = np.random.RandomState(seed)
    gen = AffineMotionGenerator(crop_hw=hw, seed=seed + 1)
    frames, flows, _ = gen.generate(_texture(rng, (hw[0] + 96, hw[1] + 96)), n_frames=n_frames)
    return frames.astype(np.float32), flows


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2)), np.float32))


def _nets():
    """Port FastStyleNet and RAFT with seeded weights, and vst's with the same."""
    torch.manual_seed(0)
    style_net = FastStyleNet(n_styles=3).eval()
    with torch.no_grad():  # spread the output over [0, 255] instead of ~127.5
        style_net.deconv3.conv2d.weight.mul_(300.0)
    raft = RAFT(iters=2).eval()
    jstyle = (types.SimpleNamespace(model=JFastStyleNet(n_styles=3)),
              faststyle_params_from_torch(style_net.state_dict()))
    jraft_params = {"params": raft_params_from_torch(raft.state_dict())}
    jraft = JRAFT(small=False, iters=2)

    def jraft_apply(a, b):
        return jraft.apply(jraft_params, a, b)

    def raft_apply(a, b):
        return raft(a, b)

    return style_net, raft_apply, jstyle, jraft_apply


@pytest.fixture(scope="module")
def programs():
    style_net, raft_apply, jstyle, jraft_apply = _nets()
    port = make_tcl_program(faststyle_stylize_fn(style_net, style_net.state_dict()), raft_apply)
    ref = jmake_tcl_program(jfaststyle_stylize_fn(*jstyle), jraft_apply)
    frames, _ = _video()
    return port, ref, frames * 2.0 - 1.0


def test_tcl_and_tcl2_match_vst(programs):
    (tcl, _, _, tcl2), (jtcl, _, _, jtcl2), frames = programs
    cur, st, lt = frames[6:7], frames[5:6], frames[1:2]
    x_t, v_t = tcl(_nchw(cur), _nchw(st), 2)
    x_j, v_j = jtcl(jnp.asarray(cur), jnp.asarray(st), 2)
    np.testing.assert_allclose(x_t.permute(0, 2, 3, 1).numpy(), np.asarray(x_j), atol=ATOL_IMG)
    assert float(v_j) > 0.01
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=RTOL_TCL)

    _, st_t, lt_t = tcl2(_nchw(cur), _nchw(st), _nchw(lt), 1)
    _, st_j, lt_j = jtcl2(jnp.asarray(cur), jnp.asarray(st), jnp.asarray(lt), 1)
    np.testing.assert_allclose([float(st_t), float(lt_t)], [float(st_j), float(lt_j)],
                               rtol=RTOL_TCL)


def test_tcl2_equals_two_tcl_calls(programs):
    (tcl, _, _, tcl2), _, frames = programs
    cur, st, lt = _nchw(frames[6:7]), _nchw(frames[5:6]), _nchw(frames[1:2])
    _, st_ref = tcl(cur, st, 0)
    _, lt_ref = tcl(cur, lt, 0)
    _, st_v, lt_v = tcl2(cur, st, lt, 0)
    np.testing.assert_allclose(float(st_v), float(st_ref), rtol=1e-5)
    np.testing.assert_allclose(float(lt_v), float(lt_ref), rtol=1e-5)


def test_tcl_gt_with_smooth_flow_matches_vst(programs):
    (_, _, tcl_gt, _), (_, _, jtcl_gt, _), frames = programs
    ys, xs = np.meshgrid(np.arange(HW[0]), np.arange(HW[1]), indexing="ij")
    rng = np.random.RandomState(7)
    a, b = rng.uniform(0.5, 1.5, 2)
    ff = np.stack([1.5 * a + 0.4 * np.sin(xs / 7.0), -b + 0.3 * np.cos(ys / 5.0)], -1)
    ff = ff[None].astype(np.float32)
    bf = (-ff + 0.05 * rng.randn(*ff.shape)).astype(np.float32)
    mask = fbc_mask(_nchw(ff), _nchw(bf))
    assert float(mask.mean()) > 0.1
    cur, prev = frames[3:4], frames[2:3]
    _, v_t = tcl_gt(_nchw(cur), _nchw(prev), 1, _nchw(ff), _nchw(bf))
    _, v_j = jtcl_gt(jnp.asarray(cur), jnp.asarray(prev), 1, jnp.asarray(ff), jnp.asarray(bf))
    assert float(v_j) > 0.01
    np.testing.assert_allclose(float(v_t), float(v_j), rtol=RTOL_TCL)


def test_identity_generator_with_exact_flow():
    """An identity generator scores only the warp quirk's residual: small
    with zero motion, finite with the motion's own backward flow
    (tests/test_eval_sintel.py:52)."""
    frames, flows = _video(n_frames=3, hw=(64, 96))
    gt = {}

    def raft_apply(a, b):
        return None, gt["flow"].expand(a.shape[0], -1, -1, -1)

    tcl, _, _, _ = make_tcl_program(lambda img, style: img, raft_apply)
    gt["flow"] = torch.zeros(1, 2, 64, 96)
    _, v = tcl(_nchw(frames[0:1]), _nchw(frames[0:1]), 0)
    assert float(v) < 0.25
    gt["flow"] = _nchw(flows[0:1])
    _, v2 = tcl(_nchw(frames[1:2]), _nchw(frames[0:1]), 0)
    assert np.isfinite(float(v2))


def test_reference_aggregation_naming():
    frames, _ = _video(n_frames=6)

    def raft_apply(a, b):
        return None, torch.zeros(a.shape[0], 2, a.shape[2], a.shape[3])

    results = evaluate_videos([SintelVideo("alley_1", frames)], lambda img, s: img,
                              raft_apply, styles=[0, 1, 2], dt_iters=1, device="cpu")
    for out_id in ("TCL-ST", "TCL-LT", "DT"):
        keys = set(results[out_id])
        assert f"{out_id}_alley_1_s1" in keys and f"{out_id}_mean" in keys
        assert {f"{out_id}_mean_s{d}" for d in (1, 2, 3)} <= keys
    assert results["DT"]["DT_mean"] > 0.0


def test_evaluate_sintel_faststyle_matches_vst():
    frames, _ = _video(n_frames=6, seed=3)
    style_net, raft_apply, jstyle, jraft_apply = _nets()
    video = SintelVideo("toy", frames)
    got = evaluate_sintel_faststyle(style_net, style_net.state_dict(), [video], raft_apply,
                                    dt_iters=1, device="cpu")
    want = jevaluate_sintel_faststyle(*jstyle, [video], jraft_apply, dt_iters=1)
    for out_id in ("TCL-ST", "TCL-LT"):
        assert set(got[out_id]) == set(want[out_id])
        for k, v in want[out_id].items():
            assert v > 0.0
            np.testing.assert_allclose(got[out_id][k], v, rtol=RTOL_TCL, err_msg=k)
