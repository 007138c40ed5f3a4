"""vst_torch's ``evaluate_videos_sharded`` against vst's
(``vst/eval/sintel.py:325``) on a 9-frame 48×64 synthetic clip, styles
(0, 1) through vst's stand-in stylizer, at world size 1 (one process, no
group) and 2 (two spawned gloo ranks, ``tests/torch_dp_cases.py``); vst's on
its 8-device mesh. With vst's stub flow the per-(video, style) TCL agrees
within 1e-4 relative, with the full RAFT (2 iterations, the port's seeded
weights carried into vst) within 2e-3 (vst's own tolerances,
``tests/test_eval_sintel.py:126-185``). The port's sharded TCL is also held
to the port's serial ``evaluate_videos`` on the same inputs, within 1e-4
relative."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import torch_dp_cases as dp
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.data.synthetic import AffineMotionGenerator, _texture
from vst.eval.sintel import SintelVideo as JSintelVideo
from vst.eval.sintel import evaluate_videos_sharded as jevaluate_videos_sharded
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst.parallel.mesh import create_mesh as jcreate_mesh
from vst_torch.eval.sintel import SintelVideo, evaluate_videos
from vst_torch.flow.raft import RAFT
from vst_torch.train.parity import stub_flow

HW = (48, 64)
N_FRAMES = 9
STYLES = [0.0, 1.0]
RTOL = {"stub": 1e-4, "raft": 2e-3}
KEYS = ("TCL-ST", "TCL-LT")


def _frames():
    rng = np.random.RandomState(0)
    gen = AffineMotionGenerator(crop_hw=HW, seed=1)
    frames, _, _ = gen.generate(_texture(rng, (HW[0] + 96, HW[1] + 96)), n_frames=N_FRAMES)
    return frames.astype(np.float32)


def _vst(frames, raft_state):
    """vst's sharded harness on the 8-device mesh, stub flow and RAFT."""
    def stylize(img, style):
        return jnp.clip(img * (1.0 + 0.1 * style), 0.0, 1.0)

    def stub(i1, i2):
        d = jnp.mean(i1 - i2, axis=-1, keepdims=True)
        return None, jnp.concatenate([d, -d], axis=-1)

    params = {"params": raft_params_from_torch(raft_state)}
    jraft = JRAFT(small=False, iters=2)
    mesh = jcreate_mesh()
    videos = [JSintelVideo("toy", frames)]
    return {"stub": jevaluate_videos_sharded(videos, stylize, stub, STYLES, mesh),
            "raft": jevaluate_videos_sharded(videos, stylize,
                                             lambda a, b: jraft.apply(params, a, b), STYLES,
                                             mesh)}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    frames = _frames()
    torch.manual_seed(0)
    raft_state = RAFT(iters=2).state_dict()
    ranks, (single, vst) = dp.spawn(
        dp.eval_cases, 2, tmp_path_factory.mktemp("eval"), frames, raft_state,
        meanwhile=lambda: (dp.eval_cases(dp.cpu_mesh(1, 0), frames, raft_state),
                           _vst(frames, raft_state)))
    return {"vst": vst, 1: single, 2: ranks, "frames": frames, "raft_state": raft_state}


@pytest.mark.parametrize("flow", ("stub", "raft"))
@pytest.mark.parametrize("world", (1, 2))
def test_tcl_matches_vsts_sharded_harness(results, world, flow):
    got_all = [results[1]] if world == 1 else results[2]
    want = results["vst"][flow]
    for got in got_all:
        for kind in KEYS:
            assert set(got[flow][kind]) == set(want[kind])
            for k, w in want[kind].items():
                np.testing.assert_allclose(got[flow][kind][k], w, rtol=RTOL[flow], err_msg=k)


def test_ranks_return_the_same_results_and_vsts_keys(results):
    """Every rank holds the all-gathered values; DT is reported per
    (video, style) and aggregated under vst's names."""
    a, b = results[2]
    for flow in ("stub", "raft"):
        for kind in KEYS:
            assert a[flow][kind] == b[flow][kind]
        assert set(a[flow]["DT"]) == set(results["vst"][flow]["DT"])
        assert all(v > 0 for v in a[flow]["DT"].values())
        assert {"DT_toy_s1", "DT_mean", "DT_mean_s2"} <= set(a[flow]["DT"])


SERIAL_RTOL = 1e-4


@pytest.fixture(scope="module")
def serial(results):
    """The port's serial harness on the fixture's frames, styles, stylizer and
    flows (no DT chain)."""
    raft = RAFT(iters=2).eval()
    raft.load_state_dict(results["raft_state"])
    videos = [SintelVideo("toy", results["frames"])]
    return {flow: evaluate_videos(videos, dp.stub_stylize, apply, STYLES, dt_iters=0,
                                  device="cpu")
            for flow, apply in (("stub", stub_flow), ("raft", raft))}


@pytest.mark.parametrize("flow", ("stub", "raft"))
@pytest.mark.parametrize("world", (1, 2))
def test_tcl_matches_the_serial_harness(results, serial, world, flow):
    """Every TCL-ST and TCL-LT value of the sharded harness (RAFT forward and
    backward as two calls at batch 1 a rank) within 1e-4 relative of the
    serial one's (RAFT at batch 2 and 4)."""
    got_all = [results[1]] if world == 1 else results[2]
    for got in got_all:
        for kind in KEYS:
            want = serial[flow][kind]
            assert set(got[flow][kind]) == set(want)
            for k, w in want.items():
                np.testing.assert_allclose(got[flow][kind][k], w, rtol=SERIAL_RTOL, err_msg=k)
