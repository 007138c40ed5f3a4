"""RAFT's small variant and training mode, ``upflow8``, ``forward_interpolate``
and the sequence loss, vst_torch against vst on the CPU, weights carried
from the port to vst by vst's own ``raft_params_from_torch`` (it reads the
small net's keys too).

* Flows in float32 within 1e-3 px (``tests/test_torch_raft.py``'s tolerance;
  measured on a CPU: small 1.5e-5 px, full 1.4e-6, in either mode).
* ``flow_sequence_loss`` in float32 within 1e-6 relative (its gradients in
  float64: ``tests/test_torch_raft_train_float64.py``).
* ``upflow8`` within 1e-5; ``forward_interpolate`` (SciPy on the host on
  both sides) equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vst.flow.datasets import flow_sequence_loss as j_loss
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst.flow.raft import upflow8 as j_upflow8
from vst.ops.flowtools import forward_interpolate as j_forward_interpolate
from vst_torch.flow.corr import lookup_pyramid
from vst_torch.flow.datasets import flow_sequence_loss
from vst_torch.flow.raft import RAFT, upflow8
from vst_torch.ops.flowtools import forward_interpolate

ATOL_PX = 1e-3
TORCH_THREADS = 2


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(TORCH_THREADS)
    yield
    torch.set_num_threads(saved)


def _images(seed, hw=(64, 96)):
    rng = np.random.RandomState(seed)
    base = rng.rand(1, hw[0] + 8, hw[1] + 8, 3).astype(np.float32) * 255
    return base[:, 4:4 + hw[0], 4:4 + hw[1]], base[:, 2:2 + hw[0], 5:5 + hw[1]]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, -3)))


def _seeded(small, train_mode, iters, seed=0, **kw):
    torch.manual_seed(seed)
    return RAFT(iters=iters, small=small, train_mode=train_mode, **kw).eval()


@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
@pytest.mark.parametrize("train_mode", [False, True], ids=["eval", "train_mode"])
def test_flows_match_vst(small, train_mode):
    i1, i2 = _images(3 + small)
    net = _seeded(small, train_mode, iters=3)
    params = raft_params_from_torch(net.state_dict())
    low_j, up_j = JRAFT(small=small, iters=3, train_mode=train_mode).apply(
        {"params": params}, jnp.asarray(i1), jnp.asarray(i2))
    with torch.no_grad():
        low_t, up_t = net(_nchw(i1), _nchw(i2))
    up_t = np.moveaxis(up_t.numpy(), -3, -1)
    want_shape = (3, 1, 64, 96, 2) if train_mode else (1, 64, 96, 2)
    assert up_t.shape == np.shape(up_j) == want_shape
    assert np.abs(up_t).max() > 1e-2  # not 0 = 0
    np.testing.assert_allclose(np.moveaxis(low_t.numpy(), -3, -1), np.asarray(low_j),
                               atol=ATOL_PX)
    np.testing.assert_allclose(up_t, np.asarray(up_j), atol=ATOL_PX)
    if train_mode:  # the last iteration's flow is the eval flow
        with torch.no_grad():
            _, up_eval = _seeded(small, False, iters=3)(_nchw(i1), _nchw(i2))
        np.testing.assert_allclose(up_t[-1], np.moveaxis(up_eval.numpy(), 1, -1), atol=1e-6)


def test_small_net_has_the_reference_keys():
    sd = _seeded(True, False, 1).state_dict()
    assert "update_block.gru.convz.weight" in sd and "fnet.layer2.0.conv3.weight" in sd
    assert not any(k.startswith("update_block.mask") for k in sd)
    assert sd["update_block.encoder.convc1.weight"].shape == (96, 4 * 7 * 7, 1, 1)
    assert sum(v.numel() for k, v in sd.items()) < 1.1e6  # RAFT small: about 1M parameters


def test_small_net_runs_at_radius_3():
    seen = []

    def lookup(pyramid, coords, radius):
        seen.append(radius)
        return lookup_pyramid(pyramid, coords, radius)

    i1, i2 = _images(5, hw=(64, 64))
    with torch.no_grad():
        RAFT(iters=2, small=True, lookup=lookup)(_nchw(i1), _nchw(i2))
    assert seen == [3, 3]


def test_sequence_loss_matches_vst():
    rng = np.random.RandomState(0)
    preds = rng.randn(4, 2, 12, 10, 2).astype(np.float32) * 3
    gt = rng.randn(2, 12, 10, 2).astype(np.float32) * 3
    gt[0, :3] = 500.0  # |gt| ≥ max_flow is left out
    valid = (rng.rand(2, 12, 10) > 0.3).astype(np.float32)
    want = j_loss([jnp.asarray(p) for p in preds], jnp.asarray(gt), jnp.asarray(valid),
                  gamma=0.7, max_flow=400.0)
    got = flow_sequence_loss(_nchw(preds), _nchw(gt), torch.from_numpy(valid), gamma=0.7,
                             max_flow=400.0)
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_upflow8_matches_vst():
    f = np.random.RandomState(1).randn(2, 5, 7, 2).astype(np.float32)
    got = np.moveaxis(upflow8(_nchw(f)).numpy(), 1, -1)
    assert got.shape == (2, 40, 56, 2)
    np.testing.assert_allclose(got, np.asarray(j_upflow8(jnp.asarray(f))), rtol=0, atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 4.0, 40.0])
def test_forward_interpolate_matches_vst(scale):
    f = (np.random.RandomState(2).randn(20, 30, 2) * scale).astype(np.float32)
    got = forward_interpolate(_nchw(f[None])[0])
    assert got.dtype == torch.float32 and got.shape == (2, 20, 30)
    np.testing.assert_array_equal(np.moveaxis(got.numpy(), 0, -1), j_forward_interpolate(f))
