"""``flow_sequence_loss`` over ``RAFT(train_mode=True)`` and its gradient with
respect to every parameter, vst_torch against vst in float64 on the CPU at
64×64 with 3 iterations (vst's ``tests/test_flow_training.py:14-32`` set-up,
with a ground truth of a few pixels and a fifth of it invalid), for the
full and the small net.

vst runs under jax x64 with its norm patched to keep float64 and its
hard-coded float32 casts in ``vst.flow.raft`` / ``vst.flow.corr`` read as
float64; the port's net runs in ``.double()`` with the lookup's plain
version (the kernel's wrapper takes float32). The port's weights reach vst
through vst's own ``raft_params_from_torch``, and so do its gradients. The
loss within 1e-10 relative, every gradient within 1e-8 relative in L2
(``vst_torch.train.parity.grad_errors``, which holds a gradient that is 0
in exact arithmetic to rounding on both sides); measured on a CPU: the
loss equal, the worst parameter's gradient 2.2e-14 (small) and 8.1e-15
(full)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vst.flow.corr
import vst.flow.raft
from torch_train_parity import _instance_norm_keeping_f64, torch_threads  # noqa: F401
from vst.flow.datasets import flow_sequence_loss as j_loss
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst_torch.flow.corr import lookup_pyramid
from vst_torch.flow.raft import RAFT
from vst_torch.train.parity import grad_errors, raft_sequence_step, raft_train_inputs

F64_LOSS_RTOL = 1e-10
F64_GRAD_RTOL = 1e-8


def _seeded(small, seed):
    torch.manual_seed(seed)
    return RAFT(iters=3, small=small, train_mode=True, lookup=lookup_pyramid).eval()


class _Jnp64:
    """``jnp`` with float32 read as float64: vst's RAFT and corr cast to
    float32 by name, which a float64 comparison must not."""
    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.fixture
def vst_float64(monkeypatch):
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    monkeypatch.setattr(vst.flow.raft, "instance_norm", _instance_norm_keeping_f64)
    monkeypatch.setattr(vst.flow.raft, "jnp", _Jnp64())
    monkeypatch.setattr(vst.flow.corr, "jnp", _Jnp64())
    yield
    jax.config.update("jax_enable_x64", saved)


def _vst_loss_and_grads(small, params, inputs):
    raft = JRAFT(small=small, iters=3, train_mode=True)
    x = {k: jnp.asarray(v, jnp.float64) for k, v in inputs.items()}
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

    def loss_fn(p):
        _, preds = raft.apply({"params": p}, x["image1"], x["image2"])
        return j_loss([preds[i] for i in range(preds.shape[0])], x["flow"], x["valid"])

    return jax.value_and_grad(loss_fn)(params)


@pytest.mark.parametrize("small", [True, False], ids=["small", "full"])
def test_sequence_loss_and_gradients_float64(vst_float64, small):
    """vst's ``tests/test_flow_training.py:14-32`` set-up at 64×64 and 3
    iterations, with a ground truth of a few pixels and a fifth of it invalid."""
    net = _seeded(small, seed=1)
    inputs = raft_train_inputs((64, 64), seed=2)
    loss, grads = raft_sequence_step(net, inputs, "cpu", torch.float64)
    want_loss, want_grads = _vst_loss_and_grads(
        small, raft_params_from_torch(net.state_dict()), inputs)
    assert abs(loss - float(want_loss)) <= F64_LOSS_RTOL * abs(float(want_loss))
    # the port's gradients, carried into vst's tree by vst's own converter
    got_tree = raft_params_from_torch({k: v.numpy() for k, v in grads.items()})
    flat = lambda tree: {jax.tree_util.keystr(p): torch.from_numpy(np.array(v, np.float64))  # noqa: E731
                         for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    got, want = flat(got_tree), flat(want_grads)
    # vst keeps the batch norm's statistics among its params; the port, as
    # torch, among its buffers
    assert {k.rsplit("'", 2)[-2] for k in set(want) - set(got)} <= {"running_mean", "running_var"}
    want = {k: want[k] for k in got}
    worst, whole = grad_errors(got, want)
    assert worst <= F64_GRAD_RTOL, worst
    assert whole <= F64_GRAD_RTOL
    assert sum(float(g.norm()) for g in got.values()) > 0


