"""MoGAN and ConGAN E steps with the real RAFT inside, against vst's on the
CPU: RAFT (full, 2 iterations) seeded in the port and carried to vst by its
``raft_params_from_torch``; the trainers at ``torch_gan_parity.CG`` but at
64² (RAFT's 4-level pyramid needs a 1/8 map of 8 pixels a side), the same
weights, batch and pool draws. Every loss within ``LOSS_RTOL`` = 1e-4
relative in float32 (the port's lookup runs its plain version on the CPU).
MoGAN's M step too (4 RAFT calls)."""

import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import (cyclegan_batch_np, cyclegan_pair, rel_err,  # noqa: F401
                              torch_threads, vst_pool_draws)
from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst_torch.flow.raft import RAFT
from vst_torch.train.cyclegan import cyclegan_batch

LOSS_RTOL = 1e-4
HW = (64, 64)


def rafts(iters=2, seed=0):
    """(the port's seeded RAFT, vst's raft_apply on the same weights)."""
    torch.manual_seed(seed)
    net = RAFT(iters=iters).eval()
    params = {"params": raft_params_from_torch(net.state_dict())}
    jnet = JRAFT(small=False, iters=iters)
    return net, jax.jit(lambda a, b: jnet.apply(params, a, b))


@pytest.mark.parametrize("step", ["mogan_e", "mogan_m", "congan_e"])
def test_losses_with_raft(step):
    variant, which = step.split("_")
    net, japply = rafts()
    jt, state, port = cyclegan_pair(variant, seed=2, raft_apply=japply, raft=net, hw=HW)
    b = cyclegan_batch_np(3, hw=HW)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    rng = jax.random.PRNGKey(4)
    if which == "e":
        _, want = jt.train_step()(state, jb, rng)
        got = port.e_step(cyclegan_batch(b, "cpu"), vst_pool_draws(rng, 2, 4))
    else:
        _, want = jt.m_step()(state, jb)
        got = port.m_step(cyclegan_batch(b, "cpu"))
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_err(float(got[k]), float(w)) <= LOSS_RTOL or float(w) == float(got[k]), k
