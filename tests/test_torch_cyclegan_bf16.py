"""The CycleGAN trainer's bf16 policy (``compute_dtype="bfloat16"``)
against vst's on the CPU at ``torch_gan_parity.CG``, the same weights,
batch and draws: the E step of CycleGAN and of MoGAN (stub flow), every
loss within ``BF16_LOSS_RTOL`` = 3e-2 relative (measured ≤ 1.8e-2: XLA
rounds a fused D to bfloat16 at other points than PyTorch's op-by-op run;
the L1 terms agree exactly), the masters and the pools float32; MoGAN's
RAFT flows of the float32 frames for the M nets and of the cast frames for
the loss, as vst's."""

import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import (cyclegan_batch_np, cyclegan_pair, rel_err,  # noqa: F401
                              torch_threads, vst_pool_draws)
from vst_torch.train.cyclegan import CycleGANConfig, CycleGANTrainer, cyclegan_batch
from vst_torch.train.parity import CYCLEGAN_SMALL, stub_flow

BF16_LOSS_RTOL = 3e-2


@pytest.mark.parametrize("variant", ["cyclegan", "mogan"])
def test_e_step_losses_bfloat16(variant):
    jt, state, port = cyclegan_pair(variant, seed=1, compute_dtype="bfloat16")
    b = cyclegan_batch_np(2)
    rng = jax.random.PRNGKey(3)
    _, want = jt.train_step()(state, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    got = port.e_step(cyclegan_batch(b, "cpu"), vst_pool_draws(rng, 2, 4))
    assert set(got) == set(want)
    for k, w in want.items():
        assert rel_err(float(got[k]), float(w)) <= BF16_LOSS_RTOL or float(w) == float(got[k]), k
    assert all(p.dtype == torch.float32 for net in port.nets.values() for p in net.parameters())
    assert port.pools["A"]["buffer"].dtype == torch.float32


def test_mogan_bfloat16_flows_follow_vst():
    """Under bf16 vst's E step feeds M_A and M_B the flows of the float32
    frames (``vst/train/cyclegan.py:340-343``) and its loss the flows of the
    frames cast to bfloat16 (``:280, 287``): 8 RAFT calls, the first two on
    the float32 frames, the next two on the cast ones."""
    seen = []

    def raft(img1, img2):
        seen.append(img1)
        return stub_flow(img1, img2)

    trainer = CycleGANTrainer(CycleGANConfig(variant="mogan", compute_dtype="bfloat16",
                                             **CYCLEGAN_SMALL), raft=raft, seed=0, device="cpu")
    batch = cyclegan_batch(cyclegan_batch_np(2), "cpu")
    trainer.e_step(batch)
    assert len(seen) == 8 and all(x.dtype == torch.float32 for x in seen)
    for k, (name, cast) in enumerate([("real_A2", False), ("real_B2", False),
                                      ("real_A2", True), ("real_B2", True)]):
        want = batch[name].to(torch.bfloat16).float() if cast else batch[name]
        assert torch.equal(seen[k], want), (k, name)
        assert not torch.equal(seen[k], batch[name].to(torch.bfloat16).float() if not cast
                               else batch[name]), (k, name)
