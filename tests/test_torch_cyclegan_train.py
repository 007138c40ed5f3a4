"""The CycleGAN family's trainer (``vst_torch.train.cyclegan``) against vst's
on the CPU at ``torch_gan_parity.CG`` (32², batch 2, ngf = ndf = 8, 2-block
generators, pool 4), MoGAN and ConGAN on vst's stub flow, the same weights,
batch and pool draws:

* the E step of each variant (and CycleGAN with a pool of 1, whose second
  image goes through the draws) and MoGAN's M step: every loss within
  ``LOSS_RTOL`` = 1e-4 relative in float32 (measured ≤ 1.4e-6);
* vst's schedule, and each optimizer counting its own updates;
* a 30-step fixed-batch run whose cycle and identity terms descend
  (``tests/test_cyclegan.py:212``); ``generate_fn`` is the net's forward.

The float64 steps (parameters and gradients): ``test_torch_cyclegan_float64.py``;
the bf16 policy: ``test_torch_cyclegan_bf16.py``; the real RAFT:
``test_torch_cyclegan_raft.py``.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from torch_gan_parity import (cyclegan_batch_np, cyclegan_pair, rel_err,  # noqa: F401
                              torch_threads, vst_pool_draws)
from vst.train.cyclegan import linear_lr_schedule as jschedule
from vst_torch.train.cyclegan import (CycleGANConfig, CycleGANTrainer, cyclegan_batch,
                                      linear_lr_schedule)
from vst_torch.train.parity import CYCLEGAN_SMALL, stub_flow

LOSS_RTOL = 1e-4
E_CASES = [("cyclegan", 4), ("cyclegan_con", 4), ("mogan", 4), ("congan", 4), ("cyclegan", 1)]


def jbatch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_losses(got, want, rtol):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = float(w), float(got[k])
        assert rel_err(g, w) <= rtol or (w == 0 and g == 0), (k, g, w)


@pytest.mark.parametrize("variant,pool", E_CASES, ids=[f"{v}_pool{p}" for v, p in E_CASES])
def test_e_step_losses_float32(variant, pool):
    jt, state, port = cyclegan_pair(variant, seed=1, pool_size=pool)
    b = cyclegan_batch_np(2)
    rng = jax.random.PRNGKey(3)
    _, want = jt.train_step()(state, jbatch(b), rng)
    got = port.e_step(cyclegan_batch(b, "cpu"), vst_pool_draws(rng, 2, pool))
    assert_losses(got, want, LOSS_RTOL)
    assert port.counts == {"G": 1, "D": 1, **({"M": 0} if variant == "mogan" else {})}


def test_m_step_losses_float32():
    jt, state, port = cyclegan_pair("mogan", seed=4)
    b = cyclegan_batch_np(5)
    _, want = jt.m_step()(state, jbatch(b))
    got = port.m_step(cyclegan_batch(b, "cpu"))
    assert_losses(got, want, LOSS_RTOL)
    assert port.counts == {"G": 0, "D": 0, "M": 1} and port.step == 1


@pytest.mark.parametrize("spe,n_epochs,decay", [(10, 100, 100), (3, 2, 4), (1, 1, 1)])
def test_linear_schedule_matches_vst(spe, n_epochs, decay):
    got = linear_lr_schedule(2e-4, spe, n_epochs, decay)
    want = jschedule(2e-4, spe, n_epochs, decay)
    for count in (0, 1, spe - 1, spe, 2 * spe, n_epochs * spe, (n_epochs + decay) * spe + 5):
        assert got(count) == pytest.approx(float(want(jnp.asarray(count, jnp.int32))), rel=1e-6)


def test_each_optimizer_counts_its_own_updates():
    """MoGAN's loop, 5 iterations (E, M, E, M, E) with a schedule that decays
    every update: G and D take 3 updates, M 2, each at its own count's rate."""
    cfg = CycleGANConfig(variant="mogan", **{**CYCLEGAN_SMALL, "steps_per_epoch": 1},
                         n_epochs=1, n_epochs_decay=4)
    trainer = CycleGANTrainer(cfg, raft=stub_flow, seed=0, device="cpu")
    batch = cyclegan_batch(cyclegan_batch_np(6), "cpu")
    rates = {g: [] for g in trainer.opts}
    for i in range(5):
        group = "M" if i % 2 else "G"
        trainer.train_iteration(i, batch)
        rates[group].append(trainer.opts[group].param_groups[0]["lr"])
        if group == "G":
            rates["D"].append(trainer.opts["D"].param_groups[0]["lr"])
    assert trainer.counts == {"G": 3, "D": 3, "M": 2} and trainer.step == 5
    for g, seen in rates.items():
        assert seen == [trainer.schedule(c) for c in range(len(seen))], g
    assert rates["M"][1] < rates["M"][0] and rates["G"][2] < rates["G"][1]


def test_reconstruction_descends():
    """30 fixed-batch E steps: the cycle and identity terms, the supervised
    part of the objective, drop (the mean of the last 5 below the first 5)."""
    trainer = CycleGANTrainer(CycleGANConfig(**CYCLEGAN_SMALL), seed=0, device="cpu")
    batch = cyclegan_batch(cyclegan_batch_np(7), "cpu")
    rec = []
    for _ in range(30):
        m = trainer.e_step(batch)
        rec.append(sum(float(m[k]) for k in ("cycle_A", "cycle_B", "idt_A", "idt_B")))
    assert np.isfinite(rec).all()
    assert np.mean(rec[-5:]) < np.mean(rec[:5]), rec


def test_the_g_step_leaves_d_without_gradients():
    """The G step takes gradients for G only (D frozen), the D step for D
    only (the pooled fakes detached)."""
    trainer = CycleGANTrainer(CycleGANConfig(variant="congan", **CYCLEGAN_SMALL), raft=stub_flow,
                              seed=0, device="cpu")
    batch = cyclegan_batch(cyclegan_batch_np(8), "cpu")
    _, fakes = trainer.g_step(batch)
    assert all(p.grad is None for k in ("D_A", "D_B") for p in trainer.nets[k].parameters())
    assert all(p.grad is not None for k in ("G_A", "F_B") for p in trainer.nets[k].parameters())
    assert not any(f.requires_grad for f in fakes)
    for net in trainer.nets.values():
        net.zero_grad(set_to_none=True)
    trainer.d_step(batch, *trainer.query_pools(fakes))
    assert all(p.grad is None for k in ("G_A", "G_B", "F_A") for p in trainer.nets[k].parameters())
    assert trainer.pools["A"]["count"] == 2 and trainer.pools["B"]["count"] == 2


def test_generate_fn_is_the_nets_forward():
    trainer = CycleGANTrainer(CycleGANConfig(**CYCLEGAN_SMALL), seed=0, device="cpu")
    x = cyclegan_batch(cyclegan_batch_np(9), "cpu")["real_B"]
    for which in ("G_A", "G_B"):
        out = trainer.generate_fn(which)(x)
        assert not out.requires_grad and out.equal(trainer.nets[which](x).detach())
