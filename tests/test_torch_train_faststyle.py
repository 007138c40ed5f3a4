"""vst_torch's FastStyleTrainer against vst's: the Johnson and Dumoulin heads
(loss and aux terms in float32, every gradient in float64; tolerances and
why in ``tests/torch_train_parity.py``), the learning-rate schedule, Adam
against optax on the same gradients (1e-6 relative), and a 3-step Johnson
trajectory in float64 (1e-3 relative)."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
import optax

from torch_train_parity import (BATCH, HW, assert_grads_agree, assert_losses_agree,
                                compare_head, float64, make_pair)
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.data.synthetic import synthetic_batch
from vst.models.faststyle import faststyle_params_from_torch
from vst.train.faststyle import TrainState
from vst.train.faststyle import ref_lr_schedule as vst_schedule
from vst_torch.convert import faststyle_state_dict_from_jax
from vst_torch.train.faststyle import (FastStyleConfig, FastStyleTrainer, batch_to_tensors,
                                       ref_lr_schedule)
from vst_torch.train.registry import select_method

ADAM_RTOL = 1e-6
TRAJECTORY_RTOL = 1e-3

# method → (n_styles, style ids): Dumoulin's conditional norms at both styles
# and at an id past the table, which both sides clip
HEADS = {"johnson": (1, (0,)), "dumoulin": (2, (1, 0, 5))}


@pytest.fixture(scope="module", params=sorted(HEADS))
def head(request):
    n_styles, sids = HEADS[request.param]
    jt, params, tt, batch = make_pair(request.param, n_styles=n_styles)
    losses, grads = compare_head(jt, params, tt, batch,
                                 [(sid, jax.random.PRNGKey(0), None) for sid in sids])
    return n_styles, sids, losses, grads


def test_head_loss_and_aux_terms(head):
    for want, got in head[2]:
        assert_losses_agree(got, want)


def test_head_gradients(head):
    for want, got in head[3]:
        assert_grads_agree(got, want)


def test_style_ids_are_clipped_into_the_table(head):
    """Ids past the table read its last row, as vst's ``mode="clip"``;
    distinct rows give distinct losses."""
    n_styles, sids, losses, _ = head
    by_row = {}
    for sid, (_, port) in zip(sids, losses):
        by_row.setdefault(min(sid, n_styles - 1), set()).add(port[0])
    assert all(len(row) == 1 for row in by_row.values())
    assert len({row.pop() for row in by_row.values()}) == len(by_row)


def test_lr_schedule_is_vsts():
    for bs in (16, 200, 1000):
        ours, theirs = ref_lr_schedule(1e-3, bs), vst_schedule(1e-3, bs)
        for step in range(3001):
            assert np.float32(ours(step)) == np.float32(theirs(step)), (bs, step)
    sched = ref_lr_schedule(1e-3, 16)  # k = 31: the first decay is update 30
    assert sched(29) == 1e-3 and sched(30) == pytest.approx(1e-3 / 1.2)
    assert sched(10 ** 6) == 1e-4


def test_adam_is_optax_across_a_decay_boundary():
    """Batch 200, so the rate divides by 1.2 every 2 updates: 6 updates on
    the same random gradients, the params after each within 1e-6 relative
    (L2 per tensor) of ``optax.adam`` with vst's schedule run in float64.
    optax in float32 would be 6.5e-6 off on the zero-initialised norm
    biases: it computes the bias correction 1 − 0.999ᵗ in float32, where
    0.999 is 1.3e-5 off; torch computes it in double precision."""
    cfg = FastStyleConfig(method="dumoulin", emphasis=(1.0, 10.0), n_styles=2, batch_size=200)
    tt = FastStyleTrainer(cfg, np.zeros((2, 16, 16, 3), np.float32), seed=3, device="cpu")
    rng = np.random.RandomState(4)
    rates = []
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    try:
        params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                        faststyle_params_from_torch(tt.model.state_dict()))
        tx = optax.adam(vst_schedule(cfg.lr, cfg.batch_size, cfg.lr_floor))
        opt_state = tx.init(params)
        for _ in range(6):
            grads = {n: torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
                     for n, p in tt.model.named_parameters()}
            for n, p in tt.model.named_parameters():
                p.grad = grads[n].clone()
            rates.append(tt.schedule(tt.step))
            tt.apply_gradients()
            updates, opt_state = tx.update(
                jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                       faststyle_params_from_torch(grads)), opt_state, params)
            params = optax.apply_updates(params, updates)
            want = faststyle_state_dict_from_jax(jax.device_get(params))
            for n, p in tt.model.named_parameters():
                rel = float((p.detach().double() - want[n]).norm() / want[n].norm())
                assert rel <= ADAM_RTOL, (n, rel)
    finally:
        jax.config.update("jax_enable_x64", saved)
    assert len(set(rates)) == 4 and tt.step == 6  # 1e-3, then ÷1.2 at updates 1, 3, 5


def test_three_step_trajectory():
    """vst's jitted train step (optax) and the port's (torch.optim.Adam), 3
    steps on 3 batches in float64: the losses, each before its update,
    within 1e-3 relative."""
    jt, params, tt, _ = make_pair("johnson")
    batches = [synthetic_batch(BATCH, hw=HW, seed=10 + i) for i in range(3)]
    want, got = [], []
    with float64(jt, tt):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        state = TrainState(step=jnp.zeros((), jnp.int32), params=p64, opt_state=jt.tx.init(p64))
        step = jt.train_step()
        for i, batch in enumerate(batches):
            state, metrics = step(state, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()},
                                  0, jax.random.PRNGKey(i))
            want.append(float(metrics["loss"]))
            tensors = {k: v.double() for k, v in batch_to_tensors(batch, "cpu").items()}
            got.append(float(tt.train_step(tensors, 0)["loss"]))
    np.testing.assert_allclose(got, want, rtol=TRAJECTORY_RTOL)
    assert want[2] < want[0]


def test_stylize_fn_clamps_to_unit_range():
    tt = FastStyleTrainer(select_method("johnson", batch_size=2),
                          np.zeros((1, 16, 16, 3), np.float32), seed=0, device="cpu")
    with torch.no_grad():
        tt.model.deconv3.conv2d.weight.mul_(3000.0)  # spread the output past [0, 255]
        x = torch.rand(1, 3, 16, 16)
        raw = tt.model(x)[1] / 255.0
    out = tt.stylize_fn()(x)
    assert raw.min() < 0 and raw.max() > 1
    assert out.shape == x.shape and torch.equal(out, raw.clamp(0, 1))
