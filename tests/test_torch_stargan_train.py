"""StarGAN v1's trainer (``vst_torch.train.stargan``) against vst's, on the CPU,
at 32², batch 2, 3 domains, conv_dim 8, G with 2 residual blocks, D with 3
stride-2 convs. vst's weights reach the port through
``vst_torch.convert.stargan_*_state_dict_from_jax``; batches are vst's
synthetic FC2 batches, labels one-hot.

* The D step (WGAN, classification, the gradient penalty on interpolates
  with a given α) and the G step (WGAN, classification, reconstruction):
  losses within ``LOSS_RTOL`` = 1e-4 relative in float32, and every
  parameter's gradient within ``GRAD_RTOL`` = 1e-8 relative in L2 in
  float64 (jax's x64 mode; vst's gradients read through a probe optimizer,
  ``tests/torch_gan_parity.py``).
* The gradient penalty alone with a given α, float64, within 1e-10.
* vst's schedule over each optimizer's own count, and the trainer's counts
  after a loop: G's moves once every ``n_critic`` iterations, as optax's.
* ``classification_loss_bce`` against ``torch.nn.functional``.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from torch_gan_parity import (fc2_batch, float64, grad_probe, grad_rel_errs,  # noqa: F401
                                    rel_err, torch_threads, tree)
from vst.models.stargan import Discriminator as JDiscriminator
from vst.train.stargan import StarGANConfig as JConfig
from vst.train.stargan import StarGANTrainer as JTrainer
from vst.train.stargan import classification_loss_bce as jcls_loss
from vst.train.stargan import stargan_lr_schedule as jschedule
from vst_torch import convert
from vst_torch.train.stargan import (StarGANConfig, StarGANTrainer, classification_loss_bce,
                                     stargan_lr_schedule)

S = 32
C = 3
D_REPEAT = 3
CFG = dict(c_dim=C, image_size=S, conv_dim=8, repeat_num=2)
LOSS_RTOL = 1e-4
GRAD_RTOL = 1e-8


def pair(seed=0, **kw):
    """(vst trainer with D_REPEAT stride-2 convs, its state, the port trainer
    on the same weights)."""
    jt = JTrainer(JConfig(**CFG, **kw))
    jt.D = JDiscriminator(S, CFG["conv_dim"], C, D_REPEAT)
    state = jt.init_state(seed)
    port = StarGANTrainer(StarGANConfig(**CFG, d_repeat_num=D_REPEAT, **kw), seed=seed,
                          device="cpu")
    port.G.load_state_dict(convert.stargan_generator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.g_params)))
    port.D.load_state_dict(convert.stargan_discriminator_state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, state.d_params)))
    return jt, state, port


def inputs(seed, dtype=np.float32):
    b = fc2_batch((S, S), 2, C, seed=seed)
    eye = np.eye(C, dtype=dtype)
    return b["x_src"].astype(dtype), eye[b["y_src"]], eye[b["y_ref"]]


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def assert_losses(got, want, rtol):
    assert set(got) == set(want)
    for k, w in want.items():
        w, g = float(w), float(got[k].detach())
        assert rel_err(g, w) <= rtol, (k, g, w)


@pytest.mark.parametrize("which", ["d", "g"])
def test_step_losses_float32(which):
    jt, state, port = pair(seed=1)
    x, c_org, c_trg = inputs(seed=2)
    key = jax.random.PRNGKey(3)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))  # vst's draw in d_step
    if which == "d":
        _, want = jt.d_step()(state, jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg), key)
        _, got = port.d_loss(nchw(x), torch.from_numpy(c_org), torch.from_numpy(c_trg),
                             torch.from_numpy(alpha))
    else:
        _, want = jt.g_step()(state, jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg))
        _, got = port.g_loss(nchw(x), torch.from_numpy(c_org), torch.from_numpy(c_trg))
    assert_losses(got, want, LOSS_RTOL)


@pytest.mark.parametrize("which", ["d", "g"])
def test_step_gradients_float64(which):
    with float64():
        jt, state, port = pair(seed=4)
        x, c_org, c_trg = inputs(seed=5, dtype=np.float64)
        key = jax.random.PRNGKey(6)
        alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))  # float64 in x64 mode
        state = state.replace(g_params=tree(state.g_params, jnp.float64),
                              d_params=tree(state.d_params, jnp.float64))
        if which == "d":
            jt.tx_d = grad_probe()
            state = state.replace(opt_d=jt.tx_d.init(state.d_params))
            state, want_m = jt.d_step()(state, jnp.asarray(x), jnp.asarray(c_org),
                                        jnp.asarray(c_trg), key)
            want = convert.stargan_discriminator_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, state.d_params))
        else:
            jt.tx_g = grad_probe()
            state = state.replace(opt_g=jt.tx_g.init(state.g_params))
            state, want_m = jt.g_step()(state, jnp.asarray(x), jnp.asarray(c_org),
                                        jnp.asarray(c_trg))
            want = convert.stargan_generator_state_dict_from_jax(
                jax.tree_util.tree_map(np.asarray, state.g_params))
    port.G.double()
    port.D.double()
    args = (nchw(x), torch.from_numpy(c_org), torch.from_numpy(c_trg))
    if which == "d":
        loss, got_m = port.d_loss(*args, torch.from_numpy(alpha))
        net = port.D
    else:
        port.D.requires_grad_(False)
        loss, got_m = port.g_loss(*args)
        net = port.G
    loss.backward()
    errs = grad_rel_errs({n: p.grad for n, p in net.named_parameters()}, want)
    assert max(errs.values()) <= GRAD_RTOL, max(errs.items(), key=lambda t: t[1])
    assert_losses(got_m, want_m, 1e-10)


def test_gradient_penalty_with_given_alpha():
    with float64():
        jt, state, port = pair(seed=7)
        x, _, _ = inputs(seed=8, dtype=np.float64)
        x2, _, _ = inputs(seed=9, dtype=np.float64)
        alpha = np.random.RandomState(10).rand(2, 1, 1, 1)
        x_hat = alpha * x + (1 - alpha) * x2
        d_params = tree(state.d_params, jnp.float64)
        want = float(jax.jit(jt._gp)(d_params, jnp.asarray(x_hat)))
    port.D.double()
    a = torch.from_numpy(alpha)
    got = port.gradient_penalty(a * nchw(x) + (1 - a) * nchw(x2)).item()
    assert rel_err(got, want) <= 1e-10


@pytest.mark.parametrize("args", [(1e-4, 200_000, 100_000, 1000), (2e-4, 3000, 2000, 1000),
                                  (1e-4, 50, 40, 1), (1e-3, 10, 10, 3)])
def test_schedule_is_vsts(args):
    """The rate at each count against vst's (float32 there: 1e-6 relative),
    through the decay and down to 0."""
    lr0, n, nd, step = args
    mine, theirs = stargan_lr_schedule(*args), jschedule(*args)
    counts = sorted({0, 1, n - nd - 2, n - nd - 1, n - nd, n - 2, n - 1, n, n + 5}
                    | set(range(0, n + 5, max(1, n // 97))))
    for c in (c for c in counts if c >= 0):
        want = float(theirs(jnp.asarray(c)))
        got = mine(c)
        assert abs(got - want) <= 1e-6 * lr0, (c, got, want)
    assert mine(n + nd) == 0.0


def test_each_optimizer_counts_its_own_updates():
    """Five iterations at n_critic 2 on a schedule that moves every update:
    D updates 5 times at counts 0 … 4, G twice at its own counts 0, 1 (vst's
    optax counts agree after the same loop)."""
    jt, state, port = pair(seed=11, n_critic=2)
    port.schedules = {k: stargan_lr_schedule(1e-4, 12, 12, 1) for k in ("G", "D")}
    lrs = {"G": [], "D": []}
    x, c_org, c_trg = inputs(seed=12)
    key = jax.random.PRNGKey(13)
    for i in range(5):
        before = {k: port.counts[k] for k in lrs}
        port.train_iteration(i, nchw(x), torch.from_numpy(c_org), torch.from_numpy(c_trg))
        for k in lrs:
            if port.counts[k] > before[k]:
                lrs[k].append(port.opts[k].param_groups[0]["lr"])
        key, sub = jax.random.split(key)
        state, _ = jt.d_step()(state, jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg), sub)
        if (i + 1) % 2 == 0:
            state, _ = jt.g_step()(state, jnp.asarray(x), jnp.asarray(c_org), jnp.asarray(c_trg))
    sched = port.schedules["G"]
    assert lrs == {"G": [sched(0), sched(1)], "D": [sched(c) for c in range(5)]}
    assert port.counts == {"G": 2, "D": 5} and port.step == int(state.step) == 5
    for k, opt in (("G", state.opt_g), ("D", state.opt_d)):  # Adam's and the schedule's counts
        counts = {int(c) for c in jax.tree_util.tree_leaves(opt) if np.asarray(c).dtype.kind == "i"}
        assert counts == {port.counts[k]}, (k, counts)


def test_classification_loss_is_bce_summed_over_labels():
    logits = np.random.RandomState(14).randn(4, 3).astype(np.float32) * 3
    targets = np.eye(3, dtype=np.float32)[[0, 2, 1, 1]]
    got = float(classification_loss_bce(torch.from_numpy(logits), torch.from_numpy(targets)))
    want = float(F.binary_cross_entropy_with_logits(
        torch.from_numpy(logits), torch.from_numpy(targets), reduction="sum")) / 4
    assert rel_err(got, want) <= 1e-6
    assert rel_err(got, float(jcls_loss(jnp.asarray(logits), jnp.asarray(targets)))) <= 1e-6
