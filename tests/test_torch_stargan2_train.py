"""StarGAN v2's trainer (``vst_torch.train.stargan2``) against vst's, on the
CPU, at 32², batch 2, 3 domains, style 8, latent 4, max width 32 (the first
blocks stay 512 wide: ``dim_in = 2¹⁴ / img_size``).

* The bf16 policy: one latent D step and one latent G step (without TCL)
  from the same weights, each loss within ``BF16_RTOL`` = 2⁻⁵ relative of
  vst's bf16 losses (measured on a CPU: up to 1.3 %, the D step's fake
  term). Not one bf16 rounding: XLA fuses chains of elementwise bf16 ops
  (AdaIN's (1 + γ)·x̂ + β, the residual sums) and rounds once a fusion,
  torch once an op, and the nets are some 20 layers deep.
* The EMA / λ_ds step against vst's ``ema_step``: after three steps every
  element within ``EMA_RTOL`` = 1e-6 of its tensor's largest magnitude
  (XLA contracts p + β(e − p) into one fma, torch rounds the product and
  the sum; measured 3e-7), λ_ds and the step equal; and
  AdamW on given gradients against ``optax.adamw`` (float64: optax's and
  torch's bias corrections round differently in float32).
* ``adv_loss`` against ``torch.nn.functional``.

Each step's losses and gradients are in ``tests/test_torch_stargan2_grads.py``
(float32) and ``tests/test_torch_stargan2_float64.py``; a whole iteration in
``tests/test_torch_stargan2_iteration.py``.
"""

import numpy as np
import torch
import torch.nn.functional as F
import jax
import jax.numpy as jnp

from torch_gan_parity import (CFG, S, fc2_batch, float64, latents, rel_err,  # noqa: F401
                              torch_threads, tree, vst_batch, vst_params, vst_state)
from vst.models.stargan2 import (generator_params_from_torch, mapping_params_from_torch,
                                 style_encoder_params_from_torch)
from vst.train.stargan2 import StarGAN2Config as JConfig
from vst.train.stargan2 import StarGAN2Trainer as JTrainer
from vst.train.stargan2 import adv_loss as jadv_loss
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer, adv_loss, gan_batch

BF16_RTOL = 2.0 ** -5
EMA_RTOL = 1e-6
OPT_RTOL = 1e-12


def test_bf16_policy_losses():
    """vst's bf16 policy and the port's: the same casts, float32 norms and
    loss reductions."""
    cfg = dict(CFG, compute_dtype="bfloat16")
    port = StarGAN2Trainer(StarGAN2Config(**cfg), seed=1, device="cpu")
    jt = JTrainer(JConfig(**cfg))
    b = fc2_batch((S, S), 2, 3, seed=2)
    z = latents(jax.random.PRNGKey(4), 2)[0]
    jb = {k: jnp.asarray(v) for k, v in vst_batch(b).items()}
    state = vst_state(jt, vst_params(port))
    _, want_d = jt.d_step("latent")(state, jb["x_real"], jb["y_org"], jb["y_trg"],
                                    jnp.asarray(z), jb["x_ref"])
    state = vst_state(jt, vst_params(port))
    _, want_g = jt.g_step("latent", True)(state, {**jb, "z": jnp.asarray(z)})
    tb = gan_batch(b, "cpu")
    got_d = port.d_step("latent", tb["x_real"], tb["y_org"], tb["y_trg"], torch.from_numpy(z),
                        tb["x_ref"])
    port = StarGAN2Trainer(StarGAN2Config(**cfg), seed=1, device="cpu")
    got_g = port.g_step("latent", True, {**tb, "z": torch.from_numpy(z)})
    for got, want in ((got_d, want_d), (got_g, want_g)):
        assert set(got) == set(want)
        for k, w in want.items():
            assert got[k].dtype == torch.float32, k
            w, g = float(w), float(got[k])
            assert (g == w == 0.0) or rel_err(g, w) <= BF16_RTOL, (k, g, w)


def test_ema_and_lambda_ds_step():
    """ema = p + β(ema − p) for G, F, E, λ_ds decay to its floor at 0 and
    the step count, against vst's ``ema_step`` over three steps."""
    cfg = dict(CFG, lambda_ds=2e-5, ds_iter=1)  # decays past 0 at step 1
    port = StarGAN2Trainer(StarGAN2Config(**cfg), seed=2, device="cpu")
    jt = JTrainer(JConfig(**cfg))
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for k, net in port.ema.items():
            for p in net.parameters():
                p.copy_(torch.from_numpy(rng.randn(*p.shape).astype(np.float32)))
    state = vst_state(jt, vst_params(port))
    # copies, not views: vst's step runs asynchronously and donates its state
    # while port.ema_step() changes the port's parameters in place
    port_ema = {k: {n: np.array(p.detach().numpy(), copy=True)
                    for n, p in net.state_dict().items()}
                for k, net in port.ema.items()}
    to_vst = {"generator": lambda sd: generator_params_from_torch(sd, S),
              "mapping": mapping_params_from_torch,
              "style_enc": lambda sd: style_encoder_params_from_torch(sd, S)}
    state = state.replace(ema={k: tree(to_vst[k](sd)) for k, sd in port_ema.items()})
    for _ in range(3):
        state = jax.block_until_ready(jt.ema_step()(state))
        port.ema_step()
    assert port.step == int(state.step) == 3
    assert float(port.lambda_ds) == float(state.lambda_ds) == 0.0
    for k, net in port.ema.items():
        want = jax.tree_util.tree_leaves(state.ema[k])
        got = jax.tree_util.tree_leaves(tree(to_vst[k](net.state_dict())))
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert np.abs(g - w).max() <= EMA_RTOL * np.abs(w).max(), k


def test_adamw_on_given_gradients():
    """Three AdamW updates (β = (0, 0.99), decoupled decay 1e-4, lr 1e-4,
    and F's 1e-6) on given float64 gradients, against vst's optax.adamw."""
    port = StarGAN2Trainer(StarGAN2Config(**CFG), seed=3, device="cpu")
    jt = JTrainer(JConfig(**CFG))
    rng = np.random.RandomState(6)
    with float64():
        for name in ("disc", "mapping"):
            net, opt = port.nets[name].double(), port.opts[name]
            params = {n: p.detach().numpy().copy() for n, p in net.named_parameters()}
            jp = {n: jnp.asarray(v) for n, v in params.items()}
            jstate = jt.tx[name].init(jp)
            for _ in range(3):
                grads = {n: rng.randn(*v.shape) * 10.0 ** rng.uniform(-6, 0)
                         for n, v in params.items()}
                for n, p in net.named_parameters():
                    p.grad = torch.from_numpy(grads[n])
                opt.step()
                updates, jstate = jt.tx[name].update({n: jnp.asarray(g) for n, g in grads.items()},
                                                     jstate, jp)
                jp = jax.tree_util.tree_map(lambda p, u: p + u, jp, updates)
            for n, p in net.named_parameters():
                want = np.asarray(jp[n])
                err = np.abs(p.detach().numpy() - want).max() / np.abs(want).max()
                assert err <= OPT_RTOL, (name, n, err)


def test_adv_loss_is_bce_with_logits():
    logits = torch.from_numpy(np.random.RandomState(7).randn(3, 5).astype(np.float32) * 4)
    for target in (0, 1):
        want = F.binary_cross_entropy_with_logits(logits, torch.full_like(logits, target))
        assert rel_err(float(adv_loss(logits, target)), float(want)) <= 1e-6
        assert rel_err(float(adv_loss(logits, target)),
                       float(jadv_loss(jnp.asarray(logits.numpy()), target))) <= 1e-6
    assert adv_loss(logits.to(torch.bfloat16), 1).dtype == torch.float32
