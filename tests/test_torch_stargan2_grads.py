"""StarGAN v2's steps against vst's, on the CPU: losses and gradients.

Float32, the real nets at 32² (``tests/test_torch_stargan2_train.py``'s
configuration): for each D step (latent and reference style: BCE and R1
through a double backward) and each AdvCon G step (latent: G, F and E;
reference: G), from the same weights, batch and latents, every loss within
``LOSS_RTOL`` = 1e-4 relative (measured ≤ 1.3e-6) and each net's whole
gradient within ``GRAD32_RTOL`` = 1e-2 relative in L2 of vst's (measured
≤ 2.4e-3, G in the latent G step). Per parameter, float32 gradients are not
comparable: rounding decides the leaky ReLUs near 0 and the sums that
cancel, and on this configuration a small head's gradient (a domain's
style-encoder head) differed by 3 %.

Float64 holds each parameter to ``GRAD_RTOL`` = 1e-8:
``test_torch_stargan2_float64.py`` with narrow D and E, and here, marked
``slow``, with these real nets (vst's float64 steps on them took 655 s on a
CPU; the port's agreed to 1e-8 in every step).
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import (CFG, S, TO_PORT, fc2_batch, float64, grad_probe,  # noqa: F401
                              grad_rel_errs, latents, port_loss, rel_err, torch_threads, tree,
                              updated, vst_batch, vst_params, vst_state, vst_step)
from vst.train.stargan2 import StarGAN2Config as JConfig
from vst.train.stargan2 import StarGAN2Trainer as JTrainer
from vst_torch.train.parity import grad_errors
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer, gan_batch

LOSS_RTOL = 1e-4
GRAD32_RTOL = 1e-2
GRAD_RTOL = 1e-8
STEPS = [("d", "latent"), ("d", "ref"), ("g", "latent"), ("g", "ref")]


@pytest.fixture(scope="module")
def setup():
    port = StarGAN2Trainer(StarGAN2Config(**CFG, lambda_tcl=100.0), seed=4, device="cpu")
    return port, vst_params(port), fc2_batch((S, S), 2, 3, seed=3), \
        latents(jax.random.PRNGKey(5), 2)[0]


@pytest.mark.parametrize("which,kind", STEPS, ids=[f"{w}_{k}" for w, k in STEPS])
def test_step_losses_and_gradients_float32(setup, which, kind):
    port, params, b, z = setup
    names = updated(which, kind)
    jt = JTrainer(JConfig(**CFG, lambda_tcl=100.0))
    for k in names:
        jt.tx[k] = grad_probe()
    state, want_m = vst_step(jt, vst_state(jt, params), which, kind,
                             {k: jnp.asarray(v) for k, v in vst_batch(b).items()}, jnp.asarray(z))
    try:
        loss, got_m = port_loss(port, which, kind, gan_batch(b, "cpu"), torch.from_numpy(z))
        loss.backward()
        for k in names:
            want = TO_PORT[k](jax.tree_util.tree_map(np.asarray, state.params[k]))
            got = {n: p.grad for n, p in port.nets[k].named_parameters()}
            _, whole = grad_errors(got, want)
            assert whole <= GRAD32_RTOL, (k, whole)
    finally:
        for net in port.nets.values():
            net.requires_grad_(True).zero_grad(set_to_none=True)
    assert set(got_m) == set(want_m)
    for k, w in want_m.items():
        w, g = float(w), float(got_m[k].detach())
        assert (g == w == 0.0) or rel_err(g, w) <= LOSS_RTOL, (k, g, w)


@pytest.mark.slow
@pytest.mark.parametrize("which,kind,lam", [(*s, 100.0) for s in STEPS] + [("g", "latent", 0.0)])
def test_step_gradients_real_nets_float64(setup, which, kind, lam):
    port, params, b, z = setup
    port = StarGAN2Trainer(StarGAN2Config(**CFG, lambda_tcl=lam), seed=4, device="cpu")
    names = updated(which, kind)
    with float64():
        jt = JTrainer(JConfig(**CFG, lambda_tcl=lam))
        for k in names:
            jt.tx[k] = grad_probe()
        jb = {k: jnp.asarray(v, jnp.float64 if np.asarray(v).dtype.kind == "f" else None)
              for k, v in vst_batch(b).items()}
        state, _ = vst_step(jt, vst_state(jt, {k: tree(v, jnp.float64) for k, v in params.items()}),
                            which, kind, jb, jnp.asarray(z, jnp.float64))
    for net in port.nets.values():
        net.double()
    tb = {k: v.double() if v.is_floating_point() else v for k, v in gan_batch(b, "cpu").items()}
    loss, _ = port_loss(port, which, kind, tb, torch.from_numpy(np.array(z, np.float64)))
    loss.backward()
    for k in names:
        errs = grad_rel_errs({n: p.grad for n, p in port.nets[k].named_parameters()},
                             TO_PORT[k](jax.tree_util.tree_map(np.asarray, state.params[k])))
        assert max(errs.values()) <= GRAD_RTOL, (k, max(errs.items(), key=lambda t: t[1]))
