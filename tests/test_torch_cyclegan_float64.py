"""The CycleGAN trainer's steps against vst's in float64 on the CPU (jax's
x64 mode, vst's float32 sites patched by ``torch_gan_parity.float64``) at
``torch_gan_parity.CG``, MoGAN and ConGAN on the stub flow, the same
weights, batch and pool draws. After one E step of each variant (and
CycleGAN with a pool of 1, whose second image goes through the draws) and
one MoGAN M step:

* every updated parameter (G, D and ConGAN's F; M) within ``PARAM_RTOL`` =
  1e-8 relative in L2 (measured ≤ 5.2e-9: a conv bias in front of an
  instance norm has a gradient of 0 in exact arithmetic, and Adam divides
  its rounding noise by eps; ``vst_torch.train.parity.param_errors``);
* every gradient within ``GRAD_RTOL`` = 1e-8 relative in L2 (measured
  ≤ 4e-14), read from vst's recording optimizers.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import (cyclegan_batch_np, cyclegan_pair, cyclegan_state_dict,  # noqa: F401
                              float64, grad_rel_errs, torch_threads, vst_pool_draws)
from vst_torch.train.cyclegan import cyclegan_batch
from vst_torch.train.parity import param_errors

PARAM_RTOL = 1e-8
GRAD_RTOL = 1e-8
E_CASES = [("cyclegan", 4), ("cyclegan_con", 4), ("mogan", 4), ("congan", 4), ("cyclegan", 1)]


def flat(trees, names):
    """vst's per-net trees as the port's ``net.param`` float64 tensors."""
    return {f"{k}.{n}": torch.as_tensor(np.asarray(v)).double() for k in names
            for n, v in cyclegan_state_dict(k, trees[k]).items()}


def port_flat(port, names, grads=False):
    return {f"{k}.{n}": (p.grad if grads else p).detach().double() for k in names
            for n, p in port.nets[k].named_parameters()}


def check(port, new_params, recorded, names):
    want_grads = flat(recorded, names)
    got_grads = port_flat(port, names, grads=True)
    assert max(grad_rel_errs(got_grads, want_grads).values()) <= GRAD_RTOL
    err = param_errors(port_flat(port, names), flat(new_params, names), want_grads,
                       port.cfg.lr)
    assert err <= PARAM_RTOL


@pytest.mark.parametrize("variant,pool", E_CASES, ids=[f"{v}_pool{p}" for v, p in E_CASES])
def test_e_step_float64(variant, pool):
    b = cyclegan_batch_np(2, dtype=np.float64)
    with float64():
        jt, state, port = cyclegan_pair(variant, seed=1, dtype=jnp.float64, pool_size=pool)
        rng = jax.random.PRNGKey(3)
        draws = vst_pool_draws(rng, 2, pool)
        new, _ = jt.train_step()(state, {k: jnp.asarray(v) for k, v in b.items()}, rng)
    for net in port.nets.values():
        net.double()
    port.e_step({k: v.double() for k, v in cyclegan_batch(b, "cpu").items()}, draws)
    names = [k for k in port.nets if k[0] in "GDF"]
    check(port, new.params, {**new.opt_g[1], **new.opt_d[1]}, names)


def test_m_step_float64():
    b = cyclegan_batch_np(5, dtype=np.float64)
    with float64():
        jt, state, port = cyclegan_pair("mogan", seed=4, dtype=jnp.float64)
        new, _ = jt.m_step()(state, {k: jnp.asarray(v) for k, v in b.items()})
    for net in port.nets.values():
        net.double()
    port.m_step({k: v.double() for k, v in cyclegan_batch(b, "cpu").items()})
    check(port, new.params, new.opt_m[1], ["M_A", "M_B"])
