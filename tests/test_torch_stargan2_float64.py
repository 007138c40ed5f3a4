"""StarGAN v2's trainer against vst's in float64 (jax's x64 mode, vst's
float32 rounding sites patched to keep float64: ``tests/torch_gan_parity.py``),
on the CPU, with the real G (vst's 256-pixel configuration at max width 16,
on 32² images) and mapping net F, and narrow stand-ins for D and E on both
sides (``TinyHead`` / ``JTinyHead``: vst's float64 convolutions run at about
1 GFLOP/s on a CPU, and the real D and E cost 4.8 GFLOP a sample in their
first block at any size).

* For each D step (latent, reference: BCE and R1 through a double backward)
  and each G step (latent with and without AdvCon's TCL, reference), every
  parameter's gradient within ``GRAD_RTOL`` = 1e-8 relative in L2 of vst's
  and every loss within ``LOSS_RTOL`` = 1e-10.

The whole iteration is ``tests/test_torch_stargan2_iteration.py``.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from torch_gan_parity import (TO_PORT, JTinyHead, TinyHead, fc2_batch, float64,  # noqa: F401
                              grad_probe, grad_rel_errs, latents, rel_err, torch_threads, tree,
                              updated, vst_batch, vst_state, vst_step)
from vst.models.stargan2 import generator_params_from_torch, mapping_params_from_torch
from vst.train.stargan2 import StarGAN2Config as JConfig
from vst.train.stargan2 import StarGAN2Trainer as JTrainer
from vst_torch.train.stargan2 import EMA_NETS, StarGAN2Config, StarGAN2Trainer, gan_batch

S = 32
IMG_SIZE = 256  # G's configuration: dim_in 64, four downsamples; 32² images
CFG = dict(img_size=IMG_SIZE, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=16)
GRAD_RTOL = 1e-8
LOSS_RTOL = 1e-10
STEPS = [("d", "latent", 100.0), ("d", "ref", 100.0), ("g", "latent", 100.0),
         ("g", "ref", 100.0), ("g", "latent", 0.0)]


def pair(lam, seed=6):
    """(port trainer in float64 with TinyHead D and E, vst trainer with the
    same weights' stand-ins, vst params in float64)."""
    port = StarGAN2Trainer(StarGAN2Config(**CFG, lambda_tcl=lam), seed=seed, device="cpu")
    torch.manual_seed(seed)
    port.nets["disc"] = TinyHead(CFG["num_domains"], 1)
    port.nets["style_enc"] = TinyHead(CFG["num_domains"], CFG["style_dim"])
    for net in port.nets.values():
        net.double()
    port.ema = {k: port.ema[k].double() if k != "style_enc" else
                TinyHead(CFG["num_domains"], CFG["style_dim"]).double()
                for k in EMA_NETS}
    port.ema["style_enc"].load_state_dict(port.nets["style_enc"].state_dict())
    port.opts = {k: torch.optim.AdamW(net.parameters(), lr=port.opts[k].defaults["lr"],
                                      betas=(0.0, 0.99), eps=1e-8, weight_decay=1e-4)
                 for k, net in port.nets.items()}
    jt = JTrainer(JConfig(**CFG, lambda_tcl=lam))
    jt.D = JTinyHead(CFG["num_domains"], 1)
    jt.E = JTinyHead(CFG["num_domains"], CFG["style_dim"])
    sd = {k: net.state_dict() for k, net in port.nets.items()}
    params = {"generator": generator_params_from_torch(sd["generator"], IMG_SIZE),
              "mapping": mapping_params_from_torch(sd["mapping"]),
              "style_enc": port.nets["style_enc"].vst_params(),
              "disc": port.nets["disc"].vst_params()}
    return port, jt, {k: tree(v, jnp.float64) for k, v in params.items()}


def tiny_to_port(params):
    return {"conv1.weight": params["trunk"]["conv1"]["kernel"].transpose(3, 2, 0, 1),
            "conv1.bias": params["trunk"]["conv1"]["bias"],
            "conv2.weight": params["trunk"]["conv2"]["kernel"].transpose(3, 2, 0, 1),
            "conv2.bias": params["trunk"]["conv2"]["bias"],
            "head.weight": params["head"]["kernel"].T, "head.bias": params["head"]["bias"]}


def to_port(name, params):
    params = jax.tree_util.tree_map(np.asarray, params)
    if name in ("disc", "style_enc"):
        return {k: torch.from_numpy(np.array(v)) for k, v in tiny_to_port(params).items()}
    return TO_PORT[name](params)


def batches(b, z):
    jb = {k: jnp.asarray(v, jnp.float64 if np.asarray(v).dtype.kind == "f" else None)
          for k, v in vst_batch(b).items()}
    tb = {k: v.double() if v.is_floating_point() else v for k, v in gan_batch(b, "cpu").items()}
    return jb, tb


def assert_losses(got_m, want_m):
    assert set(got_m) == set(want_m)
    for k, w in want_m.items():
        assert got_m[k].dtype == torch.float64, k
        w, g = float(w), float(got_m[k].detach())
        assert (g == w == 0.0) or rel_err(g, w) <= LOSS_RTOL, (k, g, w)


@pytest.mark.parametrize("which,kind,lam", STEPS,
                         ids=[f"{w}_{k}_tcl{int(l)}" for w, k, l in STEPS])
def test_step_gradients(which, kind, lam):
    b, z = fc2_batch((S, S), 2, 3, seed=3), latents(jax.random.PRNGKey(5), 2)[0]
    names = updated(which, kind)
    with float64():
        port, jt, params = pair(lam)
        for k in names:
            jt.tx[k] = grad_probe()
        jb, tb = batches(b, z)
        state, want_m = vst_step(jt, vst_state(jt, params), which, kind, jb,
                                 jnp.asarray(z, jnp.float64))
    tz = torch.from_numpy(np.array(z, np.float64))
    if which == "d":
        loss, got_m = port.d_loss(kind, tb["x_real"], tb["y_org"], tb["y_trg"], tz, tb["x_ref"])
    else:
        for k, net in port.nets.items():
            net.requires_grad_(k in names)
        loss, got_m = port.g_loss(kind, {**tb, "z": tz})
    loss.backward()
    for k in names:
        errs = grad_rel_errs({n: p.grad for n, p in port.nets[k].named_parameters()},
                             to_port(k, state.params[k]))
        assert max(errs.values()) <= GRAD_RTOL, (k, max(errs.items(), key=lambda t: t[1]))
    assert_losses(got_m, want_m)
