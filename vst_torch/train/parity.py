"""One training step's loss and gradients on a device, and the comparison of
two such steps: how the card's step is held against the CPU's
(``tests/test_torch_cuda.py``) and the port's against
vst's (``tests/torch_train_parity.py``). The feed-forward family's step is
:func:`training_step`; the StarGAN trainers' are :func:`stargan2_steps` and
:func:`stargan_steps`; the CycleGAN family's :func:`cyclegan_steps`; RAFT's
sequence loss :func:`raft_sequence_step`.

Gradients are compared per parameter in relative L2. A gradient that is 0 in
exact arithmetic (a conv bias in front of an instance norm, which subtracts
it again) is rounding noise on both sides: below ``ZERO_GRAD`` of the whole
gradient's norm on the reference side it must be below that on the other
side too, and no ratio is taken. Compare float64 gradients: through ReLUs
and max-pools a float32 gradient turns on which units rounding switches on
(0.6–2 % of a parameter's gradient between an H100 and a CPU at 64×64).
"""

from __future__ import annotations

import copy
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vst_torch.data.fc2 import synthetic_fc2_batches
from vst_torch.data.styles import load_style_images
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.flow.datasets import flow_sequence_loss
from vst_torch.train.cyclegan import (CycleGANConfig, CycleGANTrainer, cyclegan_batch,
                                      fc2_to_cyclegan)
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.registry import select_method
from vst_torch.train.stargan import StarGANConfig, StarGANTrainer
from vst_torch.train.stargan2 import EMA_NETS, StarGAN2Config, StarGAN2Trainer, gan_batch

ZERO_GRAD = 1e-6  # of the whole gradient's norm


def training_step(method: str, device, dtype: torch.dtype, coin: Optional[bool] = None,
                  hw=(64, 64), batch_size: int = 2, seed: int = 0
                  ) -> Tuple[float, Dict[str, float], Dict[str, torch.Tensor]]:
    """(loss, aux terms, every parameter's gradient as float64 on the CPU) of
    one ``method`` step in ``dtype`` on ``device``: seed ``seed``'s weights,
    procedural style 0 at 64², a synthetic batch (seed 1); ``coin`` is
    Ruder's branch."""
    cfg = select_method(method, batch_size=batch_size, n_frames=3 if method == "ruder" else 2)
    trainer = FastStyleTrainer(cfg, load_style_images(size=64)[:1], seed=seed, device=device)
    trainer.to_dtype(dtype)
    batch = batch_to_tensors(synthetic_batch(batch_size, hw=hw, n_frames=cfg.n_frames, seed=1),
                             device)
    loss, aux = trainer.loss_fn({k: v.to(dtype) for k, v in batch.items()}, 0, coin)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in aux.items()},
            {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()})


# the StarGAN checks' configurations: narrow, so that float64 on a CPU is quick
STARGAN2_SMALL = dict(img_size=32, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32,
                      lambda_tcl=100.0)
STARGAN_SMALL = dict(c_dim=3, image_size=32, conv_dim=8, repeat_num=2, d_repeat_num=3)


def _gan_inputs(device, dtype, hw, num_dom, seed):
    b = gan_batch(synthetic_fc2_batches(1, 2, hw=hw, num_dom=num_dom, seed=seed)[0], device)
    return {k: v.to(dtype) if v.is_floating_point() else v for k, v in b.items()}


def _grads(nets, names):
    return {f"{k}.{n}": p.grad.double().cpu() for k in names
            for n, p in nets[k].named_parameters()}


def stargan2_steps(device, dtype: torch.dtype, seed: int = 0
                   ) -> Dict[str, Tuple[Dict[str, float], Dict[str, torch.Tensor]]]:
    """Each of a StarGAN v2 iteration's four steps (d_latent, d_ref, g_latent,
    g_ref; AdvCon) from the same seeded weights on ``device`` in ``dtype``, at
    ``STARGAN2_SMALL``: (the step's losses, the gradients of the nets it
    updates as float64 on the CPU, keyed ``net.param``)."""
    trainer = StarGAN2Trainer(StarGAN2Config(**STARGAN2_SMALL), seed=seed, device=device)
    for net in trainer.nets.values():
        net.to(dtype)
    b = _gan_inputs(device, dtype, (32, 32), STARGAN2_SMALL["num_domains"], seed + 1)
    z = torch.randn(2, STARGAN2_SMALL["latent_dim"],
                    generator=torch.Generator().manual_seed(seed + 2)).to(device, dtype)
    out = {}
    for which in ("d", "g"):
        for kind in ("latent", "ref"):
            names = ("disc",) if which == "d" else EMA_NETS if kind == "latent" else ("generator",)
            for k, net in trainer.nets.items():
                net.zero_grad(set_to_none=True)
                net.requires_grad_(which == "d" or k in names)
            if which == "d":
                loss, metrics = trainer.d_loss(kind, b["x_real"], b["y_org"], b["y_trg"], z,
                                               b["x_ref"])
            else:
                loss, metrics = trainer.g_loss(kind, {**b, "z": z})
            loss.backward()
            out[f"{which}_{kind}"] = ({k: v.item() for k, v in metrics.items()},
                                      _grads(trainer.nets, names))
    return out


def stargan_steps(device, dtype: torch.dtype, seed: int = 0
                  ) -> Dict[str, Tuple[Dict[str, float], Dict[str, torch.Tensor]]]:
    """StarGAN v1's D step (with a seeded α) and G step from the same seeded
    weights on ``device`` in ``dtype``, at ``STARGAN_SMALL``: (losses, the
    gradients of the net the step updates, float64 on the CPU)."""
    trainer = StarGANTrainer(StarGANConfig(**STARGAN_SMALL), seed=seed, device=device)
    trainer.G.to(dtype)
    trainer.D.to(dtype)
    b = _gan_inputs(device, dtype, (32, 32), STARGAN_SMALL["c_dim"], seed + 1)
    c_org, c_trg = (torch.nn.functional.one_hot(b[k], STARGAN_SMALL["c_dim"]).to(dtype)
                    for k in ("y_org", "y_trg"))
    alpha = torch.rand(2, 1, 1, 1, generator=torch.Generator().manual_seed(seed + 2),
                       dtype=torch.float64).to(device, dtype)
    loss, d_metrics = trainer.d_loss(b["x_real"], c_org, c_trg, alpha)
    loss.backward()
    out = {"d": ({k: v.item() for k, v in d_metrics.items()}, _grads({"D": trainer.D}, ("D",)))}
    trainer.D.requires_grad_(False)
    loss, g_metrics = trainer.g_loss(b["x_real"], c_org, c_trg)
    loss.backward()
    out["g"] = ({k: v.item() for k, v in g_metrics.items()}, _grads({"G": trainer.G}, ("G",)))
    return out


# the CycleGAN family's: 2-block generators, 8 wide, pool 4
CYCLEGAN_SMALL = dict(netG="resnet_2blocks", ngf=8, ndf=8, pool_size=4, steps_per_epoch=10)


def stub_flow(img1, img2):
    """A stand-in for RAFT with its signature (vst's, ``tests/test_cyclegan.py:
    160-163``): (None, the channel mean of img1 − img2 and its negation)."""
    d = (img1 - img2).mean(1, keepdim=True)
    return None, torch.cat([d, -d], 1)


def cyclegan_steps(variant: str, device, dtype: torch.dtype, seed: int = 0, raft=None,
                   hw=(32, 32)) -> Dict[str, Tuple[Dict[str, float], Dict[str, torch.Tensor],
                                                   Dict[str, torch.Tensor]]]:
    """One E step of ``variant`` (and, for MoGAN, one M step from the same
    start) at ``CYCLEGAN_SMALL`` on ``device`` in ``dtype``, from seed
    ``seed``'s weights, a synthetic batch of 2 at ``hw`` and draws made on
    the CPU: {"e" | "m": (losses, the updated nets' gradients, their
    parameters after the update; both float64 on the CPU, keyed
    ``net.param``)}, the order of :func:`stargan_steps` plus the parameters. MoGAN and
    ConGAN take ``raft`` (a RAFT on ``device``) or the stub flow."""
    temporal = variant in ("mogan", "congan")
    fc2 = [synthetic_fc2_batches(1, 2, hw=tuple(hw), num_dom=2, seed=seed + k)[0] for k in (1, 101)]
    batch = {k: v.to(dtype) for k, v in cyclegan_batch(fc2_to_cyclegan(*fc2), device).items()}
    g = torch.Generator().manual_seed(seed + 2)
    draws = tuple((torch.rand(2, generator=g).to(device),
                   torch.randint(0, CYCLEGAN_SMALL["pool_size"], (2,), generator=g).to(device))
                  for _ in range(2))
    out = {}
    for step in ("e", "m") if variant == "mogan" else ("e",):
        trainer = CycleGANTrainer(CycleGANConfig(variant=variant, **CYCLEGAN_SMALL),
                                  raft=(raft or stub_flow) if temporal else None, seed=seed,
                                  device=device)
        for net in trainer.nets.values():
            net.to(dtype)
        metrics = trainer.e_step(batch, draws) if step == "e" else trainer.m_step(batch)
        names = [k for g in (("G", "D") if step == "e" else ("M",)) for k in trainer.groups[g]]
        out[step] = ({k: v.item() for k, v in metrics.items()}, _grads(trainer.nets, names),
                     {f"{k}.{n}": p.detach().double().cpu() for k in names
                      for n, p in trainer.nets[k].named_parameters()})
    return out


def raft_train_inputs(hw=(64, 64), batch: int = 1, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded flow-training batch, vst's NHWC layout: image1 / image2
    (B, H, W, 3) in [0, 255], a ground-truth flow (B, H, W, 2) of a few
    pixels and a valid map (B, H, W) with a fifth of it 0; float32."""
    rng = np.random.RandomState(seed)
    f32 = np.float32
    return {"image1": (rng.rand(batch, *hw, 3) * 255).astype(f32),
            "image2": (rng.rand(batch, *hw, 3) * 255).astype(f32),
            "flow": (rng.randn(batch, *hw, 2) * 2).astype(f32),
            "valid": (rng.rand(batch, *hw) > 0.2).astype(f32)}


def raft_sequence_step(net, inputs: Dict[str, np.ndarray], device, dtype: torch.dtype,
                       gamma: float = 0.8) -> Tuple[float, Dict[str, torch.Tensor]]:
    """(loss, every parameter's gradient as float64 on the CPU, under each of
    its ``state_dict`` names) of ``flow_sequence_loss`` over a copy of
    ``net`` (a ``RAFT(train_mode=True)``) in ``dtype`` on ``device``, on
    :func:`raft_train_inputs`. A float64 net needs the lookup's plain
    version (``RAFT(lookup=lookup_pyramid)``)."""
    net = copy.deepcopy(net).to(device, dtype)
    x = {k: torch.from_numpy(v).to(device, dtype) for k, v in inputs.items()}
    nchw = lambda t: t.permute(0, 3, 1, 2).contiguous()  # noqa: E731
    _, preds = net(nchw(x["image1"]), nchw(x["image2"]))
    loss = flow_sequence_loss(preds, nchw(x["flow"]), x["valid"], gamma=gamma)
    loss.backward()
    grads = {name: p.grad.detach().to("cpu", torch.float64)
             for name, p in net.named_parameters(remove_duplicate=False)}
    return float(loss.detach()), grads


def max_loss_rel_err(got: Dict[str, float], want: Dict[str, float]) -> float:
    """The largest relative difference of two steps' losses (0 where both are 0)."""
    return max(abs(got[k] - w) / abs(w) if w else abs(got[k]) for k, w in want.items())


def grad_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                ) -> Tuple[float, float]:
    """(the worst per-parameter ‖got − want‖ / ‖want‖, the same over the
    whole gradient). Raises where ``want`` is 0 in exact arithmetic and
    ``got`` is not, or where a gradient is not finite."""
    if set(got) != set(want):
        raise ValueError(f"different parameters: {sorted(set(got) ^ set(want))}")
    total = sum(float(w.double().norm()) ** 2 for w in want.values()) ** 0.5
    worst, diff = 0.0, 0.0
    for name, w in want.items():
        g = got[name].double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient not finite")
        d, norm = float((g - w.double()).norm()), float(w.double().norm())
        diff += d ** 2
        if norm < ZERO_GRAD * total:
            if float(g.norm()) >= ZERO_GRAD * total:
                raise AssertionError(f"{name}: gradient 0 on one side only")
        else:
            worst = max(worst, d / norm)
    return worst, diff ** 0.5 / total


def param_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                 want_grads: Dict[str, torch.Tensor], lr: float) -> float:
    """The worst per-parameter ‖got − want‖ / ‖want‖ of two sets of
    parameters after one Adam step from the same start. A parameter whose
    gradient is 0 in exact arithmetic (below ``ZERO_GRAD`` of the whole on
    the reference side) moves by rounding noise over Adam's eps, up to lr an
    element on either side: for it no ratio is taken and |got − want| ≤ 2·lr
    an element is required."""
    if set(got) != set(want):
        raise ValueError(f"different parameters: {sorted(set(got) ^ set(want))}")
    total = sum(float(g.double().norm()) ** 2 for g in want_grads.values()) ** 0.5
    worst = 0.0
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: parameter not finite")
        if float(want_grads[name].double().norm()) < ZERO_GRAD * total:
            if float((g - w).abs().max()) > 2 * lr:
                raise AssertionError(f"{name}: a parameter of gradient 0 moved more than lr")
        else:
            worst = max(worst, float((g - w).norm() / w.norm()))
    return worst
