"""StarGAN v2 training (Adv and AdvCon), port of ``vst/train/stargan2.py``
(``StarGANv2Adv/core/solver.py:125-238``; AdvCon's temporal term,
``StarGANv2AdvCon/core/solver.py:385-451``).

One iteration, as vst's ``train_iteration``:

1. D step with a latent style (BCE adversarial loss, R1 on the reals);
2. D step with a reference style;
3. G step with a latent style: adversarial + λ_sty·style reconstruction
   − λ_ds·diversity (0: disabled in the thesis, ``solver.py:404-414``; λ_ds
   is kept and decayed all the same) + λ_cyc·cycle [+ λ_tcl·TCL, AdvCon];
   updates G, the mapping net F and the style encoder E;
4. G step with a reference style: the same loss, updates G only;
5. EMA of G, F and E (β = 0.999) and the λ_ds decay.

Optimizers are vst's ``optax.adamw``: ``torch.optim.AdamW`` (decoupled
weight decay 1e-4, β = (0, 0.99), eps 1e-8), lr 1e-4 and 1e-6 for F. The
reference's ``Adam(weight_decay=…)`` is L2 decay, another function.

R1 = 0.5·E‖∇ₓD(x)‖² on the reals, through a double backward; the fakes of
the D steps carry no gradient. AdvCon's TCL warps the fake with the
ground-truth flow (``vst_torch.ops.sample.warp``), not with RAFT.

``cfg.compute_dtype`` is vst's policy (``vst_torch.train.policy``): casts of
the parameters and inputs on entry to each loss, float32 masters, norms and
loss reductions. vst draws the latents z and z2 from ``jax.random``; the port
draws them from a seeded ``torch.Generator`` on the device, and
``train_iteration`` takes given ones too. z2 (the diversity term's) is drawn
and unused, as in vst.

Batches are dicts of NCHW tensors on the trainer's device: x_real, x_ref
(B, 3, H, W) in [−1, 1], y_org, y_trg (B,) long; AdvCon adds x_real2, mask
(B, 1, H, W) and flow (B, 2, H, W) (:func:`gan_batch`).

Data parallel (``mesh``): each rank steps on its shard with its share of
the global loss (every term, R1 included, a batch mean: the local loss over
the world size), the gradients of the updated nets summed over ranks in one
all-reduce before AdamW and the metrics after; the latents are drawn for the
global batch on every rank and sliced. The EMA follows the reduced step, so
it is the same on every rank.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from vst_torch.core.trace import count, span
from vst_torch.models.stargan2 import Discriminator, Generator, MappingNetwork, StyleEncoder
from vst_torch.ops.sample import warp
from vst_torch.parallel.mesh import (Mesh, all_reduce_gradients, all_reduce_metrics, local_rows,
                                     replicate, share_of_global, world_size)
from vst_torch.train.policy import call, cast_img, compute_dtype_of, f32

Tensors = Dict[str, torch.Tensor]
EMA_NETS = ("generator", "mapping", "style_enc")
# the reference CheckpointIO's names of the nets (core/solver.py:47-66)
REFERENCE_NAMES = {"generator": "generator", "mapping": "mapping_network",
                   "style_enc": "style_encoder", "disc": "discriminator"}
# an FC2 batch's keys (vst_torch.data.fc2.BATCH_KEYS) → the trainers'
FC2_TO_GAN = {"x_src": "x_real", "x2_src": "x_real2", "x_ref": "x_ref", "y_src": "y_org",
              "y_ref": "y_trg", "mask": "mask", "flow": "flow"}


@dataclasses.dataclass
class StarGAN2Config:
    img_size: int = 256
    style_dim: int = 64
    latent_dim: int = 16
    num_domains: int = 4
    w_hpf: int = 0
    lambda_reg: float = 1.0
    lambda_sty: float = 1.0
    lambda_ds: float = 1.0  # decayed to 0 over ds_iter; the loss itself is 0
    lambda_cyc: float = 1.0
    lambda_tcl: float = 0.0  # AdvCon: 100 (StarGANv2AdvCon/main.py:94)
    ds_iter: int = 100_000
    lr: float = 1e-4
    f_lr: float = 1e-6
    beta1: float = 0.0
    beta2: float = 0.99
    weight_decay: float = 1e-4
    ema_beta: float = 0.999
    max_conv_dim: int = 512
    compute_dtype: Optional[str] = None  # "bfloat16": vst's policy; None: float32


def adv_loss(logits: torch.Tensor, target: int) -> torch.Tensor:
    """BCE-with-logits against a constant target (``solver.py:459-463``), in
    float32 whatever the logits' dtype, in vst's stable form."""
    logits = f32(logits)
    return (logits.clamp_min(0) - logits * float(target)
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def gan_batch(batch, device) -> Tensors:
    """An FC2 batch (``vst_torch.data.fc2.BATCH_KEYS``: host NHWC numpy, or
    the device cache's NCHW tensors) → the trainers' dict on ``device``:
    images NCHW float32, labels long."""
    out = {}
    for k, name in FC2_TO_GAN.items():
        if k not in batch:
            continue
        v = batch[k]
        if not torch.is_tensor(v):
            v = np.asarray(v)
            v = torch.from_numpy(np.ascontiguousarray(v.transpose(0, 3, 1, 2) if v.ndim == 4
                                                      else v))
        out[name] = v.to(device, torch.long if name.startswith("y_") else torch.float32)
    return out


def _seeded(seed: int, build):
    """``build()`` with torch's CPU generator seeded, leaving the caller's
    random state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class StarGAN2Trainer:
    """Owns G, F, E, D, their EMA copies (G, F, E), the four AdamW
    optimizers, λ_ds and the latent generator. The nets are He-initialised
    from torch's generator seeded with ``seed`` (vst draws its own from
    ``PRNGKey(seed)``; the tests load one side's weights into the other).
    With a ``mesh``, on the mesh's device from rank 0's nets, stepping
    data-parallel."""

    def __init__(self, cfg: StarGAN2Config, seed: int = 0, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.dtype = compute_dtype_of(cfg.compute_dtype)
        nets = _seeded(seed, lambda: {
            "generator": Generator(cfg.img_size, cfg.style_dim, cfg.max_conv_dim, cfg.w_hpf),
            "mapping": MappingNetwork(cfg.latent_dim, cfg.style_dim, cfg.num_domains),
            "style_enc": StyleEncoder(cfg.img_size, cfg.style_dim, cfg.num_domains,
                                      cfg.max_conv_dim),
            "disc": Discriminator(cfg.img_size, cfg.num_domains, cfg.max_conv_dim)})
        self.nets = replicate({k: v.to(self.device) for k, v in nets.items()}, mesh)
        self.ema = {k: copy.deepcopy(self.nets[k]).requires_grad_(False) for k in EMA_NETS}
        self.opts = {k: torch.optim.AdamW(net.parameters(),
                                          lr=cfg.f_lr if k == "mapping" else cfg.lr,
                                          betas=(cfg.beta1, cfg.beta2), eps=1e-8,
                                          weight_decay=cfg.weight_decay)
                     for k, net in self.nets.items()}
        self.lambda_ds = torch.tensor(cfg.lambda_ds, dtype=torch.float32, device=self.device)
        self.step = 0
        self.latents = torch.Generator(device=self.device).manual_seed(seed)

    # -- the nets under the compute dtype ---------------------------------------

    def _net(self, name: str, *args):
        return call(self.nets[name], self.dtype, *args)

    def _style(self, kind: str, y, z=None, x_ref=None):
        if kind == "latent":
            return self._net("mapping", z, y)
        return self._net("style_enc", x_ref, y)

    # -- the losses ---------------------------------------------------------------

    def d_loss(self, kind: str, x_real, y_org, y_trg, z=None, x_ref=None):
        """(loss, metrics) of the D step (``solver.py:125-158``): real and fake
        BCE and R1 (``:465-475``) in float32; the gradient of the loss reaches
        D's parameters only."""
        cd = self.dtype
        x = cast_img(x_real, cd).detach().requires_grad_(True)
        out = self._net("disc", x, y_org)
        loss_real = adv_loss(out, 1)
        g, = torch.autograd.grad(f32(out).sum(), x, create_graph=True)
        g = f32(g)
        loss_reg = 0.5 * g.square().reshape(g.shape[0], -1).sum(1).mean()
        with torch.no_grad():
            s_trg = self._style(kind, y_trg, cast_img(z, cd), cast_img(x_ref, cd))
            x_fake = self._net("generator", x.detach(), s_trg)
        loss_fake = adv_loss(self._net("disc", x_fake, y_trg), 0)
        loss = loss_real + loss_fake + self.cfg.lambda_reg * loss_reg
        return loss, {"real": loss_real, "fake": loss_fake, "reg": loss_reg}

    def g_loss(self, kind: str, batch: Tensors):
        """(loss, metrics) of the G step (``solver.py:161-238``; AdvCon's TCL,
        ``StarGANv2AdvCon/core/solver.py:426-446``)."""
        cfg, cd = self.cfg, self.dtype
        b = {k: cast_img(v, cd) if not k.startswith("y_") else v for k, v in batch.items()}
        x_real, y_org, y_trg = b["x_real"], b["y_org"], b["y_trg"]
        s_trg = self._style(kind, y_trg, b.get("z"), b.get("x_ref"))
        x_fake = self._net("generator", x_real, s_trg)
        loss_adv = adv_loss(self._net("disc", x_fake, y_trg), 1)
        s_pred = self._net("style_enc", x_fake, y_trg)
        loss_sty = (f32(s_pred) - f32(s_trg)).abs().mean()
        loss_ds = torch.zeros((), dtype=loss_sty.dtype, device=loss_sty.device)
        s_org = self._net("style_enc", x_real, y_org)
        x_rec = self._net("generator", x_fake, s_org)
        loss_cyc = (f32(x_rec) - f32(x_real)).abs().mean()
        loss = (loss_adv + cfg.lambda_sty * loss_sty - self.lambda_ds * loss_ds
                + cfg.lambda_cyc * loss_cyc)
        metrics = {"adv": loss_adv, "sty": loss_sty, "ds": loss_ds, "cyc": loss_cyc}
        if cfg.lambda_tcl > 0:
            x_fake2 = self._net("generator", b["x_real2"], s_trg)
            x_warp = warp(x_fake, b["flow"])
            loss_tcl = (f32(b["mask"]) * (f32(x_fake2) - f32(x_warp))).square().mean()
            loss = loss + cfg.lambda_tcl * loss_tcl
            metrics["tcl"] = loss_tcl
        return loss, metrics

    # -- the steps ----------------------------------------------------------------

    def _update(self, names, loss) -> None:
        with span("vst.train.optimizer"):
            for k in names:
                self.opts[k].zero_grad(set_to_none=True)
        with span("vst.train.backward"):
            loss.backward()
        with span("vst.train.optimizer"):
            all_reduce_gradients([self.opts[k] for k in names], self.mesh)
            for k in names:
                self.opts[k].step()

    def d_step(self, kind: str, x_real, y_org, y_trg, z=None, x_ref=None) -> Tensors:
        """One D update; the metrics, detached (no host synchronisation)."""
        with span("vst.train.d_loss"):
            loss, metrics = share_of_global(*self.d_loss(kind, x_real, y_org, y_trg, z, x_ref),
                                            self.mesh)
        self._update(("disc",), loss)
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    def g_step(self, kind: str, update_fe: bool, batch: Tensors) -> Tensors:
        """One G update: G, F and E with ``update_fe`` (the latent step,
        ``solver.py:179-183``), G alone without (the reference step,
        ``:184-187``). The other nets take no parameter gradient."""
        names = EMA_NETS if update_fe else ("generator",)
        frozen = [net for k, net in self.nets.items() if k not in names]
        for net in frozen:
            net.requires_grad_(False)
        try:
            with span("vst.train.g_loss"):
                loss, metrics = share_of_global(*self.g_loss(kind, batch), self.mesh)
            self._update(names, loss)
        finally:
            for net in frozen:
                net.requires_grad_(True)
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    @torch.no_grad()
    def ema_step(self) -> None:
        """ema = p + β·(ema − p) for G, F, E (the reference's
        ``torch.lerp(param, param_test, β)``), λ_ds −= λ_ds⁰ / ds_iter down to
        0, and the step count."""
        beta = self.cfg.ema_beta
        for k in EMA_NETS:
            for e, p in zip(self.ema[k].parameters(), self.nets[k].parameters()):
                e.sub_(p).mul_(beta).add_(p)
        self.lambda_ds = (self.lambda_ds - self.cfg.lambda_ds / self.cfg.ds_iter).clamp_min(0.0)
        self.step += 1

    def draw_latents(self, batch_size: int):
        """(z, z2), each (B, latent_dim) standard normal, from the trainer's
        generator."""
        return tuple(torch.randn(batch_size, self.cfg.latent_dim, generator=self.latents,
                                 device=self.device) for _ in range(2))

    def train_iteration(self, batch: Tensors, z=None, z2=None) -> Tensors:
        """One reference iteration: d(latent), d(ref), g(latent; G, F, E),
        g(ref; G), EMA and decay. ``z`` / ``z2`` drawn when not given.
        Returns the metrics under vst's names, detached. With a mesh, the
        latents are the global batch's draws, this rank's rows. While a
        profiler runs, the iteration records the spans ``vst.train.*`` and
        counts ``vst.train.iterations`` (``vst_torch.core.trace``)."""
        with span("vst.train.iteration"):
            if z is None:
                n = batch["x_real"].shape[0] * world_size(self.mesh)
                z, z2 = (local_rows(t, self.mesh) for t in self.draw_latents(n))
            args = (batch["x_real"], batch["y_org"], batch["y_trg"], z, batch["x_ref"])
            d_lat = self.d_step("latent", *args)
            d_ref = self.d_step("ref", *args)
            g_batch = {**batch, "z": z}
            g_lat = self.g_step("latent", True, g_batch)
            g_ref = self.g_step("ref", False, g_batch)
            with span("vst.train.ema"):
                self.ema_step()
            count("vst.train.iterations")
        return {**{f"D/latent_{k}": v for k, v in d_lat.items()},
                **{f"D/ref_{k}": v for k, v in d_ref.items()},
                **{f"G/latent_{k}": v for k, v in g_lat.items()},
                **{f"G/ref_{k}": v for k, v in g_ref.items()}}

    # -- inference and checkpoints --------------------------------------------------

    def _nets(self, use_ema: bool):
        return self.ema if use_ema else self.nets

    def generate_fn(self, use_ema: bool = True):
        """(x, s) → G(x, s), the EMA generator by default, without gradients."""
        g = self._nets(use_ema)["generator"]
        return torch.no_grad()(lambda x, s: g(x, s))

    def mapping_fn(self, use_ema: bool = True):
        """(z, y) → F(z, y), the EMA mapping net by default."""
        f = self._nets(use_ema)["mapping"]
        return torch.no_grad()(lambda z, y: f(z, y))

    def state_dicts(self, use_ema: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
        """The nets' state_dicts under the reference CheckpointIO's names
        (``generator``, ``mapping_network``, ``style_encoder`` and, for the
        live nets, ``discriminator``)."""
        return {REFERENCE_NAMES[k]: net.state_dict() for k, net in self._nets(use_ema).items()}


def nets_from_state_dicts(cfg: StarGAN2Config, sds: Dict[str, Dict[str, torch.Tensor]],
                          device) -> Dict[str, torch.nn.Module]:
    """G, F and E (and D where ``sds`` has it) from a checkpoint of
    :meth:`StarGAN2Trainer.state_dicts`, on ``device``, in eval mode."""
    build = {"generator": lambda: Generator(cfg.img_size, cfg.style_dim, cfg.max_conv_dim),
             "mapping": lambda: MappingNetwork(cfg.latent_dim, cfg.style_dim, cfg.num_domains),
             "style_enc": lambda: StyleEncoder(cfg.img_size, cfg.style_dim, cfg.num_domains,
                                               cfg.max_conv_dim),
             "disc": lambda: Discriminator(cfg.img_size, cfg.num_domains, cfg.max_conv_dim)}
    nets = {}
    for k, make in build.items():
        if REFERENCE_NAMES[k] in sds:
            net = make()
            net.load_state_dict(sds[REFERENCE_NAMES[k]])
            nets[k] = net.to(device).eval()
    return nets
