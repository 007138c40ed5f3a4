"""StarGAN v1 training, port of ``vst/train/stargan.py``
(``StarGAN/solver.py:241-412``).

WGAN adversarial losses (−E[D(real)] + E[D(fake)]), a multi-label BCE
domain classification summed over labels and averaged over the batch
(CelebA mode, ``solver.py:241-246``, ``PARITY.md:49``), the WGAN gradient
penalty on interpolates (λ_gp = 10, ``:187-199``, with vst's 1e-24 floor
under the root), reconstruction L1 (λ_rec = 10). D steps every iteration, G
every ``n_critic``-th (the caller's loop, as vst's CLI). Adam(β = (0.5,
0.999)) at vst's schedule: constant, then lr0 / num_iters_decay less every
1000 updates over the last ``num_iters_decay``. As optax's, the schedule
counts each optimizer's own updates, so G's count moves once every
``n_critic`` iterations.

The penalty's α is drawn from a seeded ``torch.Generator`` on the device
(vst draws it from the step's PRNG key); ``d_step`` takes a given α too.
Labels are (B, c_dim) float tensors, one-hot or soft; images NCHW in
[−1, 1].

Data parallel (``mesh``): each rank steps on its shard with its share of
the global loss (every term a batch mean, so the local loss over the world
size), the gradients summed over ranks before Adam and the metrics after;
α is drawn for the global batch on every rank and sliced, as vst's key does
not depend on the sharding.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from vst_torch.models.stargan import Discriminator, Generator
from vst_torch.parallel.mesh import (Mesh, all_reduce_gradients, all_reduce_metrics, local_rows,
                                     replicate, share_of_global, world_size)

Tensors = Dict[str, torch.Tensor]


def stargan_lr_schedule(lr0: float, num_iters: int = 200_000, num_iters_decay: int = 100_000,
                        lr_update_step: int = 1000) -> Callable[[int], float]:
    """``solver.py:404-409``: from update ``num_iters − num_iters_decay`` on,
    every ``lr_update_step`` updates take lr0 / num_iters_decay ·
    lr_update_step off, down to 0. ``schedule(count)`` is the rate of the
    update that follows ``count`` earlier ones."""

    def schedule(count: int) -> float:
        decayed = max(0, (count + 1 - (num_iters - num_iters_decay)) // lr_update_step)
        return max(lr0 - decayed * (lr0 / num_iters_decay) * lr_update_step, 0.0)

    return schedule


@dataclasses.dataclass
class StarGANConfig:
    c_dim: int = 4
    image_size: int = 128
    conv_dim: int = 64
    repeat_num: int = 6
    d_repeat_num: int = 6  # the CLI caps it at log2(image_size) − 1
    lambda_cls: float = 1.0
    lambda_rec: float = 10.0
    lambda_gp: float = 10.0
    n_critic: int = 5
    g_lr: float = 1e-4
    d_lr: float = 1e-4
    beta1: float = 0.5
    beta2: float = 0.999
    num_iters: int = 200_000
    num_iters_decay: int = 100_000


def classification_loss_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """BCE-with-logits summed over every label and divided by the batch
    (``solver.py:241-246``), in vst's stable form."""
    per = logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return per.sum() / logits.shape[0]


class StarGANTrainer:
    """Owns G, D, their Adam optimizers and schedules, and the penalty's α
    generator. G and D are initialised from torch's generator seeded with
    ``seed`` (G first, then D). With a ``mesh``, on the mesh's device from
    rank 0's nets, stepping data-parallel."""

    def __init__(self, cfg: StarGANConfig, seed: int = 0, device="cuda",
                 mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            self.G = Generator(cfg.conv_dim, cfg.c_dim, cfg.repeat_num).to(self.device)
            self.D = Discriminator(cfg.image_size, cfg.conv_dim, cfg.c_dim,
                                   cfg.d_repeat_num).to(self.device)
        replicate([self.G, self.D], mesh)
        self.schedules = {
            "G": stargan_lr_schedule(cfg.g_lr, cfg.num_iters, cfg.num_iters_decay),
            "D": stargan_lr_schedule(cfg.d_lr, cfg.num_iters, cfg.num_iters_decay)}
        self.opts = {k: torch.optim.Adam(net.parameters(), lr=self.schedules[k](0),
                                         betas=(cfg.beta1, cfg.beta2), eps=1e-8)
                     for k, net in (("G", self.G), ("D", self.D))}
        self.counts = {"G": 0, "D": 0}  # each optimizer's own updates
        self.step = 0  # D steps, vst's state.step
        self.alphas = torch.Generator(device=self.device).manual_seed(seed)

    def gradient_penalty(self, x_hat: torch.Tensor) -> torch.Tensor:
        """(‖∇ₓ Σ out_src(x̂)‖₂ − 1)² averaged over the batch
        (``solver.py:187-199``); the root's argument floored at 1e-24 (vst's
        guard for an input gradient of exactly 0; values unchanged)."""
        x_hat = x_hat.detach().requires_grad_(True)
        g, = torch.autograd.grad(self.D(x_hat)[0].sum(), x_hat, create_graph=True)
        norm = g.reshape(g.shape[0], -1).square().sum(1).clamp_min(1e-24).sqrt()
        return (norm - 1.0).square().mean()

    def d_loss(self, x_real, c_org, c_trg, alpha=None):
        """(loss, metrics) of the D step; α (B, 1, 1, 1) drawn when None."""
        cfg = self.cfg
        out_src, out_cls = self.D(x_real)
        d_loss_real = -out_src.mean()
        d_loss_cls = classification_loss_bce(out_cls, c_org)
        with torch.no_grad():
            x_fake = self.G(x_real, c_trg)
        d_loss_fake = self.D(x_fake)[0].mean()
        if alpha is None:  # the global batch's draws, this rank's rows
            n = x_real.shape[0] * world_size(self.mesh)
            alpha = local_rows(torch.rand((n, 1, 1, 1), generator=self.alphas,
                                          device=self.device, dtype=x_real.dtype), self.mesh)
        d_loss_gp = self.gradient_penalty(alpha * x_real + (1 - alpha) * x_fake)
        loss = (d_loss_real + d_loss_fake + cfg.lambda_cls * d_loss_cls
                + cfg.lambda_gp * d_loss_gp)
        return loss, {"D/loss_real": d_loss_real, "D/loss_fake": d_loss_fake,
                      "D/loss_cls": d_loss_cls, "D/loss_gp": d_loss_gp}

    def g_loss(self, x_real, c_org, c_trg):
        """(loss, metrics) of the G step (``solver.py:290-318``)."""
        cfg = self.cfg
        x_fake = self.G(x_real, c_trg)
        out_src, out_cls = self.D(x_fake)
        g_loss_fake = -out_src.mean()
        g_loss_cls = classification_loss_bce(out_cls, c_trg)
        g_loss_rec = (x_real - self.G(x_fake, c_org)).abs().mean()
        loss = g_loss_fake + cfg.lambda_rec * g_loss_rec + cfg.lambda_cls * g_loss_cls
        return loss, {"G/loss_fake": g_loss_fake, "G/loss_rec": g_loss_rec,
                      "G/loss_cls": g_loss_cls}

    def _update(self, name: str, loss: torch.Tensor) -> None:
        opt = self.opts[name]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_gradients([opt], self.mesh)
        for group in opt.param_groups:
            group["lr"] = self.schedules[name](self.counts[name])
        opt.step()
        self.counts[name] += 1

    def d_step(self, x_real, c_org, c_trg, alpha=None) -> Tensors:
        """One D update; the metrics, detached."""
        loss, metrics = share_of_global(*self.d_loss(x_real, c_org, c_trg, alpha), self.mesh)
        self._update("D", loss)
        self.step += 1
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    def g_step(self, x_real, c_org, c_trg) -> Tensors:
        """One G update (D takes no parameter gradient); the metrics, detached."""
        self.D.requires_grad_(False)
        try:
            loss, metrics = share_of_global(*self.g_loss(x_real, c_org, c_trg), self.mesh)
            self._update("G", loss)
        finally:
            self.D.requires_grad_(True)
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    def train_iteration(self, i: int, x_real, c_org, c_trg, alpha=None) -> Tensors:
        """Iteration ``i`` (0-based) of vst's loop (``vst/cli/__main__.py:
        256-264``): a D step, and a G step when (i + 1) % n_critic == 0."""
        metrics = self.d_step(x_real, c_org, c_trg, alpha)
        if (i + 1) % self.cfg.n_critic == 0:
            metrics.update(self.g_step(x_real, c_org, c_trg))
        return metrics

    def generate_fn(self):
        """(x, c) → G(x, c), without gradients."""
        return torch.no_grad()(lambda x, c: self.G(x, c))
