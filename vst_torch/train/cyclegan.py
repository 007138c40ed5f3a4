"""CycleGAN-family training, port of ``vst/train/cyclegan.py``
(``CycleGAN/models/cycle_gan_model.py:235-252``).

One E step, as vst's ``train_step``:

1. the fakes fake_B = G_A(real_A), fake_A = G_B(real_B) (and the
   variant's others) from the pre-update G;
2. the G step: the variant's loss against the pre-update D, gradients for G
   (and ConGAN's fusion nets F) only, D frozen as junyanz's
   ``set_requires_grad``;
3. the fakes, detached and in float32, through the two ImagePools (pool A
   holds fakes A, pool B fakes B);
4. the D step: D_A scores real_B against pooled fakes B, D_B real_A
   against pooled fakes A, each ½(real + fake) of ``gan_loss``.

Variants (every λ as ``CycleGANConfig``):

* ``cyclegan``: idt, GAN and cycle losses (``cycle_gan_model.py:205-233``);
* ``cyclegan_con``: + G_T, λ_T·mean((mask·(G_A(A2) − warp(fake_B, flow)))²)
  with the ground-truth flow (CycleGANCon ``:190-204``);
* ``congan``: four RAFT flows, the fusion blocks, the scalar soft mask
  exp(−50·mean|A2 − warp(A, bf)|), c3D_A/B, TCL_A, and TCL_B fixed at 0
  (ConGAN ``:160-308``);
* ``mogan``: the motion translators M_A, M_B (2-channel generators) make
  the E step's warping flow from RAFT's; MC (motion cycle on the rec
  pairs' flows) and MT (motion translation) under the fb mask. The M step
  (AM: |M(bf_real) − bf_fake|) trains M_A and M_B only; E and M steps
  alternate, E on even iterations (MoGAN ``:160-335``).

Every RAFT call runs without gradients (vst's ``stop_gradient``; the
reference's ``torch.no_grad()``), pads to multiples of 8 with InputPadder
and feeds the [−1, 1] frames straight in (the kept quirk), in float32. A
MoGAN E step makes 6 RAFT calls: vst's trace computes bf_A and bf_B twice
(for the M nets and for the loss), the port once. Under the bfloat16 policy
the two differ, as in vst: the M nets read the flows of the float32 frames,
the loss those of the frames cast to bfloat16, so such an E step makes 8.
An M step makes 4, a ConGAN E step 4.

Optimizers: Adam(β = (0.5, 0.999), eps 1e-8) over G_A, G_B (and F_A,
F_B), over D_A, D_B, and over M_A, M_B; the rate is junyanz's 'linear'
policy at each optimizer's own count of updates, as optax's, set before
each update. ``cfg.compute_dtype`` is vst's policy
(``vst_torch.train.policy``): the parameters (once a loss, as vst's
``cast_tree``) and the ``real_*`` images are cast on entry to the G and D
losses; mask, flow and the motion flows are
not; ``gan_loss`` upcasts, the L1 means stay in the compute dtype. The M
nets and the M step run in float32. The pools' draws come from a seeded
``torch.Generator`` on the device; ``e_step`` takes given ones too.

Batches are dicts of NCHW tensors on the trainer's device: real_A, real_B
(B, 3, H, W) in [−1, 1]; the temporal variants add real_A2, real_B2, and
cyclegan_con mask (B, 1, H, W) and flow (B, 2, H, W) (:func:`cyclegan_batch`).

Data parallel (``mesh``): each rank steps on its shard with its share of
the global loss (every term a batch mean: the local loss over the world
size), the gradients summed over ranks before Adam and the metrics after.
vst's pools are global: the fakes are all-gathered, every rank queries the
same pools with the global batch's draws (so every rank holds the same
pools) and keeps its rows of the answer. ConGAN's soft mask is a mean over
the global batch. RAFT runs on the rank's shard.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from vst_torch.models.cyclegan import (FusionBlock, define_D, define_G, gan_loss,
                                       image_pool_init, image_pool_query)
from vst_torch.ops.flowtools import fbc_mask
from vst_torch.ops.image import InputPadder
from vst_torch.ops.sample import warp
from vst_torch.parallel.mesh import (Mesh, all_gather_rows, all_reduce_gradients,
                                     all_reduce_metrics, global_mean, local_rows, replicate,
                                     share_of_global)
from vst_torch.train.policy import caller, cast_img, compute_dtype_of, f32

Tensors = Dict[str, torch.Tensor]
VARIANTS = ("cyclegan", "cyclegan_con", "mogan", "congan")
# (u, idx) of each pool's query: pool A's, then pool B's
Draws = Tuple[Tuple[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


def linear_lr_schedule(lr0: float, steps_per_epoch: int, n_epochs: int = 100,
                       n_epochs_decay: int = 100) -> Callable[[int], float]:
    """junyanz's 'linear' policy (``networks.py:38-54``): flat for
    ``n_epochs`` epochs, then linear decay to 0 over ``n_epochs_decay``,
    stepped per epoch of ``steps_per_epoch`` updates. ``schedule(count)`` is
    the rate of the update that follows ``count`` earlier ones."""

    def schedule(count: int) -> float:
        epoch = count // steps_per_epoch
        factor = 1.0 - max(0.0, epoch + 1.0 - n_epochs) / (n_epochs_decay + 1.0)
        return lr0 * min(max(factor, 0.0), 1.0)

    return schedule


@dataclasses.dataclass
class CycleGANConfig:
    variant: str = "cyclegan"  # cyclegan | cyclegan_con | mogan | congan
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5
    lambda_T: float = 10.0    # con temporal
    lambda_MC: float = 10.0   # mogan motion cycle
    lambda_MT: float = 10.0   # mogan motion translation
    lambda_AM: float = 1.0    # mogan auxiliary motion
    lambda_TCL: float = 10.0  # congan fused temporal (A side only)
    lambda_c3D: float = 10.0  # congan cross-frame 3D cycle
    gan_mode: str = "lsgan"
    lr: float = 2e-4
    beta1: float = 0.5
    pool_size: int = 50
    steps_per_epoch: int = 1000
    n_epochs: int = 100
    n_epochs_decay: int = 100
    netG: str = "resnet_9blocks"
    netD: str = "basic"
    ngf: int = 64
    ndf: int = 64
    compute_dtype: Optional[str] = None  # None: float32, the reference's policy


def cyclegan_batch(batch, device) -> Tensors:
    """A CycleGAN batch (host NHWC numpy, or the device cache's NCHW
    tensors) → NCHW float32 tensors on ``device``."""
    out = {}
    for k, v in batch.items():
        if not torch.is_tensor(v):
            v = torch.from_numpy(np.ascontiguousarray(np.asarray(v).transpose(0, 3, 1, 2)))
        out[k] = v.to(device, torch.float32)
    return out


def fc2_to_cyclegan(a, b=None) -> Dict:
    """Synthetic FC2 batches as a CycleGAN batch: side A ``a``'s source pair
    with its mask and flow; side B ``b``'s source pair or, without ``b``,
    ``a``'s reference image for both frames (vst's CLI,
    ``vst/cli/__main__.py:177-185``)."""
    real_B, real_B2 = (a["x_ref"], a["x_ref"]) if b is None else (b["x_src"], b["x2_src"])
    return {"real_A": a["x_src"], "real_A2": a["x2_src"], "real_B": real_B, "real_B2": real_B2,
            "mask": a["mask"], "flow": a["flow"]}


class CycleGANTrainer:
    """Owns the nets (``nets``: G_A, G_B, D_A, D_B, and M_A, M_B or F_A,
    F_B), their optimizers, schedules and update counts, the two pools and
    their draws' generator. Nets are initialised from torch's generator
    seeded with ``seed``, in that order, on the CPU and then moved.
    ``raft(img1, img2) → (flow_low, flow_up)`` is the bound RAFT of MoGAN
    and ConGAN (or a stand-in with its signature). With a ``mesh``, on the
    mesh's device from rank 0's nets, stepping data-parallel."""

    def __init__(self, cfg: CycleGANConfig, raft: Optional[Callable] = None, seed: int = 0,
                 device="cuda", mesh: Optional[Mesh] = None):
        if cfg.variant not in VARIANTS:
            raise ValueError(f"unknown variant {cfg.variant!r}")
        if cfg.variant in ("mogan", "congan") and raft is None:
            raise ValueError(f"{cfg.variant} needs a bound RAFT")
        self.cfg = cfg
        self.cd = compute_dtype_of(cfg.compute_dtype)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        self.raft = raft
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            nets = {"G_A": define_G(cfg.netG, 3, cfg.ngf), "G_B": define_G(cfg.netG, 3, cfg.ngf),
                    "D_A": define_D(cfg.netD, cfg.ndf), "D_B": define_D(cfg.netD, cfg.ndf)}
            if cfg.variant == "mogan":  # 2-channel motion translators (MoGAN :95-99)
                nets.update(M_A=define_G(cfg.netG, 2, cfg.ngf), M_B=define_G(cfg.netG, 2, cfg.ngf))
            if cfg.variant == "congan":
                nets.update(F_A=FusionBlock(), F_B=FusionBlock())
        self.nets = replicate({k: net.to(self.device) for k, net in nets.items()}, mesh)
        # ConGAN's fusion nets step with G off the same backward (ConGAN :313-316)
        groups = {"G": ("G_A", "G_B", "F_A", "F_B"), "D": ("D_A", "D_B"), "M": ("M_A", "M_B")}
        self.groups = {g: tuple(k for k in names if k in self.nets) for g, names in groups.items()}
        self.groups = {g: names for g, names in self.groups.items() if names}
        self.schedule = linear_lr_schedule(cfg.lr, cfg.steps_per_epoch, cfg.n_epochs,
                                           cfg.n_epochs_decay)
        self.opts = {g: torch.optim.Adam([p for k in names for p in self.nets[k].parameters()],
                                         lr=self.schedule(0), betas=(cfg.beta1, 0.999), eps=1e-8)
                     for g, names in self.groups.items()}
        self.counts = {g: 0 for g in self.opts}  # each optimizer's own updates
        self.step = 0  # E and M steps, vst's state.step
        self.pools = {"A": None, "B": None}
        self.draws = torch.Generator(device=self.device).manual_seed(seed)

    # -- pieces -------------------------------------------------------------------

    @torch.no_grad()
    def compute_raft(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """MoGAN's computeRAFT: the backward-style flow img1 → img2 of RAFT
        on float32 copies padded to multiples of 8, [−1, 1] frames fed
        straight in; no gradient."""
        padder = InputPadder(img1.shape)
        i1, i2 = padder.pad(f32(img1.detach()), f32(img2.detach()))
        _, up = self.raft(i1, i2)
        return padder.unpad(up)

    @torch.no_grad()
    def motion_aux(self, batch: Tensors) -> Tensors:
        """MoGAN's E-step inputs from the frozen M nets (float32): RAFT's
        bf_A, bf_B of the float32 frames and M_A(bf_A), M_B(bf_B)."""
        bf_A = self.compute_raft(batch["real_A2"], batch["real_A"])
        bf_B = self.compute_raft(batch["real_B2"], batch["real_B"])
        return {"bf_A": bf_A, "bf_B": bf_B,
                "bf_M_A": self.nets["M_A"](bf_A), "bf_M_B": self.nets["M_B"](bf_B)}

    def g_loss(self, batch: Tensors, aux: Optional[Tensors] = None):
        """(total, losses, fake_A, fake_B) of the G step (vst's ``_g_loss``)."""
        cfg = self.cfg
        b = {k: cast_img(v, self.cd) if k.startswith("real") else v for k, v in batch.items()}
        G = caller(self.nets, self.groups["G"] + self.groups["D"], self.cd)
        real_A, real_B = b["real_A"], b["real_B"]
        fake_B = G("G_A", real_A)
        rec_A = G("G_B", fake_B)
        fake_A = G("G_B", real_B)
        rec_B = G("G_A", fake_A)

        losses = {}
        if cfg.lambda_identity > 0:
            idt_A = G("G_A", real_B)
            idt_B = G("G_B", real_A)
            losses["idt_A"] = (idt_A - real_B).abs().mean() * cfg.lambda_B * cfg.lambda_identity
            losses["idt_B"] = (idt_B - real_A).abs().mean() * cfg.lambda_A * cfg.lambda_identity
        else:
            losses["idt_A"] = losses["idt_B"] = torch.zeros((), device=real_A.device)
        losses["G_A"] = gan_loss(G("D_A", fake_B), True, cfg.gan_mode)
        losses["G_B"] = gan_loss(G("D_B", fake_A), True, cfg.gan_mode)
        losses["cycle_A"] = (rec_A - real_A).abs().mean() * cfg.lambda_A
        losses["cycle_B"] = (rec_B - real_B).abs().mean() * cfg.lambda_B
        total = sum(losses.values())

        if cfg.variant == "cyclegan_con":
            fake_B2 = G("G_A", b["real_A2"])
            losses["G_T"] = (b["mask"] * (fake_B2 - warp(fake_B, b["flow"]))).square().mean() \
                * cfg.lambda_T
            total = total + losses["G_T"]

        if cfg.variant == "congan":
            real_A2, real_B2 = b["real_A2"], b["real_B2"]
            fake_B2 = G("G_A", real_A2)
            fake_A2 = G("G_B", real_B2)

            bf_real_A = self.compute_raft(real_A2, real_A)
            warp_B = warp(fake_B, bf_real_A)
            fuse_B = G("F_A", fake_B2, warp_B)
            mask_A = torch.exp(-50.0 * global_mean((real_A2 - warp(real_A, bf_real_A)).abs(),
                                                   self.mesh))
            bf_fake_B = self.compute_raft(fuse_B, fake_B)
            rec3D_A2 = G("F_B", G("G_B", fuse_B), warp(fake_B, bf_fake_B))

            bf_real_B = self.compute_raft(real_B2, real_B)
            warp_A = warp(fake_A, bf_real_B)
            fuse_A = G("F_B", fake_A2, warp_A)
            bf_fake_A = self.compute_raft(fuse_A, fake_A)
            rec3D_B2 = G("F_A", G("G_A", fuse_A), warp(fake_A, bf_fake_A))

            losses["c3D_A"] = (rec3D_A2 - real_A2).abs().mean() * cfg.lambda_c3D
            losses["c3D_B"] = (rec3D_B2 - real_B2).abs().mean() * cfg.lambda_c3D
            losses["TCL_A"] = (mask_A * (fuse_B - warp_B).abs()).mean() * cfg.lambda_TCL
            losses["TCL_B"] = torch.zeros((), device=real_A.device)  # off in the reference (:299)
            total = total + losses["c3D_A"] + losses["c3D_B"] + losses["TCL_A"]

        if cfg.variant == "mogan":
            real_A2, real_B2 = b["real_A2"], b["real_B2"]
            fake_B2 = G("G_A", real_A2)
            rec_A2 = G("G_B", fake_B2)
            fake_A2 = G("G_B", real_B2)
            rec_B2 = G("G_A", fake_A2)
            # every flow is detached (computeRAFT under no_grad, MoGAN :131-137),
            # the rec pairs' too: MC carries no generator gradient, as in vst
            # the flows of the frames as the loss sees them: under a compute
            # dtype, not the M nets' (vst's loss recomputes them, :280, 287)
            bf_A, bf_B = ((aux["bf_A"], aux["bf_B"]) if self.cd is None else
                          (self.compute_raft(real_A2, real_A), self.compute_raft(real_B2, real_B)))
            ff_A = self.compute_raft(real_A, real_A2)
            bf_rec_A = self.compute_raft(rec_A2, rec_A)
            mask_A = fbc_mask(ff_A, bf_A)
            warp_B = warp(fake_B, aux["bf_M_A"])
            ff_B = self.compute_raft(real_B, real_B2)
            bf_rec_B = self.compute_raft(rec_B2, rec_B)
            mask_B = fbc_mask(ff_B, bf_B)
            warp_A = warp(fake_A, aux["bf_M_B"])

            losses["MC_A"] = (mask_A * (bf_rec_A - bf_A).abs()).mean() * cfg.lambda_MC
            losses["MC_B"] = (mask_B * (bf_rec_B - bf_B).abs()).mean() * cfg.lambda_MC
            losses["MT_A"] = (mask_A * (warp_B - fake_B2).abs()).mean() * cfg.lambda_MT
            losses["MT_B"] = (mask_B * (warp_A - fake_A2).abs()).mean() * cfg.lambda_MT
            total = total + losses["MC_A"] + losses["MC_B"] + losses["MT_A"] + losses["MT_B"]

        losses["G"] = total
        return total, losses, fake_A, fake_B

    def d_loss(self, batch: Tensors, fake_A: torch.Tensor, fake_B: torch.Tensor):
        """(total, losses) of the D step (vst's ``_d_loss``) on pooled fakes."""
        cfg = self.cfg
        D = caller(self.nets, self.groups["D"], self.cd)

        def d_basic(name, real, fake):
            pred_real = D(name, cast_img(real, self.cd))
            pred_fake = D(name, cast_img(fake.detach(), self.cd))
            return 0.5 * (gan_loss(pred_real, True, cfg.gan_mode)
                          + gan_loss(pred_fake, False, cfg.gan_mode))

        loss_D_A = d_basic("D_A", batch["real_B"], fake_B)
        loss_D_B = d_basic("D_B", batch["real_A"], fake_A)
        return loss_D_A + loss_D_B, {"D_A": loss_D_A, "D_B": loss_D_B}

    def m_loss(self, batch: Tensors):
        """(total, losses) of MoGAN's M step (vst's ``m_step``, float32)."""
        G = self.nets
        with torch.no_grad():
            fake_B = G["G_A"](batch["real_A"])
            fake_B2 = G["G_A"](batch["real_A2"])
            fake_A = G["G_B"](batch["real_B"])
            fake_A2 = G["G_B"](batch["real_B2"])
        bf_A = self.compute_raft(batch["real_A2"], batch["real_A"])
        bf_B = self.compute_raft(batch["real_B2"], batch["real_B"])
        bf_fake_B = self.compute_raft(fake_B2, fake_B)
        bf_fake_A = self.compute_raft(fake_A2, fake_A)
        am_A = (G["M_A"](bf_A) - bf_fake_B).abs().mean() * self.cfg.lambda_AM
        am_B = (G["M_B"](bf_B) - bf_fake_A).abs().mean() * self.cfg.lambda_AM
        return am_A + am_B, {"AM_A": am_A, "AM_B": am_B}

    def _update(self, group: str, loss: torch.Tensor) -> None:
        opt = self.opts[group]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        all_reduce_gradients([opt], self.mesh)
        for pg in opt.param_groups:
            pg["lr"] = self.schedule(self.counts[group])
        opt.step()
        self.counts[group] += 1

    def _frozen_except(self, group: str):
        """Nets outside ``group`` take no gradient (junyanz's
        ``set_requires_grad``); restore with ``_unfreeze``."""
        for k, net in self.nets.items():
            net.requires_grad_(k in self.groups[group])

    def _unfreeze(self) -> None:
        for net in self.nets.values():
            net.requires_grad_(True)

    # -- the steps -------------------------------------------------------------------

    def g_step(self, batch: Tensors, aux: Optional[Tensors] = None):
        """One G (and F) update against the frozen D: (metrics, detached
        float32 fakes (fake_A, fake_B))."""
        self._frozen_except("G")
        try:
            loss, metrics, fake_A, fake_B = self.g_loss(batch, aux)
            loss, metrics = share_of_global(loss, metrics, self.mesh)
            self._update("G", loss)
        finally:
            self._unfreeze()
        return (all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh),
                (f32(fake_A.detach()), f32(fake_B.detach())))

    def draw(self, n: int) -> Draws:
        """Each pool's (u, idx) for a batch of ``n`` from the trainer's generator."""
        size = max(self.cfg.pool_size, 1)
        return tuple((torch.rand(n, generator=self.draws, device=self.device),
                      torch.randint(0, size, (n,), generator=self.draws, device=self.device))
                     for _ in range(2))

    def query_pools(self, fakes: Sequence[torch.Tensor], draws: Optional[Draws] = None):
        """(fake_A, fake_B) through pools A and B (made at the first query
        with the fakes' shape and dtype). With a mesh the pools hold the
        global batch's fakes and ``draws`` are the global batch's; each
        rank returns its rows."""
        fakes = [all_gather_rows(f, self.mesh) for f in fakes]
        draws = self.draw(fakes[0].shape[0]) if draws is None else draws
        out = []
        for side, fake, (u, idx) in zip("AB", fakes, draws):
            if self.pools[side] is None:
                self.pools[side] = image_pool_init(self.cfg.pool_size, fake.shape[1:], fake.dtype,
                                                   fake.device)
            self.pools[side], q = image_pool_query(self.pools[side], fake, u, idx,
                                                   self.cfg.pool_size)
            out.append(local_rows(q, self.mesh))
        return out

    def d_step(self, batch: Tensors, fake_A: torch.Tensor, fake_B: torch.Tensor) -> Tensors:
        """One D update on the pooled fakes; the metrics, detached."""
        loss, metrics = share_of_global(*self.d_loss(batch, fake_A, fake_B), self.mesh)
        self._update("D", loss)
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    def e_step(self, batch: Tensors, draws: Optional[Draws] = None) -> Tensors:
        """vst's ``train_step``: the G step, the pools, the D step. ``draws``:
        given (u, idx) for pools A and B, else drawn."""
        aux = self.motion_aux(batch) if self.cfg.variant == "mogan" else None
        metrics, fakes = self.g_step(batch, aux)
        fake_A, fake_B = self.query_pools(fakes, draws)
        metrics.update(self.d_step(batch, fake_A, fake_B))
        self.step += 1
        return metrics

    def m_step(self, batch: Tensors) -> Tensors:
        """MoGAN's M step: AM trains M_A and M_B only."""
        if self.cfg.variant != "mogan":
            raise ValueError("the M step is MoGAN's")
        self._frozen_except("M")
        try:
            loss, metrics = share_of_global(*self.m_loss(batch), self.mesh)
            self._update("M", loss)
        finally:
            self._unfreeze()
        self.step += 1
        return all_reduce_metrics({k: v.detach() for k, v in metrics.items()}, self.mesh)

    def train_iteration(self, i: int, batch: Tensors) -> Tensors:
        """Iteration ``i`` (0-based) of vst's loop: MoGAN alternates E (even
        i) and M (odd i) steps; the other variants take E steps."""
        if self.cfg.variant == "mogan" and i % 2 == 1:
            return self.m_step(batch)
        return self.e_step(batch)

    def generate_fn(self, which: str = "G_A"):
        """x → net ``which``(x), without gradients."""
        net = self.nets[which]
        return torch.no_grad()(lambda x: net(x))
