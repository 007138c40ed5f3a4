"""RAFT training at the FlyingChairs stage (Teed & Deng 2020, upstream
``train.py`` run by ``train_standard.sh``: ``--stage chairs --batch_size 10
--image_size 368 496 --lr 0.0004 --wdecay 0.0001 --num_steps 100000``, the
defaults ``--iters 12 --gamma 0.8 --clip 1.0``).

One step, as upstream's loop:

1. ``zero_grad``;
2. ``RAFT(iters, train_mode=True)`` on the pair, the context encoder's batch
   norm on the batch's statistics (upstream calls ``freeze_bn()`` only after
   the chairs stage; :meth:`RAFT.unfreeze_bn`), and
   :func:`~vst_torch.flow.datasets.flow_sequence_loss` (γ, ``max_flow``
   400, the valid mask) over every iteration's upsampled flow;
3. ``backward``, ``clip_grad_norm_`` at ``clip``;
4. AdamW (lr, weight decay ``wdecay``, eps 1e-8) and a OneCycle schedule
   (``max_lr`` lr over ``num_steps + 100`` steps, 5 % rising, linear, no
   momentum cycle), stepped after the optimizer.

``add_noise`` and mixed precision are off, as ``train_standard.sh`` has them,
and not ported. The loss is vst's form of the sequence loss: the L1 over the
two flow channels is summed where upstream averages it, so the loss and its
gradients are twice upstream's before the clip.

Batches are dicts of tensors on the trainer's device: ``image1``, ``image2``
(B, 3, H, W) RGB in [0, 255], ``flow`` (B, 2, H, W), ``valid`` (B, H, W).
:meth:`RAFTTrainer.train_iteration` reads nothing to the host, so a caller
can issue steps without waiting for the device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from vst_torch.core.trace import count, span
from vst_torch.flow.datasets import flow_sequence_loss
from vst_torch.flow.raft import RAFT
from vst_torch.kernels.corr_lookup import corr_lookup

Tensors = Dict[str, torch.Tensor]
MAX_FLOW = 400.0  # upstream's sequence_loss drops ground truth this long or longer
SCHEDULE_TAIL = 100  # OneCycleLR's total_steps is num_steps + 100 upstream
EPSILON = 1e-8  # AdamW's, upstream's --epsilon


@dataclasses.dataclass
class RAFTTrainConfig:
    iters: int = 12
    lr: float = 4e-4
    wdecay: float = 1e-4
    gamma: float = 0.8
    clip: float = 1.0
    num_steps: int = 100_000


def flow_metrics(flow_pred: torch.Tensor, flow_gt: torch.Tensor, valid: torch.Tensor) -> Tensors:
    """Upstream's EPE and the shares of valid pixels within 1, 3 and 5 px of
    the ground truth, for the last iteration's flow, as device tensors (the
    valid mask as in the loss)."""
    v = ((valid >= 0.5) & (torch.sqrt(torch.sum(flow_gt ** 2, dim=1)) < MAX_FLOW)).to(
        flow_pred.dtype)
    epe = torch.sqrt(torch.sum((flow_pred - flow_gt) ** 2, dim=1))
    n = v.sum()
    return {"epe": (epe * v).sum() / n,
            **{f"{px}px": ((epe < px) * v).sum() / n for px in (1, 3, 5)}}


class RAFTTrainer:
    """Owns the RAFT in training mode with unfrozen batch norm, AdamW and the
    OneCycle schedule. The net is initialised from torch's generator seeded
    with ``seed`` (the tests and the benchmark load other weights into
    ``raft``). ``lookup`` is RAFT's window lookup (the kernel's wrapper; give
    ``lookup_pyramid`` for a float64 net), ``dtype`` the parameters' dtype."""

    def __init__(self, cfg: Optional[RAFTTrainConfig] = None, seed: int = 0, device="cuda",
                 lookup: Callable = corr_lookup, dtype: torch.dtype = torch.float32):
        self.cfg = cfg = cfg or RAFTTrainConfig()
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            net = RAFT(iters=cfg.iters, lookup=lookup, train_mode=True)
        self.raft = net.to(self.device, dtype).train().unfreeze_bn()
        self.opt = torch.optim.AdamW(self.raft.parameters(), lr=cfg.lr,
                                     weight_decay=cfg.wdecay, eps=EPSILON)
        self.sched = torch.optim.lr_scheduler.OneCycleLR(
            self.opt, cfg.lr, cfg.num_steps + SCHEDULE_TAIL, pct_start=0.05,
            cycle_momentum=False, anneal_strategy="linear")
        self.step = 0

    def loss(self, batch: Tensors):
        """(sequence loss, metrics) of one batch through the net."""
        _, preds = self.raft(batch["image1"], batch["image2"])
        loss = flow_sequence_loss(preds, batch["flow"], batch["valid"], gamma=self.cfg.gamma,
                                  max_flow=MAX_FLOW)
        return loss, flow_metrics(preds[-1].detach(), batch["flow"], batch["valid"])

    def train_iteration(self, batch: Tensors) -> Tensors:
        """One step; the loss and the metrics, detached, on the device.
        While a profiler runs, it records the spans ``vst.train.*`` and
        counts ``vst.train.iterations`` (``vst_torch.core.trace``)."""
        with span("vst.train.iteration"):
            with span("vst.train.optimizer"):
                self.opt.zero_grad(set_to_none=True)
            with span("vst.train.loss"):
                loss, metrics = self.loss(batch)
            with span("vst.train.backward"):
                loss.backward()
            with span("vst.train.optimizer"):
                torch.nn.utils.clip_grad_norm_(self.raft.parameters(), self.cfg.clip)
                self.opt.step()
                self.sched.step()
            self.step += 1
            count("vst.train.iterations")
        return {"loss": loss.detach(), **metrics}

    def state_dict(self) -> Dict:
        """The optimizer's and the schedule's states and the step: with the
        net's ``state_dict`` (batch-norm statistics included), what a resumed
        run needs."""
        return {"optimizer": self.opt.state_dict(), "scheduler": self.sched.state_dict(),
                "step": self.step}

    def load_state_dict(self, state: Dict) -> None:
        """What :meth:`state_dict` gave; the net's ``state_dict`` is loaded
        into ``raft`` apart."""
        self.opt.load_state_dict(state["optimizer"])
        self.sched.load_state_dict(state["scheduler"])
        self.step = state["step"]
