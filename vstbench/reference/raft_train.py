"""RAFT training at its FlyingChairs stage (Teed & Deng 2020,
arXiv:2003.12039; upstream ``train.py --stage chairs`` as
``train_standard.sh`` runs it) in plain PyTorch: the benchmark's reference
for ``raft.chairs_train``.

One step: ``zero_grad``; RAFT in training mode (the authors' ``core/raft.py``
with ``iters`` 12): the feature encoder on instance norm, the context
encoder on batch norm over the batch's statistics with the running update
(upstream calls ``freeze_bn()`` only after the chairs stage), the 4-level
correlation pyramid, and each iteration a lookup at detached coordinates,
the motion encoder, the separable ConvGRU, the flow head and the convex
upsample of that iteration's flow with the mask head on its hidden state;
the exponentially weighted sequence loss (γ 0.8, ground truth of 400 px or
more dropped); ``backward``; ``clip_grad_norm_`` at 1.0; AdamW (lr 4e-4,
weight decay 1e-4, eps 1e-8); a OneCycle schedule over ``num_steps`` + 100
steps (5 % rising, linear, no momentum cycle), stepped after AdamW.

The modules are ``reference/raft.py``'s (the encoders' convolutions, the
pyramid, the ``grid_sample`` lookup, the GRU, the heads and the upsample);
:class:`BatchNorm` is this file's, and takes the place of every batch norm
of the context encoder. Departures from the authors' code:

* The sequence loss sums the L1 over the two flow channels, where upstream
  averages it: the program's loss (vst's form), twice upstream's, with
  gradients twice upstream's before the clip.
* One card takes the batch of 10; upstream's run was DataParallel over 2
  GPUs, each batch norm over its replica's 5.
* ``add_noise`` and mixed precision are not ported (``train_standard.sh``
  sets neither).
* Convolutions run on PyTorch's own im2col path, not cuDNN, forward and
  backward (cuDNN's float32 kernels for the 1x5 and 5x1 GRU convolutions are
  two orders slower on an H100 with TF32 off). Whether TF32 is on is the
  caller's: the benchmark keeps it off.
* Weights are drawn from a seed by the authors' init rule, the flow head at
  PyTorch's default (the evaluation's ``FLOW_HEAD_SCALE`` is not applied).

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from vstbench.reference import raft as ref_raft
from vstbench.reference import seeded


class BatchNorm(nn.Module):
    """``nn.BatchNorm2d`` written out: in training, each channel normalised by
    the batch's mean and biased variance over (B, H, W), and the stored
    statistics moved by ``momentum`` towards the mean and the unbiased
    variance; in evaluation, the stored statistics."""

    def __init__(self, c: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = (x - mean[:, None, None]).square().mean(dim=(0, 2, 3))
            n = x.numel() // x.shape[1]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * n / (n - 1))
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


def with_batch_norm(net: nn.Module) -> nn.Module:
    """``net`` with every batch-kind ``Norm`` of ``reference/raft.py`` replaced
    by a :class:`BatchNorm` holding its parameters and statistics (a norm
    registered twice, as the strided blocks' ``norm3``, stays one module)."""
    made: Dict[int, BatchNorm] = {}
    for module in list(net.modules()):
        for name, child in list(module._modules.items()):
            if isinstance(child, ref_raft.Norm) and child.kind == "batch":
                if id(child) not in made:
                    bn = BatchNorm(child.weight.numel()).to(child.weight.device,
                                                            child.weight.dtype)
                    bn.load_state_dict(child.state_dict())
                    made[id(child)] = bn
                module._modules[name] = made[id(child)]
    return net


def flows(net: ref_raft.RAFT, image1, image2, iters: int) -> List[torch.Tensor]:
    """Every iteration's upsampled flow (B, 2, H, W) of RAFT in training:
    images (B, 3, H, W) in [0, 255], H and W multiples of 8."""
    image1 = 2 * (image1 / 255.0) - 1.0
    image2 = 2 * (image2 / 255.0) - 1.0
    fmap1, fmap2 = net.fnet(torch.cat([image1, image2], 0)).chunk(2, 0)
    pyramid = ref_raft.build_pyramid(fmap1, fmap2)
    h, inp = torch.split(net.cnet(image1), [ref_raft.HIDDEN, ref_raft.CONTEXT], 1)
    h, inp = torch.tanh(h), F.relu(inp)
    B, _, H, W = image1.shape
    ys, xs = torch.meshgrid(torch.arange(H // 8, device=image1.device, dtype=image1.dtype),
                            torch.arange(W // 8, device=image1.device, dtype=image1.dtype),
                            indexing="ij")
    coords0 = torch.stack([xs, ys], 0)[None].repeat(B, 1, 1, 1)
    coords1 = coords0.clone()
    ub = net.update_block
    out = []
    for _ in range(iters):
        coords1 = coords1.detach()
        corr = ref_raft.lookup(pyramid, coords1)
        h = ub.gru(h, torch.cat([inp, ub.encoder(coords1 - coords0, corr)], 1))
        coords1 = coords1 + ub.flow_head(h)
        out.append(ref_raft.upsample_convex(coords1 - coords0, 0.25 * ub.mask(h)))
    return out


def sequence_loss(preds, flow, valid, gamma: float, max_flow: float) -> torch.Tensor:
    """Σᵢ γ^(n−i−1) · mean over pixels of v · Σ_channels |predᵢ − gt|, v the
    valid mask without ground truth of ``max_flow`` pixels or more."""
    v = ((valid >= 0.5) & (flow.square().sum(1).sqrt() < max_flow)).to(flow.dtype)
    n = len(preds)
    return sum(gamma ** (n - i - 1) * (v * (p - flow).abs().sum(1)).mean()
               for i, p in enumerate(preds))


def init_rule(net: ref_raft.RAFT):
    """``reference/raft.py``'s rule with the flow head's output conv at
    PyTorch's default bound."""
    rule = ref_raft.init_rule(net)

    def authors(name, t):
        spec = rule(name, t)
        if name.startswith("update_block.flow_head.conv2."):
            return spec[0], spec[1] / ref_raft.FLOW_HEAD_SCALE
        return spec

    return authors


def make(iters: int, generator: torch.Generator) -> ref_raft.RAFT:
    """The reference RAFT for training, on the generator's device, weights
    drawn from it, in training mode."""
    net = seeded.build(lambda: ref_raft.RAFT(iters), generator.device)
    net = seeded.fill(net, generator, init_rule(net))
    return with_batch_norm(net).train()


class ChairsTrainer:
    """The chairs stage's optimizer, schedule and step over ``net``; ``cfg``
    the configuration's ``raft_train`` section."""

    def __init__(self, cfg: Dict, net: ref_raft.RAFT):
        self.cfg, self.net = cfg, net.train()
        self.opt = torch.optim.AdamW(net.parameters(), lr=cfg["lr"], weight_decay=cfg["wdecay"],
                                     eps=cfg["epsilon"], foreach=False)
        self.sched = torch.optim.lr_scheduler.OneCycleLR(
            self.opt, cfg["lr"], cfg["num_steps"] + 100, pct_start=0.05, cycle_momentum=False,
            anneal_strategy="linear")

    def loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        c = self.cfg
        preds = flows(self.net, batch["image1"], batch["image2"], c["iters"])
        return sequence_loss(preds, batch["flow"], batch["valid"], c["gamma"], c["max_flow"])

    def iteration(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One step; its loss (before the update), detached."""
        self.opt.zero_grad(set_to_none=True)
        with ref_raft._no_cudnn():
            loss = self.loss(batch)
            loss.backward()
        torch.nn.utils.clip_grad_norm_(self.net.parameters(), self.cfg["clip"], foreach=False)
        self.opt.step()
        self.sched.step()
        return loss.detach()


def check_widths(arch: Dict) -> None:
    """The configuration's RAFT widths are the ones this reference builds."""
    built = {"hidden_dim": ref_raft.HIDDEN, "context_dim": ref_raft.CONTEXT,
             "corr_levels": ref_raft.LEVELS, "corr_radius": ref_raft.RADIUS, "feature_dim": 256}
    wrong = {k: (arch[k], v) for k, v in built.items() if arch[k] != v}
    if wrong:
        raise ValueError(f"RAFT widths (configured, built) differ: {wrong}")

