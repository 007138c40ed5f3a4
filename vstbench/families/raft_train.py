"""The ``raft`` configuration: RAFT trained at its FlyingChairs stage through
``vst_torch``'s ``RAFTTrainer``, with the reference's weights."""

from __future__ import annotations

import torch

from vstbench.counts.flops import count
from vstbench.reference import raft_train as ref_rt
from vstbench.reference import seeded


def reference_train(cfg, gen):
    """The reference RAFT in training mode, weights drawn from ``gen``."""
    ref_rt.check_widths(cfg["raft"])
    return ref_rt.make(cfg["raft_train"]["iters"], gen)


def trainer(cfg, ref, device):
    """The port's ``RAFTTrainer`` at the configuration's settings, its net
    holding the reference's weights and statistics (the trainer builds and
    initialises its own net on the host first: it takes none)."""
    from vst_torch.train.raft import RAFTTrainConfig, RAFTTrainer

    c = cfg["raft_train"]
    t = RAFTTrainer(RAFTTrainConfig(**{k: c[k] for k in (
        "iters", "lr", "wdecay", "gamma", "clip", "num_steps")}), device=device)
    t.raft.load_state_dict(ref.state_dict())
    return t


def reference_trainer(cfg, ref):
    return ref_rt.ChairsTrainer(cfg["raft_train"], ref)


def unit_flops(cfg, batch: int) -> int:
    """Operations of one step's forward and backward on the reference, on
    meta: the convolutions and matrix products of RAFT's 12 iterations, the
    mask head on each, and their gradients."""
    c = cfg["raft_train"]
    net = ref_rt.with_batch_norm(seeded.build(lambda: ref_rt.ref_raft.RAFT(c["iters"]),
                                              "meta")).train()
    H, W = c["image_size"]
    b = {"image1": torch.empty(batch, 3, H, W, device="meta"),
         "image2": torch.empty(batch, 3, H, W, device="meta"),
         "flow": torch.empty(batch, 2, H, W, device="meta"),
         "valid": torch.empty(batch, H, W, device="meta")}
    r = ref_rt.ChairsTrainer.__new__(ref_rt.ChairsTrainer)
    r.cfg, r.net = c, net
    return count(lambda: r.loss(b).backward())
