"""RAFT's training loop: ``RAFTTrainer.train_iteration`` a unit, on the
batches of a pool of chairs-like pairs made on the device
(``vstbench/chairs.py``), taken in turn. Iterations are issued without
waiting for the device; a synchronize closes the window, and the rate is
``batch`` image pairs a completed iteration over the whole window.

Output check. Set-up builds the one trainer the window uses and drives it
through its first ``checked_iterations`` iterations on the pool's first
batches, reading:

* each iteration's loss;
* each leaf's first gradient, clipped, as AdamW holds it after iteration 1
  (``exp_avg`` / (1 - beta1), beta1 = 0.9);
* each leaf's change over the checked iterations;
* the context encoder's batch-norm running statistics after them.

After the window, the trainer freed, the reference
(``reference/raft_train.py``), built from the same seed with its own
optimizer and schedule, runs the same iterations on the same batches.
``limits/<cell>.json`` names the numbers compared:

* ``first_loss_gap``: |program - reference| / |reference| of the first
  iteration's loss (before any update);
* ``grad_gap``: per leaf |norm(program) - norm(reference)| of the first
  gradient over the larger of the reference's norm and the median over its
  net's leaves (``fnet``, ``cnet``, ``update_block``); the worst leaf;
* ``change_gap_median_leaf``: the same gap of each leaf's change over the
  checked iterations; the median leaf;
* ``bn_stats_gap``: per running mean or variance, norm(program - reference)
  over the norm of the reference's own change from its start; the worst.
  A program that keeps its stored statistics reads 1.

Read and printed beside them, not compared: every iteration's loss
(``loss_gap``, ``loss_gap.<i>``) and the worst leaf's change
(``change_gap``). AdamW's first steps move every element by about the
learning rate whatever its gradient's size, so rounding in small gradients
becomes whole steps, and one small leaf's change swings from seed to seed.
Leaves whose reference gradient is under a thousandth of their net's median
leaf (conv biases under an instance or batch norm) move by round-off alone:
they are left out of the gradient's and the change's gaps
(``leaves_left_out`` counts them).

With ``--trace 1`` the traced branch puts in ``ctx``: ``units``, ``work``
(image pairs), ``window_s``, ``peak_bytes``, then over the profiled
iterations ``profile`` (``vstbench.trace.profile``), ``lookups`` (the
forward lookups recorded), ``lookup_bound_s`` (their least time,
``counts/lookup.py``), ``lookup_bwd_bound_s`` (the least time of their
backward passes, ``counts/lookup_bwd.py``) and ``unit_flops`` (one
iteration's forward and backward on the reference).
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List

import torch

from vstbench import chairs, trace, window
from vstbench.cell import Cell, Outcome
from vstbench.counts.lookup import lookup_bound_s
from vstbench.counts.lookup_bwd import lookup_bwd_bound_s
from vstbench.device import free, peak, reset_peak, sync, tf32
from vstbench.reference import seeded

QUIET = 1e-3  # a leaf whose gradient is under this share of its net's median is left out
BETA1 = 0.9  # AdamW's, upstream's default


def pool(cell: Cell, gen):
    c = cell.config["raft_train"]
    if cell.mix["batch"] != c["batch_size"]:
        raise ValueError(f"the mix's batch {cell.mix['batch']} is not the configuration's "
                         f"{c['batch_size']}")
    return [chairs.batch(gen, cell.mix["batch"], c["image_size"], cell.mix["pairs"])
            for _ in range(cell.mix["pool"])]


def _leaves(net: torch.nn.Module):
    """(net part, leaf name, parameter) of every parameter."""
    return [(n.split(".", 1)[0], n, p) for n, p in net.named_parameters()]


def first_grads(net, opt) -> Dict:
    """{(part, leaf): norm of the first clipped gradient} once AdamW has stepped."""
    out = {}
    for part, n, p in _leaves(net):
        s = opt.state.get(p)
        out[(part, n)] = s["exp_avg"].norm() / (1 - BETA1) if s else torch.zeros(
            (), device=p.device)
    return out


def snapshot(net) -> Dict:
    return {(part, n): p.detach().clone() for part, n, p in _leaves(net)}


def bn_stats(net) -> Dict:
    return {n: b.detach().clone() for n, b in net.named_buffers() if ".running_" in n}


def readings(losses, grads, before, after, stats0, stats) -> Dict:
    """Host floats of the checked iterations' readings."""
    return {"losses": torch.stack(losses).tolist(),
            "grads": {k: float(v) for k, v in grads.items()},
            "change": {k: float((after[k] - before[k]).norm()) for k in before},
            "bn": {n: v.double().cpu() for n, v in stats.items()},
            "bn0": {n: v.double().cpu() for n, v in stats0.items()}}


def checked(cell: Cell, step, net, opt, batches) -> Dict:
    """The readings of ``checked_iterations`` calls of ``step(batch)`` (which
    returns the loss) on the pool's first batches."""
    before, stats0 = snapshot(net), bn_stats(net)
    losses, grads = [], None
    for k in range(cell.mix["checked_iterations"]):
        losses.append(step(batches[k]))
        if k == 0:
            grads = first_grads(net, opt)
    return readings(losses, grads, before, snapshot(net), stats0, bn_stats(net))


def run(cell: Cell) -> Outcome:
    fam, mix, dev = cell.family, cell.mix, cell.device
    gen = seeded.generator(cell.seed, dev)
    ref = fam.reference_train(cell.config, gen)
    batches = pool(cell, gen)
    t = fam.trainer(cell.config, ref, dev)
    del ref
    prog = checked(cell, lambda b: t.train_iteration(b)["loss"], t.raft, t.opt, batches)
    sync(dev)
    reset_peak(dev)
    cell.mark_setup()

    bad = torch.zeros((), dtype=torch.long, device=dev)

    def unit(i):
        m = t.train_iteration(batches[(mix["checked_iterations"] + i) % len(batches)])
        bad.add_((~torch.isfinite(torch.stack(list(m.values())))).any())

    n, t0, t1 = window.run(cell.seconds, unit, finish=lambda: sync(dev))
    peak_bytes = peak(dev)
    e2e = {"train_images_per_s": window.rate(n * mix["batch"], t0, t1)}
    ctx = {}
    if cell.trace:
        ctx = {"units": n, "work": n * mix["batch"], "window_s": t1 - t0,
               "peak_bytes": peak_bytes}
        ctx.update(_profiled(cell, t, unit))
    failed = int(bad)
    del t, batches
    free(dev)
    numbers = compare(prog, reference_readings(cell))
    return Outcome(attempted=n, failed=failed, end_to_end=e2e, checks=cell.checks(numbers),
                   numbers=numbers, peak_bytes=peak_bytes, ctx=ctx)


def _profiled(cell: Cell, t, unit) -> Dict:
    """The profiled iterations, with every lookup's level sizes, coordinates
    and radius recorded for the lookups' least times."""
    lookups: List = []
    plain = t.raft.lookup

    def recorded(pyramid, coords, radius):
        lookups.append(([tuple(p.shape[-2:]) for p in pyramid], coords.detach().clone(), radius))
        return plain(pyramid, coords, radius)

    def sub():
        for i in range(cell.mix["profiled_iterations"]):
            unit(i)
        sync(cell.device)

    t.raft.lookup = recorded
    try:
        prof = trace.profile(sub)
    finally:
        t.raft.lookup = plain
    return {"profile": prof, "lookups": len(lookups),
            "lookup_bound_s": sum(lookup_bound_s(hw, c, r) for hw, c, r in lookups),
            "lookup_bwd_bound_s": sum(lookup_bwd_bound_s(hw, c[:, 0].numel(), r)
                                      for hw, c, r in lookups),
            "unit_flops": cell.family.unit_flops(cell.config, cell.mix["batch"])}


def reference_readings(cell: Cell, tf32_on: bool = False) -> Dict:
    """The reference's readings of the checked iterations, from the seed."""
    gen = seeded.generator(cell.seed, cell.device)
    net = cell.family.reference_train(cell.config, gen)
    batches = pool(cell, gen)
    r = cell.family.reference_trainer(cell.config, net)
    with tf32(tf32_on):
        return checked(cell, r.iteration, r.net, r.opt, batches)


def _medians(norms: Dict) -> Dict[str, float]:
    by_part: Dict[str, List[float]] = {}
    for (part, _), v in norms.items():
        by_part.setdefault(part, []).append(v)
    return {k: statistics.median(v) for k, v in by_part.items()}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each gap of the checked iterations; ``loss_gap.<i>`` is iteration i's."""
    gaps = [abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"])]
    g_med = _medians(ref["grads"])
    moving = {key for key, v in ref["grads"].items() if v >= QUIET * g_med[key[0]]}
    grad_gap = max(abs(prog["grads"][key] - ref["grads"][key])
                   / max(ref["grads"][key], g_med[key[0]]) for key in moving)
    change = {key: v for key, v in ref["change"].items() if key in moving}
    c_med = _medians(change)
    per_leaf = {key: abs(prog["change"][key] - v) / max(v, c_med[key[0]])
                for key, v in change.items()}
    bn = max(float((prog["bn"][n] - v).norm() / (v - ref["bn0"][n]).norm())
             for n, v in ref["bn"].items())
    out = {"first_loss_gap": gaps[0], "loss_gap": max(gaps), "grad_gap": grad_gap,
           "change_gap": max(per_leaf.values()),
           "change_gap_median_leaf": statistics.median(per_leaf.values()),
           "bn_stats_gap": bn, "leaves_left_out": float(len(ref["grads"]) - len(moving))}
    out.update({f"loss_gap.{i + 1}": g for i, g in enumerate(gaps)})
    return out


def control(cell: Cell) -> Dict[str, float]:
    """The reference with TF32 on in the program's place."""
    return compare(reference_readings(cell, tf32_on=True), reference_readings(cell))


@contextlib.contextmanager
def frozen_batch_norm():
    """A fault: the trainer's RAFT keeps its stored batch-norm statistics."""
    from vst_torch.flow.raft import RAFT

    before = RAFT.unfreeze_bn
    RAFT.unfreeze_bn = lambda self: self
    try:
        yield
    finally:
        RAFT.unfreeze_bn = before


@contextlib.contextmanager
def half_batch():
    """A fault: each training iteration sees the first half of its pairs."""
    from vst_torch.train.raft import RAFTTrainer

    before = RAFTTrainer.train_iteration

    def halved(self, batch):
        n = batch["image1"].shape[0] // 2
        return before(self, {k: v[:n] for k, v in batch.items()})

    RAFTTrainer.train_iteration = halved
    try:
        yield
    finally:
        RAFTTrainer.train_iteration = before


FAULTS = {f.__name__: f for f in (frozen_batch_norm, half_batch)}
