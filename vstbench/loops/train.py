"""The training loop: ``StarGAN2Trainer.train_iteration`` a unit, on the
batches of a pool made on the device, taken in turn. Iterations are issued
without waiting for the device; a synchronize closes the window, and the
rate is ``batch`` images a completed iteration over the whole window.

Output check. Set-up builds the one trainer the window uses and drives it
through its first ``checked_iterations`` iterations on the pool's first
batches (every row differs), reading:

* each iteration's four step losses (D latent, D ref, G latent, G ref);
* each leaf's first gradient as its optimizer holds it after iteration 1
  (AdamW with beta1 = 0 keeps the last gradient as ``exp_avg``);
* each leaf's change after the checked iterations, nets and EMA copies.

After the window the reference (``reference/stargan2.py``), built from the
same seed with its own optimizers, runs the same iterations on the same
batches and latents. ``limits/<cell>.json`` names the numbers compared:

* ``first_loss_gap``: |program - reference| / |reference| of the first
  step's loss (the D step of iteration 1, before any update);
* ``grad_gap``: per leaf |norm(program) - norm(reference)| of the first
  gradient, over the larger of the reference's norm of that leaf and the
  median over its net's leaves; the worst leaf;
* ``change_gap_median_leaf``: the same gap of each leaf's change over the
  checked iterations, nets and EMA copies; the median leaf.

Read and printed beside them, not compared: every step's loss
(``loss_gap``, ``loss_gap.<i>``) and the worst leaf's change
(``change_gap``). AdamW with beta1 = 0 moves every element by about lr at
its first step whatever its gradient's size, so rounding-level differences
in small gradients become whole steps: by iteration 3 the program's step
losses read up to 40 % from the reference's in float32 (1e-11 in float64),
and one small leaf's change swings from seed to seed.

Leaves whose reference gradient is under a thousandth of their net's median
leaf (conv biases under an instance norm, heads of domains no row drew) move
by round-off alone: they are left out of the gradient's and the change's
gaps (``leaves_left_out`` counts them).
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import torch

from vstbench import data, trace, window
from vstbench.cell import Cell, Outcome
from vstbench.device import free, peak, reset_peak, sync, tf32
from vstbench.reference import seeded
from vstbench.reference import stargan2 as ref_sg

QUIET = 1e-3  # a leaf whose gradient is under this share of its net's median is left out


def pool(cell: Cell, gen):
    c = cell.config["stargan2"]
    return data.advcon_batches(gen, cell.mix["pool"], cell.mix["batch"], c["img_size"],
                               c["num_domains"], c["latent_dim"])


def _batch(b):
    return {k: v for k, v in b.items() if k != "z"}


def leaves(nets: Dict[str, torch.nn.Module], ema: Dict[str, torch.nn.Module]):
    """(net, leaf name, tensor) of every parameter of the nets and EMA copies."""
    out = [(k, n, p) for k, net in nets.items() for n, p in net.named_parameters()]
    out += [(f"ema.{k}", n, p) for k, net in ema.items() for n, p in net.named_parameters()]
    return out


def first_grads(nets, opts) -> Dict:
    """{(net, leaf): norm of exp_avg} once each optimizer has stepped."""
    out = {}
    for k, net in nets.items():
        state = opts[k].state
        for n, p in net.named_parameters():
            s = state.get(p)
            out[(k, n)] = s["exp_avg"].norm() if s else torch.zeros((), device=p.device)
    return out


def readings(losses, grads, before, after) -> Dict:
    """Host floats of the checked iterations' readings."""
    return {"losses": torch.stack(losses).tolist(),
            "grads": {k: float(v) for k, v in grads.items()},
            "change": {(k, n): float((after[(k, n)] - before[(k, n)]).norm())
                       for k, n in before}}


def snapshot(nets, ema) -> Dict:
    return {(k, n): p.detach().clone() for k, n, p in leaves(nets, ema)}


def run(cell: Cell) -> Outcome:
    fam, mix, dev = cell.family, cell.mix, cell.device
    gen = seeded.generator(cell.seed, dev)
    ref = fam.reference_train(cell.config, gen)
    batches = pool(cell, gen)
    t = fam.trainer(cell.config, ref, dev)
    del ref
    spans = trace.Spans()
    if cell.trace:
        spans.wrap(t, "d_step", "d_steps")
        spans.wrap(t, "g_step", "g_steps")
        spans.wrap(t, "ema_step", "ema")

    before = snapshot(t.nets, t.ema)
    losses, grads = [], None
    for k in range(mix["checked_iterations"]):
        b = batches[k]
        losses.append(fam.step_losses(cell.config, t.train_iteration(_batch(b), z=b["z"])))
        if k == 0:
            grads = first_grads(t.nets, t.opts)
    prog = readings(losses, grads, before, snapshot(t.nets, t.ema))
    del before
    sync(dev)
    reset_peak(dev)
    cell.mark_setup()

    bad = torch.zeros((), dtype=torch.long, device=dev)

    def unit(i):
        b = batches[(mix["checked_iterations"] + i) % len(batches)]
        m = t.train_iteration(_batch(b), z=b["z"])
        bad.add_((~torch.isfinite(torch.stack(list(m.values())))).any())

    spans.on = cell.trace
    n, t0, t1 = window.run(cell.seconds, unit, finish=lambda: sync(dev))
    spans.on = False
    peak_bytes = peak(dev)
    e2e = {"train_images_per_s": window.rate(n * mix["batch"], t0, t1)}
    ctx = {}
    if cell.trace:
        ctx = {"spans_ms": spans.ms(), "units": n, "work": n * mix["batch"],
               "window_s": t1 - t0, "peak_bytes": peak_bytes}

        def sub():
            for i in range(mix["profiled_iterations"]):
                unit(i)
            sync(dev)

        ctx["profile"] = trace.profile(sub)
        ctx["unit_flops"] = unit_flops(cell)
    failed = int(bad)
    del t, batches
    free(dev)
    numbers = compare(prog, reference_readings(cell))
    return Outcome(attempted=n, failed=failed, end_to_end=e2e, checks=cell.checks(numbers), numbers=numbers,
                   peak_bytes=peak_bytes, ctx=ctx)


def reference_readings(cell: Cell, tf32_on: bool = False) -> Dict:
    """The reference's readings of the checked iterations, from the seed."""
    gen = seeded.generator(cell.seed, cell.device)
    nets = cell.family.reference_train(cell.config, gen)
    batches = pool(cell, gen)
    r = ref_sg.AdvConTrainer(cell.config["stargan2"], nets)
    before = snapshot(r.nets, r.ema)
    losses, grads = [], None
    with tf32(tf32_on):
        for k in range(cell.mix["checked_iterations"]):
            losses.append(r.iteration(batches[k], batches[k]["z"]))
            if k == 0:
                grads = first_grads(r.nets, r.opts)
    return readings(losses, grads, before, snapshot(r.nets, r.ema))


def _medians(norms: Dict) -> Dict[str, float]:
    by_net: Dict[str, List[float]] = {}
    for (k, _), v in norms.items():
        by_net.setdefault(k, []).append(v)
    return {k: statistics.median(v) for k, v in by_net.items()}


def compare(prog: Dict, ref: Dict) -> Dict[str, float]:
    """Each gap of the checked iterations; ``loss_gap.<i>`` is iteration i's."""
    gaps = [max(abs(p - r) / abs(r) for p, r in zip(lp, lr))
            for lp, lr in zip(prog["losses"], ref["losses"])]
    g_med = _medians(ref["grads"])
    moving = {key for key, v in ref["grads"].items() if v >= QUIET * g_med[key[0]]}
    grad_gap = max(abs(prog["grads"][key] - ref["grads"][key])
                   / max(ref["grads"][key], g_med[key[0]]) for key in moving)
    change = {key: v for key, v in ref["change"].items()
              if (key[0].replace("ema.", ""), key[1]) in moving}
    c_med = _medians(change)
    per_leaf = {key: abs(prog["change"][key] - v) / max(v, c_med[key[0]])
                for key, v in change.items()}
    first = abs(prog["losses"][0][0] - ref["losses"][0][0]) / abs(ref["losses"][0][0])
    out = {"first_loss_gap": first, "loss_gap": max(gaps), "grad_gap": grad_gap,
           "change_gap": max(per_leaf.values()),
           "change_gap_median_leaf": statistics.median(per_leaf.values()),
           "leaves_left_out": float(len(ref["grads"]) - len(moving))}
    out.update({f"loss_gap.{i + 1}": g for i, g in enumerate(gaps)})
    return out


def control(cell: Cell) -> Dict[str, float]:
    """The reference with TF32 on in the program's place."""
    return compare(reference_readings(cell, tf32_on=True), reference_readings(cell))


def unit_flops(cell: Cell) -> int:
    """Operations of one iteration's forward and backward passes (the four
    steps, R1's double backward included) on the reference, on meta."""
    from vstbench.counts.flops import count

    c = cell.config["stargan2"]
    nets = {k: seeded.build(ref_sg.builders(c)[k], "meta") for k in ref_sg.NETS}
    r = ref_sg.AdvConTrainer.__new__(ref_sg.AdvConTrainer)
    r.cfg, r.nets = c, nets
    r._step = lambda names, loss: loss.backward()
    B, img = cell.mix["batch"], c["img_size"]
    b = {k: torch.empty(B, 3, img, img, device="meta") for k in ("x_real", "x_real2", "x_ref")}
    b.update(flow=torch.empty(B, 2, img, img, device="meta"),
             mask=torch.empty(B, 1, img, img, device="meta"),
             y_org=torch.zeros(B, dtype=torch.long, device="meta"),
             y_trg=torch.zeros(B, dtype=torch.long, device="meta"))
    z = torch.empty(B, c["latent_dim"], device="meta")
    return count(lambda: [r.d_step("latent", b, z), r.d_step("ref", b, z),
                          r.g_step("latent", b, z), r.g_step("ref", b, z)])
