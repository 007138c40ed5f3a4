"""The streaming loop: ``stylize-video``'s ``stylize_frames`` on one host
frame a unit, batch 1, the host frames taken in turn (a closed loop).

Each frame's wall time runs from the call to its return: the host frame is
copied in, stylized and copied back, with the loop's synchronisation.

Output check: ``sample`` frames of the window, drawn from the seed as they
come (:class:`vstbench.window.Reservoir`), keep what ``stylize_frames``
returned; after the window the reference stylizes the same host frames.
``stylize_gap`` is the widest |program - reference| over them, in the
output's [0, 1] units.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from vstbench import data, trace, window
from vstbench.cell import PKG, Cell, Outcome
from vstbench.device import free, peak, reset_peak, sync, tf32
from vstbench.reference import seeded

WARM_FRAMES = 3


def _frames(cell: Cell, gen):
    return data.clips(gen, 1, cell.mix["host_frames"], cell.mix["hw"])[0]


def run(cell: Cell) -> Outcome:
    from vst_torch.cli.__main__ import stylize_frames

    fam, mix, dev = cell.family, cell.mix, cell.device
    gen = seeded.generator(cell.seed, dev)
    ref = fam.reference(cell.config, gen, stream=True)
    frames = _frames(cell, gen)
    prog = fam.Stream(cell.config, ref, mix, dev, PKG / ".cache")
    del ref
    spans = trace.Spans()
    if cell.trace:
        for m in prog.stylize_modules:
            spans.hook(m, "stylize")

    def frame(f):
        return stylize_frames(prog.stylize, frames[f:f + 1], 1, prog.dtype, dev)[0]

    for f in range(WARM_FRAMES):
        frame(f)
    sync(dev)
    reset_peak(dev)
    cell.mark_setup()

    reservoir = window.Reservoir(mix["sample"], cell.seed)
    kept = [None] * mix["sample"]
    walls = []

    def unit(i):
        f = i % len(frames)
        slot = reservoir.offer()
        t = time.perf_counter()
        out = frame(f)
        walls.append(time.perf_counter() - t)
        if slot >= 0:
            kept[slot] = (f, out)

    spans.on = cell.trace
    n, t0, t1 = window.run(cell.seconds, unit)
    spans.on = False
    peak_bytes = peak(dev)
    e2e = {"stream_frames_per_s": window.rate(n, t0, t1),
           "stream_frame_ms_p95": window.percentile(walls, 95) * 1e3}
    ctx = {}
    if cell.trace:
        ctx = {"spans_ms": spans.ms(), "units": n, "work": n, "window_s": t1 - t0,
               "peak_bytes": peak_bytes, "frame_walls": walls,
               "unit_flops": fam.stylize_flops(cell.config, mix["hw"])}
        spans.remove()

        def sub():
            for i in range(mix["profiled_frames"]):
                frame(i % len(frames))
            sync(dev)

        ctx["profile"] = trace.profile(sub)
    del prog
    free(dev)
    kept = [k for k in kept if k is not None]
    numbers = {"stylize_gap": check(cell, frames, kept)}
    return Outcome(attempted=n, failed=0, end_to_end=e2e, checks=cell.checks(numbers), numbers=numbers,
                   peak_bytes=peak_bytes, ctx=ctx)


def _reference(cell, ref, frames, idx):
    x = torch.from_numpy(np.ascontiguousarray(frames[idx])).to(cell.device)
    with torch.no_grad():
        out = cell.family.ref_stream(ref, x.permute(0, 3, 1, 2), cell.mix["style"])
    return out.permute(0, 2, 3, 1)


def check(cell: Cell, frames: np.ndarray, kept) -> float:
    """The widest gap of the kept frames against the reference's."""
    ref = cell.family.reference(cell.config, seeded.generator(cell.seed, cell.device),
                                stream=True)
    gap = 0.0
    with tf32(False):
        for f, out in kept:
            want = _reference(cell, ref, frames, [f])
            gap = max(gap, (torch.from_numpy(out).to(cell.device) - want).abs().max().item())
    return gap


def control(cell: Cell):
    """The reference with TF32 on in the program's place, on ``sample`` frames."""
    gen = seeded.generator(cell.seed, cell.device)
    ref = cell.family.reference(cell.config, gen, stream=True)
    frames = _frames(cell, gen)
    gap = 0.0
    for f in range(cell.mix["sample"]):
        with tf32(True):
            low = _reference(cell, ref, frames, [f])
        with tf32(False):
            want = _reference(cell, ref, frames, [f])
        gap = max(gap, (low - want).abs().max().item())
    return {"stylize_gap": gap}
