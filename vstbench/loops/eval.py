"""The evaluation loop: one call of the configuration's Sintel evaluation
(``evaluate_sintel_*`` in ``vst_torch.eval.drivers``) a unit, over one clip
for one style, clips and styles taken in turn.

A call scores every frame but the first (TCL-ST from frame 1, TCL-LT from
frame ``lt_len``), so it does ``frames - 1`` units of work.

Output check: one call of the window, drawn from the seed as the calls come
(:class:`vstbench.window.Reservoir`), keeps what the timed path produced:
every stylize call's frame and raw output, every RAFT call's images and
upsampled flows, and the call's TCL-ST and TCL-LT. After the window the
reference recomputes the clip from the same host frames:

* ``stylize_gap``: the widest |program - reference| of a stylized frame over
  the net's output scale, over every stylize call whose input is a frame of
  the clip (the timing chain's calls take the net's own outputs and are
  not answers);
* ``flow_gap_px``: the largest mean |program - reference| of an upsampled
  flow, in pixels, over every row of every RAFT call;
* ``tcl_gap``: the larger relative gap of the call's TCL-ST and TCL-LT
  against the reference's mask, warp and RMS (``reference/tcl.py``) taken
  over the program's own stylized frames and flows of the same call, so
  that it reads the ops alone;
* ``tcl_gap_end_to_end`` (printed, not compared): the same against the
  reference's TCL from its own frames and flows; the mask's thresholds flip
  pixels on the flows' rounding, so sound runs read it as high as the
  control does.

``limits/<cell>.json`` names the numbers compared; the rest are printed
beside them.

A frame that was never stylized, a RAFT row whose images are no pair of the
clip's frames or a pair the harness needs and never computed make the gap
``MISSING``, which fails every limit.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from vstbench import data, trace, window
from vstbench.cell import Cell, Outcome
from vstbench.counts.lookup import lookup_bound_s
from vstbench.device import free, peak, reset_peak, sync, tf32
from vstbench.reference import seeded
from vstbench.reference import tcl as ref_tcl

MISSING = 1e9
MATCH_TOL = 1e-6
RAFT_BATCH = 4
TCL_FLOOR = 1e-6  # a TCL of 0 (a mask that keeps no pixel) divides by this


def _inputs(cell: Cell, gen):
    """The reference's nets and the evaluation's styles, drawn in this order."""
    ref = cell.family.reference(cell.config, gen)
    return ref, cell.family.eval_styles(cell.config, gen)


def run(cell: Cell) -> Outcome:
    from vst_torch.eval.sintel import SintelVideo

    fam, mix, dev = cell.family, cell.mix, cell.device
    gen = seeded.generator(cell.seed, dev)
    ref, styles = _inputs(cell, gen)
    clips = data.clips(gen, mix["clips"], mix["frames"], mix["hw"])
    prog = fam.Eval(cell.config, ref, styles, dev)
    del ref
    videos = [SintelVideo(f"clip{c}", clip) for c, clip in enumerate(clips)]
    n_styles = len(styles)
    kw = dict(dt_iters=mix["dt_iters"], lt_len=mix["lt_len"])

    cap = {"on": False, "stylize": [], "raft": []}
    prog.capture_module.register_forward_hook(
        lambda m, inp, out: cap["stylize"].append(
            tuple(t.detach().clone() for t in prog.captured(inp, out))) if cap["on"] else None)
    prog.raft.register_forward_hook(
        lambda m, inp, out: cap["raft"].append(
            (inp[0].clone(), inp[1].clone(), out[1].clone())) if cap["on"] else None)
    spans = trace.Spans()
    if cell.trace:
        for m in prog.stylize_modules:
            spans.hook(m, "stylize")
        spans.hook(prog.raft, "raft")

    # warm every shape of the window (RAFT at batch 2 and 4, the stylize net)
    # on the clip's first lt_len + 1 frames, with a timing chain of one call
    prog.call(SintelVideo("warm", clips[0][:mix["lt_len"] + 1]), 0,
              dt_iters=1, lt_len=mix["lt_len"])
    sync(dev)
    reset_peak(dev)
    cell.mark_setup()

    reservoir = window.Reservoir(1, cell.seed)
    kept: Dict = {}
    failed = [0]

    def unit(i):
        c, s = i % len(videos), i % n_styles
        keep = reservoir.offer() == 0
        if keep:
            cap["stylize"], cap["raft"] = [], []
        cap["on"] = keep
        res = prog.call(videos[c], s, **kw)
        cap["on"] = False
        tcl = (res["TCL-ST"]["TCL-ST_mean"], res["TCL-LT"]["TCL-LT_mean"])
        failed[0] += not all(math.isfinite(v) for v in tcl)
        if keep:
            kept.update(clip=c, style=s, tcl=tcl, stylize=cap["stylize"], raft=cap["raft"])

    spans.on = cell.trace
    n, t0, t1 = window.run(cell.seconds, unit)
    spans.on = False
    peak_bytes = peak(dev)
    scored = n * (mix["frames"] - 1)
    e2e = {"eval_frames_per_s": window.rate(scored, t0, t1)}

    ctx = {}
    if cell.trace:
        ctx = _traced(cell, prog, videos, kw, spans, n, scored, t1 - t0, peak_bytes)
    del prog, cap["stylize"], cap["raft"]
    free(dev)
    numbers = check(cell, clips[kept["clip"]], kept)
    return Outcome(attempted=n, failed=failed[0], end_to_end=e2e,
                   checks=cell.checks(numbers), numbers=numbers, peak_bytes=peak_bytes, ctx=ctx)


def _traced(cell, prog, videos, kw, spans, n, scored, window_s, peak):
    """Per-layer readings: spans over the window, then one profiled call."""
    ctx = {"spans_ms": spans.ms(), "units": n, "work": scored, "window_s": window_s,
           "peak_bytes": peak}
    spans.remove()
    lookups: List = []
    plain = prog.raft.lookup

    def recorded(pyramid, coords, radius):
        lookups.append(([tuple(p.shape[-2:]) for p in pyramid], coords.detach().clone(), radius))
        return plain(pyramid, coords, radius)

    prog.raft.lookup = recorded
    ctx["profile"] = trace.profile(lambda: (prog.call(videos[0], 0, **kw), sync(cell.device)))
    prog.raft.lookup = plain
    ctx["lookup_bound_s"] = sum(lookup_bound_s(hw, c, r) for hw, c, r in lookups)
    ctx["lookups"] = len(lookups)
    ctx["unit_flops"] = unit_flops(cell)
    return ctx


def unit_flops(cell: Cell) -> int:
    """Operations the reference needs for one call: the timing's ``dt_iters``
    stylizes and, a scored frame, its stylizes (the frame and each earlier
    frame it is compared with) and RAFT at batch 2 (one pair, both ways)
    before ``lt_len`` or 4 (two pairs) from there on."""
    fam, cfg, mix = cell.family, cell.config, cell.mix
    n, lt = mix["frames"], mix["lt_len"]
    hw = mix["hw"]
    phw = [hw[0] + sum(ref_tcl.pad_amounts(*hw)[2:]), hw[1] + sum(ref_tcl.pad_amounts(*hw)[:2])]
    n_pair, n_two = lt - 1, n - lt
    sty = mix["dt_iters"] + 2 * n_pair + 3 * n_two
    return (sty * fam.stylize_flops(cfg, hw) + n_pair * fam.raft_flops(cfg, 2, phw)
            + n_two * fam.raft_flops(cfg, 4, phw))


# -- the output check --------------------------------------------------------------


def _match(x: torch.Tensor, frames: torch.Tensor) -> int:
    """Index of the frame that ``x`` (1, C, H, W) or (C, H, W) equals, else -1."""
    x = x.reshape(frames.shape[1:])
    for i in range(frames.shape[0]):
        if (x - frames[i]).abs().max().item() <= MATCH_TOL:
            return i
    return -1


def needed_pairs(n: int, lt: int) -> List[Tuple[int, int]]:
    """(j, k): the flow from frame j to frame k, both ways of every ST and LT pair."""
    pairs = set()
    for i in range(1, n):
        pairs |= {(i - 1, i), (i, i - 1)}
    for i in range(lt, n):
        pairs |= {(i - lt, i), (i, i - lt)}
    return sorted(pairs)


def program_outputs(kept: Dict, xp: torch.Tensor) -> Dict:
    """The kept call's outputs keyed by what they answer: raw stylized frames
    by frame index, upsampled flows by (j, k); unmatched rows counted."""
    stylized, flows, unmatched = {}, {}, 0
    for x, out in kept["stylize"]:
        i = _match(x, xp)
        if i >= 0:
            stylized.setdefault(i, []).append(out)
    padded = ref_tcl.pad(xp)
    for a, b, up in kept["raft"]:
        for r in range(a.shape[0]):
            j, k = _match(a[r], padded), _match(b[r], padded)
            if j < 0 or k < 0:
                unmatched += 1
                continue
            flows.setdefault((j, k), []).append(up[r:r + 1])
    return {"stylized": stylized, "flows": flows, "unmatched": unmatched, "tcl": kept["tcl"]}


def reference_outputs(cell: Cell, ref, style, xp: torch.Tensor, pairs) -> Dict:
    """The reference's raw stylized frames, flows of ``pairs`` and TCL values."""
    fam, mix = cell.family, cell.mix
    H, W = xp.shape[-2:]
    with torch.no_grad():
        stylized = {i: fam.ref_stylize(ref, xp[i:i + 1], style) for i in range(xp.shape[0])}
        padded = ref_tcl.pad(xp)
        flows = {}
        for s in range(0, len(pairs), RAFT_BATCH):
            part = pairs[s:s + RAFT_BATCH]
            up = ref["raft"](padded[[j for j, _ in part]], padded[[k for _, k in part]])
            flows.update({p: up[i:i + 1] for i, p in enumerate(part)})
        unit = {i: fam.tcl_space(v) for i, v in stylized.items()}
        tcl = ops_tcl(unit, flows, xp.shape[0], mix["lt_len"], H, W)
    return {"stylized": stylized, "flows": flows, "tcl": tcl}


def ops_tcl(unit: Dict, flows: Dict, n: int, lt: int, H: int, W: int,
            dtype=torch.float32) -> Tuple[float, float]:
    """TCL-ST and TCL-LT means of a clip by the reference's mask, warp and
    RMS, computed in ``dtype``: ``unit`` the stylized frames in TCL space by
    index, ``flows`` the padded upsampled flows by (j, k)."""

    def one(i, j):
        ff = ref_tcl.unpad(flows[(j, i)], H, W).to(dtype)
        bf = ref_tcl.unpad(flows[(i, j)], H, W).to(dtype)
        return float(ref_tcl.tcl(unit[i].to(dtype), unit[j].to(dtype), ff, bf))

    with torch.no_grad():
        return (float(np.mean([one(i, i - 1) for i in range(1, n)])),
                float(np.mean([one(i, i - lt) for i in range(lt, n)])))


def program_ops_tcl(cell: Cell, prog: Dict, n: int, pairs, H: int, W: int):
    """The reference's ops over the program's own stylized frames and flows
    (the first output of each frame and pair), or None where the call left
    one of them out."""
    if len(prog["stylized"]) < n or not set(pairs) <= set(prog["flows"]):
        return None
    unit = {i: cell.family.tcl_space(outs[0]) for i, outs in prog["stylized"].items()}
    return ops_tcl(unit, {p: f[0] for p, f in prog["flows"].items()}, n, cell.mix["lt_len"],
                   H, W)


def _tcl_gap(got, want) -> float:
    if want is None:
        return MISSING
    gap = max(abs(p - r) / max(abs(r), TCL_FLOOR) for p, r in zip(got, want))
    return gap if math.isfinite(gap) else MISSING


def compare(prog: Dict, ref: Dict, n_frames: int, pairs, scale: float,
            ops) -> Dict[str, float]:
    """The numbers of the check; ``ops`` is the reference ops' TCL over the
    program's own frames and flows (None where they are incomplete)."""
    sty = [(o - ref["stylized"][i]).abs().max().item() / scale
           for i, outs in prog["stylized"].items() for o in outs]
    sty_gap = max(sty) if len(prog["stylized"]) == n_frames else MISSING
    flow = [(f - ref["flows"][p]).abs().mean().item()
            for p, fl in prog["flows"].items() if p in ref["flows"] for f in fl]
    flow_max = [(f - ref["flows"][p]).abs().max().item()
                for p, fl in prog["flows"].items() if p in ref["flows"] for f in fl]
    complete = set(pairs) <= set(prog["flows"]) and not prog.get("unmatched")
    flow_gap = max(flow) if flow and complete else MISSING
    return {"stylize_gap": sty_gap, "flow_gap_px": flow_gap,
            "tcl_gap": _tcl_gap(prog["tcl"], ops),
            "tcl_gap_end_to_end": _tcl_gap(prog["tcl"], ref["tcl"]),
            "flow_gap_max_px": max(flow_max) if flow_max and complete else MISSING,
            "tcl_st": prog["tcl"][0], "tcl_lt": prog["tcl"][1]}


def _frames(clip: np.ndarray, device, fam) -> torch.Tensor:
    return fam.pipeline(torch.from_numpy(clip).to(device).permute(0, 3, 1, 2).contiguous())


def check(cell: Cell, clip: np.ndarray, kept: Dict) -> Dict[str, float]:
    """The kept call against the reference, recomputed from the seed and the clip."""
    fam, dev = cell.family, cell.device
    ref, styles = _inputs(cell, seeded.generator(cell.seed, dev))
    xp = _frames(clip, dev, fam)
    prog = program_outputs(kept, xp)
    pairs = needed_pairs(xp.shape[0], cell.mix["lt_len"])
    H, W = xp.shape[-2:]
    ops = program_ops_tcl(cell, prog, xp.shape[0], pairs, H, W)
    with tf32(False):
        refs = reference_outputs(cell, ref, styles[kept["style"]], xp,
                                 sorted(set(pairs) | set(prog["flows"])))
    return compare(prog, refs, xp.shape[0], pairs, fam.STYLIZE_SCALE, ops)


def control(cell: Cell) -> Dict[str, float]:
    """The control: the reference in the program's place, with TF32 on and
    its mask, warp and RMS in bfloat16 (the ops run no matmul, so TF32 never
    reaches them), on the first call's clip and style, against the reference
    with TF32 off and its ops in float32."""
    fam, dev = cell.family, cell.device
    gen = seeded.generator(cell.seed, dev)
    ref, styles = _inputs(cell, gen)
    clip = data.clips(gen, cell.mix["clips"], cell.mix["frames"], cell.mix["hw"])[0]
    xp = _frames(clip, dev, fam)
    pairs = needed_pairs(xp.shape[0], cell.mix["lt_len"])
    with tf32(True):
        low = reference_outputs(cell, ref, styles[0], xp, pairs)
    with tf32(False):
        refs = reference_outputs(cell, ref, styles[0], xp, pairs)
    H, W = xp.shape[-2:]
    unit = {i: fam.tcl_space(v) for i, v in low["stylized"].items()}
    n, lt = xp.shape[0], cell.mix["lt_len"]
    low = {"stylized": {i: [v] for i, v in low["stylized"].items()},
           "flows": {p: [v] for p, v in low["flows"].items()},
           "tcl": ops_tcl(unit, low["flows"], n, lt, H, W, torch.bfloat16)}
    ops = program_ops_tcl(cell, low, n, pairs, H, W)
    return compare(low, refs, n, pairs, fam.STYLIZE_SCALE, ops)
