"""The FC2 metric harness: per-task TCL / FID / LPIPS, port of
``vst/eval/fc2.py`` (``utils/metrics/eval.py:71-246``).

For every domain-pair task ``style{o}2style{t}`` (o ≠ t), ``num_outs``
fakes an eval sample:

* TCL: per sample, RMS of ``mask·(G(x2) − warp(G(x), flow))`` with the
  ground-truth flow (:137-138);
* LPIPS: the mean pairwise distance within each sample's chunk of fakes
  (:202-210);
* FID: between each task's pile of references and its pile of fakes (:213);

written to ``{TCL,LPIPS,FID}_{step:05d}_{mode}.json`` with
``<METRIC>_<mode>/<task>`` keys, ``/mean`` and the metric nets' ``/backbone``
(:223-246). The fakes stay in memory; the reference round-trips 8-bit PNGs,
which ``quantize_like_png`` reproduces (PARITY.md row 26).
"""

from __future__ import annotations

import os
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from vst_torch.core.metrics import save_json
from vst_torch.metrics.fid import InceptionV3, fid_from_activations
from vst_torch.metrics.lpips import LPIPS, lpips_pairwise
from vst_torch.ops.sample import warp


def to_nchw(a: np.ndarray) -> np.ndarray:
    """A batch's (N, H, W, C) array as (N, C, H, W)."""
    return np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2))


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """An FC2 batch (``vst_torch.data.fc2.BATCH_KEYS``, NHWC numpy) as NCHW
    tensors on ``device``; the labels stay numpy, as the drivers branch on
    them on the host."""
    out = {k: torch.from_numpy(to_nchw(batch[k])).to(device)
           for k in ("x_src", "x2_src", "mask", "flow")}
    out.update(y_src=np.asarray(batch["y_src"]), y_ref=np.asarray(batch["y_ref"]),
               x_ref=to_nchw(batch["x_ref"]))
    return out


def calculate_metrics(style_fn: Callable, eval_batches: Iterable[Dict[str, np.ndarray]],
                      num_domains: int, mode: str = "latent", num_outs_per_domain: int = 10,
                      step: int = 0, out_dir: Optional[str] = None,
                      inception: Optional[InceptionV3] = None, lpips: Optional[LPIPS] = None,
                      rng_seed: int = 0, quantize_like_png: bool = True,
                      deterministic: bool = False, device="cuda"):
    """``style_fn(x_real, y_trg, mode, rng, x_ref) → x_fake``, NCHW tensors on
    ``device`` in [−1, 1], ``y_trg`` a long tensor, ``rng`` a seeded
    ``torch.Generator`` on ``device`` (each fake pair of a round gets two
    generators of one seed, so both frames draw the same style, as vst's
    shared key does); in ``reference`` mode the style comes from ``x_ref``
    (``eval.py:128``). ``deterministic=True`` declares that ``style_fn``
    ignores ``rng``: every fake of a chunk is then the same, within-chunk
    LPIPS is 0 by construction, and it is skipped with a note."""
    if mode not in ("latent", "reference"):
        raise ValueError(f"mode {mode!r}: 'latent' or 'reference'")
    device = torch.device(device)
    inception = inception or InceptionV3(seed=0, device=device)
    lpips = lpips or LPIPS(seed=0, device=device)

    tasks = []
    for d in range(1, num_domains):
        tasks += [f"style02style{d}", f"style{d}2style0"]
    tcl_vals: Dict[str, List[float]] = {t: [] for t in tasks}
    fakes: Dict[str, List[np.ndarray]] = {t: [] for t in tasks}
    refs: Dict[str, List[np.ndarray]] = {t: [] for t in tasks}
    chunk_ids: Dict[str, List[int]] = {t: [] for t in tasks}  # num_outs fakes a sample
    seeds = np.random.RandomState(rng_seed)

    def generator(seed):
        return torch.Generator(device=device).manual_seed(seed)

    sample_counter = 0
    with torch.no_grad():
        for batch in eval_batches:
            b = batch_to_device(batch, device)
            y_org, y_trg = b["y_src"], b["y_ref"]
            y_dev = torch.from_numpy(y_trg.astype(np.int64)).to(device)
            x_ref_dev = torch.from_numpy(b["x_ref"]).to(device)
            N = y_org.shape[0]
            for j in range(num_outs_per_domain):
                seed = int(seeds.randint(2 ** 31))
                x_fake = style_fn(b["x_src"], y_dev, mode, generator(seed), x_ref_dev)
                x_fake2 = style_fn(b["x2_src"], y_dev, mode, generator(seed), x_ref_dev)
                err = (b["mask"] * (x_fake2 - warp(x_fake, b["flow"]))) ** 2
                tcl = torch.sqrt(torch.mean(err, dim=(1, 2, 3))).cpu().numpy()
                xf = x_fake.cpu().numpy()
                if quantize_like_png:  # the reference writes the fakes as 8-bit PNGs
                    xf01 = np.clip((xf + 1) / 2, 0, 1)
                    xf = (np.round(xf01 * 255) / 255 * 2 - 1).astype(np.float32)
                for k in range(N):
                    if y_org[k] == y_trg[k]:
                        continue
                    task = f"style{y_org[k]}2style{y_trg[k]}"
                    if task not in tcl_vals:
                        continue
                    tcl_vals[task].append(float(tcl[k]))
                    fakes[task].append(xf[k])
                    chunk_ids[task].append(sample_counter + k)
                    if j == 0:
                        refs[task].append(b["x_ref"][k])
            sample_counter += N

    tcl_dict, lpips_dict, fid_dict = OrderedDict(), OrderedDict(), OrderedDict()
    for task in tasks:
        if not fakes[task]:
            continue
        tcl_dict[f"TCL_{mode}/{task}"] = float(np.mean(tcl_vals[task]))
        if not deterministic:
            by_sample: Dict[int, List[np.ndarray]] = {}
            for img, sid in zip(fakes[task], chunk_ids[task]):
                by_sample.setdefault(sid, []).append(img)
            lp_vals = [lpips_pairwise(lpips, [im[None] for im in group])
                       for group in by_sample.values() if len(group) > 1]
            if lp_vals:
                lpips_dict[f"LPIPS_{mode}/{task}"] = float(np.mean(lp_vals))
        fid_dict[f"FID_{mode}/{task}"] = fid_from_activations(
            inception(np.stack(refs[task])), inception(np.stack(fakes[task])))

    if deterministic:
        lpips_dict[f"LPIPS_{mode}/note"] = (
            "skipped: generator is deterministic in (x, y) — every fake in "
            "a sample's chunk is identical, so within-chunk pairwise LPIPS "
            "is degenerate-by-construction (no diversity to measure)")
    backbones = {"LPIPS": getattr(lpips, "backbone", "random-he"),
                 "FID": getattr(inception, "backbone", "random-he")}
    for d, name in ((lpips_dict, "LPIPS"), (fid_dict, "FID"), (tcl_dict, "TCL")):
        nums = [v for k, v in d.items() if not k.endswith("/mean") and isinstance(v, float)]
        if nums:
            d[f"{name}_{mode}/mean"] = float(np.mean(nums))
            if name in backbones:  # "random-he" numbers are a pipeline test
                d[f"{name}_{mode}/backbone"] = backbones[name]
        if out_dir:
            save_json(d, os.path.join(out_dir, f"{name}_{step:05d}_{mode}.json"),
                      aggregate=False)
    return {"TCL": tcl_dict, "LPIPS": lpips_dict, "FID": fid_dict}
