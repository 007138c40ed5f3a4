"""Experiment harness, port of ``vst/train/experiments.py``
(``methods/learning-based/fs_tests.py``): ``train_net`` / ``infer_test`` and
the ``param_var`` emphasis sweep that emits a LaTeX table row (:38-49), on
synthetic batches and procedural styles when no data is given.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vst_torch.data.styles import load_style_images
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.registry import FASTSTYLE_METHODS, select_method


def train_net(method: str, emphasis: Optional[Sequence[float]] = None, sid: int = 2,
              steps: int = 50, batch_size: int = 4, hw=(64, 64), style_images=None,
              batch_iter: Optional[Iterator] = None, seed: int = 0, device="cuda"):
    """Train one config on style ``sid``; returns (trainer, loss history: one
    dict of floats a step). ``batch_iter`` yields NHWC numpy batches;
    synthetic ones (seeds ``seed``, ``seed + 1``, …) without it."""
    cfg = select_method(method, batch_size=batch_size, n_frames=3 if method == "ruder" else 2)
    if emphasis is not None:
        cfg.emphasis = tuple(emphasis)
    styles = style_images if style_images is not None else load_style_images(size=64)
    trainer = FastStyleTrainer(cfg, styles[sid:sid + 1], seed=seed, device=device)

    def default_batches():
        i = 0
        while True:
            yield synthetic_batch(batch_size, hw=hw, n_frames=cfg.n_frames, seed=seed + i)
            i += 1

    it = batch_iter or default_batches()
    history = []
    for _ in range(steps):
        metrics = trainer.train_step(batch_to_tensors(next(it), trainer.device), 0)
        history.append({k: float(v) for k, v in metrics.items()})
    return trainer, history


def infer_test(trainer: FastStyleTrainer, frames: np.ndarray,
               style_id: int = 0) -> Tuple[np.ndarray, float, float]:
    """Per-frame inference over a clip (T, H, W, 3) in [0, 1]; returns (the
    styled frames, the mean short-term and long-term consistency), the
    reference's ``infer`` summary (fast_style_transfer.py:267-390)."""
    stylize = trainer.stylize_fn()
    x = torch.from_numpy(np.ascontiguousarray(frames.transpose(0, 3, 1, 2))).to(trainer.device)
    styled = np.stack([stylize(x[i:i + 1], style_id)[0].permute(1, 2, 0).cpu().numpy()
                       for i in range(x.shape[0])])
    st = float(np.mean(np.abs(np.diff(styled, axis=0))))
    lt = float(np.mean(np.abs(styled[5:] - styled[:-5]))) if len(styled) > 5 else 0.0
    return styled, st, lt


def param_var(method: str, pos: int, values: Sequence[float], steps: int = 30, hw=(64, 64),
              seed: int = 0, device="cuda") -> Tuple[str, List]:
    """Sweep emphasis parameter ``pos`` over ``values`` (fs_tests.py:38-49):
    train each variant briefly, score its consistency on a synthetic clip,
    emit a LaTeX row of the short-term then the long-term values."""
    results = []
    for v in values:
        emphasis = list(FASTSTYLE_METHODS[method])
        emphasis[pos] = v
        trainer, _ = train_net(method, emphasis, steps=steps, hw=hw, seed=seed, device=device)
        clip = synthetic_batch(1, hw=hw, n_frames=2, seed=seed + 999)["imgs"][0]
        _, st, lt = infer_test(trainer, clip)
        results.append((st, lt))
    cst = np.asarray(results)
    flat = np.hstack((cst[:, 0], cst[:, 1]))
    return " & " + " & ".join("%.4f" % x for x in flat), results
