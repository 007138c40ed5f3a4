"""Metrics, copied from ``vst/core/metrics.py``: the reference reports metric
dicts with ``_mean`` / ``_mean_s{d}`` keys (``utils/sintel_eval.py:112-130``,
save_dict_as_json), and training logs its scalars step by step (in place of
the reference's losses.txt / loss_list.npy / TensorBoard scalars)."""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

import numpy as np


def aggregate_means(data: Dict[str, float], num_styles: int = 3) -> Dict[str, float]:
    """Add ``_mean`` and per-style ``_mean_s{d}``; keys are
    ``"<video>_s<d>"`` and per-style means group by the trailing tag."""
    out = dict(data)
    values = list(data.values())
    if values:
        out["_mean"] = float(np.mean(values))
    for d in range(1, num_styles + 1):
        sv = [v for k, v in data.items() if k.endswith(f"_s{d}")]
        if sv:
            out[f"_mean_s{d}"] = float(np.mean(sv))
    return out


def save_json(data: Dict, path: str, num_styles: int = 3, aggregate: bool = True) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    if aggregate:
        data = aggregate_means(data, num_styles)
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)


class MetricsLogger:
    """Append-per-step scalar logger: an in-memory history, mirrored to a
    text file (one line per ``log`` call) and dumped as a .npy curve."""

    def __init__(self, log_path: Optional[str] = None):
        self.log_path = log_path
        self.history: List[Dict[str, float]] = []
        self._t0 = time.time()
        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)

    def log(self, step: int, **scalars: float) -> None:
        rec = {"step": step, "elapsed_s": time.time() - self._t0}
        rec.update({k: float(v) for k, v in scalars.items()})
        self.history.append(rec)
        if self.log_path:
            line = f"[{rec['elapsed_s']:.1f}s] step {step} " + " ".join(
                f"{k}: {v:.6g}" for k, v in scalars.items())
            with open(self.log_path, "a") as f:
                f.write(line + "\n")

    def save_curves(self, path: str) -> None:
        """(log calls, step + scalars) as a float array, in the history's key
        order without the elapsed time."""
        if not self.history:
            return
        keys = [k for k in self.history[0] if k != "elapsed_s"]
        np.save(path, np.array([[h.get(k, np.nan) for k in keys] for h in self.history]))
