"""Metric aggregation, copied from ``vst/core/metrics.py``: the reference
reports metric dicts with ``_mean`` / ``_mean_s{d}`` keys
(``utils/sintel_eval.py:112-130``, save_dict_as_json)."""

from __future__ import annotations

import json
import os
from typing import Dict

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
