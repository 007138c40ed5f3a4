"""A cell of ``BENCHMARK.json`` and the files it is made of, found by name.

A cell ``<config>.<mix>`` is run from:

* ``configs/<config>.json``: the sizes as run; its ``family`` names
  ``families/<family>.py``, which builds the program's nets and the
  reference's from the seed (``reference/<family>.py``);
* ``mixes/<mix>.json``: the traffic's parameters; its ``loop`` names
  ``loops/<loop>.py``, the closed loop that drives the program;
* ``limits/<cell>.json``: the limit of each number the output check compares;
* ``metrics/<metric>.py``: one reader per per-layer metric (``read(ctx)``
  returns the value, or None when the run has nothing to read); a metric
  split by mix (``<stem>.<mix>``) may share ``metrics/<stem>.py``.

A new cell, mix or metric is a new file; no existing file changes.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def module(kind: str, name: str):
    """``vstbench/<kind>/<name>.py``, imported (``kind`` is a package)."""
    return importlib.import_module(f"vstbench.{kind}.{name}")


def metric_reader(name: str, pkg: Path = PKG) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``metrics/<name>.py`` (a metric's name may hold dots), or
    where there is none of ``metrics/<stem>.py``, ``<stem>`` the name up to
    its last dot: one reader for a quantity split by the mix, such as
    ``mfu_pct.eval`` and ``mfu_pct.train``."""
    path = pkg / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = pkg / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(f"vstbench_metric_{name.replace('.', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Check:
    """One number the output check compares, with its limit (the number
    passes when it is finite and at most the limit)."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a loop hands back once the window has closed and the check ran."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    checks: List[Check]
    peak_bytes: int
    ctx: Dict = dataclasses.field(default_factory=dict)
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)  # all the check read


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict
    mix: Dict
    limits: Dict[str, float]
    seed: int
    seconds: float
    trace: bool
    device: object = "cuda"
    setup_s: Optional[float] = None
    clock_origin: Callable[[], float] = None  # seconds since the process started

    @property
    def family(self):
        return module("families", self.config["family"])

    @property
    def loop(self):
        return module("loops", self.mix["loop"])

    def mark_setup(self) -> None:
        """Set-up ends here: the first timed unit starts next."""
        self.setup_s = self.clock_origin()

    def checks(self, values: Dict[str, float]) -> List[Check]:
        missing = sorted(set(self.limits) - set(values))
        if missing:
            raise KeyError(f"the check computed no {missing}")
        return [Check(k, float(values[k]), float(self.limits[k])) for k in self.limits]


def benchmark(root: Path = ROOT) -> Dict:
    return read_json(root / "BENCHMARK.json")


def find(workload: str, bench: Dict) -> Tuple[Dict, Dict, List[Dict], List[Dict]]:
    """(cell entry, config entry, its end-to-end metrics, its per-layer
    metrics) of ``workload``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    entry = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[entry["config"]]

    def mine(m):
        return workload in m.get("workloads", [workload])

    return (entry, config, [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)])


def load(workload: str, seed: int, seconds: float, trace: bool, bench: Dict,
         root: Path = ROOT, **overrides) -> Cell:
    entry, config, _, _ = find(workload, bench)
    pkg = root / PKG.name
    return Cell(name=workload, config=read_json(root / config["file"]),
                mix=read_json(pkg / "mixes" / f"{entry['traffic']}.json"),
                limits=read_json(pkg / "limits" / f"{workload}.json"),
                seed=seed, seconds=seconds, trace=trace, **overrides)


def cache_dirs() -> Dict[str, str]:
    """Fixed cache directories inside the checkout, for the environment."""
    base = PKG / ".cache"
    return {"TORCH_EXTENSIONS_DIR": str(base / "torch_extensions"),
            "TRITON_CACHE_DIR": str(base / "triton"),
            "PYTORCH_KERNEL_CACHE_PATH": str(base / "torch_kernels"),
            "CUDA_CACHE_PATH": str(base / "nv_compute")}


def environ_for_run() -> None:
    """Caches inside the checkout; libraries kept from loading JAX."""
    for k, v in cache_dirs().items():
        os.environ[k] = v
        os.makedirs(v, exist_ok=True)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
