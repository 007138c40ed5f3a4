"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m vstbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, nets, the kernel library, inputs, one warm unit at the
cell's own shapes) is ``setup_s``, from the process's start to the first
timed unit. The cell's loop then runs units of work for ``--seconds``, the
unit in flight completing, and checks what the timed path produced against
the plain reference. The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and ``check`` last: each number compared with
its limit); the same numbers end standard error. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.

Without the cards the cell asks for, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits with 2 or 3.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "vst")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules():
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p


def result_line(cell, entry, outcome, e2e_metrics, layer_metrics, device_name) -> dict:
    from vstbench.cell import metric_reader

    metrics = {}
    if cell.trace:
        ctx = dict(outcome.ctx, setup_s=cell.setup_s)
        for m in layer_metrics:
            value = metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in e2e_metrics:
            value = cell.setup_s if m["name"] == "setup_s" else outcome.end_to_end[m["name"]]
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": entry["chips"],
              "memory_peak_bytes": outcome.peak_bytes}
    line = {"correct": bool(all(c.ok for c in outcome.checks) and outcome.failed == 0),
            "attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": device}
    if cell.trace:
        prof = outcome.ctx["profile"]
        device.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        line["breakdown"] = {"device_ops": prof["device_ops"], "idle_gaps": prof["idle_gaps"]}
    line["card"] = power_limit()
    line["check"] = {c.name: {"value": c.value, "limit": c.limit} for c in outcome.checks}
    return line


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from vstbench import cell as cells

    cells.environ_for_run()
    import torch

    from vstbench.device import cards_missing

    bench = cells.benchmark()
    entry, _, e2e_metrics, layer_metrics = cells.find(args.workload, bench)
    why = cards_missing(entry["chips"])
    if why:
        print(f"vstbench: {why}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    cell = cells.load(args.workload, args.seed, args.seconds, bool(args.trace), bench,
                      device=torch.device("cuda", 0), clock_origin=process_age)
    outcome = cell.loop.run(cell)
    bad = forbidden_modules()
    if bad:
        print(f"vstbench: modules of JAX or the JAX package are loaded: {bad}", file=sys.stderr)
        return 3
    line = result_line(cell, entry, outcome, e2e_metrics, layer_metrics,
                       torch.cuda.get_device_name(0))
    for c in outcome.checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAIL'}",
              file=sys.stderr)
    print(f"check failed_units {outcome.failed} limit 0", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
