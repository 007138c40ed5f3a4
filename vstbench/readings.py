"""The readings that a cell's limits are set from, many seeds in one process.

    python3 -m vstbench.readings --workload <cell> --seeds 1 2 3 ... [--control] [--fault NAME]

For each seed: one unit of the cell at its own size through the cell's loop
(the program's readings, every number the check computes), then with
``--control`` the control's (the reference with TF32 on in the program's
place), or with ``--fault`` the program with a fault of ``vstbench.faults``
planted. One JSON line a seed, on standard output and appended to
``chiprun_out/readings.jsonl`` when that directory exists.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    from vstbench import cell as cells

    cells.environ_for_run()
    import torch

    from vstbench.device import cards_missing
    from vstbench.faults import FAULTS

    why = cards_missing(1)
    if why:
        print(why, file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bench = cells.benchmark()
    out = "chiprun_out/readings.jsonl" if os.path.isdir("chiprun_out") else None
    for seed in args.seeds:
        row = {"workload": args.workload, "seed": seed}
        c = cells.load(args.workload, seed, 0.0, False, bench, device=torch.device("cuda", 0),
                       clock_origin=time.perf_counter)
        fault = FAULTS[args.fault]() if args.fault else contextlib.nullcontext()
        t = time.perf_counter()
        with fault:
            o = c.loop.run(c)
        row.update(program=o.numbers, fault=args.fault, seconds=time.perf_counter() - t)
        if args.control:
            t = time.perf_counter()
            row.update(control=c.loop.control(c), control_seconds=time.perf_counter() - t)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
