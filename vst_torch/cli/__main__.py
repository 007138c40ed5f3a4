"""vst_torch command line, port of ``vst/cli/__main__.py`` (the benchmark
subcommands so far).

    python -m vst_torch.cli bench
    python -m vst_torch.cli bench-raft [--hw 436 1024] [--iters 5] [--out-dir DIR]

``bench`` runs ``vst_torch.bench``. ``bench-raft`` times the Sintel eval
path's RAFT pair program, forward and backward flow of one frame pair in one
call at batch 2 (``vst/eval/sintel.py:compute_raft_pair``), per variant:
``f32`` (InputPadder to multiples of 8) and ``f32_pad64`` (multiples of 64),
with the x2 / x4 direction-batch slope for ``f32``; and each variant's flow
against ``f32``'s. It prints one JSON line and writes it to
``<out-dir>/raft_timing.json``. Weights are random, from ``--seed``; every
variant gets the same weights. Float32 with TF32 off, RAFT's lookup through
the corr_lookup kernel on CUDA. Runs on CUDA unless ``--device cpu``.

Not ported yet: the bf16 variants (``bf16_enc``, ``bf16_full``,
``bf16_full_pad64``), which wait for RAFT's bf16 dtypes, and the other
subcommands.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Sequence

import numpy as np
import torch

from vst_torch import bench, set_f32_precision
from vst_torch.core.timing import windows_ms
from vst_torch.flow.raft import RAFT
from vst_torch.ops.image import InputPadder

# variant name → InputPadder multiple
RAFT_VARIANTS = {"f32": 8, "f32_pad64": 64}
SLOPE_VARIANTS = ("f32",)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


@torch.no_grad()
def bench_raft(hw: Sequence[int] = (436, 1024), raft_iters: int = 20, iters: int = 5,
               seed: int = 0, variants: Sequence[str] = tuple(RAFT_VARIANTS),
               device="cuda") -> Dict:
    """The RAFT pair benchmark; returns the results dict (``cmd_bench_raft``'s
    keys for the variants run). ``f32`` is the reference of the flow deltas
    and is always run."""
    device = torch.device(device)
    set_f32_precision()
    H, W = hw
    rng = np.random.RandomState(seed)
    img1, img2 = (torch.from_numpy(rng.rand(1, H, W, 3).astype(np.float32))
                  .permute(0, 3, 1, 2).contiguous().to(device) for _ in range(2))
    results = {"hw": [H, W], "iters": raft_iters, "device": device_name(device),
               "methodology": "pair program, best of 3 windows; CUDA events after a "
                              "synchronize on CUDA, the host clock on the CPU",
               "weights": "seeded-random (program identical to the converted-checkpoint path)"}
    flows = {}
    for name in ["f32"] + [v for v in variants if v != "f32"]:
        torch.manual_seed(seed)
        raft = RAFT(iters=raft_iters).to(device).eval()
        padder = InputPadder(img1.shape, mult=RAFT_VARIANTS[name])
        i1, i2 = padder.pad(img1, img2)
        a = torch.cat([i1, i2], 0)
        b = torch.cat([i2, i1], 0)
        flows[name] = padder.unpad(raft(a, b)[1][:1]).cpu().numpy()
        mults = (1, 2, 4) if name in SLOPE_VARIANTS else (1,)
        for mult in mults:
            am, bm = torch.cat([a] * mult, 0), torch.cat([b] * mult, 0)
            ms = min(windows_ms(lambda _: raft(am, bm)[1], am, iters)) / mult
            key = f"pair_ms_{name}" + (f"_x{mult}" if mult > 1 else "")
            results[key] = ms
            print(f"{name}" + (f" x{mult}" if mult > 1 else "")
                  + f": {ms:.1f} ms/pair (fwd+bwd batched)", flush=True)
        del raft
    mag = np.sqrt((flows["f32"] ** 2).sum(1)) + 1e-6
    for name, flow in flows.items():
        if name == "f32":
            continue
        epe = np.sqrt(((flow - flows["f32"]) ** 2).sum(1))
        results[f"{name}_vs_f32_epe_mean"] = float(epe.mean())
        results[f"{name}_vs_f32_rel_mean"] = float((epe / mag).mean())
    return results


def cmd_bench(args) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench: needs a CUDA device")
    print(json.dumps(bench.run()))


def cmd_bench_raft(args) -> None:
    results = bench_raft(args.hw, args.raft_iters, args.iters, args.seed, args.variants,
                         args.device)
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "raft_timing.json"), "w") as f:
        json.dump(results, f, indent=2, sort_keys=True)
    print(json.dumps(results))


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vst_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("bench", help="styled frames/s of FastStyleNet at 436x1024")
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("bench-raft", help="RAFT pair program timing")
    s.add_argument("--device", default="cuda")
    s.add_argument("--hw", type=int, nargs=2, default=(436, 1024))
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--out-dir", default="runs/latest")
    s.add_argument("--raft-iters", type=int, default=20)
    s.add_argument("--iters", type=int, default=5, help="timing loop length")
    s.add_argument("--variants", nargs="+", choices=tuple(RAFT_VARIANTS),
                   default=list(RAFT_VARIANTS))
    s.set_defaults(fn=cmd_bench_raft)
    return p


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
