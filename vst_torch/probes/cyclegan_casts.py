"""The bf16 E steps of the CycleGAN trainer with the parameters cast once a
loss (the trainer's ``policy.caller``, as vst's ``cast_tree``) against once a
net call (``policy.call`` at every call), on one card in one process.

    python -m vst_torch.probes.cyclegan_casts [--steps N]

cyclegan and MoGAN at 256² × 4, ngf = ndf = 64, RAFT 20 iterations (the
kernel), a seeded random batch in [−1, 1]; the two ways in turns A B B A.
Each turn: a fresh trainer, 2 iterations of warm-up, then ``N`` E steps
timed one by one with CUDA events (their median), then one more E step
under torch.profiler (``chip_smoke.profile_call``: busy share, launches).
Prints one JSON line a turn.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path


def turn(cs, variant: str, per_call: bool, steps: int, dev) -> dict:
    import torch

    from vst_torch.train import cyclegan as cg
    from vst_torch.train.policy import call, caller

    cg.caller = ((lambda nets, names, dtype: lambda name, *a: call(nets[name], dtype, *a))
                 if per_call else caller)
    try:
        raft = cs.seeded_raft(20, dev) if variant == "mogan" else None
        trainer = cg.CycleGANTrainer(cg.CycleGANConfig(variant=variant,
                                                       compute_dtype="bfloat16"),
                                     raft=raft, seed=0, device=dev)
        g = torch.Generator(device=dev).manual_seed(1)
        batch = {k: torch.rand(4, 3, 256, 256, generator=g, device=dev) * 2 - 1
                 for k in ("real_A", "real_A2", "real_B", "real_B2")}
        for i in range(2):
            trainer.train_iteration(i, batch)
        ms = []
        for _ in range(steps):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            trainer.e_step(batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        profile = cs.profile_call(lambda: trainer.e_step(batch))
    finally:
        cg.caller = caller
    return {"variant": variant, "casts": "per_call" if per_call else "per_loss",
            "e_step_ms_median": statistics.median(ms), "e_step_ms": ms,
            "busy_share": profile["busy_share"], "kernel_launches": profile["kernel_launches"],
            "profile": profile, "device": torch.cuda.get_device_name(0)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("cyclegan_casts: needs a CUDA device")
    cs.set_f32_precision()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    for variant in ("cyclegan", "mogan"):
        for per_call in (False, True, True, False):
            print(json.dumps(turn(cs, variant, per_call, args.steps, dev)), flush=True)


if __name__ == "__main__":
    main()
