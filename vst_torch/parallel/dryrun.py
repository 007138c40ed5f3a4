"""The multi-device dry run, port of ``__graft_entry__.py:dryrun_multichip``:

    python -m vst_torch.parallel.dryrun N

spawns N processes in one process group (NCCL with one CUDA device each
where the host has N of them, else gloo on the CPU) and runs vst's three
checks at vst's tiny shapes, data-parallel over the N ranks:

1. one Johnson training step at global batch N, 32², TV on;
2. ``evaluate_videos_sharded`` with the full RAFT at 2 iterations on a 32²
   synthetic clip of N + 2 frames (through the ``corr_lookup`` kernel on
   CUDA);
3. one StarGAN v2 AdvCon ``train_iteration`` with R1 and the TCL term.

Every value must be finite. Rank 0 prints vst's line; the exit code is 0
only if every rank finished.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch

RANK_TIMEOUT_S = 600


def _checks(n: int, mesh) -> str:
    from vst_torch.data.styles import load_style_images
    from vst_torch.data.synthetic import synthetic_batch
    from vst_torch.eval.sintel import SintelVideo, evaluate_videos_sharded
    from vst_torch.flow.raft import RAFT
    from vst_torch.parallel.mesh import shard_batch
    from vst_torch.train.faststyle import FastStyleConfig, FastStyleTrainer, batch_to_tensors
    from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer

    cfg = FastStyleConfig(method="johnson", emphasis=(1e0, 1e1, 1e-4), batch_size=n)
    trainer = FastStyleTrainer(cfg, load_style_images(size=64)[:1], seed=0, mesh=mesh)
    batch = batch_to_tensors(synthetic_batch(n, hw=(32, 32), n_frames=2, seed=0), "cpu")
    loss = float(trainer.train_step(shard_batch(batch, mesh), 0)["loss"])
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in the multi-device dry run")

    frames = synthetic_batch(1, hw=(32, 32), n_frames=n + 2, seed=1)["imgs"][0]
    torch.manual_seed(2)
    raft = RAFT(iters=2).to(mesh.device).eval()

    def stylize(x, sid):
        return (trainer.model(x, 1.0, sid)[1] / 255.0).clamp(0.0, 1.0)

    res = evaluate_videos_sharded([SintelVideo("dry", frames)], stylize, raft, styles=[0],
                                  mesh=mesh)
    tcl = res["TCL-ST"]["TCL-ST_mean"]
    if not np.isfinite(tcl):
        raise AssertionError("non-finite sharded-evaluation TCL in the dry run")

    cfg2 = StarGAN2Config(img_size=32, style_dim=8, latent_dim=4, num_domains=3, max_conv_dim=32,
                          lambda_tcl=100.0)
    tr2 = StarGAN2Trainer(cfg2, seed=0, mesh=mesh)
    rng = np.random.RandomState(0)

    def img(seed):
        return torch.from_numpy(np.random.RandomState(seed).rand(n, 3, 32, 32)
                                .astype(np.float32) * 2 - 1)

    gbatch = {"x_real": img(10), "x_real2": img(11), "x_ref": img(12),
              "y_org": torch.from_numpy(rng.randint(0, 3, (n,))),
              "y_trg": torch.from_numpy(rng.randint(0, 3, (n,))),
              "mask": torch.ones(n, 1, 32, 32), "flow": torch.zeros(n, 2, 32, 32)}
    metrics = tr2.train_iteration(shard_batch(gbatch, mesh))
    values = {k: float(metrics[k]) for k in ("G/latent_adv", "D/latent_reg", "G/latent_tcl")}
    for k, v in values.items():
        if not np.isfinite(v):
            raise AssertionError(f"non-finite {k} in the StarGAN v2 dry run")
    return (f"dryrun_multichip({n}): ok, loss={loss:.4f}, sharded-eval(real-RAFT) TCL={tcl:.4f}, "
            f"sg2 adv={values['G/latent_adv']:.4f} r1={values['D/latent_reg']:.4f} "
            f"tcl={values['G/latent_tcl']:.4f}")


def _rank(rank: int, n: int, init_method: str, device_type: str) -> None:
    from vst_torch import set_f32_precision
    from vst_torch.parallel.mesh import create_mesh, initialize_distributed

    import torch.distributed as dist

    torch.set_num_threads(max(1, min(4, (os.cpu_count() or 1) // n)))
    initialize_distributed(init_method, n, rank, device=device_type,
                           timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        set_f32_precision()
        devices = [f"cuda:{r}" for r in range(n)] if device_type == "cuda" else ["cpu"] * n
        line = _checks(n, create_mesh(devices=devices))
        dist.barrier()
        if rank == 0:
            print(line, flush=True)
    finally:
        dist.destroy_process_group()


def dryrun(n: int) -> int:
    """Run the checks on ``n`` spawned ranks; 0 if all of them finished."""
    device_type = "cuda" if torch.cuda.is_available() and n <= torch.cuda.device_count() else "cpu"
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'pg')}"
        procs = [ctx.Process(target=_rank, args=(r, n, init_method, device_type))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            p.join(max(deadline - time.monotonic(), 0.0))
        failed = [r for r, p in enumerate(procs) if p.is_alive() or p.exitcode != 0]
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    if failed:
        print(f"dryrun_multichip({n}): ranks {failed} failed ({device_type})", file=sys.stderr)
        return 1
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return dryrun(int(argv[0]) if argv else 8)


if __name__ == "__main__":
    sys.exit(main())
