"""Shared set-up of the data-parallel tests (``tests/test_torch_parallel.py``,
``tests/test_torch_eval_sharded.py``): gloo ranks spawned on the CPU, and
each trainer's step run on one global batch either whole (world size 1, no
mesh) or sharded over the ranks of a mesh.

This module imports torch and vst_torch only: the spawned ranks import it,
and none of them needs JAX.

Each rank joins its group through a ``file://`` store in the test's
``tmp_path`` (so xdist workers never share a port) with a 60 s timeout, and
:func:`spawn` joins every rank with a timeout, so a hung collective fails
the test instead of holding the suite.
"""

from __future__ import annotations

import multiprocessing
from datetime import timedelta
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vst_torch.data.fc2 import synthetic_fc2_batches
from vst_torch.data.styles import load_style_images
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.eval.sintel import SintelVideo, evaluate_videos_sharded
from vst_torch.flow.raft import RAFT
from vst_torch.parallel.mesh import (Mesh, create_mesh, initialize_distributed, local_rows,
                                     replicate)
from vst_torch.train.cyclegan import CycleGANConfig, CycleGANTrainer, cyclegan_batch, fc2_to_cyclegan
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.parity import CYCLEGAN_SMALL, STARGAN2_SMALL, STARGAN_SMALL, stub_flow
from vst_torch.train.registry import select_method
from vst_torch.train.stargan import StarGANConfig, StarGANTrainer
from vst_torch.train.stargan2 import EMA_NETS, StarGAN2Config, StarGAN2Trainer, gan_batch

GROUP_TIMEOUT = timedelta(seconds=60)
JOIN_TIMEOUT_S = 240
RANK_THREADS = 2
HW = (32, 32)
GLOBAL_BATCH = 2  # one sample a rank, as vst's tests one a device
VST_BATCH = 8  # vst's sharded Johnson step (tests/test_train_faststyle.py:74)
# each trainer's Adam rate, for vst's flip budget (|Δ| ≤ 2·lr an element)
LR = {"johnson": 1e-3, "stargan": 1e-4, "stargan2": 1e-4, "cyclegan": 2e-4, "mogan": 2e-4,
      "congan": 2e-4}


def _rank_main(rank: int, n: int, store: str, out: str, fn: Callable, args) -> None:
    torch.set_num_threads(RANK_THREADS)
    initialize_distributed(f"file://{store}", n, rank, device="cpu", timeout=GROUP_TIMEOUT)
    try:
        result = fn(create_mesh(devices=["cpu"] * n), *args)
        torch.save(result, out)
    finally:
        torch.distributed.destroy_process_group()


def spawn(fn: Callable, n: int, tmp_path, *args, meanwhile: Callable = lambda: None) -> Tuple:
    """``fn(mesh, *args)`` on ``n`` spawned gloo ranks, and ``meanwhile()``
    in this process while they run: (each rank's result in rank order,
    ``meanwhile()``'s). A rank that fails or outlives ``JOIN_TIMEOUT_S``
    fails the call."""
    ctx = multiprocessing.get_context("spawn")
    store = str(tmp_path / f"pg_{fn.__name__}")
    outs = [str(tmp_path / f"{fn.__name__}_rank{r}.pt") for r in range(n)]
    procs = [ctx.Process(target=_rank_main, args=(r, n, store, outs[r], fn, args))
             for r in range(n)]
    for p in procs:
        p.start()
    try:
        here = meanwhile()
        for p in procs:
            p.join(JOIN_TIMEOUT_S)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT_S} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * n, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [torch.load(o, weights_only=False) for o in outs], here


# -- the trainers' steps -----------------------------------------------------------------

def _grads(named: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": p.grad.detach().double().clone() for k, net in named.items()
            for n, p in net.named_parameters() if p.grad is not None}


def _params(named: Dict[str, torch.nn.Module]) -> Dict[str, torch.Tensor]:
    return {f"{k}.{n}": t.detach().clone() for k, net in named.items()
            for n, t in net.state_dict().items()}


def _floats(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in metrics.items()}


def johnson_step(mesh, dtype, batch_size=GLOBAL_BATCH, seed=2):
    """One Johnson step (TV on, vst's 1e-4) on ``batch_size`` synthetic
    pairs at 32² (seed ``seed``), the trainer seeded 0."""
    trainer = FastStyleTrainer(select_method("johnson", batch_size=batch_size),
                               load_style_images(size=64)[:1], seed=0, device="cpu", mesh=mesh)
    trainer.to_dtype(dtype)
    batch = batch_to_tensors(synthetic_batch(batch_size, hw=HW, n_frames=2, seed=seed), "cpu")
    metrics = trainer.train_step({k: local_rows(v, mesh).to(dtype) for k, v in batch.items()})
    nets = {"model": trainer.model}
    return {"metrics": _floats(metrics), "grads": _grads(nets), "params": _params(nets)}


def stargan_step(mesh, dtype):
    """StarGAN v1's D step (α drawn by the trainer for the global batch)
    and G step at ``STARGAN_SMALL``."""
    trainer = StarGANTrainer(StarGANConfig(**STARGAN_SMALL), seed=0, device="cpu", mesh=mesh)
    trainer.G.to(dtype)
    trainer.D.to(dtype)
    b = gan_batch(synthetic_fc2_batches(1, GLOBAL_BATCH, hw=HW, num_dom=STARGAN_SMALL["c_dim"],
                                        seed=1)[0], "cpu")
    x = local_rows(b["x_real"], mesh).to(dtype)
    c_org, c_trg = (local_rows(torch.nn.functional.one_hot(b[k], STARGAN_SMALL["c_dim"]),
                               mesh).to(dtype) for k in ("y_org", "y_trg"))
    metrics = trainer.d_step(x, c_org, c_trg)
    grads = _grads({"D": trainer.D})
    metrics.update(trainer.g_step(x, c_org, c_trg))
    grads.update(_grads({"G": trainer.G}))
    return {"metrics": _floats(metrics), "grads": grads,
            "params": _params({"G": trainer.G, "D": trainer.D})}


def _stargan2(mesh, dtype):
    trainer = StarGAN2Trainer(StarGAN2Config(**STARGAN2_SMALL), seed=0, device="cpu", mesh=mesh)
    for net in (*trainer.nets.values(), *trainer.ema.values()):
        net.to(dtype)
    b = gan_batch(synthetic_fc2_batches(1, GLOBAL_BATCH, hw=HW,
                                        num_dom=STARGAN2_SMALL["num_domains"], seed=1)[0], "cpu")
    return trainer, {k: local_rows(v, mesh).to(dtype) if v.is_floating_point()
                     else local_rows(v, mesh) for k, v in b.items()}


def stargan2_steps(mesh, dtype):
    """StarGAN v2's latent D and G steps (AdvCon; one update each, as vst's
    ``tests/test_gan_multichip.py:115``) with the global batch's latents,
    this rank's rows: the metrics, the gradients and the parameters."""
    trainer, b = _stargan2(mesh, dtype)
    n = b["x_real"].shape[0] * (1 if mesh is None else mesh.size)
    z = local_rows(trainer.draw_latents(n)[0], mesh).to(dtype)
    metrics = trainer.d_step("latent", b["x_real"], b["y_org"], b["y_trg"], z, b["x_ref"])
    grads = _grads({"disc": trainer.nets["disc"]})
    metrics.update({f"G/{k}": v for k, v in
                    trainer.g_step("latent", True, {**b, "z": z}).items()})
    grads.update(_grads({k: trainer.nets[k] for k in EMA_NETS}))
    return {"metrics": _floats(metrics), "grads": grads, "params": _params(trainer.nets)}


def cyclegan_e_step(mesh, dtype, variant):
    """One E step of ``variant`` at ``CYCLEGAN_SMALL`` (stub flow), its pools'
    draws made by the trainer for the global batch."""
    temporal = variant in ("mogan", "congan")
    trainer = CycleGANTrainer(CycleGANConfig(variant=variant, **CYCLEGAN_SMALL),
                              raft=stub_flow if temporal else None, seed=0, device="cpu",
                              mesh=mesh)
    for net in trainer.nets.values():
        net.to(dtype)
    fc2 = [synthetic_fc2_batches(1, GLOBAL_BATCH, hw=HW, num_dom=2, seed=s)[0] for s in (1, 101)]
    batch = cyclegan_batch(fc2_to_cyclegan(*fc2), "cpu")
    metrics = trainer.e_step({k: local_rows(v, mesh).to(dtype) for k, v in batch.items()})
    nets = {k: trainer.nets[k] for g in ("G", "D") for k in trainer.groups[g]}
    return {"metrics": _floats(metrics), "grads": _grads(nets), "params": _params(nets)}


def _step(case: str, mesh, dtype):
    if case == "johnson":
        return johnson_step(mesh, dtype)
    if case == "stargan":
        return stargan_step(mesh, dtype)
    if case == "stargan2":
        return stargan2_steps(mesh, dtype)
    return cyclegan_e_step(mesh, dtype, case)


CASES = ("johnson", "stargan", "stargan2", "cyclegan", "mogan", "congan")


def trainer_cases(mesh) -> Dict[str, Dict[str, Dict]]:
    """Every case in float64 (gradients) and float32 (losses, parameters) on
    ``mesh`` (None: world size 1 on the global batch)."""
    with torch.random.fork_rng(devices=[]):
        return {case: {"f64": _step(case, mesh, torch.float64),
                       "f32": _step(case, mesh, torch.float32)} for case in CASES}


def params_within_flip_budget(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
                              lr: float, flip_budget: float = 0.002) -> None:
    """vst's check of a sharded step's parameters
    (``tests/test_gan_multichip.py:25-35``): elements outside rtol 5e-3,
    atol 2e-4 at most ``flip_budget`` of all, each within 2·lr (Adam's first
    step turns a reduction-order sign flip of a ~0 gradient into ±lr)."""
    assert set(got) == set(want)
    n_bad = n_tot = 0
    for k, w in want.items():
        a, b = w.double().numpy(), got[k].double().numpy()
        close = np.isclose(a, b, rtol=5e-3, atol=2e-4)
        n_bad += int((~close).sum())
        n_tot += close.size
        assert np.abs(a - b).max() <= 2 * lr + 1e-6, k
    assert n_bad / n_tot <= flip_budget, f"{n_bad}/{n_tot} elements differ"


def cpu_mesh(size: int, rank: int) -> Mesh:
    """A mesh's view for ``rank`` of ``size`` without a process group: the
    sharding arithmetic only (no collective)."""
    return Mesh(size, rank, torch.device("cpu"))


# -- what the ranks of tests/test_torch_parallel.py run ---------------------------------

def parallel_ranks(mesh):
    """What each spawned rank runs: every trainer case, Johnson at vst's
    batch of 8, and ``replicate`` of rank-dependent nets and Adam state."""
    out = trainer_cases(mesh)
    out["johnson_vst"] = johnson_step(mesh, torch.float64, batch_size=VST_BATCH)
    out["replicated"] = replicated(mesh)
    return out


def rank_state(rank: int):
    """A net and an Adam that took one step, both seeded by ``rank``."""
    torch.manual_seed(10 + rank)
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.InstanceNorm2d(4, affine=True))
    opt = torch.optim.Adam(net.parameters(), lr=1e-3)
    net(torch.randn(2, 3, 8, 8)).square().mean().backward()
    opt.step()
    return net, opt


def state_of(net, opt):
    return {**{f"net.{k}": v.clone() for k, v in net.state_dict().items()},
            **{f"opt.{i}.{k}": v.clone() for i, s in enumerate(opt.state.values())
               for k, v in s.items()}}


def replicated(mesh):
    net, opt = rank_state(mesh.rank)
    replicate([net, opt], mesh)
    return state_of(net, opt)


# -- the sharded Sintel evaluation ---------------------------------------------------------

def stub_stylize(img, style):
    """vst's stand-in stylizer (``tests/test_eval_sintel.py:135-136``)."""
    return (img * (1.0 + 0.1 * style)).clamp(0.0, 1.0)


def eval_cases(mesh, frames: np.ndarray, raft_state: Dict[str, torch.Tensor]):
    """``evaluate_videos_sharded`` on one clip, styles (0, 1), with the stub
    flow and with the full RAFT (2 iterations) carrying ``raft_state``."""
    raft = RAFT(iters=2).eval()
    raft.load_state_dict(raft_state)
    videos = [SintelVideo("toy", frames)]
    return {"stub": evaluate_videos_sharded(videos, stub_stylize, stub_flow, [0.0, 1.0], mesh),
            "raft": evaluate_videos_sharded(videos, stub_stylize, raft, [0.0, 1.0], mesh)}
