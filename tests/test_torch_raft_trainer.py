"""RAFT's training at its chairs stage on the CPU: ``RAFTTrainer``
(``vst_torch.train.raft``), the unfrozen batch norm of ``vst_torch.flow.raft``,
``train-raft``, the trainer's spans and counters, and the output check of the
benchmark's cell ``raft.chairs_train``, against the frozen plain reference
``vstbench/reference/raft_train.py``.

* Trainer against reference at 2×3×128×128 with 3 iterations, seeded random
  weights from the reference's init: the loss and every parameter's gradient
  in float64 within 1e-8 relative (``test_torch_raft_train_float64.py``'s
  tolerance; measured on a CPU: the loss 2.1e-16, the worst gradient
  1.3e-14). 128 is the least side at which the reference runs: its
  ``grid_sample`` lookup divides by a level's width less 1, and at 64 the
  fourth level is 1×1 (upstream's lookup shares that).
* Two steps in float32: every parameter within twice the two steps'
  learning rates (AdamW's first steps move an element by about the
  learning rate whatever its gradient's size, so an element whose gradient
  rounding flips lands up to twice the steps' length away; measured: the
  worst element 0.70 of that), and each batch-norm running statistic's
  distance from the reference's within 1e-3 of the reference's own change
  (the second step's statistics come from weights those flips moved;
  measured 4.0e-5).
* ``_Norm('batch')`` unfrozen and in training against
  ``torch.nn.functional.batch_norm(training=True)``; a RAFT as built keeps its
  stored statistics in training mode, bit for bit as in evaluation, until
  ``unfreeze_bn``.
* ``train-raft`` for 2 steps on a FlyingChairs tree in ``tmp_path``, then 2
  more resumed from its checkpoint.
* The output check of ``raft.chairs_train`` (its limits file) passes the
  trainer and fails it with the batch norm frozen or half the batch.
"""

import contextlib
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from vst_torch.cli.__main__ import main as cli_main
from vst_torch.core import trace
from vst_torch.flow.corr import lookup_pyramid
from vst_torch.flow.io import write_flo
from vst_torch.flow.raft import RAFT, _Norm
from vst_torch.train.parity import grad_errors
from vst_torch.train.raft import RAFTTrainConfig, RAFTTrainer
from vstbench import cell as cells
from vstbench import chairs
from vstbench.loops import raft_train as loop
from vstbench.reference import raft_train as ref_rt
from vstbench.reference import seeded

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "vstbench/configs/raft.json").read_text())
PAIRS = json.loads((ROOT / "vstbench/mixes/chairs_train.json").read_text())["pairs"]
LIMITS = json.loads((ROOT / "vstbench/limits/raft.chairs_train.json").read_text())
HW, BATCH, ITERS, SEED = (128, 128), 2, 3, 1919000001
F64_RTOL = 1e-8
BN_GAP = 1e-3


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def small_cfg():
    return dict(CONFIG["raft_train"], iters=ITERS, batch_size=BATCH, image_size=list(HW))


def small_pairs():
    return dict(PAIRS, shape_px=[8, 30], move_px=10, tail_px=24, bg_move_px=5)


def pair(dtype=torch.float32, n=1):
    gen = torch.Generator().manual_seed(SEED)
    return [{k: v.to(dtype) for k, v in chairs.batch(gen, BATCH, HW, small_pairs()).items()}
            for _ in range(n)]


def both(dtype):
    """(the port's trainer, the reference's) holding the reference's weights."""
    c = small_cfg()
    ref = ref_rt.make(ITERS, seeded.generator(SEED, "cpu")).to(dtype)
    t = RAFTTrainer(RAFTTrainConfig(iters=ITERS), device="cpu", dtype=dtype,
                    lookup=lookup_pyramid)
    t.raft.load_state_dict(ref.state_dict())
    return t, ref_rt.ChairsTrainer(c, ref)


def test_trainer_matches_the_reference_in_float64():
    t, r = both(torch.float64)
    b, = pair(torch.float64)
    loss_t, metrics = t.loss(b)
    loss_r = r.loss(b)
    assert abs(loss_t.item() - loss_r.item()) <= F64_RTOL * abs(loss_r.item())
    assert 0 < float(metrics["epe"]) and 0 <= float(metrics["1px"]) <= 1
    loss_t.backward()
    loss_r.backward()
    worst, _ = grad_errors({n: p.grad for n, p in t.raft.named_parameters()},
                           {n: p.grad for n, p in r.net.named_parameters()})
    assert worst <= F64_RTOL


def test_two_float32_steps_match_the_reference():
    t, r = both(torch.float32)
    start = {n: v.clone() for n, v in r.net.state_dict().items()}
    lrs = []
    for b in pair(n=2):
        lrs.append(t.sched.get_last_lr()[0])
        t.train_iteration(b)
        r.iteration(b)
    ref_state = r.net.state_dict()
    for n, v in t.raft.state_dict().items():
        if ".running_" in n:
            assert (v - ref_state[n]).norm() <= BN_GAP * (ref_state[n] - start[n]).norm(), n
        else:
            assert (v - ref_state[n]).abs().max() <= 2 * sum(lrs), n
    assert t.step == 2 and t.sched.last_epoch == 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_unfrozen_batch_norm_is_the_functional_one(dtype):
    g = torch.Generator().manual_seed(3)
    norm = _Norm("batch", 5).to(dtype)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5, generator=g)
        norm.bias.uniform_(-1, 1, generator=g)
    norm.frozen = False
    x = torch.randn(3, 5, 7, 6, generator=g, dtype=dtype) * 2 + 1
    mean, var = norm.running_mean.clone(), norm.running_var.clone()
    want = F.batch_norm(x, mean, var, norm.weight, norm.bias, training=True, momentum=0.1,
                        eps=1e-5)
    got = norm(x)
    assert got.dtype == dtype
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(norm.running_mean, mean, rtol=0, atol=0)
    torch.testing.assert_close(norm.running_var, var, rtol=0, atol=0)
    torch.testing.assert_close(var, 0.9 + 0.1 * x.var(dim=(0, 2, 3)))  # the unbiased variance
    norm.eval()  # evaluation reads the stored statistics
    torch.testing.assert_close(norm(x), (x - mean[:, None, None]) / torch.sqrt(
        var[:, None, None] + 1e-5) * norm.weight[:, None, None] + norm.bias[:, None, None])


def test_a_built_raft_keeps_its_stored_statistics():
    torch.manual_seed(0)
    net = RAFT(iters=2, train_mode=True)
    i1, i2 = (torch.rand(2, 3, 64, 64) * 255 for _ in range(2))
    buffers = {n: b.clone() for n, b in net.named_buffers()}
    with torch.no_grad():
        _, trained = net.train()(i1, i2)
        _, evaluated = net.eval()(i1, i2)
    assert torch.equal(trained, evaluated)
    assert all(torch.equal(b, buffers[n]) for n, b in net.named_buffers())
    with torch.no_grad():
        _, unfrozen = net.train().unfreeze_bn()(i1, i2)
    assert not torch.equal(unfrozen, evaluated)
    assert not torch.equal(net.cnet.norm1.running_mean, buffers["cnet.norm1.running_mean"])


def _chairs_tree(root: Path, n=4, hw=(96, 128)):
    from PIL import Image

    rng = np.random.RandomState(0)
    (root / "data").mkdir(parents=True)
    for i in range(n):
        for k in (1, 2):
            Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
                root / "data" / f"{i:05d}_img{k}.ppm")
        write_flo(str(root / "data" / f"{i:05d}_flow.flo"),
                  (rng.randn(*hw, 2) * 3).astype(np.float32))


def test_train_raft_runs_and_resumes(tmp_path):
    _chairs_tree(tmp_path / "chairs")
    argv = ["train-raft", "--device", "cpu", "--data-dir", str(tmp_path / "chairs"),
            "--image-size", "64", "64", "--batch-size", "2", "--iters", "2", "--steps", "2",
            "--log-every", "1", "--out-dir", str(tmp_path / "run")]
    first = cli_main(argv)
    assert first["start_step"] == 0 and first["step"] == 2 and first["n_nonfinite"] == 0
    assert sorted(p.name for p in (tmp_path / "run").glob("*.pth")) == [
        "2_raft.pth", "2_train_state.pth"]
    second = cli_main(argv + ["--resume"])
    assert second["start_step"] == 2 and second["step"] == 4
    state = torch.load(tmp_path / "run" / "4_train_state.pth")
    assert state["step"] == 4 and state["scheduler"]["last_epoch"] == 4
    assert all(s["step"] == 4 for s in state["optimizer"]["state"].values())
    assert second["lr"] > first["lr"]  # OneCycle's warm-up went on
    raft = torch.load(tmp_path / "run" / "4_raft.pth")
    assert "cnet.norm1.running_mean" in raft


def test_an_iteration_records_the_train_spans_and_the_lookup_backward():
    t = RAFTTrainer(RAFTTrainConfig(iters=2), device="cpu")
    b = {"image1": torch.rand(1, 3, 64, 64) * 255, "image2": torch.rand(1, 3, 64, 64) * 255,
         "flow": torch.randn(1, 2, 64, 64), "valid": torch.ones(1, 64, 64)}
    trace.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        t.train_iteration(b)
    snap = trace.snapshot()
    trace.reset()
    names = {"vst.train.iteration", "vst.train.loss", "vst.train.backward",
             "vst.train.optimizer", "vst.corr_lookup.backward", "vst.raft.call"}
    assert names <= set(snap["spans"]) and names <= {e.name for e in prof.events()}
    assert snap["spans"]["vst.train.loss"]["parent"] == "vst.train.iteration"
    assert snap["spans"]["vst.corr_lookup.backward"]["calls"] == 2
    assert snap["counters"] == {"vst.train.iterations": 1, "vst.corr_lookup.backwards": 2}


SYNTHETIC = {"spans": {"vst.train.loss": {"device_ms": 800.0, "calls": 2},
                       "vst.train.backward": {"device_ms": 1400.0, "calls": 2},
                       "vst.train.optimizer": {"device_ms": 20.0, "calls": 4},
                       "vst.corr_lookup.backward": {"device_ms": 480.0, "calls": 24}},
             "counters": {"vst.train.iterations": 2, "vst.corr_lookup.backwards": 24}}
READERS = {"fwd_ms.raft_train": 400.0, "bwd_ms.raft_train": 700.0, "optim_ms.raft_train": 10.0,
           "lookup_bwd_ms.raft_train": 240.0, "corr_lookup_backwards.raft_train": 12.0,
           "lookup_bwd_roofline.raft_train": 100.0 * 24 * 0.139e-3 * 1e3 / 480.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_reader_of_the_cell(name):
    read = cells.metric_reader(name)
    ctx = {"program_trace": SYNTHETIC, "lookups": 24, "lookup_bwd_bound_s": 24 * 0.139e-3}
    assert read(ctx) == pytest.approx(READERS[name], rel=1e-12)
    assert read({"program_trace": {"spans": {}, "counters": {}}, "lookups": 24}) is None
    assert read({"program_trace": None}) is None and read({}) is None


@pytest.fixture(scope="module")
def check_cell():
    """The cell at the tests' size on the CPU, and the reference's readings."""
    c = cells.load("raft.chairs_train", SEED, 0.0, False, cells.benchmark(),
                   device=torch.device("cpu"))
    c.config["raft_train"].update(small_cfg())
    c.mix.update(batch=BATCH, pool=3, pairs=small_pairs())
    return c, loop.reference_readings(c)


def program(c, fault=None):
    gen = seeded.generator(c.seed, c.device)
    ref = c.family.reference_train(c.config, gen)
    batches = loop.pool(c, gen)
    with loop.FAULTS[fault]() if fault else contextlib.nullcontext():
        t = c.family.trainer(c.config, ref, c.device)
        return loop.checked(c, lambda b: t.train_iteration(b)["loss"], t.raft, t.opt, batches)


@pytest.mark.parametrize("fault", [None, "frozen_batch_norm", "half_batch"])
def test_the_output_check_passes_the_trainer_and_fails_the_faults(check_cell, fault):
    c, ref = check_cell
    numbers = loop.compare(program(c, fault), ref)
    failed = [k for k, limit in LIMITS.items() if not numbers[k] <= limit]
    assert (failed == []) == (fault is None), (fault, numbers)
    if fault == "frozen_batch_norm":
        assert numbers["bn_stats_gap"] == pytest.approx(1.0)
