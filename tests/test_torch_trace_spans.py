"""The port's spans and counters (``vst_torch.core.trace``) and the
benchmark's readers of them (``vstbench/program_trace.py``,
``vstbench/metrics/``), on the CPU:

* with no profiler running, ``span`` and ``count`` touch neither
  ``record_function`` nor a CUDA event and record nothing;
* under ``torch.profiler``, nested spans give their calls, host time and
  parent, counters add up, and every span is an event of the profiler's own;
* the Sintel harness (``eval-sintel`` at 32×48 under ``VST_PROFILE_DIR``),
  RAFT, ``stylize_frames`` and a StarGAN v2 iteration record the spans and
  counters a hand count of their code gives;
* each new per-layer metric's reader gives its value from a synthetic
  snapshot and None from an empty one.

A ``cuda``-marked test runs each cell of ``BENCHMARK.json`` once, small, on
the card with ``--trace 1``'s readers, and holds ``corr_lookup``'s launch
counter to the benchmark's own count of the lookups of the profiled call
(``python -m pytest --noconftest tests/test_torch_trace_spans.py -q -m
cuda``; skips without a card).
"""

import time

import numpy as np
import pytest
import torch

from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import stylize_frames
from vst_torch.core import trace
from vst_torch.data.fc2 import synthetic_fc2_batches
from vst_torch.flow.raft import RAFT
from vst_torch.train.stargan2 import StarGAN2Config, StarGAN2Trainer, gan_batch
from vstbench import cell as cells

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean_registry():
    trace.reset()
    yield
    trace.reset()


def profiled(fn):
    """(fn(), the profiler's event names) with a CPU profiler running."""
    with torch.profiler.profile(activities=CPU) as prof:
        out = fn()
    return out, {e.name for e in prof.events()}


def test_off_records_nothing_and_touches_no_profiler_or_event(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with no profiler running")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with trace.span("vst.test.outer") as outer:
            with trace.span("vst.test.inner") as inner:
                trace.count("vst.test.n", 5)
        assert outer is inner  # one shared object: nothing allocated a call
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_nested_spans_under_the_profiler():
    def work():
        with trace.span("vst.test.outer"):
            for k in range(2):
                with trace.span("vst.test.inner"):
                    time.sleep(0.01)
                    trace.count("vst.test.n", k + 1)
            trace.count("vst.test.calls")

    _, names = profiled(work)
    snap = trace.snapshot()
    outer, inner = snap["spans"]["vst.test.outer"], snap["spans"]["vst.test.inner"]
    assert (outer["calls"], outer["parent"]) == (1, None)
    assert (inner["calls"], inner["parent"]) == (2, "vst.test.outer")
    assert 20.0 <= inner["host_ms"] <= outer["host_ms"]
    assert inner["device_ms"] is None and outer["self_device_ms"] is None  # no card
    assert snap["counters"] == {"vst.test.n": 3, "vst.test.calls": 1}
    assert {"vst.test.outer", "vst.test.inner"} <= names
    trace.reset()
    assert trace.snapshot() == {"spans": {}, "counters": {}}


def test_a_span_closes_when_its_block_raises():
    def work():
        with pytest.raises(ValueError):
            with trace.span("vst.test.raises"):
                raise ValueError("inside")
        with trace.span("vst.test.after"):
            pass

    profiled(work)
    spans = trace.snapshot()["spans"]
    assert spans["vst.test.raises"]["calls"] == 1
    assert spans["vst.test.after"]["parent"] is None  # the stack was popped


def test_eval_sintel_counts_by_hand(tmp_path, monkeypatch):
    """The README's CPU run under ``VST_PROFILE_DIR``, with DT chains of 2:
    the synthetic clip (8 frames, its exact flows, so no RAFT) for 3 styles."""
    monkeypatch.setenv("VST_PROFILE_DIR", str(tmp_path / "prof"))
    cli_main(["eval-sintel", "--device", "cpu", "--hw", "32", "48", "--raft-iters", "2",
              "--dt-iters", "2", "--out-dir", str(tmp_path / "out")])
    n, styles, lt, dt = 8, 3, 5, 2
    pairs = (n - 1) + (n - lt)  # ST pairs from frame 1, LT pairs from frame lt
    snap = trace.snapshot()
    assert snap["counters"] == {
        "vst.eval.frames_scored": styles * (n - 1),
        # warm-up 2 a style; a DT call and 2 chains of dt; each frame of the pairs once
        "vst.eval.stylize_calls": styles * (2 + 1 + 2 * dt + n),
        # each pair takes both frames; the store gives all but the first take of each
        "vst.eval.stylize_reuses": styles * (2 * pairs - n),
        # warm-up 2 a style; the DT call's sum; one TCL value a pair
        "vst.eval.host_reads": styles * (2 + 1 + pairs)}
    spans = snap["spans"]
    assert spans["vst.eval.call"]["calls"] == 1 and spans["vst.eval.call"]["parent"] is None
    assert {k: (v["calls"], v["parent"]) for k, v in spans.items() if k != "vst.eval.call"} == {
        "vst.eval.upload": (2, "vst.eval.call"),  # the warm-up frame, the clip
        "vst.eval.dt": (styles, "vst.eval.call"),
        "vst.eval.ops": (styles * pairs, "vst.eval.call")}


def test_raft_records_its_call_and_three_stages():
    """And the GRU's span once an iteration inside the update loop."""
    torch.manual_seed(0)
    raft = RAFT(iters=2).eval()
    x = torch.rand(1, 3, 64, 64) * 255
    with torch.no_grad():
        _, names = profiled(lambda: raft(x, x))
    snap = trace.snapshot()
    stages = ("vst.raft.encode", "vst.raft.corr", "vst.raft.update")
    assert {k: (v["calls"], v["parent"]) for k, v in snap["spans"].items()} == {
        "vst.raft.call": (1, None), **{s: (1, "vst.raft.call") for s in stages},
        "vst.raft.gru": (2, "vst.raft.update")}
    assert sum(snap["spans"][s]["host_ms"] for s in stages) <= snap["spans"]["vst.raft.call"][
        "host_ms"]
    assert snap["spans"]["vst.raft.gru"]["host_ms"] <= snap["spans"]["vst.raft.update"]["host_ms"]
    assert {"vst.raft.call", "vst.raft.gru", *stages} <= names
    assert snap["counters"] == {}  # the plain lookup and GRU on the CPU launch no kernel


@pytest.mark.parametrize("frames,batch", [(4, 2), (3, 1), (5, 2)])
def test_stylize_frames_counts_its_copies(frames, batch):
    h, w = 8, 12
    clip = np.random.RandomState(0).rand(frames, h, w, 3).astype(np.float32)
    (out, _), names = profiled(lambda: stylize_frames(lambda x: x * 2.0, clip, batch,
                                                       torch.float32, torch.device("cpu")))
    np.testing.assert_array_equal(out, clip * 2.0)
    chunks = -(-frames // batch)
    frame_bytes = h * w * 3 * 4
    snap = trace.snapshot()
    # up: every chunk, the tail padded to the batch; down: the frames alone
    assert snap["counters"] == {"vst.stream.frames": frames,
                                "vst.stream.pageable_bytes": (chunks * batch + frames)
                                * frame_bytes}
    if frames % batch == 0:
        assert snap["counters"]["vst.stream.pageable_bytes"] == 2 * frame_bytes * frames
    assert {k: (v["calls"], v["parent"]) for k, v in snap["spans"].items()} == {
        "vst.stream.call": (1, None), "vst.stream.upload": (chunks, "vst.stream.call"),
        "vst.stream.download": (chunks, "vst.stream.call")}
    assert {"vst.stream.call", "vst.stream.upload", "vst.stream.download"} <= names


def test_a_stargan2_iteration_records_every_train_span():
    cfg = StarGAN2Config(img_size=32, style_dim=8, latent_dim=4, num_domains=3,
                         max_conv_dim=32, lambda_tcl=100.0)
    trainer = StarGAN2Trainer(cfg, seed=1, device="cpu")
    batch = gan_batch(synthetic_fc2_batches(1, 2, hw=(32, 32), num_dom=3, seed=2)[0], "cpu")
    profiled(lambda: trainer.train_iteration(batch))
    snap = trace.snapshot()
    assert {k: (v["calls"], v["parent"]) for k, v in snap["spans"].items()} == {
        "vst.train.iteration": (1, None),
        "vst.train.d_loss": (2, "vst.train.iteration"),
        "vst.train.g_loss": (2, "vst.train.iteration"),
        "vst.train.backward": (4, "vst.train.iteration"),
        "vst.train.optimizer": (8, "vst.train.iteration"),  # before and after each backward
        "vst.train.ema": (1, "vst.train.iteration")}
    assert snap["counters"] == {"vst.train.iterations": 1}


def _span(device_ms, host_ms=0.0):
    return {"calls": 1, "host_ms": host_ms, "device_ms": device_ms,
            "self_device_ms": device_ms, "parent": None}


SYNTHETIC = {
    "spans": {"vst.raft.encode": _span(760.0), "vst.raft.corr": _span(95.0),
              "vst.raft.update": _span(2660.0), "vst.raft.gru": _span(760.0),
              "vst.eval.ops": _span(38.0),
              "vst.eval.upload": _span(1.0, host_ms=114.0),
              "vst.stream.upload": _span(0.5, host_ms=40.0), "vst.stream.download": _span(125.0),
              "vst.train.d_loss": _span(700.0), "vst.train.g_loss": _span(1100.0),
              "vst.train.backward": _span(1300.0), "vst.train.optimizer": _span(300.0),
              "vst.train.ema": _span(20.0)},
    "counters": {"vst.eval.frames_scored": 19, "vst.eval.stylize_calls": 96,
                 "vst.eval.stylize_reuses": 33,
                 "vst.eval.host_reads": 37, "vst.corr_lookup.launches": 380,
                 "vst.gru.launches": 1520,
                 "vst.stream.frames": 50, "vst.stream.pageable_bytes": 535756800,
                 "vst.train.iterations": 2}}

READERS = {
    "raft_encode_ms.eval": 760.0 / 19, "raft_corr_ms.eval": 95.0 / 19,
    "raft_update_ms.eval": 2660.0 / 19, "tcl_ops_ms.eval": 38.0 / 19,
    "upload_ms.eval": 114.0 / 19, "stylize_calls.eval": 96 / 19, "host_reads.eval": 37 / 19,
    "stylize_reuses.eval": 33 / 19,
    "corr_lookup_launches.eval": 20.0, "raft_gru_ms.eval": 760.0 / 19,
    "gru_launches.eval": 80.0, "upload_ms.stream": 40.0 / 50,
    "download_ms.stream": 125.0 / 50, "pageable_bytes.stream": 10.715136,
    "fwd_ms.train": 900.0, "bwd_ms.train": 650.0, "optim_ms.train": 160.0}


@pytest.mark.parametrize("name", sorted(READERS))
def test_each_new_reader_reads_a_synthetic_snapshot(name):
    read = cells.metric_reader(name)
    assert read({"program_trace": SYNTHETIC}) == pytest.approx(READERS[name], rel=1e-12)
    assert read({"program_trace": {"spans": {}, "counters": {}}}) is None
    assert read({"program_trace": None}) is None  # a program without the registry
    assert read({}) is None  # a run with no profiled sub-window


def test_every_new_reader_is_a_metric_of_the_benchmark():
    per_layer = {m["name"]: m for m in cells.benchmark()["per_layer"]}
    assert set(READERS) <= set(per_layer)
    assert {per_layer[n]["source"] for n in READERS} == {"program_span", "program_counter"}


def test_the_live_snapshot_is_read_once_a_result_line():
    """A ``--trace 1`` ctx (one with the loop's ``profile``) takes the
    program's snapshot at the first reader and keeps it for the others."""
    profiled(lambda: [trace.count("vst.stream.frames", 4),
                      trace.count("vst.stream.pageable_bytes", 8_000_000)])
    ctx = {"profile": {"busy_s": 1.0}}
    assert cells.metric_reader("pageable_bytes.stream")(ctx) == 2.0
    trace.reset()
    assert cells.metric_reader("pageable_bytes.stream")(ctx) == 2.0
    assert ctx["program_trace"]["counters"]["vst.stream.frames"] == 4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the corr_lookup kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


SMALL = {"eval": dict(frames=8, hw=[256, 512]), "stream": dict(host_frames=8, sample=4),
         "train": dict(batch=4, pool=4)}


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["johnson.sintel_tcl", "johnson.stream",
                                      "stargan2.train_advcon"])
def test_a_traced_run_reads_every_new_metric_on_the_card(card, workload):
    bench = cells.benchmark()
    c = cells.load(workload, 2 ** 32 + 5, 0.0, True, bench, device=card,
                   clock_origin=time.perf_counter)
    c.mix.update(SMALL[c.mix["loop"]])
    outcome = c.loop.run(c)
    ctx = dict(outcome.ctx)
    mine = [m["name"] for m in bench["per_layer"]
            if m["name"] in READERS and workload in m["workloads"]]
    values = {name: cells.metric_reader(name)(ctx) for name in mine}
    assert mine and None not in values.values(), values
    counters = ctx["program_trace"]["counters"]
    if c.mix["loop"] == "eval":
        assert counters["vst.eval.frames_scored"] == c.mix["frames"] - 1
        assert counters["vst.corr_lookup.launches"] == ctx["lookups"] > 0
        # each iteration's lookup, and gru_zr and gru_q for each of its 2 passes
        assert counters["vst.gru.launches"] == 4 * ctx["lookups"]
    if c.mix["loop"] == "stream":
        h, w = c.mix["hw"]
        assert values["pageable_bytes.stream"] == pytest.approx(2 * h * w * 3 * 4 / 1e6,
                                                                rel=1e-12)
