"""The profiler summary and the per-layer readers, on made-up readings."""

import pytest
import torch

from vstbench import cell as cells
from vstbench import trace


def events():
    sub = trace.SUBWINDOW
    return [
        (sub, "user_annotation", 0.0, 1000.0),
        ("aten::conv2d", "cpu_op", 0.0, 300.0),
        ("aten::item", "cpu_op", 600.0, 900.0),
        ("cudaLaunchKernel", "cuda_runtime", 10.0, 20.0),
        ("DT/clip0_s1", "gpu_user_annotation", 0.0, 1000.0),  # not device work
        ("sgemm", "kernel", 100.0, 400.0),
        ("sgemm", "kernel", 350.0, 500.0),
        ("corr_lookup_kernel<4>", "kernel", 700.0, 750.0),
        ("Memcpy DtoH", "gpu_memcpy", 800.0, 850.0),
        ("late", "kernel", 990.0, 1100.0),
    ]


def test_summary_busy_idle_and_labels():
    s = trace.summarise(events())
    # device union inside [0, 1000]: 100-500, 700-750, 800-850, 990-1000 = 510 us
    assert s["busy_s"] == pytest.approx(510e-6) and s["window_s"] == pytest.approx(1e-3)
    assert s["device_ms_by_name"]["sgemm"] == pytest.approx(0.45)
    assert s["device_ops"][0] == ["sgemm", pytest.approx(450e-6)]
    gaps = dict((round(sec * 1e6), name) for name, sec in s["idle_gaps"])
    # 500-700 (200 us, host in aten::item at its middle 600), 0-100 (aten::conv2d)
    assert gaps[200] == "aten::item" and gaps[100] == "aten::conv2d"
    assert gaps[140] == "host outside any operation"  # 850-990: middle 920


def test_summary_needs_its_annotation():
    with pytest.raises(RuntimeError):
        trace.summarise([("k", "kernel", 0.0, 1.0)])


def test_profile_runs_on_the_cpu():
    s = trace.profile(lambda: torch.ones(64, 64) @ torch.ones(64, 64))
    assert s["busy_s"] == 0.0 and s["window_s"] > 0


def read(name, ctx):
    return cells.metric_reader(name)(ctx)


def test_readers_on_a_made_up_window():
    prof = trace.summarise(events())
    ctx = {"spans_ms": {"raft": 600.0, "stylize": 200.0, "d_steps": 30.0, "g_steps": 50.0},
           "units": 2, "work": 38, "window_s": 1.0, "peak_bytes": 2 ** 31, "profile": prof,
           "lookups": 1, "lookup_bound_s": 25e-6, "unit_flops": 67e12 * 0.1,
           "frame_walls": [0.012, 0.014]}
    assert read("raft_ms.eval", ctx) == pytest.approx(600 / 38)
    assert read("stylize_ms.eval", ctx) == pytest.approx(200 / 38)
    assert read("harness_rest_ms.eval", ctx) == pytest.approx(200 / 38)
    assert read("corr_lookup_roofline.eval", ctx) == pytest.approx(50.0)
    assert read("mfu_pct.train", ctx) == pytest.approx(20.0)
    assert read("device_idle_pct.stream", ctx) == pytest.approx(49.0)
    assert read("peak_mem_gib.eval", ctx) == pytest.approx(2.0)
    stream = dict(ctx, spans_ms={"stylize": 20.0}, units=2, work=2)
    assert read("net_ms.stream", stream) == pytest.approx(10.0)
    assert read("copy_ms.stream", stream) == pytest.approx((26.0 - 20.0) / 2)
    assert read("d_steps_ms.train", ctx) == pytest.approx(15.0)
    assert read("g_steps_ms.train", ctx) == pytest.approx(25.0)
