"""vst_torch benchmark: styled frames per second on one GPU, port of
``bench.py``.

    python -m vst_torch.bench          # or: python -m vst_torch.cli bench

Workload (as ``bench.py``): the Johnson FastStyleNet (3 styles, style 0,
strength 1) stylizing 436×1024 frames, x = clamp(net(x)/255, 0, 1), each
call consuming the previous call's output. Weights are random, from seed 0;
bf16 configs cast the whole net (``net.to(torch.bfloat16)``, as
``bench.py:28`` casts the params) and the frames. Float32 runs with TF32
off.

Per config: a chained loop of 20 calls, 3 windows, CUDA events after a
synchronize; best and mean per frame. ``paths_ms_fused`` is the same
20-call chain captured once as a CUDA graph and replayed (the counterpart
of ``bench.py``'s one-program ``fori_loop``); a capture that fails raises.
Peak device memory per config is recorded. Prints one JSON line with
``bench.py``'s keys.

With ``VST_PROFILE_DIR`` set, the run is traced into that directory
(``vst_torch.core.trace.profile_trace``), each config under
``vst.bench.<name>``. Left out: ``bench.py``'s ``_dn`` configs, which measure
XLA buffer donation (no PyTorch counterpart).
"""

from __future__ import annotations

import json
import sys
from typing import Dict, Sequence

import numpy as np
import torch

from vst_torch import set_f32_precision
from vst_torch.core.timing import windows_ms
from vst_torch.core.trace import profile_trace, span
from vst_torch.models.faststyle import FastStyleNet

REF_FPS = 1000.0 / 5.87  # the reference's Johnson DT on an RTX 2080, as bench.py
METRIC = "styled_frames_per_sec_per_chip_436x1024_johnson"
H, W = 436, 1024
ITERS = 20
CONFIGS = (("f32_b1", torch.float32, 1), ("bf16_b1", torch.bfloat16, 1),
           ("bf16_b8", torch.bfloat16, 8), ("bf16_b32", torch.bfloat16, 32),
           ("bf16_b64", torch.bfloat16, 64), ("bf16_b128", torch.bfloat16, 128))


def seeded_net(dtype: torch.dtype, device, seed: int = 0) -> FastStyleNet:
    torch.manual_seed(seed)
    return FastStyleNet(n_styles=3).to(device=device, dtype=dtype).eval()


def make_stylize(net: FastStyleNet, style: torch.Tensor):
    """The benchmark's program: NCHW frames in [0, 1] → clamp(net/255, 0, 1).
    ``style`` is a device tensor, so a call makes no host→device copy and
    can be captured in a CUDA graph."""
    def stylize(img):
        _, out = net(img, 1.0, style)
        return (out / 255.0).clamp(0.0, 1.0)

    return stylize


def graph_chain_ms(fn, x: torch.Tensor, iters: int, windows: int = 3) -> float:
    """ms per call of ``iters`` chained calls captured as one CUDA graph:
    best of ``windows`` replays. Capture errors propagate."""
    static_x = x.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture stream, as capture needs
        fn(static_x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        v = static_x
        for _ in range(iters):
            v = fn(v)
    graph.replay()
    best = float("inf")
    for _ in range(windows):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


@torch.no_grad()
def measure(dtype: torch.dtype, batch: int, h: int = H, w: int = W, iters: int = ITERS,
            device="cuda") -> Dict[str, float]:
    """One config on a CUDA device: frames/s and ms per frame (best and mean
    of 3 windows), the CUDA-graph chain's ms per frame and the peak memory."""
    net = seeded_net(dtype, device)
    img = torch.from_numpy(np.random.RandomState(0).rand(batch, 3, h, w).astype(np.float32))
    img = img.to(device=device, dtype=dtype)
    stylize = make_stylize(net, torch.zeros((), dtype=torch.long, device=device))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    times = windows_ms(stylize, img, iters)
    peak = torch.cuda.max_memory_allocated(device)
    dt, dt_mean = min(times), sum(times) / len(times)
    torch.cuda.empty_cache()  # the graph's private pool takes the eager run's place
    fused = graph_chain_ms(stylize, img, iters)
    del net, img
    torch.cuda.empty_cache()
    return {"fps": batch * 1000.0 / dt, "ms": dt / batch, "ms_mean": dt_mean / batch,
            "ms_fused": fused / batch, "peak_mem_gib": peak / 2 ** 30}


def report(results: Dict[str, Dict[str, float]], device_name: str) -> Dict:
    """The JSON line, with ``bench.py``'s keys (``failed_paths`` never: a
    config that fails raises) plus ``peak_mem_gib`` per config."""
    best = max(results, key=lambda k: results[k]["fps"])
    return {
        "metric": METRIC,
        "value": results[best]["fps"],
        "unit": "frames/s/chip",
        "vs_baseline": results[best]["fps"] / REF_FPS,
        "latency_ms_f32_b1": results["f32_b1"]["ms"],
        "latency_ms_bf16_b1": results["bf16_b1"]["ms"],
        "latency_ms_f32_b1_mean": results["f32_b1"]["ms_mean"],
        "latency_ms_bf16_b1_mean": results["bf16_b1"]["ms_mean"],
        "b1_path": {"f32": "f32_b1", "bf16": "bf16_b1"},
        "methodology": "chained-loop device latency, CUDA events; best-of-3 (mean also "
                       "reported); _fused = the 20-call chain as one CUDA graph",
        "best_config": best,
        "device": device_name,
        "paths_ms": {k: v["ms"] for k, v in results.items()},
        "paths_ms_fused": {k: v["ms_fused"] for k, v in results.items()},
        "peak_mem_gib": {k: v["peak_mem_gib"] for k, v in results.items()},
    }


def run(configs: Sequence = CONFIGS, device="cuda") -> Dict:
    """Measure ``configs`` (which must include f32_b1 and bf16_b1) on a CUDA
    device and return the report."""
    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("the benchmark times a CUDA device; got " + str(device))
    set_f32_precision()
    results = {}
    with profile_trace():  # a no-op unless VST_PROFILE_DIR is set
        for name, dtype, batch in configs:
            with span(f"vst.bench.{name}"):
                results[name] = measure(dtype, batch, device=device)
            print(name, json.dumps(results[name]), file=sys.stderr, flush=True)
    return report(results, torch.cuda.get_device_name(device))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("vst_torch.bench: needs a CUDA device")
    print(json.dumps(run()))


if __name__ == "__main__":
    main()
