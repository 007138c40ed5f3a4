"""Where the Hopper kernels spend their time, on the card: each kernel as
built from its source, beside variants of that source with a part cut out
or done another way.

    python -m vst_torch.probes.kernel_trials

- ``corr_lookup`` at the Sintel tcl2 shape (the inputs of ``chip_smoke.py``
  phase 2): the kernel; its map reads alone (each lane sums its outputs and
  stores one float); its stores alone (no map read).
- ``pad_conv3x3`` f32 ``full`` and ``mxu_only`` at the trunk shape: the
  kernel; its products alone (the first chunk is staged, the others are not,
  so the sums are wrong: a timing, not a result); its weights brought by
  one bulk copy a row, as for C_out ≠ 128, instead of one a tap.
- ``pad_conv3x3`` ``shift_only`` and ``dma_only`` at the trunk shape, f32
  and bf16: the kernel; ``shift_only``'s loads alone (the halo staged, one
  vector stored a thread), its stores alone (nothing staged: the sums are
  of whatever shared memory holds), a register window that loads each row's
  3 vectors itself instead of the staged halo, and 4 or 16 rows a CTA
  instead of 8; ``dma_only`` with 2 or 8 vectors a thread instead of 4.
- The host's time to issue one f32 ``shift_only`` call (``host_ms``):
  through the wrapper; its input checks alone; the C entry point with y
  allocated and the stream read on each call, as the wrapper does; with
  only one of the two on each call; the entry point alone (y and the stream
  made once).

A variant is the source with a few lines replaced (each replaced text must
be found, or the probe raises), built by nvcc with the package's flags into
``vst_torch/_build/trials/`` and launched through its C entry point with
ctypes. Times are ms per call: corr_lookup the best of 3 windows of 200
launches into one output, the conv the best of 3 windows of 20 chains of 10
convs, as ``bisect_im2col`` times them; the halo-only modes on the device
alone, as ``device_ms`` (``vst_torch.core.timing.graph_ms``, inputs cold in
L2). Prints one JSON line per kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from vst_torch import set_f32_precision
from vst_torch.core.timing import cold_pool, graph_ms, host_ms, windows_ms
from vst_torch.flow.corr import build_pyramid
from vst_torch.flow.raft import coords_grid
from vst_torch.kernels import _nvcc
from vst_torch.kernels.corr_lookup import _ENTRY_POINTS as CORR_ENTRY
from vst_torch.kernels import pad_conv3x3 as conv_module
from vst_torch.kernels.pad_conv3x3 import _ENTRY_POINTS as CONV_ENTRY
from vst_torch.probes import bisect_im2col

TRIALS = _nvcc.BUILD_DIR / "trials"

CORR_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "reads_only": [
        ("  for (int j = lane; j < per_query; j += 32) {\n    const int l = j / kN2;",
         "  float sum = 0.f;\n"
         "  for (int j = lane; j < per_query; j += 32) {\n    const int l = j / kN2;"),
        ("    bw[l * kN2 + k] = s;\n  }\n  __syncwarp();\n"
         "  for (int j = lane; j < per_query; j += 32) o[j] = bw[j];",
         "    sum += s;\n  }\n  o[lane] = sum;"),
    ],
    "stores_only": [
        ("    const int h = pick(l,", "    bw[l * kN2 + k] = x + y;\n    continue;\n"
                                    "    const int h = pick(l,"),
    ],
}
CONV_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "products_only": [
        ("    vst::mbar_wait(vst::smem_addr(&wbar[c % S]), (c / S) & 1);",
         "    if (c < S - 1) vst::mbar_wait(vst::smem_addr(&wbar[c % S]), (c / S) & 1);"),
        ("    if (next < chunks) {\n      stage_f32<Ring>",
         "    if (next < 0) {\n      stage_f32<Ring>"),
    ],
    "weights_by_row": [
        ("    if (g.cout == kF32N) {\n      if (lane < 9) {",
         "    if (false) {\n      if (lane < 9) {"),
    ],
}


# shift_only's alternative to the staged halo: a register window whose side
# columns are the neighbouring threads' centres, loaded again (L1 or L2),
# each halo row's loads issued one row ahead of its sums
REGISTER_WINDOW = """
template <int LANES>
__global__ void __launch_bounds__(kHaloThreads)
pad_shift_window(const uint4* __restrict__ x, uint4* __restrict__ y, Geometry g, int vpp) {
  const int r0 = (blockIdx.x / g.col_tiles) * kShiftRows;
  const int c0 = (blockIdx.x % g.col_tiles) * kShiftCols;
  const int k0 = blockIdx.y * kSliceVecs;
  const int k = threadIdx.x % kSliceVecs, c = c0 + threadIdx.x / kSliceVecs;
  if (k >= min(kSliceVecs, vpp - k0) || c >= g.width) return;
  const size_t image = (size_t)blockIdx.z * g.height * g.width;
  const uint4* xb = x + image * vpp + k0 + k;
  const int cols[3] = {reflect(c - 1, g.width), c, reflect(c + 1, g.width)};
  uint4 win[4][3];
  auto load_row = [&](int hr, uint4 (&v)[3]) {
    const uint4* row = xb + (size_t)reflect(r0 - 1 + hr, g.height) * g.width * vpp;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) v[dx] = __ldg(row + (size_t)cols[dx] * vpp);
  };
#pragma unroll
  for (int hr = 0; hr < 3; ++hr) load_row(hr, win[hr]);
#pragma unroll
  for (int i = 0; i < kShiftRows; ++i) {
    if (r0 + i >= g.height) break;
    if (i + 3 < kShiftRows + 2) load_row(i + 3, win[(i + 3) % 4]);
    float s[LANES] = {};
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) accumulate(s, win[(i + dy) % 4][dx]);
    y[(image + (size_t)(r0 + i) * g.width + c) * vpp + k0 + k] = pack(s);
  }
}

"""
COPY_ANCHOR = "// vpp: 16-byte vectors a pixel. The copy indexes"
SHIFT_STORE = "    y[(image + (size_t)(r0 + i) * g.width + c) * vpp + k0 + k] = pack(s);"
HALO_VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "halo_kernel": [],
    "shift_loads_only": [(SHIFT_STORE, "    if (i == 0)\n" + SHIFT_STORE)],
    "shift_stores_only": [
        ("      vst::cp_async16(vst::smem_addr(halo_tile + i), xb + ((size_t)gr * g.width + gc) * vpp"
         " + k, 16);",
         "      (void)gr;\n      (void)gc;")],
    "shift_register_window": [
        (COPY_ANCHOR, REGISTER_WINDOW + COPY_ANCHOR),
        ("  pad_shift_sum<LANES><<<grid, kHaloThreads, kShiftSmem, s>>>(x, y, g, vpp);",
         "  pad_shift_window<LANES><<<grid, kHaloThreads, 0, s>>>(x, y, g, vpp);")],
    "shift_rows_4": [("constexpr int kShiftRows = 8;", "constexpr int kShiftRows = 4;")],
    "shift_rows_16": [("constexpr int kShiftRows = 8;", "constexpr int kShiftRows = 16;")],
    "copy_vecs_2": [("constexpr int kCopyVecs = 4;", "constexpr int kCopyVecs = 2;")],
    "copy_vecs_8": [("constexpr int kCopyVecs = 4;", "constexpr int kCopyVecs = 8;")],
}


def build_variants(name: str, variants: Dict[str, List[Tuple[str, str]]],
                   entry: Dict) -> Dict[str, Callable]:
    """Build every variant of ``csrc/<name>.cu`` (one nvcc each, all at
    once); returns its C entry point by variant."""
    TRIALS.mkdir(parents=True, exist_ok=True)
    source = (_nvcc.CSRC / f"{name}.cu").read_text()
    jobs = {}
    for variant, edits in variants.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}/{variant}: the text to replace is not in the source")
            text = text.replace(old, new)
        src = TRIALS / f"{name}_{variant}.cu"
        src.write_text(text)
        so = TRIALS / f"lib{name}_{variant}.so"
        jobs[variant] = (subprocess.Popen(
            [_nvcc.nvcc(), *_nvcc.NVCC_FLAGS, "-I", str(_nvcc.CSRC), "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    fns = {}
    for variant, (proc, so) in jobs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{name}/{variant}: nvcc failed:\n{out}")
        (fn_name, argtypes), = entry.items()
        fn = getattr(ctypes.CDLL(str(so)), fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        fns[variant] = fn
    return fns


def _checked(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


def corr_trials(dev) -> Dict[str, float]:
    g = torch.Generator(device=dev).manual_seed(0)
    B, H, W, C = 4, 54, 128, 256
    pyramid = build_pyramid(torch.randn(B, C, H, W, generator=g, device=dev),
                            torch.randn(B, C, H, W, generator=g, device=dev), 4)
    coords = (coords_grid(B, H, W, device=dev)
              + 8.0 * torch.randn(B, 2, H, W, generator=g, device=dev)).contiguous()
    out = torch.empty((B, H, W, 4 * 81), device=dev)
    heights = (ctypes.c_int * 4)(*[t.shape[2] for t in pyramid])
    widths = (ctypes.c_int * 4)(*[t.shape[3] for t in pyramid])
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for variant, fn in build_variants("corr_lookup", CORR_VARIANTS, CORR_ENTRY).items():
        def launch(_):
            _checked(fn(*[t.data_ptr() for t in pyramid], heights, widths, 4, coords.data_ptr(),
                        out.data_ptr(), B * H * W, H * W, 4, stream))
            return _
        times[variant] = min(windows_ms(launch, coords, 200))
    return times


def conv_trials(dev) -> Dict[str, float]:
    x, w = bisect_im2col.trunk_inputs(torch.float32, dev)
    N, H, W, C = x.shape
    stream = torch.cuda.current_stream(dev).cuda_stream
    times = {}
    for variant, fn in build_variants("pad_conv3x3", CONV_VARIANTS, CONV_ENTRY).items():
        for mode_index, mode in enumerate(("full", "mxu_only")):
            def conv(v):
                y = torch.empty_like(v)
                _checked(fn(v.data_ptr(), w.data_ptr(), y.data_ptr(), N, H, W, C, C, mode_index,
                            0, stream))
                return y
            times[f"{variant}_{mode}"] = bisect_im2col.per_conv_ms(conv, x)
    return times


def halo_trials(dev) -> Dict[str, Dict[str, float]]:
    """device_ms of each halo-only variant, by dtype: the kernel in both
    modes, the shift_ variants in shift_only, the copy_ ones in dma_only."""
    fns = build_variants("pad_conv3x3", HALO_VARIANTS, CONV_ENTRY)
    times = {}
    for dtype in (torch.float32, torch.bfloat16):
        x, _ = bisect_im2col.trunk_inputs(dtype, dev)
        N, H, W, C = x.shape
        pool = cold_pool(x)
        rec = times[str(dtype).removeprefix("torch.")] = {}
        for variant, fn in fns.items():
            modes = ("shift_only", "dma_only") if variant == "halo_kernel" else (
                ("shift_only",) if variant.startswith("shift_") else ("dma_only",))
            for mode in modes:
                index = 2 if mode == "shift_only" else 3

                def conv(v, fn=fn, index=index):
                    y = torch.empty_like(v)
                    _checked(fn(v.data_ptr(), v.data_ptr(), y.data_ptr(), N, H, W, C, C, index,
                                int(dtype == torch.bfloat16),
                                torch.cuda.current_stream(dev).cuda_stream))
                    return y
                rec[f"{variant}_{mode}"] = graph_ms(conv, pool, bisect_im2col.GRAPH_ITERS)
    return times


def host_trials(dev) -> Dict[str, float]:
    x, w = bisect_im2col.trunk_inputs(torch.float32, dev)
    mode = "shift_only"
    fn = conv_module._kernel()
    args, _ = conv_module.launch_args(x, w, mode)
    y = torch.empty_like(x)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def entry_point(alloc, read_stream):
        def call(v):
            out = torch.empty_like(v) if alloc else y
            _checked(fn(v.data_ptr(), w.data_ptr(), out.data_ptr(), *args,
                        torch.cuda.current_stream(v.device).cuda_stream if read_stream
                        else stream))
        return call

    return {
        "wrapper": host_ms(lambda v: conv_module.pad_conv3x3(v, w, mode), x),
        "checks": host_ms(lambda v: conv_module._check(v, w, mode), x),
        "entry_point_alloc_stream": host_ms(entry_point(True, True), x),
        "entry_point_alloc": host_ms(entry_point(True, False), x),
        "entry_point_stream": host_ms(entry_point(False, True), x),
        "entry_point": host_ms(entry_point(False, False), x)}


@torch.no_grad()
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trials: needs a CUDA device")
    set_f32_precision()
    dev = torch.device("cuda", 0)
    print(json.dumps({"kernel": "corr_lookup", "shape": [4, 54, 128], "ms": corr_trials(dev)}))
    print(json.dumps({"kernel": "pad_conv3x3_float32", "shape": [1, 109, 256, 128],
                      "ms": conv_trials(dev)}))
    print(json.dumps({"kernel": "pad_conv3x3_halo_only", "shape": [1, 109, 256, 128],
                      "device_ms": halo_trials(dev)}))
    print(json.dumps({"kernel": "pad_conv3x3_float32_shift_only", "shape": [1, 109, 256, 128],
                      "host_ms": host_trials(dev)}))


if __name__ == "__main__":
    main()
