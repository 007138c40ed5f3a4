"""Where two Hopper kernels spend their time, on the card: each kernel as
built from its source, beside variants of that source with a part cut out.

    python -m vst_torch.probes.kernel_trials

- ``corr_lookup`` at the Sintel tcl2 shape (the inputs of ``chip_smoke.py``
  phase 2): the kernel; its map reads alone (each lane sums its outputs and
  stores one float); its stores alone (no map read).
- ``pad_conv3x3`` f32 ``full`` and ``mxu_only`` at the trunk shape: the
  kernel; its products alone (the first chunk is staged, the others are not,
  so the sums are wrong: a timing, not a result); its weights brought by
  one bulk copy a row, as for C_out ≠ 128, instead of one a tap.

A variant is the source with a few lines replaced (each replaced text must
be found, or the probe raises), built by nvcc with the package's flags into
``vst_torch/_build/trials/`` and launched through its C entry point with
ctypes. Times are ms per call: corr_lookup the best of 3 windows of 200
launches into one output, the conv the best of 3 windows of 20 chains of 10
convs, as ``bisect_im2col`` times them. Prints one JSON line per kernel.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from typing import Callable, Dict, List, Tuple

import torch

from vst_torch import set_f32_precision
from vst_torch.core.timing import windows_ms
from vst_torch.flow.corr import build_pyramid
from vst_torch.flow.raft import coords_grid
from vst_torch.kernels import _nvcc
from vst_torch.kernels.corr_lookup import _ENTRY_POINTS as CORR_ENTRY
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


@torch.no_grad()
def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_trials: needs a CUDA device")
    set_f32_precision()
    dev = torch.device("cuda", 0)
    print(json.dumps({"kernel": "corr_lookup", "shape": [4, 54, 128], "ms": corr_trials(dev)}))
    print(json.dumps({"kernel": "pad_conv3x3_float32", "shape": [1, 109, 256, 128],
                      "ms": conv_trials(dev)}))


if __name__ == "__main__":
    main()
