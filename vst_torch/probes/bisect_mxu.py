"""The matrix-product rate inside one kernel, on the card: port of
``scripts/bisect_mxu.py``.

    python -m vst_torch.probes.bisect_mxu

For bfloat16 (tensor cores) and float32 (SIMT, TF32 off): y = Σ_{64 reps}
x @ w in the ``gemm_rate`` kernel, x (4096, K), w (K, N) from seed 0,
swept over the script's (K, N). Prints ms (best of 3 windows of 10 calls)
and TF/s, beside the plain version's ms, the bound and two cuBLAS
yardsticks: ``library_ms``, one ``torch.matmul`` of depth reps·K that
computes the same Σ (``library_operands``: x repeated along K, w along
K, built outside the timed window), and ``library_x64_ms``, 64 × one
``torch.matmul(x, w)``, the yardstick of earlier runs. ``launches`` is
the number of kernel launches the record's timing made.
"""

from __future__ import annotations

import json
from typing import Dict, List

import numpy as np
import torch

from vst_torch import set_f32_precision
from vst_torch.core.roofline import bound, product_ops_per_s
from vst_torch.core.timing import windows_ms
from vst_torch.kernels.gemm_rate import gemm_rate, gemm_rate_plain
from vst_torch.kernels.pad_conv3x3 import dtype_name

M = 4096
REPS = 64
SHAPES = ((128, 128), (128, 256), (128, 512), (128, 1024), (256, 128), (512, 128),
          (1152, 128), (512, 512), (256, 256))
DTYPES = (torch.bfloat16, torch.float32)


def gemm_inputs(K: int, N: int, dtype: torch.dtype, device, seed: int = 0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(M, K).astype(np.float32))
    w = torch.from_numpy(rng.randn(K, N).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


def gemm_bound(x: torch.Tensor, w: torch.Tensor, reps: int = REPS):
    """x and w read once, y written once; reps products at the matrix rate."""
    (m, k), n = x.shape, w.shape[1]
    nbytes = (m * k + k * n + m * n) * x.element_size()
    return bound(nbytes, 2 * reps * m * k * n, product_ops_per_s(x.dtype))


def library_operands(x: torch.Tensor, w: torch.Tensor, reps: int = REPS):
    """(x | x | … , w ; w ; …): x (M, reps·K) and w (reps·K, N), whose one
    product is Σ_{reps} x @ w, the yardstick's single cuBLAS call."""
    return x.repeat(1, reps), w.repeat(reps, 1)


def best_ms(fn, x: torch.Tensor, iters: int) -> float:
    return min(windows_ms(lambda _: fn(), x, iters))


@torch.no_grad()
def run(device="cuda") -> List[Dict]:
    set_f32_precision()
    records = []
    for dtype in DTYPES:
        for K, N in SHAPES:
            x, w = gemm_inputs(K, N, dtype, device)
            launched = gemm_rate.launches[dtype_name(dtype)]
            ms = best_ms(lambda: gemm_rate(x, w, REPS), x, 10)
            launched = gemm_rate.launches[dtype_name(dtype)] - launched
            bound_ms, bound_by = gemm_bound(x, w)
            xs, ws = library_operands(x, w)
            records.append({
                "dtype": dtype_name(dtype), "M": M, "K": K, "N": N, "reps": REPS, "ms": ms,
                "tflops": 2 * REPS * M * K * N / 1e9 / ms, "launches": launched,
                "plain_ms": best_ms(lambda: gemm_rate_plain(x, w, REPS), x, 2),
                "library_ms": best_ms(lambda: torch.matmul(xs, ws), x, 10),
                "library_x64_ms": REPS * best_ms(lambda: torch.matmul(x, w), x, 10),
                "bound_ms": bound_ms, "bound_by": bound_by})
            del xs, ws
    return records


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bisect_mxu: needs a CUDA device")
    dtype = None
    for rec in run():
        if rec["dtype"] != dtype:
            dtype = rec["dtype"]
            print(f"--- {dtype} ---")
        print(f"  K={rec['K']:5d} N={rec['N']:5d}: {rec['ms']:8.4f} ms ({rec['tflops']:.1f} TF/s); "
              f"plain {rec['plain_ms']:.4f}; cuBLAS {rec['library_ms']:.4f} "
              f"(x{REPS}: {rec['library_x64_ms']:.4f}); "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})")
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
