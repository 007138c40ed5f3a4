"""The FastStyleNet residual-trunk conv on the card, port of
``scripts/bisect_im2col.py``.

    python -m vst_torch.probes.bisect_im2col

For float32 and bfloat16: a chain of ``N_CONV`` reflect-pad + 3×3 convs at
the bench's trunk shape (x (1, 109, 256, 128) channels-last, w (3, 3, 128,
128) × 0.02, from seed 0) through the ``pad_conv3x3`` kernel. Prints ms per
conv (best of 3 windows of 20 chains launched from the host) and TF/s from
the script's FLOP count 27904·9·C²·2; the kernel's device time alone
(``device_ms``: one CUDA graph over copies of x that are cold in L2) and the
host's time to issue a call (``host_ms``); beside them the plain version's
and the library yardstick's ms per conv and the bound. The script's four
variants (tap9, im2col, ztrick, row3) are four ways to feed one function to
the TPU's matrix unit; the kernel is their one Hopper counterpart. Float32
runs with TF32 off.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from vst_torch import set_f32_precision
from vst_torch.core.roofline import PEAK_F32_OPS_PER_S, bound, product_ops_per_s
from vst_torch.core.timing import cold_pool, graph_ms, host_ms, windows_ms
from vst_torch.kernels.pad_conv3x3 import (DTYPES, dtype_name, out_channels, pad_conv3x3,
                                           pad_conv3x3_plain)

H, W, C = 109, 256, 128
N_CONV = 10
PIXELS = 27904  # H·W, as the script counts them
GRAPH_ITERS = 20  # replays a window of device_ms


def trunk_inputs(dtype: torch.dtype, device, seed: int = 0,
                 shape: Tuple[int, int, int, int] = (1, H, W, C), cout: Optional[int] = None):
    """x (N, H, W, C) ~ N(0, 1) and w (3, 3, C, C_out) ~ N(0, 0.02²), from
    numpy; C_out = C unless given."""
    rng = np.random.RandomState(seed)
    c = shape[3]
    w = torch.from_numpy(rng.randn(3, 3, c, cout or c).astype(np.float32) * 0.02)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    return x.to(device, dtype), w.to(device, dtype)


def library_weight(w: torch.Tensor) -> torch.Tensor:
    """w (3, 3, C_in, C_out) as cuDNN's (C_out, C_in, 3, 3), channels-last."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def library_pad_conv3x3(x: torch.Tensor, w_lib: torch.Tensor) -> torch.Tensor:
    """The library yardstick: ``F.pad(mode="reflect")`` then cuDNN's
    ``F.conv2d`` in channels-last. Timed beside the kernel; the port never
    calls it."""
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    return F.conv2d(xp.contiguous(memory_format=torch.channels_last), w_lib).permute(0, 2, 3, 1)


def conv_bound(x: torch.Tensor, w: torch.Tensor, mode: str = "full") -> Tuple[float, str]:
    """Bound of one conv in ``mode``: x read and y written once (w too when
    the mode multiplies); products at the dtype's matrix rate, the 9 tap
    sums of ``shift_only`` at the f32 rate."""
    N, h, wd, cin = x.shape
    pixels = N * h * wd
    cout = out_channels(w, mode)
    size = x.element_size()
    if mode in ("full", "mxu_only"):
        nbytes = (pixels * (cin + cout) + 9 * cin * cout) * size
        return bound(nbytes, 2 * pixels * 9 * cin * cout, product_ops_per_s(x.dtype))
    ops = pixels * 9 * cin if mode == "shift_only" else 0
    return bound(pixels * (cin + cout) * size, ops, PEAK_F32_OPS_PER_S)


def per_conv_ms(conv, x: torch.Tensor) -> float:
    """Best of 3 windows of 20 chains of ``N_CONV`` convs, per conv."""
    def chain(v):
        for _ in range(N_CONV):
            v = conv(v)
        return v

    return min(windows_ms(chain, x, 20)) / N_CONV


def kernel_times(conv, x: torch.Tensor, pool) -> Dict[str, float]:
    """The kernel's three times: ``ms_per_conv`` (host-launched chains,
    ``per_conv_ms``), ``device_ms`` (one CUDA graph over ``pool``, inputs
    cold in L2, ``graph_ms``) and ``host_ms`` (the host's time to issue one
    call, ``host_ms``)."""
    return {"ms_per_conv": per_conv_ms(conv, x), "device_ms": graph_ms(conv, pool, GRAPH_ITERS),
            "host_ms": host_ms(conv, x)}


@torch.no_grad()
def run(device="cuda") -> List[Dict]:
    set_f32_precision()
    records = []
    for dtype in DTYPES:
        x, w = trunk_inputs(dtype, device)
        w_lib = library_weight(w)
        times = kernel_times(lambda v: pad_conv3x3(v, w), x, cold_pool(x))
        bound_ms, bound_by = conv_bound(x, w)
        records.append({
            "dtype": dtype_name(dtype), "shape": [1, H, W, C], "n_conv": N_CONV, **times,
            "tflops": PIXELS * 9 * C * C * 2 / 1e9 / times["ms_per_conv"],
            "plain_ms_per_conv": per_conv_ms(lambda v: pad_conv3x3_plain(v, w), x),
            "library_ms_per_conv": per_conv_ms(lambda v: library_pad_conv3x3(v, w_lib), x),
            "bound_ms": bound_ms, "bound_by": bound_by})
    return records


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bisect_im2col: needs a CUDA device")
    for rec in run():
        print(f"--- {rec['dtype']} ---")
        print(f"  pad_conv3x3: {rec['ms_per_conv']:.4f} ms/conv ({rec['tflops']:.1f} TF/s), "
              f"device {rec['device_ms']:.4f}, host {rec['host_ms']:.4f}; "
              f"plain {rec['plain_ms_per_conv']:.4f}; cuDNN {rec['library_ms_per_conv']:.4f}; "
              f"bound {rec['bound_ms']:.4f} ({rec['bound_by']})")
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
