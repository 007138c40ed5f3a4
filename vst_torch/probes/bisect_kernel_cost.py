"""Where the fused pad-conv's time goes, on the card: port of
``scripts/bisect_kernel_cost.py``.

    python -m vst_torch.probes.bisect_kernel_cost

The ``pad_conv3x3`` kernel in its four modes at the trunk shape, for
float32 and bfloat16, each timed three ways (``bisect_im2col.kernel_times``):
over a host-launched chain of ``N_CONV`` convs (best of 3 windows of 20
chains, ``ms_per_conv``), on the device alone (``device_ms``, a CUDA graph
over inputs cold in L2) and on the host alone (``host_ms``). On Hopper the
split is:

- ``dma_only``: the reflected input read once and stored, a gather copy;
- ``shift_only``: the reflected halo staged in shared memory, the 9 shifted
  reads summed;
- ``mxu_only``: the FMA or tensor-core products, all from one unshifted tap;
- ``full``: the conv.

Beside each: the plain version's time, the bound and the library
yardstick, one PyTorch call after a reflect ``F.pad`` that computes the
mode's function (``library_mode``): ``full`` cuDNN's conv, ``mxu_only``
``torch.matmul`` of the unshifted tap with w summed over its taps,
``shift_only`` a depthwise cuDNN conv with a ones 3×3 filter, ``dma_only``
the slice's copy. ``shift_only`` and ``dma_only`` give wrong maths on
purpose.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from vst_torch import set_f32_precision
from vst_torch.kernels.pad_conv3x3 import DTYPES, MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.core.timing import cold_pool
from vst_torch.probes.bisect_im2col import (C, H, N_CONV, W, conv_bound, kernel_times,
                                            library_pad_conv3x3, library_weight, per_conv_ms,
                                            trunk_inputs)


def library_arg(w: torch.Tensor, mode: str) -> Optional[torch.Tensor]:
    """What the mode's library call takes in place of w, made outside the
    timed window: cuDNN's weight (``full``), w summed over the 9 taps
    (``mxu_only``), a ones (C, 1, 3, 3) depthwise filter (``shift_only``)."""
    if mode == "full":
        return library_weight(w)
    if mode == "mxu_only":
        return w.sum((0, 1))
    if mode == "shift_only":
        return torch.ones((w.shape[2], 1, 3, 3), dtype=w.dtype, device=w.device)
    return None


def library_mode(x: torch.Tensor, arg: Optional[torch.Tensor], mode: str) -> torch.Tensor:
    """The library yardstick of ``mode``, x (N, H, W, C) channels-last:
    reflect ``F.pad``, then one call. Timed beside the kernel; the port
    never calls it."""
    if mode == "full":
        return library_pad_conv3x3(x, arg)
    H, W = x.shape[1:3]
    xp = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    if mode == "shift_only":
        xp = xp.contiguous(memory_format=torch.channels_last)
        return F.conv2d(xp, arg, groups=x.shape[3]).permute(0, 2, 3, 1)
    tap = xp[:, :, :H, :W].permute(0, 2, 3, 1)
    return tap.contiguous() if mode == "dma_only" else torch.matmul(tap, arg)


@torch.no_grad()
def run(device="cuda") -> List[Dict]:
    set_f32_precision()
    records = []
    for dtype in DTYPES:
        x, w = trunk_inputs(dtype, device)
        pool = cold_pool(x)
        rec = {"dtype": dtype_name(dtype), "shape": [1, H, W, C], "n_conv": N_CONV, "modes": {}}
        for mode in MODES:
            bound_ms, bound_by = conv_bound(x, w, mode)
            arg = library_arg(w, mode)
            rec["modes"][mode] = {
                **kernel_times(lambda v: pad_conv3x3(v, w, mode), x, pool),
                "plain_ms_per_conv": per_conv_ms(lambda v: pad_conv3x3_plain(v, w, mode), x),
                "library_ms_per_conv": per_conv_ms(lambda v: library_mode(v, arg, mode), x),
                "bound_ms": bound_ms, "bound_by": bound_by}
        records.append(rec)
    return records


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bisect_kernel_cost: needs a CUDA device")
    for rec in run():
        print(f"--- {rec['dtype']} ---")
        for mode, m in rec["modes"].items():
            print(f"  {mode:12s} {m['ms_per_conv']:.4f} ms/conv, device {m['device_ms']:.4f}, "
                  f"host {m['host_ms']:.4f}; plain {m['plain_ms_per_conv']:.4f}; "
                  f"library {m['library_ms_per_conv']:.4f}; bound {m['bound_ms']:.4f} "
                  f"({m['bound_by']})")
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
