"""Where the fused pad-conv's time goes, on the card: port of
``scripts/bisect_kernel_cost.py``.

    python -m vst_torch.probes.bisect_kernel_cost

The ``pad_conv3x3`` kernel in its four modes at the trunk shape, each timed
over a chain of ``N_CONV`` convs (best of 3 windows of 20 chains), for
float32 and bfloat16. On Hopper the split is:

- ``dma_only``: the device-memory → shared-memory load of the reflected
  halo, and one store;
- ``shift_only``: plus the 9 shifted shared-memory reads, summed;
- ``mxu_only``: the FMA or tensor-core products, all from one unshifted tap;
- ``full``: the conv.

Beside each: the plain version's time and the bound; for ``full`` also the
cuDNN yardstick. ``shift_only`` and ``dma_only`` give wrong maths on purpose.
"""

from __future__ import annotations

import json
from typing import Dict, List

import torch

from vst_torch import set_f32_precision
from vst_torch.kernels.pad_conv3x3 import DTYPES, MODES, dtype_name, pad_conv3x3, pad_conv3x3_plain
from vst_torch.probes.bisect_im2col import (C, H, N_CONV, W, conv_bound, library_pad_conv3x3,
                                            library_weight, per_conv_ms, trunk_inputs)


@torch.no_grad()
def run(device="cuda") -> List[Dict]:
    set_f32_precision()
    records = []
    for dtype in DTYPES:
        x, w = trunk_inputs(dtype, device)
        rec = {"dtype": dtype_name(dtype), "shape": [1, H, W, C], "n_conv": N_CONV, "modes": {}}
        for mode in MODES:
            bound_ms, bound_by = conv_bound(x, w, mode)
            rec["modes"][mode] = {
                "ms_per_conv": per_conv_ms(lambda v: pad_conv3x3(v, w, mode), x),
                "plain_ms_per_conv": per_conv_ms(lambda v: pad_conv3x3_plain(v, w, mode), x),
                "bound_ms": bound_ms, "bound_by": bound_by}
        w_lib = library_weight(w)
        rec["modes"]["full"]["library_ms_per_conv"] = per_conv_ms(
            lambda v: library_pad_conv3x3(v, w_lib), x)
        records.append(rec)
    return records


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bisect_kernel_cost: needs a CUDA device")
    for rec in run():
        print(f"--- {rec['dtype']} ---")
        for mode, m in rec["modes"].items():
            print(f"  {mode:12s} {m['ms_per_conv']:.4f} ms/conv; plain {m['plain_ms_per_conv']:.4f}; "
                  f"bound {m['bound_ms']:.4f} ({m['bound_by']})")
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
