"""The ``pad_conv3x3`` kernel of another checkout and of this one, timed in
turns on one card with this checkout's timing helpers.

    python -m vst_torch.probes.conv_ab OTHER_CHECKOUT

Runs four processes, one after the other: OTHER, this, this, OTHER. Each
imports ``vst_torch`` from the checkout it times (its wrapper and its kernel
source, built into that checkout's ``vst_torch/_build/``) and loads
``graph_ms``, ``cold_pool`` and ``host_ms`` from this checkout's
``vst_torch/core/timing.py``, so that a parent that lacks them is read with
the same yardstick. For each mode and dtype at the trunk shape it prints
``ms_per_conv`` (the checkout's own host-launched chain,
``bisect_im2col.per_conv_ms``), ``device_ms`` and ``host_ms``: one JSON line
per process.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]  # this checkout
GRAPH_ITERS = 20  # bisect_im2col.GRAPH_ITERS, which an older checkout lacks


def time_checkout(root: str) -> dict:
    """The times of ``root``'s kernel; runs in a process of its own."""
    sys.path.insert(0, root)
    import torch

    from vst_torch import set_f32_precision
    from vst_torch.kernels.pad_conv3x3 import DTYPES, MODES, dtype_name, pad_conv3x3
    from vst_torch.probes.bisect_im2col import per_conv_ms, trunk_inputs

    spec = importlib.util.spec_from_file_location("conv_ab_timing",
                                                  HERE / "vst_torch" / "core" / "timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    if not torch.cuda.is_available():
        raise SystemExit("conv_ab: needs a CUDA device")
    set_f32_precision()
    dev = torch.device("cuda", 0)
    times = {}
    with torch.no_grad():
        for dtype in DTYPES:
            x, w = trunk_inputs(dtype, dev)
            pool = timing.cold_pool(x)
            for mode in MODES:
                def conv(v, mode=mode):
                    return pad_conv3x3(v, w, mode)
                times[f"{mode}_{dtype_name(dtype)}"] = {
                    "ms_per_conv": per_conv_ms(conv, x),
                    "device_ms": timing.graph_ms(conv, pool, GRAPH_ITERS),
                    "host_ms": timing.host_ms(conv, x)}
    return {"checkout": root, "device": torch.cuda.get_device_name(0), "times": times}


def main() -> None:
    if len(sys.argv) == 3 and sys.argv[1] == "--time":
        print(json.dumps(time_checkout(sys.argv[2])), flush=True)
        return
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = str(Path(sys.argv[1]).resolve())
    for root in (other, str(HERE), str(HERE), other):
        # a script, not -m, so that sys.path holds no checkout but ``root``
        subprocess.run([sys.executable, __file__, "--time", root], check=True, cwd=root)


if __name__ == "__main__":
    main()
