"""DT and ``tcl2`` of checkouts in turns on one card, each in a process of
its own, as ``chip_smoke.py`` measures them (phases 3 and 5).

    python -m vst_torch.probes.main_path_ab SPEC [SPEC ...]

A SPEC is a checkout directory, or ``DIR+MODULE`` to import MODULE in that
process before the checkout's ``chip_smoke`` (which then imports what it
imports). The SPECs run one after the other in the order given, e.g. OTHER,
this, this, OTHER. Each process builds the checkout's kernels into its
``vst_torch/_build/``, then prints one JSON line: DT (FastStyleNet, 3
styles, 1×3×436×1024, the best of 2 windows of 20 chained calls) and
``tcl2_ms`` (3 stylizes and the batch-4 RAFT call at 432×1024, mean of 3
after a warm-up), with the same seeds and helpers as the checkout's
``chip_smoke.py``.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path


def time_checkout(root: str, preimport: str | None) -> dict:
    """The times of ``root``'s main path; runs in a process of its own."""
    sys.path.insert(0, root)
    if preimport:
        importlib.import_module(preimport)
    import torch

    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("main_path_ab: needs a CUDA device")
    cs.set_f32_precision()
    dev = torch.device("cuda", 0)
    cs.phase_build()
    net = cs.seeded_style_net(dev)
    x = cs.to_nchw(cs.synthetic_clip(1, (436, 1024)), dev) * 2 - 1
    style = torch.tensor(1, device=dev)
    with torch.no_grad():
        dt = min(cs.chain_ms(lambda y: net(y, 1.0, style)[1] / 127.5 - 1.0, x, 20)
                 for _ in range(2))
        raft = cs.seeded_raft(20, dev)
        frames = cs.to_nchw(cs.synthetic_clip(8, (432, 1024), seed=3), dev) * 2 - 1
        _, _, _, tcl2 = cs.make_tcl_program(cs.faststyle_stylize_fn(net, net.state_dict()),
                                            lambda a, b: raft(a, b))
        zero = torch.tensor(0, device=dev)
        tcl2_ms = cs.time_ms(lambda: tcl2(frames[5:6], frames[4:5], frames[0:1], zero), 3, 1)
    return {"checkout": root, "preimport": preimport, "device": torch.cuda.get_device_name(0),
            "dt_ms_per_frame": dt, "tcl2_ms": tcl2_ms}


def main() -> None:
    if len(sys.argv) in (3, 4) and sys.argv[1] == "--time":
        print(json.dumps(time_checkout(sys.argv[2], sys.argv[3] if len(sys.argv) == 4 else None)),
              flush=True)
        return
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    for spec in sys.argv[1:]:
        root, _, module = spec.partition("+")
        root = str(Path(root).resolve())
        # a script, not -m, so that sys.path holds no checkout but ``root``
        subprocess.run([sys.executable, os.path.abspath(__file__), "--time", root,
                        *([module] if module else [])], check=True, cwd=root)


if __name__ == "__main__":
    main()
