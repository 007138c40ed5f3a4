"""The feed-forward method registry, the part evaluation needs: the names
of ``vst/train/registry.py``'s ``FASTSTYLE_METHODS`` and the nets
``vst/train/faststyle.py:FastStyleTrainer`` builds (``:110-112``). vst's
module imports its trainer and so jax; this one is the port's own.

Training (the emphasis parameters and loss heads, ``select_method``'s
config, ``run_id``) is not ported yet.
"""

from __future__ import annotations

from vst_torch.models.faststyle import FastStyleNet

# the methods of fs_tests.py:51-72, vst/train/registry.py:14-20
FASTSTYLE_METHODS = ("johnson", "dumoulin", "huang", "reconet", "ruder")


def num_inputs(method: str) -> int:
    """The net's input channels: Ruder's takes (frame, mask, warped previous
    output), 3 + 1 + 3 = 7; every other method a frame's 3. Raises as vst's
    ``select_method`` for a name that is not a feed-forward method."""
    if method not in FASTSTYLE_METHODS:
        raise KeyError(f"{method} is not a feed-forward method; "
                       f"known: {sorted(FASTSTYLE_METHODS)}")
    return 7 if method == "ruder" else 3


def method_net(method: str, n_styles: int) -> FastStyleNet:
    """The method's net, freshly initialised from torch's current seed."""
    return FastStyleNet(num_inp=num_inputs(method), n_styles=n_styles)


def bootstrap_net(n_styles: int) -> FastStyleNet:
    """Ruder's frame-0 net: a 3-input FastStyleNet (``fs_ruder.py:25-34``)."""
    return FastStyleNet(num_inp=3, n_styles=n_styles)
