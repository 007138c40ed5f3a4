"""Method registry, port of ``vst/train/registry.py`` (``fs_tests.select_method``,
``methods/learning-based/fs_tests.py:51-72``): method name → trainer config
with the thesis's standard emphasis parameters, the method's nets, and the
reference's run-id encoding.
"""

from __future__ import annotations

import numpy as np

from vst_torch.models.faststyle import FastStyleNet
from vst_torch.train.faststyle import FastStyleConfig

# fs_tests.py's standard emphasis parameters (:54, :59, :62, :67, :70)
FASTSTYLE_METHODS = {
    "johnson": (1e0, 1e1, 1e-4),
    "dumoulin": (1e0, 1e1),
    "huang": (1e0, 1e1, 1e2, 1e-4),
    "reconet": (1e0, 1e1, 1e2, 1e2, 1e-4),
    "ruder": (1e0, 1e1, 1e2),
}

GAN_VARIANTS = ("cyclegan", "cyclegan_con", "mogan", "congan")
STARGAN_VARIANTS = ("stargan", "stargan2", "stargan2_advcon")

ALL_METHODS = tuple(FASTSTYLE_METHODS) + GAN_VARIANTS + STARGAN_VARIANTS + ("obst",)


def _check(name: str) -> None:
    if name not in FASTSTYLE_METHODS:
        raise KeyError(f"{name} is not a feed-forward method; "
                       f"known: {sorted(FASTSTYLE_METHODS)}")


def select_method(name: str, n_styles: int = 1, batch_size: int = 16,
                  n_frames: int = 2) -> FastStyleConfig:
    """The feed-forward method's trainer config."""
    _check(name)
    return FastStyleConfig(method=name, emphasis=FASTSTYLE_METHODS[name], n_styles=n_styles,
                           batch_size=batch_size, n_frames=n_frames)


def run_id(method: str, sid, epochs: int, batch_size: int, lr: float, emphasis) -> str:
    """The reference's run id (``fast_style_transfer.py:186-216``):
    ``sid{d}_ep{E}_bs{B}_lr{log10}`` and ``_{letter}{log10(w)}`` per loss,
    for checkpoints exported from reference-trained runs."""
    letters = {
        "johnson": ["a", "b", "d"],
        "dumoulin": ["a", "b"],
        "huang": ["a", "b", "c", "d"],
        "reconet": ["a", "b", "cf", "co", "d"],
        "ruder": ["a", "b", "c"],
    }[method]
    if isinstance(sid, (list, tuple)):
        rid = "msid%d_ep%d_bs%d_lr%d" % (len(sid), epochs, batch_size, np.log10(lr))
    else:
        rid = "sid%d_ep%d_bs%d_lr%d" % (sid, epochs, batch_size, np.log10(lr))
    for letter, w in zip(letters, emphasis):
        rid += "_%s%d" % (letter, np.log10(w))
    return rid + "/"


def num_inputs(method: str) -> int:
    """The net's input channels: Ruder's takes (frame, mask, warped previous
    output), 3 + 1 + 3 = 7; every other method a frame's 3. Raises as
    :func:`select_method` for a name that is not a feed-forward method."""
    _check(method)
    return 7 if method == "ruder" else 3


def method_net(method: str, n_styles: int) -> FastStyleNet:
    """The method's net, freshly initialised from torch's current seed."""
    return FastStyleNet(num_inp=num_inputs(method), n_styles=n_styles)


def bootstrap_net(n_styles: int) -> FastStyleNet:
    """Ruder's frame-0 net: a 3-input FastStyleNet (``fs_ruder.py:25-34``)."""
    return FastStyleNet(num_inp=3, n_styles=n_styles)
