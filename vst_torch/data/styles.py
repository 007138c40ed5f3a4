"""Style images, port of ``vst/data/styles.py``.

The reference loads three paintings from ``styles/*.jpg`` resized to 512²
(``fast_style_transfer.py:740-756``, ``sid_styles`` :178). They are not in the
repository: a user's files are read when present (through cv2, imported
inside the loader), and otherwise deterministic procedural textures stand in,
equal to vst's bit for bit (loss values then differ from the reference's,
the mechanics do not).
"""

from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

DEFAULT_STYLE_NAMES = ["s1_starry_night", "s2_the_scream", "s3_take_on_me"]


def _procedural_style(seed: int, size: int) -> np.ndarray:
    """Swirly multi-scale texture standing in for a painting."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(
        np.linspace(0, 1, size, dtype=np.float32),
        np.linspace(0, 1, size, dtype=np.float32),
        indexing="ij",
    )
    img = np.zeros((size, size, 3), np.float32)
    for octave in range(4):
        f = 2.0 ** (octave + 1)
        phase = rng.uniform(0, 2 * np.pi, 3)
        rot = rng.uniform(0, np.pi)
        u = np.cos(rot) * xs + np.sin(rot) * ys
        v = -np.sin(rot) * xs + np.cos(rot) * ys
        swirl = np.sin(2 * np.pi * f * (u + 0.3 * np.sin(2 * np.pi * f * v)))
        for c in range(3):
            img[..., c] += (0.5 ** octave) * np.sin(swirl * 2 + phase[c])
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def load_style_images(style_dir: Optional[str] = None, names: Optional[List[str]] = None,
                      size: int = 512) -> np.ndarray:
    """(n_styles, size, size, 3) float32 in [0, 1]: per style,
    ``<style_dir>/<name>.jpg|.png|.jpeg`` if it exists (area-resized), else
    the procedural texture keyed by the style's index."""
    names = names or DEFAULT_STYLE_NAMES
    out = []
    for i, name in enumerate(names):
        img = None
        if style_dir:
            for ext in (".jpg", ".png", ".jpeg"):
                p = os.path.join(style_dir, name + ext)
                if os.path.exists(p):
                    import cv2

                    bgr = cv2.imread(p, cv2.IMREAD_COLOR)
                    rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
                    rgb = cv2.resize(rgb, (size, size), interpolation=cv2.INTER_AREA)
                    img = rgb.astype(np.float32) / 255.0
                    break
        if img is None:
            img = _procedural_style(1000 + i, size)
        out.append(img)
    return np.stack(out)
