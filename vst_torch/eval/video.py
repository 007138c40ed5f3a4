"""Writing stylized frames: PNGs and a video, port of ``vst/eval/video.py:20-30``.

``write_png`` encodes an 8-bit RGB PNG with the standard library (``zlib``
and ``struct``), so frames are written wherever Python runs. ``_writer``
opens an mp4 through imageio and its ffmpeg backend, falling back to a GIF
when there is no such backend, as vst's; it needs imageio, which the caller
imports through it.

The rest of vst's module (``make_videos``, the StarGAN-v2 grids and latent
videos) is not ported yet.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_png(path: str, image: np.ndarray) -> None:
    """(H, W, 3) uint8 → an 8-bit truecolour PNG at ``path``."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, 3 * w)], 1)  # filter 0
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(chunk(b"IEND", b""))


def _writer(path: str, fps: int):
    """(path written, writer): an mp4 through imageio's ffmpeg backend, or,
    without one, a GIF beside it. Raises ImportError without imageio."""
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    try:
        return path, imageio.get_writer(path, fps=fps)
    except (ValueError, ImportError):
        gif = os.path.splitext(path)[0] + ".gif"
        return gif, imageio.get_writer(gif, duration=1000.0 / fps)
