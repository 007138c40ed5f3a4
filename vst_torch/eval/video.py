"""Writing stylized frames and StarGAN v2's debug grids, port of
``vst/eval/video.py:20-30, 56-93``.

``write_png`` encodes an 8-bit RGB PNG with the standard library (``zlib``
and ``struct``), so frames are written wherever Python runs. ``_writer``
opens an mp4 through imageio and its ffmpeg backend, falling back to a GIF
when there is no such backend, as vst's; it needs imageio, which the caller
imports through it. ``translate_and_reconstruct`` is ``train-stargan2``'s
sample grid (``StarGANv2Adv/core/utils.py:63-90``), written with
``write_png``.

Not ported yet: ``make_videos`` and ``latent_interpolation_video``.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch


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


def denormalize(x: np.ndarray) -> np.ndarray:
    """[−1, 1] → [0, 1], clipped (``core/utils.py:28-31``)."""
    return np.clip((x + 1.0) / 2.0, 0.0, 1.0)


def image_grid(rows) -> np.ndarray:
    """Rows of equally sized (H, W, 3) images → one (rows·H, cols·W, 3) array."""
    return np.concatenate([np.concatenate(list(r), axis=1) for r in rows], axis=0)


@torch.no_grad()
def translate_and_reconstruct(generate, style_encode, x_src: torch.Tensor, y_src,
                              x_ref: torch.Tensor, y_ref, filename=None) -> np.ndarray:
    """``core/utils.py:63-90``: fake = G(x_src, E(x_ref, y_ref)), rec =
    G(fake, E(x_src, y_src)); one row each of src, ref, fake and rec, the
    batch side by side, in [0, 1]. Images are NCHW tensors in [−1, 1]. Writes
    the grid as an 8-bit PNG (× 255, truncated, as vst) to ``filename``
    when given."""
    x_fake = generate(x_src, style_encode(x_ref, y_ref))
    x_rec = generate(x_fake, style_encode(x_src, y_src))
    grid = image_grid([[denormalize(img) for img in b.float().permute(0, 2, 3, 1).cpu().numpy()]
                       for b in (x_src, x_ref, x_fake, x_rec)])
    if filename:
        os.makedirs(os.path.dirname(os.path.abspath(filename)), exist_ok=True)
        write_png(filename, (grid * 255).astype(np.uint8))
    return grid
