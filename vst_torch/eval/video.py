"""Writing stylized frames and videos, and StarGAN v2's debug grids and
latent walk, port of ``vst/eval/video.py``.

``write_png`` encodes an 8-bit RGB PNG with the standard library (``zlib``
and ``struct``), so frames are written wherever Python runs. ``_writer``
opens an mp4 through imageio and its ffmpeg backend and falls back to vst's
GIF (``duration = 1000 / fps`` ms a frame) without that backend, through
imageio where it is installed and through PIL where it is not.
``make_videos`` turns each frame directory into one video
(``utils/video_maker.py:24-43``); ``translate_and_reconstruct`` is
``train-stargan2``'s sample grid (``StarGANv2Adv/core/utils.py:63-90``);
``latent_interpolation_video`` stylizes one image while it lerps between
latent codes (``video_latent``, ``core/utils.py:200-275``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List

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


class _PILGifWriter:
    """imageio's writer interface (``with``, ``append_data``) over PIL: each
    frame is quantized to 256 colours (fast octree, an order of magnitude
    quicker than PIL's default median cut at Sintel's size) and kept, and
    the frames are saved as one animated GIF when the block ends."""

    def __init__(self, path: str, duration_ms: float):
        self.path, self.duration_ms, self.frames = path, duration_ms, []

    def __enter__(self):
        return self

    def append_data(self, image: np.ndarray) -> None:
        from PIL import Image

        self.frames.append(Image.fromarray(np.asarray(image, np.uint8)).quantize(
            256, method=Image.Quantize.FASTOCTREE))

    def close(self) -> None:
        if self.frames:
            self.frames[0].save(self.path, save_all=True, append_images=self.frames[1:],
                                duration=self.duration_ms, loop=0)
        self.frames = []

    def __exit__(self, *exc):
        self.close()
        return False


def _writer(path: str, fps: int):
    """(path written, writer): an mp4 through imageio's ffmpeg backend or,
    without one, a GIF beside it, through imageio or, without imageio,
    through PIL."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    gif = os.path.splitext(path)[0] + ".gif"
    try:
        import imageio.v2 as imageio
    except ImportError:
        return gif, _PILGifWriter(gif, 1000.0 / fps)
    try:
        return path, imageio.get_writer(path, fps=fps)
    except (ValueError, ImportError):
        return gif, imageio.get_writer(gif, duration=1000.0 / fps)


def make_videos(frames_root: str, out_dir=None, fps: int = 18) -> List[str]:
    """Each subdirectory of ``frames_root`` that holds PNGs becomes
    ``<out_dir>/<subdir>.mp4`` (or the GIF of :func:`_writer`), its frames in
    name order, read through PIL as RGB. Returns the paths written."""
    from PIL import Image

    out_dir = out_dir or frames_root
    written = []
    for sub in sorted(os.listdir(frames_root)):
        d = os.path.join(frames_root, sub)
        if not os.path.isdir(d):
            continue
        frames = [f for f in sorted(os.listdir(d)) if f.endswith(".png")]
        if not frames:
            continue
        path, w = _writer(os.path.join(out_dir, sub + ".mp4"), fps)
        with w:
            for f in frames:
                with Image.open(os.path.join(d, f)) as img:
                    w.append_data(np.asarray(img.convert("RGB")))
        written.append(path)
    return written


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


@torch.no_grad()
def latent_interpolation_video(generate, mapping, x_src: torch.Tensor, latents: np.ndarray,
                               y_trg: torch.Tensor, path: str, steps_per_pair: int = 16,
                               fps: int = 18) -> str:
    """``video_latent``: for each pair of consecutive latent codes, z lerped
    in numpy over ``np.linspace(0, 1, steps_per_pair, endpoint=False)``,
    s = mapping(z, y_trg), one frame G(x_src, s); ``x_src`` is one NCHW
    image (3, H, W) in [−1, 1] on the nets' device, ``y_trg`` a (1,) domain
    tensor there. Each frame goes to the writer as uint8 (× 255, truncated,
    as vst). Returns the path written."""
    path, w = _writer(path, fps)
    x = x_src[None]
    with w:
        for a, b in zip(latents[:-1], latents[1:]):
            for t in np.linspace(0.0, 1.0, steps_per_pair, endpoint=False):
                z = (1 - t) * a + t * b
                s = mapping(torch.as_tensor(z[None], dtype=x.dtype, device=x.device), y_trg)
                frame = generate(x, s)[0].float().permute(1, 2, 0).cpu().numpy()
                w.append_data((denormalize(frame) * 255).astype(np.uint8))
    return path
