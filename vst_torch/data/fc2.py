"""The FC2 pseudo-paired multi-domain eval set, port of ``vst/data/fc2.py``
(``StarGANv2Adv/core/data_loader.py:217-348``).

* directory layout: ``style_dir/style{0..D−1}/<img>.jpg`` (styled FC2 crops,
  the content as style0), ``temp_dir/style{d}/<img>_2.jpg`` (the styled next
  frame), ``data_dir/<img>.npy`` ((1, H, W, 9) = img1 ⊕ img2 ⊕ mask ⊕
  backward flow);
* 4 domain-pair entries an image: (0,0), (0,d), (d,0), (d,d) for each
  non-content style d (:281-288), shuffled with seed 1234;
* a seeded 97 % / 3 % train / eval split (:292-311);
* batches in [−1, 1], NHWC numpy, keys ``BATCH_KEYS``.

Images are read through PIL (vst reads them with imageio, which reads a JPEG
through PIL too; the port does not require imageio). ``synthetic_fc2_batches``
makes the same batch dict without files. ``FC2Fetcher`` and
``CycleGANFC2Dataset`` belong to the GAN families (ROADMAP item 6).
"""

from __future__ import annotations

import os
import random
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from vst_torch.data.synthetic import synthetic_batch

BATCH_KEYS = ("x_src", "x2_src", "y_src", "x_ref", "y_ref", "mask", "flow")


def to_grayscale3(img: np.ndarray) -> np.ndarray:
    """PIL 'L' conversion (ITU-R 601-2: 0.299 / 0.587 / 0.114) repeated to 3
    channels, the style-3 post-process (``datagen.py:131-148``); copied from
    ``vst/data/datagen.py:32``. img (..., 3) NHWC."""
    g = img[..., 0] * 0.299 + img[..., 1] * 0.587 + img[..., 2] * 0.114
    return np.repeat(g[..., None], 3, axis=-1)


def _read_image(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


class DatasetFC2:
    def __init__(self, data_dir: str, style_dir: str, temp_dir: str, num_dom: int = 2,
                 base_len: Optional[int] = 22208):
        self.data_dir = data_dir
        self.style_dir = style_dir
        self.temp_dir = temp_dir
        self.styles: List[str] = []
        self.dataset: List[Tuple[str, int, int]] = []

        style_list = sorted(os.listdir(style_dir))[:num_dom]
        for sty in style_list:
            n = len(os.listdir(os.path.join(style_dir, sty)))
            if base_len is not None and n != base_len:
                raise ValueError(f"{sty}: {n} images, expected {base_len}")
            self.styles.append(sty)

        for img in sorted(os.listdir(os.path.join(style_dir, style_list[0]))):
            self.dataset.append((img, 0, 0))
            for i, _ in enumerate(style_list[1:]):
                self.dataset.append((img, 0, i + 1))
                self.dataset.append((img, i + 1, 0))
                self.dataset.append((img, i + 1, i + 1))

        random.Random(1234).shuffle(self.dataset)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        file, src_lbl, ref_lbl = self.dataset[index]

        def load(path):
            return _read_image(path).astype(np.float32) / 255.0 * 2.0 - 1.0  # Normalize(0.5, 0.5)

        stem = os.path.splitext(file)[0]
        src = load(os.path.join(self.style_dir, self.styles[src_lbl], file))
        src2 = load(os.path.join(self.temp_dir, self.styles[src_lbl], stem + "_2.jpg"))
        ref = load(os.path.join(self.style_dir, self.styles[ref_lbl], file))
        np_data = np.load(os.path.join(self.data_dir, stem + ".npy"))[0]
        return {"x_src": src, "x2_src": src2, "y_src": np.int32(src_lbl),
                "x_ref": ref, "y_ref": np.int32(ref_lbl),
                "mask": np_data[:, :, 6:7].astype(np.float32),
                "flow": np_data[:, :, 7:9].astype(np.float32)}


def train_eval_split(n: int, split: float = 0.97, seed: int = 0):
    """``random_split``: a seeded numpy permutation cut at ``split`` (the
    reference draws from torch's generator; the statistics are the same)."""
    perm = np.random.RandomState(seed).permutation(n)
    k = int(split * n)
    return perm[:k], perm[k:]


class FC2Loader:
    """Batches of ``DatasetFC2`` indices, shuffled per epoch."""

    def __init__(self, dataset: DatasetFC2, indices, batch_size: int, seed: int = 0):
        self.dataset = dataset
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self._rng = np.random.RandomState(seed)

    def __len__(self):
        return len(self.indices) // self.batch_size

    def epoch(self, shuffle: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        order = self.indices.copy()
        if shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        for i in range(0, len(order) - bs + 1, bs):
            samples = [self.dataset[int(j)] for j in order[i:i + bs]]
            yield {k: np.stack([s[k] for s in samples]) for k in BATCH_KEYS}


def _stylize_np(img: np.ndarray, d: int) -> np.ndarray:
    """Domain d's colour remap: the 3×3 matrix applied d times, clipped."""
    if d == 0:
        return img
    m = np.asarray([[0.9, 0.2, 0.0], [0.1, 0.7, 0.3], [0.2, 0.1, 0.8]], np.float32)
    out = img
    for _ in range(d):
        out = np.einsum("...c,cd->...d", out, m)
    return np.clip(out, 0, 1)


def synthetic_fc2_batches(n_batches: int, batch_size: int, hw=(64, 64), num_dom: int = 4,
                          seed: int = 0):
    """The same batch dicts without files: per sample an affine-motion frame
    pair, 'styled' per domain by a colour remap, with its analytic mask and
    flow; vst's batches bit for bit."""
    rng = np.random.RandomState(seed)
    out = []
    for b in range(n_batches):
        base = synthetic_batch(batch_size, hw=hw, n_frames=2, seed=seed + b)
        y_src = rng.randint(0, num_dom, batch_size)
        y_ref = rng.randint(0, num_dom, batch_size)
        frames = base["imgs"]
        x_src = np.stack([_stylize_np(frames[i, 0], y_src[i]) for i in range(batch_size)])
        x2_src = np.stack([_stylize_np(frames[i, 1], y_src[i]) for i in range(batch_size)])
        x_ref = np.stack([_stylize_np(frames[i, 0], y_ref[i]) for i in range(batch_size)])
        out.append({"x_src": x_src * 2 - 1, "x2_src": x2_src * 2 - 1,
                    "y_src": y_src.astype(np.int32), "x_ref": x_ref * 2 - 1,
                    "y_ref": y_ref.astype(np.int32), "mask": base["masks"][:, 0],
                    "flow": base["flows"][:, 0]})
    return out
