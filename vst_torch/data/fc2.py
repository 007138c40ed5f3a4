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
makes the same batch dict without files; ``FC2Fetcher`` adds the GAN
trainers' latent draws; ``CycleGANFC2Dataset`` is the CycleGAN family's
reader of the same trees.
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


class CycleGANFC2Dataset:
    """The CycleGAN family's FC2 reader (``vst/data/fc2.py:183-239``,
    ``CycleGAN/fc2_dataset.py:19-66``; one model per style ``sid``): a sample
    is real_A from ``styled-files/style0``, real_A2 its ``_2`` next frame
    from ``styled-files3/style0``, real_B and real_B2 the same names from
    ``style{sid}``, in [−1, 1] (NHWC float32); ``with_flow`` adds mask and
    flow, channels 6:7 and 7:9 of ``DATAFiles/<stem>.npy``
    (CycleGANCon ``fc2_dataset.py:32-46``). Names sorted, then shuffled with
    ``random.Random(1234)``. Images are read through PIL (vst: imageio)."""

    def __init__(self, dset_dir: str, sid: int = 1, with_flow: bool = False):
        self.data_dir1 = os.path.join(dset_dir, "styled-files", "style0")
        self.data_dir2 = os.path.join(dset_dir, "styled-files3", "style0")
        self.style_dir1 = os.path.join(dset_dir, "styled-files", f"style{sid}")
        self.style_dir2 = os.path.join(dset_dir, "styled-files3", f"style{sid}")
        self.npy_dir = os.path.join(dset_dir, "DATAFiles") if with_flow else None
        names = sorted(os.listdir(self.data_dir1))
        if len(names) != len(os.listdir(self.data_dir2)):
            raise ValueError(f"{self.data_dir1} and {self.data_dir2} differ in length")
        self.dataset = [(n, os.path.splitext(n)[0] + "_2" + os.path.splitext(n)[1])
                        for n in names]
        random.Random(1234).shuffle(self.dataset)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        def load(path):
            return _read_image(path).astype(np.float32) / 255.0 * 2 - 1

        n1, n2 = self.dataset[index]
        out = {"real_A": load(os.path.join(self.data_dir1, n1)),
               "real_A2": load(os.path.join(self.data_dir2, n2)),
               "real_B": load(os.path.join(self.style_dir1, n1)),
               "real_B2": load(os.path.join(self.style_dir2, n2))}
        if self.npy_dir:
            np_data = np.load(os.path.join(self.npy_dir, os.path.splitext(n1)[0] + ".npy"))[0]
            out["mask"] = np_data[:, :, 6:7].astype(np.float32)
            out["flow"] = np_data[:, :, 7:9].astype(np.float32)
        return out

    def epoch(self, batch_size: int, shuffle: bool = True, seed: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Batches of one pass, in ``np.random.RandomState(seed)``'s order;
        the tail short of a batch is dropped."""
        order = np.arange(len(self.dataset))
        if shuffle:
            np.random.RandomState(seed).shuffle(order)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            samples = [self[int(j)] for j in order[i:i + batch_size]]
            yield {k: np.stack([s[k] for s in samples]) for k in samples[0]}


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


class FC2Fetcher:
    """An endless fetcher over an ``FC2Loader``'s epochs that adds two latent
    draws a batch, z_trg and z_trg2 (``data_loader.py:321-348``), from
    ``np.random.RandomState(seed)``: vst's batches and latents bit for bit."""

    def __init__(self, loader: FC2Loader, latent_dim: int = 16, seed: int = 0):
        self.loader = loader
        self.latent_dim = latent_dim
        self._rng = np.random.RandomState(seed)
        self._it = iter(loader.epoch())

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        try:
            batch = next(self._it)
        except StopIteration:
            self._it = iter(self.loader.epoch())
            batch = next(self._it)
        n = batch["x_src"].shape[0]
        return {**batch,
                "z_trg": self._rng.randn(n, self.latent_dim).astype(np.float32),
                "z_trg2": self._rng.randn(n, self.latent_dim).astype(np.float32)}


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
