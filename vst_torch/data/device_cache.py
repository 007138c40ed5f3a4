"""Device-resident FC2 corpus, port of ``vst/data/device_cache.py:26``
(``DeviceFC2Cache``).

The reference streams every batch host → GPU inside ``__getitem__``
(``datasets.py:75-77``). A quantized FC2-style corpus fits in device memory:
images as uint8 (they came from .jpg), masks as uint8, flows as float16
(FC2 flow magnitudes ≪ 2048), about 0.6 MB a 256² sample. The cache uploads
each of the three tensors once; then every batch is a gather and a
dequantize on the device, and only its indices cross from the host.

``DeviceStyledCache`` (``:75-189``) does the same for the GAN trainers'
pseudo-paired styled corpus. A cache lives on the device it is given; it
has no fallback to the host.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from vst_torch.data.fc2 import _read_image


class DeviceFC2Cache:
    """A ``DATAFiles``-style directory ((1, H, W, 9) float .npy per sample:
    img1 ⊕ img2 ⊕ mask ⊕ backward flow) uploaded to ``device`` once.

    ``sample(batch_size)`` draws indices from ``np.random.RandomState(seed)``
    (vst's draws) and returns the trainer's NCHW float32 batch on the
    device: imgs (B, 2, 3, H, W), masks (B, 1, 1, H, W), flows
    (B, 1, 2, H, W).
    """

    def __init__(self, data_dir: str, limit: Optional[int] = None, seed: int = 0,
                 device="cuda"):
        files = sorted(f for f in os.listdir(data_dir) if f.endswith(".npy"))[:limit]
        imgs, masks, flows = [], [], []
        for f in files:
            d = np.load(os.path.join(data_dir, f))[0]
            imgs.append(np.round(np.clip(d[:, :, 0:6], 0.0, 1.0) * 255.0).astype(np.uint8))
            masks.append(np.round(np.clip(d[:, :, 6:7], 0.0, 1.0)).astype(np.uint8))
            flows.append(d[:, :, 7:9].astype(np.float16))
        self.device = torch.device(device)
        self.n = len(files)
        # one copy per tensor, not per sample; kept NHWC as stored
        self.imgs = torch.from_numpy(np.stack(imgs)).to(self.device)    # (N, H, W, 6) u8
        self.masks = torch.from_numpy(np.stack(masks)).to(self.device)  # (N, H, W, 1) u8
        self.flows = torch.from_numpy(np.stack(flows)).to(self.device)  # (N, H, W, 2) f16
        self._rng = np.random.RandomState(seed)

    def gather(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The batch of samples ``idx`` (a device index tensor)."""
        # × float32(1/255): XLA compiles vst's ``/ 255.0`` to this product
        imgs = self.imgs.index_select(0, idx).float() * (1.0 / 255.0)
        B, H, W, _ = imgs.shape
        imgs = imgs.reshape(B, H, W, 2, 3).permute(0, 3, 4, 1, 2)
        masks = self.masks.index_select(0, idx).float().permute(0, 3, 1, 2)[:, None]
        flows = self.flows.index_select(0, idx).float().permute(0, 3, 1, 2)[:, None]
        return {"imgs": imgs.contiguous(), "masks": masks.contiguous(),
                "flows": flows.contiguous()}

    def sample(self, batch_size: int) -> Dict[str, torch.Tensor]:
        return self.gather(_to_device(self._rng.randint(0, self.n, size=(batch_size,)),
                                      self.device))


_TWO_OVER_255 = float(np.float32(2.0 / 255.0))


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host indices → a long tensor on ``device``, from pinned memory on a
    card, so the host does not wait for it."""
    t = torch.from_numpy(np.asarray(a, np.int64))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class DeviceStyledCache:
    """The pseudo-paired styled corpus of the GAN trainers (the styled-files /
    styled-files3 / DATAFiles trio, ``core/data_loader.py:232-250``) on
    ``device``: per domain the frame-1 and frame-2 images as uint8, and the
    shared masks (uint8) and flows (float16), uploaded once. Every sampler
    draws its indices on the host from ``np.random.RandomState(seed)``, in
    vst's order (vst's indices bit for bit), and gathers on the device:
    x_src, x2_src, x_ref (B, 3, H, W) float32 in [−1, 1], y_src, y_ref (B,)
    long, mask (B, 1, H, W), flow (B, 2, H, W).

    ``root`` holds ``styled-files/<style>/<name>.jpg``,
    ``styled-files3/<style>/<stem>_2.jpg`` and ``DATAFiles/<stem>.npy``; the
    first ``num_dom`` styles and the first ``limit`` names are taken, sorted.
    Images are read through PIL (vst reads them with imageio).
    """

    def __init__(self, root: str, num_dom: int = 4, limit: Optional[int] = None,
                 seed: int = 0, device="cuda"):
        sdir, tdir, ddir = (os.path.join(root, d)
                            for d in ("styled-files", "styled-files3", "DATAFiles"))
        styles = sorted(os.listdir(sdir))[:num_dom]
        names = sorted(os.listdir(os.path.join(sdir, styles[0])))[:limit]
        stems = [os.path.splitext(n)[0] for n in names]
        img1 = np.stack([np.stack([_read_image(os.path.join(sdir, sty, n)) for n in names])
                         for sty in styles])
        img2 = np.stack([np.stack([_read_image(os.path.join(tdir, sty, st + "_2.jpg"))
                                   for st in stems]) for sty in styles])
        masks, flows = [], []
        for st in stems:
            d = np.load(os.path.join(ddir, st + ".npy"))[0]
            masks.append(np.round(np.clip(d[:, :, 6:7], 0.0, 1.0)).astype(np.uint8))
            flows.append(d[:, :, 7:9].astype(np.float16))
        self.device = torch.device(device)
        self.num_dom = len(styles)
        self.n = len(names)
        # one copy per tensor; kept NHWC as stored
        self.img1 = torch.from_numpy(img1).to(self.device)  # (D, N, H, W, 3) u8
        self.img2 = torch.from_numpy(img2).to(self.device)
        self.masks = torch.from_numpy(np.stack(masks)).to(self.device)  # (N, H, W, 1) u8
        self.flows = torch.from_numpy(np.stack(flows)).to(self.device)  # (N, H, W, 2) f16
        self._rng = np.random.RandomState(seed)

    def gather(self, idx: torch.Tensor, src: torch.Tensor, ref: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
        """The batch of samples ``idx`` with source domains ``src`` and
        reference domains ``ref`` (device long tensors)."""

        def img(tbl, dom):
            # Normalize(0.5, 0.5): XLA compiles vst's (u / 255)·2 − 1 to one
            # fma, u·float32(2/255) − 1 rounded once; in float64 the product
            # and the difference are exact, so one rounding to float32 is it
            x = (tbl[dom, idx].double() * _TWO_OVER_255 - 1.0).float()
            return x.permute(0, 3, 1, 2).contiguous()

        return {"x_src": img(self.img1, src), "x2_src": img(self.img2, src),
                "x_ref": img(self.img1, ref), "y_src": src, "y_ref": ref,
                "mask": self.masks[idx].float().permute(0, 3, 1, 2).contiguous(),
                "flow": self.flows[idx].float().permute(0, 3, 1, 2).contiguous()}

    def _sample(self, idx, src, ref) -> Dict[str, torch.Tensor]:
        return self.gather(*(_to_device(a, self.device) for a in (idx, src, ref)))

    def sample(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """StarGAN v2's pairs, with DatasetFC2's statistics
        (``data_loader.py:281-288``): each image expands into 1 + 3(D−1)
        entries, (0, 0) once, then (0, k), (k, 0), (k, k) for every k ≥ 1, and
        entries are drawn uniformly; an entry index is drawn and decoded."""
        idx = self._rng.randint(0, self.n, size=(batch_size,))
        e = self._rng.randint(0, 3 * self.num_dom - 2, size=(batch_size,))
        k = (e - 1) // 3 + 1
        r = (e - 1) % 3
        src = np.where(e == 0, 0, np.where(r == 0, 0, k))
        ref = np.where(e == 0, 0, np.where(r == 1, 0, k))
        return self._sample(idx, src, ref)

    def sample_multidomain(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """StarGAN v1's batch (plain domains, ``StarGAN/main.py:30``): an image
        of a uniform domain with its label, and a uniform target label in
        ``y_ref``."""
        idx = self._rng.randint(0, self.n, size=(batch_size,))
        src = self._rng.randint(0, self.num_dom, size=(batch_size,))
        trg = self._rng.randint(0, self.num_dom, size=(batch_size,))
        return self._sample(idx, src, trg)

    def sample_cyclegan(self, batch_size: int, sid: int = 1) -> Dict[str, torch.Tensor]:
        """CycleGAN's unpaired batch (one model a style,
        ``CycleGAN/fc2_dataset.py:19-101``): side A the content (style 0) pair
        with its mask and flow, side B style ``sid`` at an independent index."""
        ia = self._rng.randint(0, self.n, size=(batch_size,))
        ib = self._rng.randint(0, self.n, size=(batch_size,))
        zeros = np.zeros(batch_size, np.int64)
        sids = np.full(batch_size, sid, np.int64)
        a = self._sample(ia, zeros, zeros)
        b = self._sample(ib, sids, sids)
        return {"real_A": a["x_src"], "real_A2": a["x2_src"], "real_B": b["x_src"],
                "real_B2": b["x2_src"], "mask": a["mask"], "flow": a["flow"]}
