"""Device-resident FC2 corpus, port of ``vst/data/device_cache.py:26``
(``DeviceFC2Cache``).

The reference streams every batch host → GPU inside ``__getitem__``
(``datasets.py:75-77``). A quantized FC2-style corpus fits in device memory:
images as uint8 (they came from .jpg), masks as uint8, flows as float16
(FC2 flow magnitudes ≪ 2048), about 0.6 MB a 256² sample. The cache uploads
each of the three tensors once; then every batch is a gather and a
dequantize on the device, and only its indices cross from the host.

The cache lives on the device it is given; it has no fallback to the host.
``DeviceStyledCache`` and its multi-domain samplers belong to the GAN family
and are not ported yet.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch


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
        idx = torch.from_numpy(self._rng.randint(0, self.n, size=(batch_size,)))
        if self.device.type == "cuda":  # from pinned memory: the host does not wait for the card
            idx = idx.pin_memory().to(self.device, non_blocking=True)
        return self.gather(idx.to(self.device))
