"""Image primitives (pad / resize / pool), NCHW, port of ``vst/ops/image.py``."""

from __future__ import annotations

import torch
import torch.nn.functional as F


# CUDA's reflection pad indexes in 32 bits and refuses larger tensors
MAX_32BIT_NUMEL = 2 ** 31 - 1


def reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """ReflectionPad2d (reference ``methods/learning-based/network.py:101-103``).
    A batch whose padded size passes 32-bit indexing (FastStyleNet's decoder
    at batch 128 × 436×1024) is padded in batch chunks that fit."""
    if pad == 0:
        return x
    n, c, h, w = x.shape
    per_sample = c * (h + 2 * pad) * (w + 2 * pad)
    if n * per_sample <= MAX_32BIT_NUMEL or n == 1:
        return F.pad(x, (pad, pad, pad, pad), mode="reflect")
    chunk = max(1, MAX_32BIT_NUMEL // per_sample)
    return torch.cat([F.pad(part, (pad, pad, pad, pad), mode="reflect")
                      for part in x.split(chunk)], 0)


def replicate_pad(x: torch.Tensor, pad) -> torch.Tensor:
    """F.pad(mode='replicate'); pad = (left, right, top, bottom)."""
    return F.pad(x, tuple(pad), mode="replicate")


def resize_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest upsample by an integer factor (UpsampleConvLayer)."""
    return x.repeat_interleave(scale, dim=2).repeat_interleave(scale, dim=3)


def resize_bilinear(x: torch.Tensor, out_hw, align_corners: bool = False) -> torch.Tensor:
    """F.interpolate(mode='bilinear'); align_corners=True serves RAFT's upflow8."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=align_corners)


def avg_pool2d(x: torch.Tensor, window: int = 2, stride: int = 2) -> torch.Tensor:
    """F.avg_pool2d, floor mode (the corr pyramid, reference ``corr.py:26``)."""
    return F.avg_pool2d(x, window, stride)


class InputPadder:
    """Pads images so H, W are divisible by ``mult`` with replicate padding —
    ``utils/raft/raft/utils/utils.py:7-24``; mode='sintel' centres the pad,
    otherwise the rows are padded at the bottom."""

    def __init__(self, dims, mode: str = "sintel", mult: int = 8):
        self.ht, self.wd = dims[-2], dims[-1]  # NCHW
        pad_ht = (((self.ht // mult) + 1) * mult - self.ht) % mult
        pad_wd = (((self.wd // mult) + 1) * mult - self.wd) % mult
        if mode == "sintel":
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                         pad_ht // 2, pad_ht - pad_ht // 2]
        else:
            self._pad = [pad_wd // 2, pad_wd - pad_wd // 2, 0, pad_ht]

    def pad(self, *inputs):
        return [replicate_pad(x, self._pad) for x in inputs]

    def unpad(self, x):
        ht, wd = x.shape[-2], x.shape[-1]
        c = [self._pad[2], ht - self._pad[3], self._pad[0], wd - self._pad[1]]
        return x[..., c[0]:c[1], c[2]:c[3]]
