"""The temporal consistency loss of the thesis' Sintel harness, in plain
PyTorch: the benchmark's reference for masks, warps and TCL values.

Semantics of the authors' ``utils/flowtools.py`` and ``sintel_eval.py``:

* frames are padded for RAFT to multiples of 8 by replicating the border,
  the padding split between both sides (RAFT's ``InputPadder``, sintel mode);
* ``warp`` is a backward warp whose grid is normalised by W-1, H-1 and then
  sampled with ``align_corners=False`` (a quirk of the authors' code, kept);
* the mask is the forward-backward consistency test with the motion-boundary
  test (``fbcCheckTorch``);
* TCL(i, j) = RMS(mask * (S(i) - warp(S(j), bf))), where S is the stylized
  frame, ff the flow j -> i, bf the flow i -> j.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def pad_amounts(h: int, w: int, mult: int = 8):
    ph = (((h // mult) + 1) * mult - h) % mult
    pw = (((w // mult) + 1) * mult - w) % mult
    return [pw // 2, pw - pw // 2, ph // 2, ph - ph // 2]


def pad(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, pad_amounts(*x.shape[-2:]), mode="replicate")


def unpad(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    left, _, top, _ = pad_amounts(h, w)
    return x[..., top:top + h, left:left + w]


def warp(x: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    B, _, H, W = x.shape
    ys, xs = torch.meshgrid(torch.arange(H, device=x.device, dtype=x.dtype),
                            torch.arange(W, device=x.device, dtype=x.dtype), indexing="ij")
    gx = 2.0 * (xs + flow[:, 0]) / max(W - 1, 1) - 1.0
    gy = 2.0 * (ys + flow[:, 1]) / max(H - 1, 1) - 1.0
    return F.grid_sample(x, torch.stack([gx, gy], -1), mode="bilinear", padding_mode="zeros",
                         align_corners=False)


def _gradient(x: torch.Tensor):
    """Central differences with zero padding, (dx, dy) of (B, H, W)."""
    dx = (F.pad(x, (0, 1))[:, :, 1:] - F.pad(x, (1, 0))[:, :, :-1]) / 2.0
    dy = (F.pad(x, (0, 0, 0, 1))[:, 1:] - F.pad(x, (0, 0, 1, 0))[:, :-1]) / 2.0
    return dx, dy


def fb_mask(ff: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    """(B, 1, H, W): 1 where consistent, 0 where occluded or on a motion edge."""
    wf = warp(ff, bf)
    occ = ((wf + bf) ** 2).sum(1) > 0.01 * ((wf ** 2).sum(1) + (bf ** 2).sum(1)) + 0.5
    ux, uy = _gradient(bf[:, 0])
    vx, vy = _gradient(bf[:, 1])
    mob = (ux ** 2 + uy ** 2) + (vx ** 2 + vy ** 2) > 0.01 * (bf ** 2).sum(1) + 0.002
    return (~(occ | mob)).to(ff.dtype)[:, None]


def tcl(styled_i: torch.Tensor, styled_j: torch.Tensor, ff: torch.Tensor,
        bf: torch.Tensor) -> torch.Tensor:
    """TCL of one frame pair: styled frames (1, 3, H, W) in [0, 1]."""
    return torch.sqrt(torch.mean((fb_mask(ff, bf) * (styled_i - warp(styled_j, bf))) ** 2))
