"""The FAN face-landmark net (wing), NCHW, port of ``vst/models/wing.py``
(``StarGANv2Adv/core/wing.py``).

StarGAN v2 runs it only with ``w_hpf > 0``: its heatmaps become the masks of
the generator's high-pass skips. Module names are the reference's
``state_dict`` keys (``conv1.conv.weight``, ``m0.b1_4.conv1.weight``,
``downsample.0`` the batch norm and ``downsample.2`` the conv, ``bn_end0``,
``l0``, …), so a ``wing.ckpt`` loads unchanged and vst's
``fan_params_from_torch`` (``vst/models/wing.py:264``) reads the port's
weights.

Parts: the pre-activation ``ConvBlock`` with its ½ + ¼ + ¼ channel split
(``wing.py:154-188``), ``CoordConvTh`` with coordinate, radius and boundary
channels (``:92-150``), the depth-4 ``HourGlass`` (``:49-87``), the
one-module ``FAN`` (``:190-246``), and ``get_heatmap`` with the 98-landmark
mask pipeline (truncate, min-max normalise, shift, power, ``:437-539``).

As vst's: batch norm is inference-mode only (stored statistics, eps 1e-5),
so :class:`FAN` stays in ``eval()`` whatever ``train()`` is asked; the
coordinate channels keep the reference's swapped names (x varies along the
rows, ``wing.py:98-101``) and ``rr`` is divided by its own max; their sizes
are fixed (256² in the stem, 64² in the hourglass), so the FAN takes
256×256 images and :func:`get_heatmap` resizes to that first.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.ops.image import avg_pool2d, resize_bilinear, resize_nearest

FAN_HW = 256  # the input size the coordinate channels are built for


def _conv3x3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, 1, 1, bias=False)


class ConvBlock(nn.Module):
    """``wing.py:154-188``: three pre-activation 3×3 convs (out/2, out/4,
    out/4 channels) concatenated, plus the input or, on a change of width,
    a pre-activation 1×1 conv of it."""

    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.bn1 = nn.BatchNorm2d(in_planes)
        self.conv1 = _conv3x3(in_planes, out_planes // 2)
        self.bn2 = nn.BatchNorm2d(out_planes // 2)
        self.conv2 = _conv3x3(out_planes // 2, out_planes // 4)
        self.bn3 = nn.BatchNorm2d(out_planes // 4)
        self.conv3 = _conv3x3(out_planes // 4, out_planes // 4)
        self.downsample = None
        if in_planes != out_planes:
            self.downsample = nn.Sequential(nn.BatchNorm2d(in_planes), nn.ReLU(),
                                            nn.Conv2d(in_planes, out_planes, 1, 1, bias=False))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        o1 = self.conv1(F.relu(self.bn1(x)))
        o2 = self.conv2(F.relu(self.bn2(o1)))
        o3 = self.conv3(F.relu(self.bn3(o2)))
        residual = x if self.downsample is None else self.downsample(x)
        return torch.cat([o1, o2, o3], 1) + residual


def coord_channels(h: int, w: int, with_r: bool, device=None) -> torch.Tensor:
    """(2 or 3, h, w): x varying along the rows, y along the columns, both in
    [−1, 1], and with ``with_r`` their radius over its max."""
    xs = (torch.arange(h, dtype=torch.float32, device=device)[:, None].expand(h, w)
          / (h - 1)) * 2 - 1
    ys = (torch.arange(w, dtype=torch.float32, device=device)[None, :].expand(h, w)
          / (w - 1)) * 2 - 1
    chans = [xs, ys]
    if with_r:
        rr = torch.sqrt(xs ** 2 + ys ** 2)
        chans.append(rr / rr.max())
    return torch.stack(chans)


class CoordConvTh(nn.Module):
    """``wing.py:92-150``: the input with its coordinate channels (and, with a
    boundary heatmap, the coordinates where the boundary passes 0.05)
    concatenated, then a conv. Returns (the conv's output, the last two
    concatenated channels). The conv's input width is the reference's: the
    boundary's two channels are counted unless ``first_one``."""

    def __init__(self, height: int, width: int, with_r: bool, with_boundary: bool,
                 in_channels: int, first_one: bool = False, *, out_channels: int,
                 kernel_size: int, stride: int = 1, padding: int = 0):
        super().__init__()
        self.height, self.width = height, width
        self.with_r, self.with_boundary = with_r, with_boundary
        in_channels += 3 if with_r else 2
        if with_boundary and not first_one:
            in_channels += 2
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size, stride, padding)

    def forward(self, x: torch.Tensor, heatmap: Optional[torch.Tensor] = None):
        B = x.shape[0]
        coords = coord_channels(self.height, self.width, self.with_r, x.device).to(x.dtype)
        coords = coords[None].expand(B, -1, -1, -1)
        if self.with_boundary and heatmap is not None:
            boundary = heatmap[:, -1:].clamp(0.0, 1.0)
            xy = coords[:, :2]
            coords = torch.cat([coords, torch.where(boundary > 0.05, xy, torch.zeros_like(xy))], 1)
        ret = torch.cat([x, coords], 1)
        return self.conv(ret), ret[:, -2:]


class HourGlass(nn.Module):
    """``wing.py:49-87``: its ``CoordConvTh`` (64², 256 + 3 channels in the
    FAN's first module), then the depth-``depth`` recursion of ConvBlocks:
    up = b1(x), low = b3(inner(b2(pool(x)))), out = up + nearest×2(low)."""

    def __init__(self, depth: int = 4, first_one: bool = False):
        super().__init__()
        self.depth = depth
        self.coordconv = CoordConvTh(64, 64, True, True, 256, first_one, out_channels=256,
                                     kernel_size=1, stride=1, padding=0)
        for level in range(depth, 0, -1):
            self.add_module(f"b1_{level}", ConvBlock(256, 256))
            self.add_module(f"b2_{level}", ConvBlock(256, 256))
            if level == 1:
                self.add_module(f"b2_plus_{level}", ConvBlock(256, 256))
            self.add_module(f"b3_{level}", ConvBlock(256, 256))

    def _level(self, level: int, inp: torch.Tensor) -> torch.Tensor:
        up1 = self._modules[f"b1_{level}"](inp)
        low1 = self._modules[f"b2_{level}"](avg_pool2d(inp, 2, 2))
        if level > 1:
            low2 = self._level(level - 1, low1)
        else:
            low2 = self._modules[f"b2_plus_{level}"](low1)
        low3 = self._modules[f"b3_{level}"](low2)
        return up1 + resize_nearest(low3, 2)

    def forward(self, x: torch.Tensor, heatmap: Optional[torch.Tensor]):
        x, last = self.coordconv(x, heatmap)
        return self._level(self.depth, x), last


class FAN(nn.Module):
    """``wing.py:190-246`` with one module and 98 landmarks: (B, 3, 256, 256)
    images in [0, 1] → (heatmaps (B, 99, 64, 64), the last landmark the
    boundary; the hourglass's last two coordinate channels (B, 2, 64, 64))."""

    def __init__(self, num_landmarks: int = 98):
        super().__init__()
        self.conv1 = CoordConvTh(FAN_HW, FAN_HW, True, False, 3, out_channels=64, kernel_size=7,
                                 stride=2, padding=3)
        self.bn1 = nn.BatchNorm2d(64)
        self.conv2 = ConvBlock(64, 128)
        self.conv3 = ConvBlock(128, 128)
        self.conv4 = ConvBlock(128, 256)
        self.m0 = HourGlass(4, first_one=True)
        self.top_m_0 = ConvBlock(256, 256)
        self.conv_last0 = nn.Conv2d(256, 256, 1, 1, 0)
        self.bn_end0 = nn.BatchNorm2d(256)
        self.l0 = nn.Conv2d(256, num_landmarks + 1, 1, 1, 0)
        self.eval()

    def train(self, mode: bool = True) -> "FAN":
        """Batch norm here is inference-only, as vst's ``_BN``: always eval."""
        return super().train(False)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x, _ = self.conv1(x)
        x = F.relu(self.bn1(x))
        x = avg_pool2d(self.conv2(x), 2, 2)
        x = self.conv4(self.conv3(x))
        ll, boundary = self.m0(x, None)
        ll = self.top_m_0(ll)
        ll = F.relu(self.bn_end0(self.conv_last0(ll)))
        return self.l0(ll), boundary


# ---------------------------------------------------------------------------
# heatmaps → masks (wing.py:437-539)
# ---------------------------------------------------------------------------

IDX = {
    "chin": (8, 25), "eyebrows": (33, 51), "eyebrowsedges": (33, 46),
    "nose": (51, 55), "nostrils": (55, 60), "eyes": (60, 76),
    "lipedges": (76, 82), "lipupper": (77, 82), "liplower": (83, 88),
    "lipinner": (88, 96),
}
_ZEROED = (list(range(0, IDX["chin"][0])) + list(range(IDX["chin"][1], 33))
           + [IDX["eyebrowsedges"][0], IDX["eyebrowsedges"][1],
              IDX["lipedges"][0], IDX["lipedges"][1]])


def _minmax_normalize(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Each (sample, channel) map to [0, 1] by its own min and max."""
    flat = x.flatten(2)
    mx = flat.max(dim=2, keepdim=True).values
    mn = flat.min(dim=2, keepdim=True).values
    return ((flat - mn) / (mx - mn + eps)).view_as(x)


def _shift(x: torch.Tensor, n: int) -> torch.Tensor:
    """Vertical circular shift by ``n`` rows (``wing.py:459-477``)."""
    return x if n == 0 else torch.roll(x, n, dims=2)


def preprocess_heatmaps(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """98-channel landmark heatmaps (B, 98, H, W) → (mask, mask2), each
    (B, 1, H, W) (``wing.py:494-539``; mask2 leaves out the chin, the
    eyebrows and the mouth). Shifts scale with H // 256, except the eyes'
    −8 and −24 rows, as in the reference."""
    x = torch.where(x < 0.1, torch.zeros_like(x), x)
    x = _minmax_normalize(x)
    sw = x.shape[2] // 256
    ops = {"chin": (0, 3), "eyebrows": (-7 * sw, 2), "nostrils": (8 * sw, 4),
           "lipupper": (-8 * sw, 4), "liplower": (8 * sw, 4), "lipinner": (-2 * sw, 3)}
    for part, (sh, power) in ops.items():
        s, e = IDX[part]
        x[:, s:e] = _shift(x[:, s:e], sh) ** power
    x[:, _ZEROED] = 0.0
    s, e = IDX["nose"]
    x[:, s + 1:e] = _shift(x[:, s + 1:e], 4 * sw)
    s, e = IDX["eyes"]
    eyes = x[:, s:e]
    x[:, s:e] = _shift(eyes, -8) ** 3 + _shift(eyes, -24)

    x2 = x.clone()
    for part in ("chin", "eyebrows"):
        s, e = IDX[part]
        x2[:, s:e] = 0.0
    x2[:, IDX["lipedges"][0]:IDX["lipinner"][1]] = 0.0
    return (torch.nan_to_num(x.sum(1, keepdim=True)),
            torch.nan_to_num(x2.sum(1, keepdim=True)))


@torch.no_grad()
def get_heatmap(fan: FAN, x: torch.Tensor, preprocess: bool = True):
    """``wing.py:249-260``: NCHW images in [−1, 1] resized to 256² (bilinear,
    align_corners=False), mapped to [0, 1], through the FAN, the boundary
    channel dropped. With ``preprocess`` the heatmaps go back up to 256²
    (bilinear, align_corners=True) and through :func:`preprocess_heatmaps`,
    giving (mask, mask2); without, the (B, 98, 64, 64) heatmaps (the
    landmark path, ``wing.py:262-272``)."""
    x = resize_bilinear(x, (FAN_HW, FAN_HW), align_corners=False)
    heat, _ = fan(x * 0.5 + 0.5)
    heat = heat[:, :-1]
    if not preprocess:
        return heat
    heat = resize_bilinear(heat, (FAN_HW, FAN_HW), align_corners=True)
    return preprocess_heatmaps(heat)
