"""LPIPS, port of ``vst/metrics/lpips.py`` (``utils/metrics/lpips.py``).

AlexNet's post-ReLU feature maps, each unit-normalized over channels, the
squared difference weighted by the learned 1×1 convs, averaged over space
and summed over the 5 taps. Inputs are in [−1, 1]; the reference shifts them
by μ = (−0.03, −0.088, −0.188), σ = (0.458, 0.448, 0.450) (:58-60).

The learned weights are vst's conversion of the reference's
``lpips_weights.ckpt``, a byte copy at ``vst_torch/metrics/data/
lpips_lin.npz``. The AlexNet keeps torchvision's ``features.{i}`` keys, so a
torchvision ``state_dict`` loads with no converter; without one it is vst's
seeded He-randomized AlexNet, bit for bit (values then differ from the
reference's, the mechanics do not).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.perceptual.vgg import he_randomized_, load_features

_LIN_PATH = os.path.join(os.path.dirname(__file__), "data", "lpips_lin.npz")

MU = (-0.03, -0.088, -0.188)
SIGMA = (0.458, 0.448, 0.450)

ALEX_CHANNELS = (64, 192, 384, 256, 256)


class AlexNetFeatures(nn.Module):
    """torchvision ``alexnet.features`` up to its last ReLU, returning the 5
    post-ReLU maps (``lpips.py:20-33``)."""

    TAPS = (1, 4, 7, 9, 11)

    def __init__(self):
        super().__init__()
        self.features = nn.Sequential(
            nn.Conv2d(3, 64, 11, stride=4, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(64, 192, 5, padding=2), nn.ReLU(), nn.MaxPool2d(3, 2),
            nn.Conv2d(192, 384, 3, padding=1), nn.ReLU(),
            nn.Conv2d(384, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, 256, 3, padding=1), nn.ReLU())

    def forward(self, x) -> List[torch.Tensor]:
        taps = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.TAPS:
                taps.append(x)
        return taps


def load_lin_weights(path: Optional[str] = None) -> List[np.ndarray]:
    """The 5 learned (C,) weight vectors (the squeezed 1×1 convs)."""
    path = path or _LIN_PATH
    if os.path.exists(path):
        data = np.load(path)
        return [data[f"w{i}"] for i in range(5)]
    # without the file: uniform weights (not the reference's)
    return [np.full((c,), 1.0 / c, np.float32) for c in ALEX_CHANNELS]


def convert_lin_weights_from_ckpt(ckpt_path: str, out_path: Optional[str] = None) -> str:
    """One-time conversion of the reference's ``lpips_weights.ckpt`` (keys
    ``lpips_weights.{i}.main.1.weight`` shaped (1, C, 1, 1)) to the .npz."""
    sd = torch.load(ckpt_path, map_location="cpu")
    out_path = out_path or _LIN_PATH
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    np.savez(out_path, **{f"w{i}": sd[f"lpips_weights.{i}.main.1.weight"].detach().numpy()
                          .reshape(-1).astype(np.float32) for i in range(5)})
    return out_path


def _unit_normalize(x, eps=1e-10):
    return x * torch.rsqrt(torch.sum(x ** 2, dim=1, keepdim=True) + eps)


class LPIPS:
    """The bound metric: ``lpips(x, y)`` over [−1, 1] (B, 3, H, W) images,
    a float (the mean over the batch)."""

    def __init__(self, alexnet_sd: Optional[Dict[str, torch.Tensor]] = None,
                 lin_path: Optional[str] = None, seed: int = 0, device="cuda"):
        net = AlexNetFeatures()
        if alexnet_sd is not None:
            load_features(net, alexnet_sd)
            self.backbone = "torchvision-alexnet"
        else:
            # He-scaled so random features stay discriminative at depth; the
            # lin head weights are the reference's all the same
            he_randomized_(net, seed)
            self.backbone = "random-he"
        self.device = torch.device(device)
        self.net = net.requires_grad_(False).eval().to(self.device)
        self.lin = [torch.from_numpy(np.asarray(w, np.float32)).to(self.device)
                    for w in load_lin_weights(lin_path)]

    @torch.no_grad()
    def __call__(self, x, y) -> float:
        x = torch.as_tensor(x).to(self.device, torch.float32)
        y = torch.as_tensor(y).to(self.device, torch.float32)
        mu = torch.tensor(MU, device=self.device)[:, None, None]
        sigma = torch.tensor(SIGMA, device=self.device)[:, None, None]
        val = 0.0
        for a, b, w in zip(self.net((x - mu) / sigma), self.net((y - mu) / sigma), self.lin):
            # a 1×1 conv with weight w, then the mean: the mean over (B, H, W)
            # of Σ_c w_c·d²
            d = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            val = val + torch.mean(torch.sum(d * w[:, None, None], dim=1))
        return float(val)


def lpips_pairwise(lpips: LPIPS, group_of_images: Sequence) -> float:
    """``calculate_lpips_given_images`` (:85-98): the mean pairwise distance
    over the group."""
    vals = []
    n = len(group_of_images)
    for i in range(n - 1):
        for j in range(i + 1, n):
            vals.append(lpips(group_of_images[i], group_of_images[j]))
    return float(np.mean(vals))
