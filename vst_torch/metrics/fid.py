"""FID, port of ``vst/metrics/fid.py`` (``utils/metrics/fid.py``).

InceptionV3 pool3 activations on the device, then per-pile mean and
covariance and the Fréchet distance in float64 numpy / SciPy on the host
(:56-59): the host math is vst's, copied as it is.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

import numpy as np
import torch
from scipy import linalg

from vst_torch.metrics.inception import InceptionV3Trunk
from vst_torch.perceptual.vgg import he_randomized_, load_features


class InceptionV3:
    """The bound feature extractor: torchvision's weights from a user's
    ``state_dict`` (``backbone`` "torchvision-inception"), or vst's seeded
    He-randomized trunk ("random-he"; batch norms keep their init), bit for
    bit vst's for a seed. Numbers from the random trunk are a pipeline test,
    not comparable with the reference's FID magnitudes."""

    def __init__(self, torch_state_dict: Optional[Dict[str, torch.Tensor]] = None,
                 seed: int = 0, device="cuda"):
        net = InceptionV3Trunk()
        if torch_state_dict is not None:
            load_features(net, torch_state_dict)
            self.backbone = "torchvision-inception"
        else:
            # torch's default init vanishes features at depth (every image
            # maps to about the same activations); He-scaled features stay
            # discriminative
            he_randomized_(net, seed)
            self.backbone = "random-he"
        self.device = torch.device(device)
        self.net = net.requires_grad_(False).eval().to(self.device)

    @torch.no_grad()
    def __call__(self, images, chunk: int = 16) -> np.ndarray:
        """images: (B, 3, H, W), a tensor or an array, in the eval pipeline's
        range. Returns (B, 2048) activations. Runs in chunks of ``chunk``, the
        last one zero-padded and trimmed as vst does (the batch norms use
        their stored statistics, so the padding changes nothing)."""
        images = torch.as_tensor(images).to(self.device, torch.float32)
        n = images.shape[0]
        outs = []
        for i in range(0, n, chunk):
            part = images[i:i + chunk]
            if part.shape[0] < chunk:
                pad = part.new_zeros((chunk - part.shape[0],) + part.shape[1:])
                part = torch.cat([part, pad], 0)
            outs.append(self.net(part))
        return torch.cat(outs, 0)[:n].cpu().numpy()


def frechet_distance(mu, cov, mu2, cov2) -> float:
    """``fid.py:56-59``."""
    cc = linalg.sqrtm(np.atleast_2d(np.dot(cov, cov2)))
    # SciPy before 1.18 returns (sqrtm, errest) with disp=False; from 1.17 on,
    # without disp, the array alone: take either
    if isinstance(cc, tuple):
        cc = cc[0]
    dist = np.sum((mu - mu2) ** 2) + np.trace(cov + cov2 - 2 * cc)
    return float(np.real(dist))


def activation_stats(actvs: np.ndarray):
    return np.mean(actvs, axis=0), np.cov(actvs, rowvar=False)


def fid_from_activations(actvs1: np.ndarray, actvs2: np.ndarray) -> float:
    """Fréchet distance of two activation piles.

    Equal to ``frechet_distance(activation_stats(...))``, but when both piles
    are smaller than the feature dimension the cross term is computed in the
    sample subspace: the nonzero eigenvalues of cov1·cov2 are those of the
    (n1, n1) matrix (X1 X2ᵀ)(X2 X1ᵀ)/((n1−1)(n2−1)) for centred piles Xi, so
    tr √(cov1·cov2) = Σ √λ needs no 2048² sqrtm."""
    # a random trunk on far-out-of-distribution pixels can overflow float32
    # to inf; sanitize so the eigensolver stays stable
    a1 = np.nan_to_num(np.asarray(actvs1, np.float64), nan=0.0, posinf=1e6, neginf=-1e6)
    a2 = np.nan_to_num(np.asarray(actvs2, np.float64), nan=0.0, posinf=1e6, neginf=-1e6)
    n1, d = a1.shape
    n2 = a2.shape[0]
    if min(n1, n2) >= 2 and max(n1, n2) < d:
        mu1, mu2 = a1.mean(0), a2.mean(0)
        x1 = (a1 - mu1) / np.sqrt(n1 - 1)
        x2 = (a2 - mu2) / np.sqrt(n2 - 1)
        cross = x1 @ x2.T          # (n1, n2)
        small = cross @ cross.T    # (n1, n1): the spectrum of cov1·cov2
        ev = np.linalg.eigvalsh((small + small.T) / 2)
        tr_sqrt = np.sum(np.sqrt(np.clip(ev, 0.0, None)))
        tr1 = float(np.sum(x1 * x1))
        tr2 = float(np.sum(x2 * x2))
        return float(np.sum((mu1 - mu2) ** 2) + tr1 + tr2 - 2.0 * tr_sqrt)
    mu1, cov1 = activation_stats(a1)
    mu2, cov2 = activation_stats(a2)
    return frechet_distance(mu1, cov1, mu2, cov2)


def fid_from_image_batches(inception: InceptionV3, batches1: Iterable, batches2: Iterable
                           ) -> float:
    """``calculate_fid_given_paths`` (:62-79) over in-memory batch iterables
    of (B, 3, H, W) images in place of directory loaders."""
    actvs = [np.concatenate([inception(b) for b in batches], axis=0)
             for batches in (batches1, batches2)]
    return fid_from_activations(actvs[0], actvs[1])
