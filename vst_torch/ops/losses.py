"""Loss primitives (NCHW), port of ``vst/ops/losses.py``: Gram matrix, total
variation, ImageNet normalisation."""

from __future__ import annotations

import torch

# torchvision ImageNet normalisation of the learning-based VGG16 path
# (``fast_style_transfer.py`` VGG16_MEAN/STD and ``normalize`` :819-822)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """Batched Gram matrix (``fast_style_transfer.py:813-817``): features
    F (B, C, H·W), G = F·Fᵀ / (H·W). x (B, C, H, W) → (B, C, C).

    vst's rule (``preferred_element_type``): float64 stays float64, every
    other dtype accumulates and returns float32, so bf16 features are cast
    to float32 before the product (exactly vst's f32 product of bf16 values).
    vst accumulates at HIGHEST precision; on CUDA that is a float32 ``bmm``
    with TF32 off (``vst_torch.set_f32_precision``)."""
    B, C, H, W = x.shape
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    f = x.reshape(B, C, H * W).to(acc)
    return torch.bmm(f, f.transpose(1, 2)) / (H * W)


def gram_matrix_obst(x: torch.Tensor) -> torch.Tensor:
    """OBST variant (``obst_eval.py:223-229``): the same F·Fᵀ/(h·w), kept
    separate so call sites cite their own reference."""
    return gram_matrix(x)


def _safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with a ZERO subgradient at x == 0.

    d/dx √x → ∞ as x → 0⁺: where adjacent pixels are exactly equal, a plain
    ``torch.sqrt`` turns the training step into NaN, even under a zero loss
    weight (0·∞ = NaN in the chain rule). Values are exact (√0 = 0); only the
    undefined subgradient is chosen as 0, with vst's double ``where``."""
    nonzero = x > 0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def tv_loss(x: torch.Tensor) -> torch.Tensor:
    """Total variation (``fast_style_transfer.py:795-803``, ``calc_tv_loss``):
    the channelwise L2 norm of the forward differences, summed over pixels
    and batch. x (B, C, H, W)."""
    sij = x[:, :, :-1, :-1]
    si1j = x[:, :, 1:, :-1]  # +1 in H
    sij1 = x[:, :, :-1, 1:]  # +1 in W
    tv1 = ((sij1 - sij) ** 2).sum(1)
    tv2 = ((si1j - sij) ** 2).sum(1)
    return _safe_sqrt(tv1 + tv2).sum()


def normalize_imagenet(img: torch.Tensor) -> torch.Tensor:
    """(img − mean) / std with torchvision's ImageNet statistics; img
    (B, 3, H, W) in [0, 1] (``fast_style_transfer.py:819-822``)."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=img.dtype, device=img.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD, dtype=img.dtype, device=img.device)[:, None, None]
    return (img - mean) / std
