"""The least time an H100 SXM could take for a piece of work, from the
published peaks (NVIDIA data sheet, dense rates, 700 W): the larger of the
bytes over the memory rate and the operations over the rate of the unit
that does them. Count each input byte read once and each output byte
written once."""

from __future__ import annotations

from typing import Tuple

import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12          # float32 outside the tensor cores
PEAK_BF16_TENSOR_OPS_PER_S = 989e12  # bf16 on the tensor cores, f32 accumulation


def product_ops_per_s(dtype: torch.dtype) -> float:
    """The peak for matrix products in ``dtype`` (float32 runs with TF32 off)."""
    return PEAK_BF16_TENSOR_OPS_PER_S if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S


def bound(nbytes: float, ops: float, ops_per_s: float) -> Tuple[float, str]:
    """(bound in ms, "bytes" or "operations", whichever bounds it)."""
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")
