"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full power limit of 700 W), copied from the port's
``vst_torch/core/roofline.py``. The benchmark runs float32 with TF32 off, so
its products are held to the float32 rate outside the tensor cores."""

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12


def bound_s(nbytes: float, ops: float, ops_per_s: float = PEAK_F32_OPS_PER_S) -> float:
    """The least seconds the chip could take: the larger of bytes over the
    memory rate and operations over ``ops_per_s``."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / ops_per_s)
