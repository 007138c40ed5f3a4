"""vst_torch — the PyTorch/CUDA port of vst for one NVIDIA H100.

Tensors are NCHW (PyTorch's layout and the torch reference's); the JAX
package ``vst`` keeps NHWC. Modules keep the torch reference's
``state_dict`` key names, so ``vst_torch.convert`` and vst's
``*_params_from_torch`` carry weights both ways.

Entry points run on CUDA unless the caller passes ``device="cpu"``. The
hand-written Hopper kernels (``vst_torch/csrc/``: RAFT's correlation-window
lookup, the reflect-pad 3×3 trunk conv in four cost modes, the in-kernel
matrix-product rate probe) launch for CUDA tensors; for CPU tensors their
wrappers (``vst_torch/kernels/``) compute the plain PyTorch versions.

This package imports torch, numpy and scipy only — never jax, flax or vst;
the commands that read video files or write videos import cv2 or imageio
inside themselves.
"""

import torch


def set_f32_precision() -> None:
    """Run float32 matmuls and cuDNN convolutions in full float32.

    PyTorch runs cuDNN convolutions in TF32 by default, which keeps about
    three decimal digits; the JAX reference computes the RAFT correlation
    volume at HIGHEST precision. The entry points call this before they run.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
