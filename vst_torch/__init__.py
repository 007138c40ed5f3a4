"""vst_torch — the PyTorch/CUDA port of vst for one NVIDIA H100.

Tensors are NCHW (PyTorch's layout and the torch reference's); the JAX
package ``vst`` keeps NHWC. Modules keep the torch reference's
``state_dict`` key names, so ``vst_torch.convert`` and vst's
``*_params_from_torch`` carry weights both ways.

Entry points run on CUDA unless the caller passes ``device="cpu"``. The one
hand-written kernel (RAFT's correlation-window lookup,
``vst_torch/csrc/corr_lookup.cu``) launches for CUDA tensors; for CPU
tensors its wrapper computes the plain PyTorch version.

This package imports torch, numpy and scipy only — never jax, flax or vst.
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
