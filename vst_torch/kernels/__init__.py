"""Hand-written Hopper kernels and their wrappers.

Each wrapper computes its kernel's plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors, or raises; it never falls back.
"""
