"""The device's side of a run: synchronise, memory peak, TF32, and the rule
that a measurement needs a card (there is no fallback to the CPU)."""

from __future__ import annotations

import gc

import torch


def is_cuda(dev) -> bool:
    return torch.device(dev).type == "cuda"


def sync(dev) -> None:
    if is_cuda(dev):
        torch.cuda.synchronize()


def reset_peak(dev) -> None:
    if is_cuda(dev):
        torch.cuda.reset_peak_memory_stats()


def peak(dev) -> int:
    return torch.cuda.max_memory_allocated() if is_cuda(dev) else 0


def free(dev) -> None:
    """Collect the program's objects (hooks and wrappers make cycles) and
    return their memory to the card."""
    gc.collect()
    if is_cuda(dev):
        torch.cuda.empty_cache()


def cards_missing(need: int) -> str:
    """Why ``need`` cards are not there, or "" when they are."""
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the card and has no CPU fallback"
    if torch.cuda.device_count() < need:
        return f"the cell needs {need} CUDA devices, {torch.cuda.device_count()} found"
    return ""


class tf32:
    """TF32 on or off for matmuls and cuDNN inside the block."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        self.before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = self.on

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.before
