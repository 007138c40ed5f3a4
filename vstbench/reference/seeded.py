"""Weights drawn from a seed on the device, in a few large calls.

A net is built on the meta device (no memory, no init), moved to the target
device uninitialised, and every entry of its ``state_dict`` is filled from
one normal and one uniform draw of a ``torch.Generator`` on that device,
sliced in the order of the ``state_dict``. ``rule(name, tensor)`` says how
each entry is drawn: ``("normal", mean, std)``, ``("uniform", bound)``
(U(-bound, bound)) or ``("const", value)``. The same seed on the same device
gives the same weights.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
from torch import nn

Rule = Callable[[str, torch.Tensor], Tuple]


def build(make: Callable[[], nn.Module], device) -> nn.Module:
    """``make()`` on the meta device, then moved, uninitialised, to ``device``."""
    with torch.device("meta"):
        net = make()
    return net.to_empty(device=device)


@torch.no_grad()
def fill(net: nn.Module, generator: torch.Generator, rule: Rule) -> nn.Module:
    """Fill every ``state_dict`` entry of ``net`` by ``rule`` from two draws of
    ``generator`` (on ``net``'s device)."""
    entries = list(net.state_dict(keep_vars=True).items())
    specs = [(name, t, rule(name, t)) for name, t in entries]
    n_normal = sum(t.numel() for _, t, s in specs if s[0] == "normal")
    n_uniform = sum(t.numel() for _, t, s in specs if s[0] == "uniform")
    device = generator.device
    normal = torch.randn(n_normal, generator=generator, device=device)
    uniform = torch.rand(n_uniform, generator=generator, device=device).mul_(2.0).sub_(1.0)
    i_n = i_u = 0
    for _, t, spec in specs:
        kind = spec[0]
        if kind == "normal":
            t.copy_(normal[i_n:i_n + t.numel()].view_as(t).mul(spec[2]).add(spec[1]))
            i_n += t.numel()
        elif kind == "uniform":
            t.copy_(uniform[i_u:i_u + t.numel()].view_as(t).mul(spec[1]))
            i_u += t.numel()
        elif kind == "const":
            t.fill_(spec[1])
        else:
            raise ValueError(f"unknown init kind {kind!r}")
    return net


def fan_in(weight: torch.Tensor) -> int:
    return weight.shape[1] * math.prod(weight.shape[2:])


def torch_default(name: str, t: torch.Tensor, weights: dict) -> Tuple:
    """PyTorch's default of a conv or linear: weight and bias U(±1/√fan_in)
    (kaiming_uniform with a=√5 gives that bound for the weight)."""
    w = weights[name.rsplit(".", 1)[0] + ".weight"]
    return ("uniform", 1.0 / math.sqrt(fan_in(w)))


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (any non-negative
    integer below 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 64))
