"""The compute-dtype policy of the GAN trainers, port of ``vst/train/policy.py``.

The reference trains the GAN families in float32. vst adds an optional
compute dtype, and the port keeps vst's function, which is casts, not
``torch.autocast`` (autocast picks a dtype op by op, which is another
function):

* master parameters and optimizer state stay float32;
* the loss function casts the parameters and the image and latent inputs to
  the compute dtype on entry (:func:`call`, or :func:`caller` for the
  nets of one loss, through ``torch.func.functional_call``); the gradients come back through the
  casts and reach the float32 masters as float32;
* instance-norm statistics are float32 whatever the activations' dtype
  (``vst_torch.nn.norm.instance_norm``);
* losses are reduced in float32 (:func:`f32` at the loss sites).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

_ALIASES = {"bf16": "bfloat16", "f32": "float32", "fp32": "float32",
            "f16": "float16", "fp16": "float16"}


def compute_dtype_of(name: Optional[str]) -> Optional[torch.dtype]:
    """A config string (``bfloat16`` or a short alias) → its torch dtype;
    None or "" → None, full float32 (the reference's policy)."""
    if not name:
        return None
    dtype = getattr(torch, _ALIASES.get(name, name), None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown compute dtype {name!r}")
    return dtype


def cast_img(x: Optional[torch.Tensor], dtype: Optional[torch.dtype]):
    """An image or latent input in the compute dtype (as it is for None)."""
    return x if dtype is None or x is None else x.to(dtype)


def cast_params(net: torch.nn.Module, dtype: Optional[torch.dtype]) -> Dict[str, torch.Tensor]:
    """``net``'s float32 parameters cast to ``dtype`` (the casts stay on the
    autograd graph, so gradients reach the float32 masters); the others, and
    every parameter for ``dtype=None``, as they are."""
    return {n: p.to(dtype) if dtype is not None and p.dtype == torch.float32 else p
            for n, p in net.named_parameters()}


def call(net: torch.nn.Module, dtype: Optional[torch.dtype], *args):
    """``net(*args)`` with its parameters in the compute dtype; ``net``
    itself for ``dtype=None``."""
    if dtype is None:
        return net(*args)
    return functional_call(net, cast_params(net, dtype), args)


def caller(nets: Dict[str, torch.nn.Module], names, dtype: Optional[torch.dtype]
           ) -> Callable[..., torch.Tensor]:
    """``f(name, *args)``: ``call(nets[name], dtype, *args)`` with the
    parameters of each net of ``names`` cast once, when ``f`` is made, as
    vst casts the parameter tree once a loss (``cast_tree``). Make one a
    loss, after the last update of those parameters."""
    if dtype is None:
        return lambda name, *args: nets[name](*args)
    params = {k: cast_params(nets[k], dtype) for k in names}
    return lambda name, *args: functional_call(nets[name], params[name], args)


def f32(x: torch.Tensor) -> torch.Tensor:
    """The loss sites' upcast: reductions accumulate in float32 (float64
    stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
