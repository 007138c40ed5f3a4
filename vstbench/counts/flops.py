"""Operations a unit of work needs, counted on the frozen reference.

The matrix products and convolutions (2 operations a multiply-add, forward
and backward) of a call on the meta device are counted with PyTorch's FLOP
formulas (``torch.utils.flop_counter.flop_registry``), so no memory is
touched and the count follows the reference, not the program: a convolution
the program moves into a hand-written kernel stays in the count. The
counting mode tracks no modules (``FlopCounterMode``'s module tracker
refuses ``autograd.grad`` on a leaf, which R1's double backward takes).
"""

from __future__ import annotations

from typing import Callable

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class _Counter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out


def count(fn: Callable[[], object]) -> int:
    """Operations of ``fn()``, whose tensors lie on the meta device."""
    with _Counter() as mode:
        fn()
    return int(mode.total)
