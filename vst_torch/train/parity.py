"""One training step's loss and gradients on a device, and the comparison of
two such steps: how the card's step is held against the CPU's
(``chip_smoke.py``, ``tests/test_torch_cuda.py``) and the port's against
vst's (``tests/torch_train_parity.py``).

Gradients are compared per parameter in relative L2. A gradient that is 0 in
exact arithmetic (a conv bias in front of an instance norm, which subtracts
it again) is rounding noise on both sides: below ``ZERO_GRAD`` of the whole
gradient's norm on the reference side it must be below that on the other
side too, and no ratio is taken. Compare float64 gradients: through ReLUs
and max-pools a float32 gradient turns on which units rounding switches on
(0.6–2 % of a parameter's gradient between an H100 and a CPU at 64×64).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from vst_torch.data.styles import load_style_images
from vst_torch.data.synthetic import synthetic_batch
from vst_torch.train.faststyle import FastStyleTrainer, batch_to_tensors
from vst_torch.train.registry import select_method

ZERO_GRAD = 1e-6  # of the whole gradient's norm


def training_step(method: str, device, dtype: torch.dtype, coin: Optional[bool] = None,
                  hw=(64, 64), batch_size: int = 2, seed: int = 0
                  ) -> Tuple[float, Dict[str, float], Dict[str, torch.Tensor]]:
    """(loss, aux terms, every parameter's gradient as float64 on the CPU) of
    one ``method`` step in ``dtype`` on ``device``: seed ``seed``'s weights,
    procedural style 0 at 64², a synthetic batch (seed 1); ``coin`` is
    Ruder's branch."""
    cfg = select_method(method, batch_size=batch_size, n_frames=3 if method == "ruder" else 2)
    trainer = FastStyleTrainer(cfg, load_style_images(size=64)[:1], seed=seed, device=device)
    trainer.to_dtype(dtype)
    batch = batch_to_tensors(synthetic_batch(batch_size, hw=hw, n_frames=cfg.n_frames, seed=1),
                             device)
    loss, aux = trainer.loss_fn({k: v.to(dtype) for k, v in batch.items()}, 0, coin)
    loss.backward()
    return (loss.item(), {k: v.item() for k, v in aux.items()},
            {n: p.grad.double().cpu() for n, p in trainer.model.named_parameters()})


def grad_errors(got: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
                ) -> Tuple[float, float]:
    """(the worst per-parameter ‖got − want‖ / ‖want‖, the same over the
    whole gradient). Raises where ``want`` is 0 in exact arithmetic and
    ``got`` is not, or where a gradient is not finite."""
    if set(got) != set(want):
        raise ValueError(f"different parameters: {sorted(set(got) ^ set(want))}")
    total = sum(float(w.double().norm()) ** 2 for w in want.values()) ** 0.5
    worst, diff = 0.0, 0.0
    for name, w in want.items():
        g = got[name].double()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: gradient not finite")
        d, norm = float((g - w.double()).norm()), float(w.double().norm())
        diff += d ** 2
        if norm < ZERO_GRAD * total:
            if float(g.norm()) >= ZERO_GRAD * total:
                raise AssertionError(f"{name}: gradient 0 on one side only")
        else:
            worst = max(worst, d / norm)
    return worst, diff ** 0.5 / total
