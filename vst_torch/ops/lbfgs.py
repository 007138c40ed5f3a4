"""torch-semantics L-BFGS as a plain loop over tensors, port of
``vst/ops/lbfgs.py``.

The reference's OBST drives ``torch.optim.LBFGS`` with its defaults (lr 1,
20 iterations a ``.step(closure)``, no line search, history 100) inside
``while n_iter <= max_iter: optimizer.step(closure)``
(``obst_eval.py:383-404``): the first step is scaled by ``min(1, 1/‖g‖₁)``,
and the outer loop counts closure calls, so ``[50, 40, 30]`` runs
``[60, 60, 40]`` iterations (:func:`torch_eval_counts`).

:func:`lbfgs_minimize` replicates ``torch.optim.LBFGS.step``'s no-line-search
branch: the same two-loop recursion with ``ys > 1e-10`` curvature gating,
``H_diag = ys / (y·y)``, the first-step rule and the four break conditions
(``max|g| ≤ tol_grad``, ``gtd > −tol_change``, ``max|t·d| ≤ tol_change``,
``|Δloss| < tol_change``), emulated as a ``done`` flag that freezes the
iterate, as vst's ``lax.scan`` does. The history is preallocated ``(m, n)``
buffers written at ``count`` under a mask, and every decision is a
``torch.where`` on the device: a level runs without one host sync
(``torch.optim.LBFGS`` syncs about five times an iteration), which is why it
is not used here; the tests hold this loop against it.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch


def torch_eval_counts(max_iters: Sequence[int], evals_per_step: int = 20) -> tuple:
    """Closure-call counts of ``while n <= max_iter: opt.step(closure)`` with
    torch's default 20 calls a step: the loop runs until the count EXCEEDS
    the cap (``obst_eval.py:386-404``), so [50, 40, 30] runs [60, 60, 40]."""
    out = []
    for mi in max_iters:
        n = 0
        while n <= mi:
            n += evals_per_step
        out.append(n)
    return tuple(out)


def _compact_direction(g, S, Y, rho, count, H_diag):
    """The compact (Byrd–Nocedal–Schnabel) L-BFGS direction, mathematically
    the two-loop recursion on the same history: two (m, n) matvecs and
    O(m²) small ops in place of 2·m sequential n-vector dots.

        H = γI + [S  γY] · [ R⁻ᵀ(D+γYᵀY)R⁻¹   −R⁻ᵀ ]   [Sᵀ ]
                           [ −R⁻¹               0   ] · [γYᵀ]

    R = the upper triangle of SᵀY (diagonal included), D = diag(SᵀY),
    γ = H_diag. Slots at or past ``count`` get identity rows in R and zeros
    elsewhere, which removes them exactly as the two-loop's shorter lists do."""
    m = S.shape[0]
    valid = torch.arange(m, device=g.device) < count
    vv = valid[:, None] & valid[None, :]
    Sg = S @ g
    Yg = Y @ g
    STY = torch.where(vv, S @ Y.T, 0.0)
    D = torch.diag(torch.diagonal(STY))
    eye = torch.eye(m, dtype=g.dtype, device=g.device)
    R = torch.where(vv, torch.triu(STY), 0.0) + torch.where(valid, 0.0, 1.0)[:, None] * eye
    YTY = torch.where(vv, Y @ Y.T, 0.0)
    g1 = torch.where(valid, Sg, 0.0)
    g2 = H_diag * torch.where(valid, Yg, 0.0)
    p2 = torch.linalg.solve_triangular(R, g1[:, None], upper=True)[:, 0]  # R⁻¹ Sᵀg
    mid = (D + H_diag * YTY) @ p2 - g2
    p1 = torch.linalg.solve_triangular(R.T, mid[:, None], upper=False)[:, 0]  # R⁻ᵀ(...)
    p1 = torch.where(valid, p1, 0.0)
    p2 = torch.where(valid, p2, 0.0)
    Hg = H_diag * g + S.T @ p1 - H_diag * (Y.T @ p2)
    return -Hg


def _two_loop(g, S, Y, rho, count, H_diag):
    """torch's two-loop recursion over all m slots, each masked by
    ``j < count`` (rho is 0 past ``count``, so those terms vanish as they do
    in torch's shorter lists)."""
    m = S.shape[0]
    valid = torch.arange(m, device=g.device) < count
    q = -g
    al = [None] * m
    for j in range(m - 1, -1, -1):
        al[j] = torch.where(valid[j], rho[j] * torch.dot(S[j], q), 0.0)
        q = q - al[j] * Y[j]
    r = q * H_diag
    for j in range(m):
        be_j = torch.where(valid[j], rho[j] * torch.dot(Y[j], r), 0.0)
        r = r + (al[j] - be_j) * S[j]
    return r


def lbfgs_minimize(loss_fn: Callable[[torch.Tensor], torch.Tensor], x0: torch.Tensor,
                   num_iters: int, lr: float = 1.0, tolerance_grad: float = 1e-7,
                   tolerance_change: float = 1e-9, history_size: int | None = None,
                   impl: str = "two_loop") -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``num_iters`` torch-semantics L-BFGS iterations on ``loss_fn`` from
    ``x0`` (any shape; flattened inside). Returns (x, losses (num_iters,)).

    Each iteration evaluates ``loss_fn`` and its gradient by
    ``torch.autograd.grad`` on a leaf copy of the flat iterate (grad mode is
    on inside, whatever the caller's). ``history_size`` defaults to
    ``num_iters``: the reference never evicts (torch's 100 exceeds every
    level's count). ``impl``: ``"two_loop"``, torch's recursion; ``"compact"``,
    the same direction in matrix form (what OBST runs)."""
    shape = x0.shape
    n = x0.numel()
    m = history_size or num_iters
    if m < num_iters:
        raise ValueError("history eviction is not implemented (torch's default history 100 "
                         ">= every OBST level's iteration count)")
    if impl not in ("two_loop", "compact"):
        raise ValueError(f"impl {impl!r}: 'two_loop' or 'compact'")
    direction = _compact_direction if impl == "compact" else _two_loop
    dt = x0.dtype if x0.is_floating_point() else torch.float32
    kw = dict(dtype=dt, device=x0.device)
    x = x0.detach().reshape(-1).to(dt)
    prev_g = torch.zeros(n, **kw)
    prev_loss = torch.tensor(float("inf"), **kw)
    d = torch.zeros(n, **kw)
    t = torch.tensor(0.0, **kw)
    S = torch.zeros(m, n, **kw)
    Y = torch.zeros(m, n, **kw)
    rho = torch.zeros(m, **kw)
    count = torch.zeros((), dtype=torch.long, device=x0.device)
    H_diag = torch.tensor(1.0, **kw)
    done = torch.zeros((), dtype=torch.bool, device=x0.device)
    one = torch.tensor(1.0, **kw)
    losses = []
    for k in range(num_iters):
        xl = x.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = loss_fn(xl.view(shape))
            (g,) = torch.autograd.grad(loss, xl)
        loss = loss.detach()
        if k == 0:  # no history yet: steepest descent, the step scaled by 1/‖g‖₁
            d = -g
            t = torch.minimum(one, 1.0 / g.abs().sum()) * lr
        else:
            y = g - prev_g
            s = d * t
            ys = torch.dot(y, s)
            do_append = ys > 1e-10
            idx = torch.where(do_append, count, m - 1).view(1)  # write target (masked)
            S.index_copy_(0, idx, torch.where(do_append, s, S.index_select(0, idx)[0])[None])
            Y.index_copy_(0, idx, torch.where(do_append, y, Y.index_select(0, idx)[0])[None])
            rho.index_copy_(0, idx, torch.where(do_append, 1.0 / ys, rho.index_select(0, idx)))
            count = count + do_append.long()
            H_diag = torch.where(do_append, ys / torch.dot(y, y), H_diag)
            d = direction(g, S, Y, rho, count, H_diag)
            t = torch.full((), lr, **kw)
        # torch's break conditions. Before the update (these freeze x at
        # x_k): the Δloss and max|g| breaks are torch's post-update checks of
        # iteration k−1, the same program point (prev_loss starts at +inf)
        gtd = torch.dot(g, d)
        done = (done | (g.abs().max() <= tolerance_grad) | (gtd > -tolerance_change)
                | ((loss - prev_loss).abs() < tolerance_change))
        x = torch.where(done, x, x + t * d)
        # after the update: this one freezes x at x_{k+1}
        done = done | ((t * d).abs().max() <= tolerance_change)
        prev_g, prev_loss = g, loss
        losses.append(loss)
    return x.view(shape), torch.stack(losses)
