"""Process groups and data parallelism, port of ``vst/parallel/mesh.py``.

vst runs one ``jax.sharding.Mesh`` whose ``data`` axis shards the batch, and
GSPMD inserts the gradient reduction where a loss mean spans that axis. The
port runs one process a device under ``torch.distributed`` (NCCL for CUDA,
gloo for the CPU), and the reductions GSPMD would insert are explicit calls:

* :func:`share_of_global`: a rank's loss as its shard's share of the global
  batch's loss (a mean term / world size, a sum term as it is), so that the
  gradients' sum over ranks is the global batch's gradient;
* :func:`all_reduce_gradients`: one flat all-reduce (sum) of the gradients of
  an optimizer's parameters, between ``backward()`` and ``step()``;
* :func:`all_reduce_metrics`: one all-reduce of a step's metric tensors, with
  no host synchronisation.

The trainers call them at their one update site instead of wrapping their
nets in ``DistributedDataParallel``, whose reducer hooks do not support the
double backward of WGAN-GP and R1. vst's ``model`` axis is reserved and no
caller uses it, so ``create_mesh`` refuses ``n_model > 1``. With no mesh, or
a mesh without a process group (one process), every helper is the identity
and runs no collective.
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data axis as this process sees it: ``size`` ranks, this one's
    ``rank`` and ``device``, and the process ``group`` (None: one process,
    no collective)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[Any] = None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None, device="cuda",
                           timeout: Optional[timedelta] = None) -> int:
    """Join the process group; returns the world size.

    Without arguments and without a group it is a no-op that returns 1, as
    vst's single-host default (``vst/parallel/mesh.py:45-48``); a group
    already joined returns its size. ``coordinator_address`` is an
    ``init_method`` (``tcp://host:port``, ``file:///path``; a bare
    ``host:port`` means TCP), or None for ``env://`` (torchrun's variables).
    The backend is NCCL for a CUDA ``device``, gloo for the CPU.
    """
    if dist.is_initialized():
        return dist.get_world_size()
    if coordinator_address is None and num_processes is None:
        return 1
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id, **kw)
    return dist.get_world_size()


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """The data axis over every rank of the process group (one process, no
    group: a mesh of 1). ``devices``: each rank's device, indexed by rank;
    by default ``cuda:<local rank>`` (``LOCAL_RANK``, else the rank modulo
    the devices on the host). There is no fallback to the CPU: pass
    ``["cpu"] * world_size`` for it."""
    if n_model != 1:
        raise ValueError("the model axis is reserved (vst/parallel/mesh.py:6-7); n_model must be 1")
    grouped = dist.is_initialized()
    size, rank = (dist.get_world_size(), dist.get_rank()) if grouped else (1, 0)
    if n_data is not None and n_data != size:
        raise ValueError(f"n_data={n_data}, but the process group has {size} ranks")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("create_mesh: no CUDA device (pass devices=['cpu'] * world size)")
        local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        device = torch.device("cuda", local)
    else:
        if len(devices) != size:
            raise ValueError(f"{len(devices)} devices for {size} ranks")
        device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(size, rank, device, dist.group.WORLD if grouped else None)


def world_size(mesh: Optional[Mesh]) -> int:
    """The ranks of ``mesh``; 1 without one."""
    return 1 if mesh is None else mesh.size


def _collective(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.group is not None


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def local_rows(x, mesh: Optional[Mesh]):
    """This rank's contiguous slice of the leading axis of ``x`` (a tensor
    or numpy array): rows [rank·n, (rank + 1)·n) of n = len / size, as
    ``P("data")`` places them. The leading axis must divide by the size."""
    if mesh is None or mesh.size == 1:
        return x
    if x.shape[0] % mesh.size:
        raise ValueError(f"a leading axis of {x.shape[0]} does not divide over {mesh.size} ranks")
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def _to_device(x, device: torch.device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device)


def batch_sharding(mesh: Mesh) -> Callable:
    """The placement of a batch: an array → this rank's rows on its device."""
    return lambda x: _to_device(local_rows(x, mesh), mesh.device)


def replicated_sharding(mesh: Mesh) -> Callable:
    """The placement of a replicated array: the whole of it on this rank's
    device (every rank holds the same host data)."""
    return lambda x: _to_device(x, mesh.device)


def shard_batch(batch, mesh: Mesh):
    """A tree (dicts, lists, tuples) of host arrays or tensors → this rank's
    rows of each on its device."""
    return tree_map(batch_sharding(mesh), batch)


def _coalesced(tensors: Sequence[torch.Tensor], device: torch.device,
               op: Callable[[torch.Tensor], None]) -> int:
    """``op`` on one flat buffer a dtype holding ``tensors`` (on ``device``),
    the results copied back in place; returns the bytes ``op`` saw."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    nbytes = 0
    for group in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1).to(device) for t in group])
        op(flat)
        nbytes += flat.numel() * flat.element_size()
        # one multi-tensor copy back, not one launch a tensor: the host's
        # issue rate bounds these reductions (PERF.md §6, PR 13)
        parts = flat.split([t.numel() for t in group])
        torch._foreach_copy_([t.detach() for t in group],
                             [p.view_as(t) for p, t in zip(parts, group)])
    return nbytes


def _state_tensors(obj) -> List[torch.Tensor]:
    """Every parameter and buffer of a module, every state tensor of an
    optimizer (in parameter order), or the tensors of a tree of them."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        return [v for group in obj.param_groups for p in group["params"]
                for _, v in sorted(obj.state.get(p, {}).items()) if torch.is_tensor(v)]
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in _state_tensors(v)]
    return []


def replicate(tree, mesh: Mesh):
    """Modules, optimizers and tensors (or a tree of them) made equal on
    every rank: rank 0's values broadcast in place (one flat broadcast a
    dtype). Modules and tensors should already be on the rank's device.
    Returns ``tree``."""
    if _collective(mesh):
        _coalesced(_state_tensors(tree), mesh.device,
                   lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return tree


def share_of_global(loss: torch.Tensor, terms: Dict[str, torch.Tensor], mesh: Optional[Mesh],
                    sums: Iterable[str] = ()) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, terms) of a rank's shard → its share of the global batch's.

    Every term is a batch mean (its share: local mean / size) but those named
    in ``sums``: weighted terms of ``loss`` that are sums over the batch (a
    share as it is). A term that is ``loss`` itself becomes the loss's
    share. Summed over ranks the shares are the global loss and terms, and
    their gradients the global gradient. At size 1 the arguments are
    returned as they are."""
    n = world_size(mesh)
    if n == 1:
        return loss, terms
    sums = set(sums)
    share = loss / n
    for k in sums:
        share = share + terms[k] * ((n - 1) / n)
    terms = {k: share if v is loss else v if k in sums else v / n for k, v in terms.items()}
    return share, terms


def all_reduce_gradients(optimizers: Sequence[torch.optim.Optimizer], mesh: Optional[Mesh]) -> int:
    """The sum over ranks of the gradients of the optimizers' parameters, in
    place, in one flat all-reduce a dtype, between ``backward()`` and
    ``step()``. Parameters without a gradient are left out (the same on
    every rank: the same step runs everywhere). Returns the bytes reduced
    (0 without a collective)."""
    if not _collective(mesh):
        return 0
    grads = [p.grad for opt in optimizers for group in opt.param_groups
             for p in group["params"] if p.grad is not None]
    return _coalesced(grads, mesh.device, lambda flat: dist.all_reduce(flat, group=mesh.group))


def all_reduce_metrics(metrics: Dict[str, torch.Tensor], mesh: Optional[Mesh]
                       ) -> Dict[str, torch.Tensor]:
    """A step's metric tensors (shares, see :func:`share_of_global`) summed
    over ranks in one all-reduce a dtype, detached, with no host
    synchronisation."""
    if not _collective(mesh):
        return metrics
    out = {k: v.detach().clone() for k, v in metrics.items()}
    _coalesced(list(out.values()), mesh.device,
               lambda flat: dist.all_reduce(flat, group=mesh.group))
    return out


def all_gather_rows(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """Every rank's ``x`` concatenated along the leading axis in rank order
    (the global batch of a sharded tensor); no gradient."""
    if not _collective(mesh):
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.group)
    return torch.cat(parts)


def global_mean(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mean of ``x`` over the global batch (equal shards), for a
    statistic that carries no gradient."""
    if not _collective(mesh):
        return x.mean()
    m = (x.mean() / mesh.size).detach()
    dist.all_reduce(m, group=mesh.group)
    return m
