"""One checkpointing facility for the port, counterpart of
``vst/core/checkpoint.py``.

vst keeps one orbax store, ``<dir>/<step>/<name>``. The port keeps the torch
files its commands have always written, one file a tree, named by a layout
(a ``str.format`` pattern over ``step`` and ``name``):

* ``model.pt``: ``train-faststyle`` (no step; one tree, ``model``);
* ``{step:06d}_{name}.ckpt``: StarGAN v2 (``nets``, ``nets_ema``: dicts of
  state_dicts, the reference's CheckpointIO names);
* ``{step}-{name}.ckpt``: StarGAN v1 (``G``, ``D``);
* ``{step}_net_{name}.pth``: the CycleGAN family (junyanz's
  ``save_networks``: ``G_A``, ``G_B``, ``D_A``, ...).
* ``{step}_{name}.pth``: ``train-raft`` (upstream RAFT's ``train.py`` names:
  ``raft``, the net's ``state_dict``; ``train_state``, the optimizer's and
  the schedule's).

A file of any other name is a layout of its own (:meth:`Checkpointer.file`),
so one reader serves converted reference checkpoints too. Trees are torch
``state_dict``s or dicts of them; a module passed to :meth:`save` is saved
as its ``state_dict``. :meth:`restore` reads onto the CPU.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

import torch

LAYOUTS = {"faststyle": "{name}.pt", "stargan2": "{step:06d}_{name}.ckpt",
           "stargan": "{step}-{name}.ckpt", "cyclegan": "{step}_net_{name}.pth",
           "raft": "{step}_{name}.pth"}


def clean_state_dict(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A flat ``state_dict`` with a DataParallel ``module.`` prefix stripped
    and batch norms' ``num_batches_tracked`` dropped, as vst's converters
    do (eval-mode nets do not read it). Other trees pass unchanged."""
    if not all(torch.is_tensor(v) for v in sd.values()):
        return sd
    return {k.removeprefix("module."): v for k, v in sd.items()
            if not k.endswith("num_batches_tracked")}


class Checkpointer:
    """Step-tagged torch checkpoints: ``<dir>/<layout.format(step, name)>``.

    Usage::

        ckpt = Checkpointer(run_dir, LAYOUTS["stargan2"])
        ckpt.save(1000, nets=trainer.state_dicts(), nets_ema=trainer.state_dicts(True))
        sds = ckpt.restore(ckpt.latest_step(), nets_ema=None)["nets_ema"]
    """

    def __init__(self, directory: str, layout: str = LAYOUTS["stargan2"]):
        self.directory = os.path.abspath(directory)
        self.layout = layout
        # the layout's file names as a pattern: (step, name) groups where it has them
        parts = re.split(r"(\{step(?::0?\d+d)?\}|\{name\})", layout)
        self._pattern = re.compile("".join(
            r"(?P<step>\d+)" if p.startswith("{step") else r"(?P<name>.+)" if p == "{name}"
            else re.escape(p.replace("{{", "{").replace("}}", "}")) for p in parts))

    @classmethod
    def file(cls, path: str) -> "Checkpointer":
        """The checkpointer of one file: its directory, its name as the
        layout (no step, no name)."""
        name = os.path.basename(path).replace("{", "{{").replace("}", "}}")
        return cls(os.path.dirname(path) or ".", name)

    def path(self, step: Optional[int], name: str) -> str:
        return os.path.join(self.directory, self.layout.format(step=step, name=name))

    def save(self, step: Optional[int], **trees: Any) -> List[str]:
        """Each tree to its file; returns the paths written."""
        os.makedirs(self.directory, exist_ok=True)
        paths = []
        for name, tree in trees.items():
            if isinstance(tree, torch.nn.Module):
                tree = tree.state_dict()
            paths.append(self.path(step, name))
            torch.save(tree, paths[-1])
        return paths

    def restore(self, step: Optional[int], **likes: Any) -> Dict[str, Any]:
        """Each named tree read onto the CPU (a flat ``state_dict`` through
        :func:`clean_state_dict`). A ``like`` that is a module has the tree
        loaded into it and is returned; None returns the tree."""
        out = {}
        for name, like in likes.items():
            tree = torch.load(self.path(step, name), map_location="cpu")
            if isinstance(tree, dict):
                tree = clean_state_dict(tree)
            if isinstance(like, torch.nn.Module):
                like.load_state_dict(tree)
                tree = like
            out[name] = tree
        return out

    def entries(self) -> List[Tuple[Optional[int], Optional[str]]]:
        """(step, name) of every file of the layout in the directory."""
        if not os.path.isdir(self.directory):
            return []
        out = []
        for f in os.listdir(self.directory):
            m = self._pattern.fullmatch(f)
            if m:
                groups = m.groupdict()
                out.append((int(groups["step"]) if groups.get("step") else None,
                            groups.get("name")))
        return out

    def latest_step(self) -> Optional[int]:
        """The newest step of any file of the layout; None without one."""
        steps = [s for s, _ in self.entries() if s is not None]
        return max(steps) if steps else None
