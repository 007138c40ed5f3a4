"""Faults planted in the program underneath a run, to show that the output
check catches them (``tests/test_vstbench_faults.py``) and to read what they
do to the compared numbers at a cell's own size (``vstbench.readings``).

Each is a context manager that patches ``vst_torch`` and restores it:

* ``answer_altered``: every stylize net's output nudged where it is produced
  (FastStyleNet by 0.5 of its 255 range, the StarGAN v2 generator by 0.002);
* ``flow_altered``: RAFT's upsampled flow shifted by 0.05 pixel;
* ``ops_altered``: the evaluation's warp (of the stylized frame and inside
  the fb mask) samples 0.05 pixel off the flow;
* ``state_unchanged``: the trainer's update computes the gradients and skips
  the optimizer step;
* ``half_batch``: each training iteration sees the first half of its rows,
  so every mean is taken over the rest.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, attr, make):
    before = getattr(obj, attr)
    setattr(obj, attr, make(before))
    try:
        yield
    finally:
        setattr(obj, attr, before)


@contextlib.contextmanager
def answer_altered():
    from vst_torch.models.faststyle import FastStyleNet
    from vst_torch.models.stargan2 import Generator

    def fast(f):
        return lambda self, *a, **k: (lambda o: (o[0], o[1] + 0.5))(f(self, *a, **k))

    def gen(f):
        return lambda self, *a, **k: f(self, *a, **k) + 0.002

    with _patched(FastStyleNet, "forward", fast), _patched(Generator, "forward", gen):
        yield


@contextlib.contextmanager
def flow_altered():
    from vst_torch.flow.raft import RAFT

    def shifted(f):
        return lambda self, *a, **k: (lambda o: (o[0], o[1] + 0.05))(f(self, *a, **k))

    with _patched(RAFT, "forward", shifted):
        yield


@contextlib.contextmanager
def ops_altered():
    import vst_torch.eval.sintel as sintel
    import vst_torch.ops.flowtools as flowtools

    def shifted(f):
        return lambda x, flow: f(x, flow + 0.05)

    with _patched(sintel, "warp", shifted), _patched(flowtools, "warp", shifted):
        yield


@contextlib.contextmanager
def state_unchanged():
    from vst_torch.train.stargan2 import StarGAN2Trainer

    def no_step(f):
        def update(self, names, loss):
            for k in names:
                self.opts[k].zero_grad(set_to_none=True)
            loss.backward()
        return update

    with _patched(StarGAN2Trainer, "_update", no_step):
        yield


@contextlib.contextmanager
def half_batch():
    from vst_torch.train.stargan2 import StarGAN2Trainer

    def halved(f):
        def iteration(self, batch, z=None, z2=None):
            n = batch["x_real"].shape[0] // 2
            return f(self, {k: v[:n] for k, v in batch.items()}, z=None if z is None else z[:n],
                     z2=None if z2 is None else z2[:n])
        return iteration

    with _patched(StarGAN2Trainer, "train_iteration", halved):
        yield


FAULTS = {f.__name__: f for f in (answer_altered, flow_altered, ops_altered, state_unchanged,
                                  half_batch)}
