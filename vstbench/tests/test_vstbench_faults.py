"""The output check catches each fault a cell can have: the harness's loop
runs on the CPU at a tiny size (the look for a card skipped), once as it is
and once with the timed path broken underneath (``vstbench.faults``), and
the broken run's numbers fail the cell's limits, far above the sound run's."""

import time

import pytest
import torch

from vstbench import cell as cells
from vstbench import faults

BENCH = cells.benchmark()


def tiny(workload):
    c = cells.load(workload, 2 ** 33 + 11, 0.0, False, BENCH, device=torch.device("cpu"),
                   clock_origin=time.perf_counter)
    if "raft" in c.config:
        c.config["raft"]["iters"] = 3
    if "stargan2" in c.config:
        c.config["stargan2"].update(max_conv_dim=32, style_dim=8, latent_dim=4)
    if c.mix["loop"] == "eval":
        c.mix.update(frames=7, hw=[128, 128], dt_iters=2)
    elif c.mix["loop"] == "stream":
        c.mix.update(host_frames=4, hw=[64, 96], sample=3)
    else:
        c.config["stargan2"]["img_size"] = 32
        c.mix.update(batch=2, pool=4)
    return c


CASES = [("johnson.sintel_tcl", "answer_altered"), ("johnson.sintel_tcl", "flow_altered"),
         ("johnson.sintel_tcl", "ops_altered"), ("stargan2.sintel_tcl", "answer_altered"),
         ("stargan2.sintel_tcl", "ops_altered"), ("johnson.stream", "answer_altered"),
         ("stargan2.train_advcon", "state_unchanged"), ("stargan2.train_advcon", "half_batch")]
_sound = {}


def sound(workload):
    if workload not in _sound:
        c = tiny(workload)
        _sound[workload] = c.loop.run(c)
    return _sound[workload]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    c = tiny(workload)
    with faults.FAULTS[fault]():
        broken = c.loop.run(c)
    assert not all(ch.ok for ch in broken.checks)
    base = {ch.name: ch.value for ch in sound(workload).checks}
    assert any(ch.value > 10 * base[ch.name] and not ch.ok for ch in broken.checks)


@pytest.mark.parametrize("workload", ["johnson.sintel_tcl", "johnson.stream"])
def test_the_sound_run_passes(workload):
    assert all(ch.ok for ch in sound(workload).checks)


def test_faults_restore_the_program():
    from vst_torch.train.stargan2 import StarGAN2Trainer

    before = StarGAN2Trainer._update
    with faults.state_unchanged():
        assert StarGAN2Trainer._update is not before
    assert StarGAN2Trainer._update is before
