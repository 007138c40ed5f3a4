"""On the card: each cell's control (the reference with TF32 on, in the
program's place) fails the cell's limits while the program passes them, at
a size a test run holds. Skips without a card.

    python -m pytest -q vstbench/tests/test_vstbench_cuda.py -m cuda
"""

import time

import pytest
import torch

from vstbench import cell as cells

BENCH = cells.benchmark()
SMALL = {"eval": dict(frames=8, hw=[256, 512]), "stream": dict(host_frames=8, sample=4),
         "train": dict(batch=4, pool=4)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_the_control_fails_where_the_program_passes(card, workload):
    c = cells.load(workload, 2 ** 32 + 3, 0.0, False, BENCH, device=card,
                   clock_origin=time.perf_counter)
    c.mix.update(SMALL[c.mix["loop"]])
    program = c.loop.run(c)
    assert all(ch.ok for ch in program.checks), program.checks
    control = c.checks(c.loop.control(c))
    assert not all(ch.ok for ch in control), control
