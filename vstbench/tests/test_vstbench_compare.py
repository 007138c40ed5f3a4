"""The output checks' arithmetic on made-up readings."""

import time

import pytest
import torch

from vstbench import cell as cells
from vstbench.loops import eval as eval_loop
from vstbench.loops import train


def readings(scale=1.0, quiet=1e-9):
    grads = {("disc", "w"): 2.0 * scale, ("disc", "b"): quiet, ("disc", "v"): 1.0,
             ("generator", "w"): 0.5, ("generator", "u"): 0.4}
    change = {("disc", "w"): 1e-3, ("disc", "b"): 5e-4, ("disc", "v"): 1e-3,
              ("generator", "w"): 2e-3, ("generator", "u"): 2e-3,
              ("ema.generator", "w"): 2e-6, ("ema.generator", "u"): 2e-6}
    return {"losses": [[1.0, 2.0, 3.0, 4.0], [1.5, 2.5, 3.5, 4.5]], "grads": grads,
            "change": change}


def test_train_compare_reads_worst_leaves_and_leaves_quiet_ones_out():
    ref = readings()
    prog = readings(scale=1.1)
    prog["losses"][0][0] = 1.001
    prog["losses"][1][3] = 4.5 * 1.3
    prog["change"][("disc", "b")] = 1.0  # a quiet leaf's round-off move: left out
    prog["change"][("generator", "u")] = 3e-3
    got = train.compare(prog, ref)
    assert got["first_loss_gap"] == pytest.approx(1e-3)
    assert got["loss_gap"] == pytest.approx(0.3) and got["loss_gap.2"] == pytest.approx(0.3)
    # disc's median first gradient is 1.0: w reads |2.2 - 2.0| / 2.0
    assert got["grad_gap"] == pytest.approx(0.1)
    assert got["change_gap"] == pytest.approx(0.5)  # generator.u: 1e-3 / 2e-3
    assert got["leaves_left_out"] == 1


def test_train_compare_sees_a_state_left_unchanged():
    ref = readings()
    prog = readings()
    prog["change"] = {k: 0.0 for k in prog["change"]}
    assert train.compare(prog, ref)["change_gap"] == pytest.approx(1.0)


def test_eval_compare_flags_what_is_missing():
    one = torch.ones(1, 2, 4, 4)
    ref = {"stylized": {0: torch.zeros(1, 3, 2, 2), 1: torch.zeros(1, 3, 2, 2)},
           "flows": {(0, 1): one, (1, 0): one}, "tcl": (0.5, 0.25)}
    prog = {"stylized": {0: [torch.full((1, 3, 2, 2), 0.1)], 1: [torch.zeros(1, 3, 2, 2)]},
            "flows": {(0, 1): [one + 0.01], (1, 0): [one]}, "tcl": (0.5, 0.3), "unmatched": 0}
    got = eval_loop.compare(prog, ref, 2, [(0, 1), (1, 0)], 1.0, (0.4, 0.3))
    assert got["stylize_gap"] == pytest.approx(0.1) and got["flow_gap_px"] == pytest.approx(0.01)
    assert got["tcl_gap"] == pytest.approx(0.25) and got["tcl_gap_end_to_end"] == pytest.approx(0.2)
    del prog["stylized"][1]
    prog["unmatched"] = 1
    got = eval_loop.compare(prog, ref, 2, [(0, 1), (1, 0)], 1.0, None)
    assert got["stylize_gap"] == eval_loop.MISSING and got["flow_gap_px"] == eval_loop.MISSING
    assert got["tcl_gap"] == eval_loop.MISSING


def test_ops_tcl_reads_the_ops_on_given_frames_and_flows():
    from vst_torch.eval.sintel import tcl_value
    from vst_torch.ops.flowtools import fbc_mask
    from vst_torch.ops.sample import warp

    g = torch.Generator().manual_seed(3)
    n, lt, H, W = 4, 2, 16, 24  # multiples of 8: RAFT's padding is none
    unit = {i: torch.rand(1, 3, H, W, generator=g) for i in range(n)}
    # smooth, consistent flows (a shift a frame), so that the mask keeps pixels
    v = torch.tensor([0.37, -0.21]).view(1, 2, 1, 1)
    flows = {(j, k): (k - j) * v + 0.01 * torch.rand(1, 2, H, W, generator=g)
             for j, k in eval_loop.needed_pairs(n, lt)}

    def prog(i, j):
        ff, bf = flows[(j, i)], flows[(i, j)]
        return float(tcl_value(fbc_mask(ff, bf), unit[i], warp(unit[j], bf)))

    st, lt_v = eval_loop.ops_tcl(unit, flows, n, lt, H, W)
    assert st == pytest.approx(sum(prog(i, i - 1) for i in range(1, n)) / (n - 1), rel=1e-6)
    assert lt_v == pytest.approx(sum(prog(i, i - lt) for i in range(lt, n)) / (n - lt), rel=1e-6)
    assert st > 0 and lt_v > 0
    low = eval_loop.ops_tcl(unit, flows, n, lt, H, W, torch.bfloat16)
    assert low != (st, lt_v)


def test_needed_pairs_are_both_ways_of_st_and_lt():
    pairs = eval_loop.needed_pairs(7, 5)
    assert (0, 1) in pairs and (1, 0) in pairs and (1, 6) in pairs and (6, 1) in pairs
    assert len(pairs) == 2 * 6 + 2 * 2


def test_training_flops_count_r1s_double_backward():
    c = cells.load("stargan2.train_advcon", 1, 0, False, cells.benchmark(),
                   device=torch.device("cpu"), clock_origin=time.perf_counter)
    c.config["stargan2"].update(img_size=32, max_conv_dim=32, style_dim=8, latent_dim=4)
    c.mix["batch"] = 2
    assert train.unit_flops(c) > 0


def test_checks_fail_on_nan_and_over_the_limit():
    assert not cells.Check("a", float("nan"), 1.0).ok
    assert not cells.Check("a", 2.0, 1.0).ok and cells.Check("a", 1.0, 1.0).ok
