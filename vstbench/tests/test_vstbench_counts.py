"""The yardstick's counts against hand counts."""

import math

import pytest
import torch

from vstbench.counts import flops, lookup, peaks
from vstbench.reference import johnson, raft, seeded


def conv_flops(cin, cout, k, h_out, w_out, batch=1):
    return 2 * batch * cin * cout * k * k * h_out * w_out


def faststyle_by_hand(h, w, n_conv_styles=3):
    total = conv_flops(3, 32, 9, h, w) + conv_flops(32, 64, 3, h // 2, w // 2)
    total += conv_flops(64, 128, 3, h // 4, w // 4)
    total += 10 * conv_flops(128, 128, 3, h // 4, w // 4)
    total += conv_flops(128, 64, 3, h // 2, w // 2) + conv_flops(64, 32, 3, h, w)
    total += conv_flops(32, 3, 9, h, w)
    return total


def test_faststyle_at_sintel_size_is_137_3_gflop():
    net = seeded.build(lambda: johnson.FastStyleNet(3), "meta")
    counted = flops.count(lambda: net(torch.empty(1, 3, 436, 1024, device="meta"), 0))
    assert counted == faststyle_by_hand(436, 1024)
    assert counted / 1e9 == pytest.approx(137.3, abs=0.05)


def test_raft_at_batch_4_is_3803_gflop():
    net = seeded.build(lambda: raft.RAFT(20), "meta")
    x = torch.empty(4, 3, 432, 1024, device="meta")
    assert flops.count(lambda: net(x, x)) / 1e9 == pytest.approx(3803.1, abs=0.1)


def test_corr_volume_is_counted():
    f = torch.empty(1, 256, 8, 16, device="meta")
    n = 8 * 16
    assert flops.count(lambda: raft.build_pyramid(f, f)) == 2 * n * n * 256


def test_lookup_bytes_by_hand():
    # one query at (1, 1) of a 4x4 map, radius 1: its (2r+2)^2 patch is
    # x, y in [0, 3], 16 elements, all in bounds
    coords = torch.tensor([1.0, 1.0]).reshape(1, 2, 1, 1)
    nbytes, ops = lookup.lookup_bytes_ops([(4, 4)], coords, 1)
    assert nbytes == 16 * 4 + 2 * 4 + 9 * 4
    assert ops == 9 * lookup.OPS_PER_OUTPUT
    # at the corner (0, 0) only x, y in [0, 2] are in bounds: 9 elements
    nbytes, _ = lookup.lookup_bytes_ops([(4, 4)], torch.zeros(1, 2, 1, 1), 1)
    assert nbytes == 9 * 4 + 2 * 4 + 9 * 4


def test_bound_takes_the_larger_side():
    assert peaks.bound_s(peaks.PEAK_BYTES_PER_S, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 2 * peaks.PEAK_F32_OPS_PER_S) == pytest.approx(2.0)
    assert math.isclose(peaks.PEAK_F32_OPS_PER_S, 67e12)
