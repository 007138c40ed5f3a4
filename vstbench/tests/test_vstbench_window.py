"""The window's arithmetic, on a fake clock, and the rule that a run
without a card prints no result."""

import io
import random
from contextlib import redirect_stdout

import pytest
import torch

from vstbench import window


class FakeClock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_in_flight_unit_completes_and_counts():
    clock = FakeClock()
    durations = [4.0, 4.0, 4.0]

    def unit(i):
        clock.t += durations[i]

    n, t0, t1 = window.run(10.0, unit, clock)
    # units start at 0, 4 and 8 s (time remains); the third ends at 12 s and counts
    assert (n, t0, t1) == (3, 100.0, 112.0)


def test_one_unit_when_the_window_is_empty():
    clock = FakeClock()
    n, _, _ = window.run(0.0, lambda i: setattr(clock, "t", clock.t + 1.0), clock)
    assert n == 1


def test_finish_runs_before_the_window_closes():
    clock = FakeClock()
    calls = []

    def unit(i):
        calls.append(i)
        clock.t += 0.5

    n, t0, t1 = window.run(1.0, unit, clock, finish=lambda: setattr(clock, "t", clock.t + 2.0))
    assert n == 2 and t1 - t0 == 3.0


def test_rate_counts_a_stall():
    # 10 units of 1 s and one stall of 5 s: the rate is over all 15 s
    assert window.rate(10, 0.0, 15.0) == pytest.approx(10 / 15)
    with pytest.raises(ValueError):
        window.rate(1, 2.0, 2.0)


@pytest.mark.parametrize("n", [1, 19, 20, 21, 100, 2501])
def test_percentile_is_nearest_rank_over_every_sample(n):
    values = random.Random(n).sample(range(10 * n), n)
    ordered = sorted(values)
    rank = -(-95 * n // 100)  # ceil(0.95 n)
    assert window.percentile(values, 95) == ordered[rank - 1]


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 7), (9, 12)]
    assert window.union(iv) == [(0, 3), (5, 7), (9, 12)]
    assert window.covered(iv, 1, 10) == pytest.approx(2 + 2 + 1)
    assert window.gaps(iv, -1, 10) == [(-1, 0), (3, 5), (7, 9)]
    assert window.gaps([], 0, 1) == [(0, 1)]


def test_reservoir_keeps_a_uniform_sample():
    hits = [0] * 10
    for seed in range(2000):
        r = window.Reservoir(1, seed)
        kept = None
        for i in range(10):
            if r.offer() == 0:
                kept = i
        hits[kept] += 1
    assert min(hits) > 140 and max(hits) < 260


def test_reservoir_is_the_same_for_a_seed():
    a, b = window.Reservoir(3, 2 ** 33 + 1), window.Reservoir(3, 2 ** 33 + 1)
    assert [a.offer() for _ in range(50)] == [b.offer() for _ in range(50)]


def test_a_run_without_a_card_fails_and_prints_nothing(monkeypatch, capsys):
    from vstbench import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = run.main(["--workload", "johnson.sintel_tcl", "--seed", "1", "--seconds", "1"])
    assert rc != 0 and out.getvalue() == ""
    assert "no CUDA device" in capsys.readouterr().err


def test_a_run_with_too_few_cards_fails(monkeypatch):
    from vstbench.device import cards_missing

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cards_missing(4) and not cards_missing(1)
