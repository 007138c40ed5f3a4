"""vst_torch's Ruder head against vst's in both of its branches, on the same
weights (the flow-aware net and the bootstrap) and a 3-frame batch: loss and
aux terms in float32, every gradient in float64 (tolerances and why in
``tests/torch_train_parity.py``).

vst draws the branch as ``jax.random.uniform(key) < 0.5`` inside its step;
the port takes the branch as an argument, so each case gives vst a key that
draws that branch (in float32 and in float64 mode alike) and the port the
branch itself. The port's own draw comes from its seeded generator."""

import numpy as np
import pytest
import jax

from torch_train_parity import assert_grads_agree, assert_losses_agree, compare_head, make_pair
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst_torch.train.faststyle import FastStyleTrainer
from vst_torch.train.registry import select_method


def vst_coin(key):
    return bool(jax.random.uniform(key) < 0.5)


def key_drawing(coin):
    """The first PRNGKey(i) whose draw is ``coin`` in float32 and in float64."""
    saved = jax.config.read("jax_enable_x64")
    for i in range(100):
        key = jax.random.PRNGKey(i)
        try:
            jax.config.update("jax_enable_x64", True)
            wide = vst_coin(key)
        finally:
            jax.config.update("jax_enable_x64", saved)
        if vst_coin(key) == coin == wide:
            return key
    raise AssertionError(f"no key draws {coin}")


@pytest.fixture(scope="module")
def ruder():
    jt, params, tt, batch = make_pair("ruder", n_frames=3)
    cases = [(0, key_drawing(True), True), (0, key_drawing(False), False)]
    return compare_head(jt, params, tt, batch, cases)


@pytest.mark.parametrize("branch", [0, 1], ids=["roll", "zero"])
def test_branch_loss_and_aux_terms(ruder, branch):
    want, got = ruder[0][branch]
    assert_losses_agree(got, want)
    if branch == 1:  # zero-context mode: no temporal term
        assert want[1]["temporal"] == got[1]["temporal"] == 0
    else:
        assert want[1]["temporal"] > 0


@pytest.mark.parametrize("branch", [0, 1], ids=["roll", "zero"])
def test_branch_gradients(ruder, branch):
    want, got = ruder[1][branch]
    assert_grads_agree(got, want)


def test_the_ports_coin_is_seeded_and_fair():
    def draws(seed):
        tt = FastStyleTrainer(select_method("ruder", batch_size=2),
                              np.zeros((1, 16, 16, 3), np.float32), seed=seed, device="cpu")
        return [tt.draw_coin() for _ in range(400)]

    a = draws(0)
    assert a == draws(0) and a != draws(1)
    assert 160 < sum(a) < 240
