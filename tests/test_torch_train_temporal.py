"""vst_torch's Huang and ReCoNet heads against vst's on the same weights and
batch: loss and every aux term (the temporal ones included) in float32, every
parameter's gradient in float64 (tolerances and why in
``tests/torch_train_parity.py``)."""

import pytest
import jax

from torch_train_parity import assert_grads_agree, assert_losses_agree, compare_head, make_pair
from torch_train_parity import torch_threads  # noqa: F401 (autouse)


@pytest.fixture(scope="module", params=["huang", "reconet"])
def head(request):
    jt, params, tt, batch = make_pair(request.param)
    return compare_head(jt, params, tt, batch, [(0, jax.random.PRNGKey(0), None)])


def test_head_loss_and_aux_terms(head):
    (want, got), = head[0]
    assert_losses_agree(got, want)
    temporal = [k for k in want[1] if "temporal" in k]
    assert temporal and all(want[1][k] > 0 for k in temporal)


def test_head_gradients(head):
    (want, got), = head[1]
    assert_grads_agree(got, want)
