"""The device timing helpers of ``vst_torch.core.timing`` refuse CPU tensors
(no fallback to a host clock), and ``cold_pool`` makes the pool that
``graph_ms`` needs: distinct copies of x, ``POOL_BYTES`` or more together."""

import pytest
import torch

from vst_torch.core import timing


def test_graph_ms_refuses_cpu_tensors():
    pool = [torch.zeros(4), torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        timing.graph_ms(lambda v: v + 1, pool, 2)


def test_host_ms_refuses_a_cpu_tensor():
    calls = []
    with pytest.raises(ValueError, match="CUDA"):
        timing.host_ms(calls.append, torch.zeros(4))
    assert calls == []  # refused before any call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cold_pool_is_distinct_copies_past_l2(dtype):
    x = torch.arange(3 * 1000 * 1000, dtype=torch.float32).to(dtype)  # 12 MB / 6 MB
    pool = timing.cold_pool(x)
    nbytes = [t.numel() * t.element_size() for t in pool]
    assert sum(nbytes) >= timing.POOL_BYTES > sum(nbytes[1:])  # no copy more than needed
    assert pool[0] is x
    assert len({t.data_ptr() for t in pool}) == len(pool)
    assert all(torch.equal(t, x) for t in pool)
