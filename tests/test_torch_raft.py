"""vst_torch RAFT (full variant) against vst's at 64×96 with 4 GRU
iterations, weights carried both ways; the corr lookup runs through the
kernel's wrapper, which computes the plain version on the CPU. Tolerance
1e-3 px on flow_low and flow_up (measured on a CPU: 1.9e-6 and 3.5e-6 px,
with flows up to 2.7 px). The JAX side takes about 20 s of init and compile
on a CPU."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst_torch.convert import raft_state_dict_from_jax
from vst_torch.flow.raft import RAFT, coords_grid, upsample_flow_convex

ATOL_PX = 1e-3


def _images(seed, hw=(64, 96), b=1):
    rng = np.random.RandomState(seed)
    base = rng.rand(b, hw[0] + 8, hw[1] + 8, 3).astype(np.float32) * 255
    return base[:, 4:4 + hw[0], 4:4 + hw[1]], base[:, 2:2 + hw[0], 5:5 + hw[1]]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _seeded_raft(iters, seed=0):
    torch.manual_seed(seed)
    net = RAFT(iters=iters).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # give the context encoder's batch norm real statistics
        for name, buf in net.cnet.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))
        for name, p in net.cnet.named_parameters():
            if p.dim() == 1 and "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return net


def _port_flows(net, i1, i2):
    with torch.no_grad():
        low, up = net(_nchw(i1), _nchw(i2))
    return low.permute(0, 2, 3, 1).numpy(), up.permute(0, 2, 3, 1).numpy()


def test_full_raft_port_to_flax():
    i1, i2 = _images(3)
    net = _seeded_raft(4)
    params = raft_params_from_torch(net.state_dict())
    low_j, up_j = JRAFT(small=False, iters=4).apply(
        {"params": params}, jnp.asarray(i1), jnp.asarray(i2))
    low_t, up_t = _port_flows(net, i1, i2)
    assert up_t.shape == (1, 64, 96, 2) and low_t.shape == (1, 8, 12, 2)
    assert np.abs(up_t).max() > 1e-2  # the comparison is not 0 = 0
    np.testing.assert_allclose(low_t, np.asarray(low_j), atol=ATOL_PX)
    np.testing.assert_allclose(up_t, np.asarray(up_j), atol=ATOL_PX)


def test_flax_params_load_into_the_port():
    i1, i2 = _images(4, hw=(32, 48))
    jnet = JRAFT(small=False, iters=2)
    params = jax.device_get(jnet.init(jax.random.PRNGKey(1), jnp.asarray(i1),
                                      jnp.asarray(i2))["params"])
    net = RAFT(iters=2).eval()
    net.load_state_dict(raft_state_dict_from_jax(params), strict=True)
    _, up_j = jnet.apply({"params": params}, jnp.asarray(i1), jnp.asarray(i2))
    _, up_t = _port_flows(net, i1, i2)
    np.testing.assert_allclose(up_t, np.asarray(up_j), atol=ATOL_PX)


def test_state_dict_round_trip_is_exact():
    sd = _seeded_raft(1, seed=5).state_dict()
    assert "cnet.layer2.0.norm3.running_var" in sd
    assert "cnet.layer2.0.downsample.1.running_var" in sd
    back = raft_state_dict_from_jax(raft_params_from_torch(sd))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_rejects_sizes_not_divisible_by_8():
    net = RAFT(iters=1).eval()
    img = torch.zeros(1, 3, 60, 96)
    with pytest.raises(ValueError, match="divisible by 8"):
        net(img, img)


def test_coords_grid_and_convex_upsample_layout():
    g = coords_grid(2, 3, 4)
    assert g.shape == (2, 2, 3, 4)
    assert g[0, 0, 1, 2] == 2 and g[0, 1, 1, 2] == 1  # channel 0 = x
    # a mask that picks the centre neighbour (k = 4) everywhere: the convex
    # upsample is then the nearest 8× upsample of 8·flow
    flow = torch.randn(1, 2, 3, 4)
    mask = torch.full((1, 576, 3, 4), -1e4)
    mask[:, 4 * 64:5 * 64] = 0.0
    up = upsample_flow_convex(flow, mask)
    want = 8 * flow.repeat_interleave(8, 2).repeat_interleave(8, 3)
    torch.testing.assert_close(up, want)
