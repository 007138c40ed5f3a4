"""RAFT's bf16 compute dtypes (``encoder_dtype``, ``update_dtype``) against
vst's at 64×96 with 4 GRU iterations, the same weights on both sides.

XLA's CPU convolutions and ATen's round bf16 at other points, so the port's
bf16 flow is not held to vst's to 1e-4. It is held to vst's own bf16 error:
the mean relative difference |port bf16 − vst bf16| / |vst bf16| must be no
larger than vst's |vst bf16 − vst f32| / |vst f32| at the same inputs, and
under vst's own bounds for bf16 against f32 (0.15 encoders, 0.2 encoders and
update block, ``tests/test_flow_raft.py:183-224``). Measured on a CPU:
0.0062 against vst's 0.0098 (encoders), 0.0063 against 0.0121 (both); the
port's f32 flow is vst's within 1e-6 relative. The update block's cast
is checked twice more: by the output dtype of each of its convolutions, and
by the change it makes to the flow, against the change vst's makes."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vst.flow.raft import RAFT as JRAFT
from vst.flow.raft import raft_params_from_torch
from vst_torch.flow.raft import RAFT
from vst_torch.nn.conv import TorchConv

# case → (port encoder dtype, port update dtype, vst's, vst's)
CASES = {"f32": (None, None, None, None),
         "encoder": (torch.bfloat16, None, jnp.bfloat16, None),
         "encoder_and_update": (torch.bfloat16, torch.bfloat16, jnp.bfloat16, jnp.bfloat16)}
BOUND = {"encoder": 0.15, "encoder_and_update": 0.2}  # vst's, bf16 against f32
# the update block's bf16 against the encoders' alone, port against vst: the
# relative size of the two changes and the cosine between them (measured on a
# CPU: 0.92 and 0.78); a port that left the update block in float32 would
# read 0 and nan
MOVE_RATIO = (0.5, 2.0)
MOVE_COSINE = 0.5


def _images(seed=3, hw=(64, 96)):
    rng = np.random.RandomState(seed)
    base = rng.rand(1, hw[0] + 8, hw[1] + 8, 3).astype(np.float32) * 255
    return base[:, 4:4 + hw[0], 4:4 + hw[1]], base[:, 2:2 + hw[0], 5:5 + hw[1]]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _rel(a, b):
    return float(np.abs(a - b).mean() / (np.abs(b).mean() + 1e-6))


@pytest.fixture(scope="module")
def flows():
    """case → (vst's flow, the port's flow), NHWC, from one seeded parameter
    set carried to vst, at the same images."""
    torch.manual_seed(0)
    net = RAFT(iters=4).eval()
    params = {"params": raft_params_from_torch(net.state_dict())}
    i1, i2 = _images()
    out = {}
    for case, (enc, upd, jenc, jupd) in CASES.items():
        _, vst_flow = JRAFT(small=False, iters=4, encoder_dtype=jenc, update_dtype=jupd).apply(
            params, jnp.asarray(i1), jnp.asarray(i2))
        port = RAFT(iters=4, encoder_dtype=enc, update_dtype=upd).eval()
        port.load_state_dict(net.state_dict(), strict=True)  # one parameter set for every dtype
        with torch.no_grad():
            _, up = port(_nchw(i1), _nchw(i2))
        assert up.dtype == torch.float32  # bf16 stays inside the convolutions
        out[case] = (np.asarray(vst_flow), up.permute(0, 2, 3, 1).numpy())
    return out


@pytest.mark.parametrize("case", list(BOUND))
def test_bf16_raft_within_vsts_own_bf16_error(flows, case):
    vst_f32, port_f32 = flows["f32"]
    vst_bf16, port_bf16 = flows[case]
    assert _rel(port_f32, vst_f32) < 1e-4
    vst_gap = _rel(vst_bf16, vst_f32)
    assert 0 < vst_gap < BOUND[case]
    assert _rel(port_bf16, vst_bf16) <= vst_gap
    assert _rel(port_bf16, vst_f32) < BOUND[case]


def test_bf16_update_block_moves_flow_as_vsts(flows):
    """The update block's bf16 (``encoder_and_update`` against ``encoder``)
    changes the port's flow by about as much as vst's, and the same way."""
    vst_enc, port_enc = flows["encoder"]
    vst_full, port_full = flows["encoder_and_update"]
    dv, dp = (vst_full - vst_enc).ravel(), (port_full - port_enc).ravel()
    ratio = _rel(port_full, port_enc) / _rel(vst_full, vst_enc)
    cosine = float(dv @ dp / np.sqrt((dv @ dv) * (dp @ dp)))
    assert MOVE_RATIO[0] < ratio < MOVE_RATIO[1]
    assert cosine > MOVE_COSINE


@pytest.mark.parametrize("case", list(BOUND))
def test_bf16_convs_run_in_their_dtype(case):
    """Every convolution's output dtype: the encoders' in the encoder dtype;
    the update block's (motion encoder, the six GRU gates, the flow head's
    first conv, the mask head's first conv) in the update dtype; the delta
    and mask output convs in float32 (vst/flow/raft.py:170, 216-232,
    265-290)."""
    enc, upd = (d or torch.float32 for d in CASES[case][:2])
    torch.manual_seed(1)
    net = RAFT(iters=1, encoder_dtype=CASES[case][0], update_dtype=CASES[case][1]).eval()
    seen, want = {}, {}
    for name, m in net.named_modules():
        if isinstance(m, TorchConv):
            m.register_forward_hook(lambda m, a, out, name=name: seen.update({name: out.dtype}))
            if name.startswith(("fnet.", "cnet.")):
                want[name] = enc
            elif name in ("update_block.flow_head.conv2", "update_block.mask.2"):
                want[name] = torch.float32
            else:
                want[name] = upd
    assert sum(n.startswith("update_block.gru.conv") for n in want) == 6
    assert sum(n.startswith("update_block.encoder.") for n in want) == 5
    i1, i2 = _images(hw=(32, 48))
    with torch.no_grad():
        net(_nchw(i1), _nchw(i2))
    assert seen == want


def test_bf16_raft_keeps_float32_where_vst_does():
    """The pyramid, the hidden state, the delta and the mask logits stay
    float32 under both bf16 dtypes (vst/flow/raft.py:423-428, 230, 170,
    289)."""
    torch.manual_seed(1)
    net = RAFT(iters=1, encoder_dtype=torch.bfloat16, update_dtype=torch.bfloat16).eval()
    seen = {}
    net.update_block.gru.register_forward_hook(lambda m, a, out: seen.update(h=out.dtype))
    net.update_block.flow_head.register_forward_hook(lambda m, a, out: seen.update(d=out.dtype))
    net.update_block.mask.register_forward_hook(lambda m, a, out: seen.update(m=out.dtype))
    net.fnet.register_forward_hook(lambda m, a, out: seen.update(f=out.dtype))
    i1, i2 = _images(hw=(32, 48))
    with torch.no_grad():
        low, up = net(_nchw(i1), _nchw(i2))
    assert seen == {"f": torch.bfloat16, "h": torch.float32, "d": torch.float32,
                    "m": torch.float32}
    assert low.dtype == up.dtype == torch.float32
    assert all(p.dtype == torch.float32 for p in net.parameters())


def test_torch_conv_compute_dtype():
    """flax ``Conv(dtype=bf16)``: float32 parameters, the input, kernel and
    bias cast to bf16, a bf16 output; without a compute dtype, nn.Conv2d."""
    torch.manual_seed(2)
    conv = TorchConv(4, 6, 3, padding=1, compute_dtype=torch.bfloat16)
    x = torch.randn(1, 4, 5, 7)
    y = conv(x)
    assert conv.weight.dtype == torch.float32 and y.dtype == torch.bfloat16
    want = torch.nn.functional.conv2d(x.bfloat16(), conv.weight.bfloat16(),
                                      conv.bias.bfloat16(), padding=1)
    torch.testing.assert_close(y, want, atol=0, rtol=0)
    plain = TorchConv(4, 6, 3, padding=1)
    plain.load_state_dict(conv.state_dict())
    torch.testing.assert_close(plain(x), torch.nn.functional.conv2d(
        x, conv.weight, conv.bias, padding=1), atol=0, rtol=0)
