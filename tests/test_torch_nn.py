"""vst_torch.nn against vst.nn: instance norms (one-pass statistics), the
conditional norm's style table, and the conv blocks — the 9×9 stride-1
ConvLayer against vst's space-to-depth path, UpsampleConvLayer against vst's
subpixel fold. Weights go port → flax. Tolerance 1e-4 relative (measured on
a CPU: ≤ 7e-6 relative, the instance norm; the convs ≤ 8e-7)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vst.nn import conv as jconv
from vst.nn import norm as jnorm
from vst_torch.nn import conv, norm

RTOL = 1e-4


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(seed, shape):
    return (np.random.RandomState(seed).randn(*shape) * 3 + 1).astype(np.float32)


def _conv_params(c):
    return {"Conv_0": {"kernel": c.weight.detach().numpy().transpose(2, 3, 1, 0),
                       "bias": c.bias.detach().numpy()}}


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3 + (1.0 if p.dim() == 1 else 0.0))


def test_instance_norm():
    x = _x(0, (2, 9, 11, 5))
    got = _nhwc(norm.instance_norm(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(jnorm.instance_norm(jnp.asarray(x))),
                               rtol=RTOL, atol=1e-5)


def test_instance_norm_module():
    x = _x(1, (2, 8, 10, 6))
    m = norm.InstanceNorm(6)
    _randomize(m, 1)
    params = {"scale": m.weight.detach().numpy(), "bias": m.bias.detach().numpy()}
    want = jnorm.InstanceNorm(affine=True).apply({"params": params}, jnp.asarray(x))
    np.testing.assert_allclose(_nhwc(m(_nchw(x))), np.asarray(want), rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("style", [0, 2, 7])  # 7: clipped to the last style
def test_conditional_instance_norm(style):
    x = _x(2, (1, 8, 10, 6))
    torch.manual_seed(2)
    m = norm.ConditionalInstanceNorm(6, num_styles=3)
    _randomize(m.bn, 3)
    params = {"scale": m.bn.weight.detach().numpy(), "bias": m.bn.bias.detach().numpy(),
              "embed": m.embed.weight.detach().numpy()}
    want = jnorm.ConditionalInstanceNorm(num_styles=3).apply(
        {"params": params}, jnp.asarray(x), style)
    np.testing.assert_allclose(_nhwc(m(_nchw(x), style)), np.asarray(want),
                               rtol=RTOL, atol=1e-5)


@pytest.mark.parametrize("cin,cout,k,stride,hw", [
    (3, 8, 9, 1, (20, 24)),   # the stem: vst's space-to-depth path
    (8, 16, 3, 2, (13, 18)),  # a strided down conv
])
def test_conv_layer(cin, cout, k, stride, hw):
    torch.manual_seed(k)
    m = conv.ConvLayer(cin, cout, k, stride)
    x = _x(4, (2, *hw, cin))
    want = jconv.ConvLayer(cout, k, stride=stride).apply(
        {"params": {"TorchConv_0": _conv_params(m.conv2d)}}, jnp.asarray(x))
    got = _nhwc(m(_nchw(x)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-4)


def test_upsample_conv_layer_against_subpixel_fold():
    torch.manual_seed(5)
    m = conv.UpsampleConvLayer(8, 4, 3, 1, upsample=2)
    x = _x(5, (1, 7, 9, 8))
    want = jconv.UpsampleConvLayer(4, 3, stride=1, upsample=2).apply(
        {"params": {"TorchConv_0": _conv_params(m.conv2d)}}, jnp.asarray(x))
    got = _nhwc(m(_nchw(x)))
    assert got.shape == (1, 14, 18, 4)
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-4)


def test_conv_tanh():
    torch.manual_seed(6)
    m = conv.ConvTanh(8, 3, 9, 1)
    with torch.no_grad():
        m.conv2d.weight.mul_(300.0)  # reach tanh's curved range
    x = _x(6, (1, 16, 20, 8))
    want = jconv.ConvTanh(3, 9).apply(
        {"params": {"ConvLayer_0": {"TorchConv_0": _conv_params(m.conv2d)}}}, jnp.asarray(x))
    got = _nhwc(m(_nchw(x)))
    assert np.ptp(got) > 50.0
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-3)
