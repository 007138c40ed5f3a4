"""vst_torch's loss primitives, ``warp_masked`` and the VGG extractors against
vst's, inputs from numpy seeds (the port NCHW, vst NHWC).

Tolerances: the losses, ``warp_masked`` and the VGG features agree to 1e-5
relative, as max |port − vst| / max |vst| (f32 sums in another order); the
He-randomized VGGs and the weight bridge are equal bit for bit."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from vst.ops import losses as jlosses
from vst.ops import sample as jsample
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.perceptual import vgg as jvgg
from vst_torch.convert import caffe_vgg_state_dict_from_jax, vgg_state_dict_from_jax
from vst_torch.ops import losses, sample
from vst_torch.perceptual import vgg

RTOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _img(seed, shape=(2, 12, 16, 3)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 16, 16, 64)])
def test_gram_matrix(shape):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    want = np.asarray(jlosses.gram_matrix(jnp.asarray(x)))
    got = losses.gram_matrix(_nchw(x)).numpy()
    assert got.shape == (shape[0], shape[3], shape[3])
    assert _rel(got, want) <= RTOL
    assert torch.equal(losses.gram_matrix_obst(_nchw(x)), losses.gram_matrix(_nchw(x)))


@pytest.mark.parametrize("shape", [(2, 7, 9, 5), (1, 16, 16, 64)])
def test_gram_matrix_bf16_accumulates_and_returns_float32(shape):
    """vst's rule (``preferred_element_type``): bf16 features give a float32
    Gram, the float32 product of the bf16 values; float64 stays float64."""
    x = np.random.RandomState(2).randn(*shape).astype(np.float32)
    want = jlosses.gram_matrix(jnp.asarray(x).astype(jnp.bfloat16))
    got = losses.gram_matrix(_nchw(x).to(torch.bfloat16))
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    assert _rel(got.numpy(), np.asarray(want)) <= 1e-6
    assert losses.gram_matrix(_nchw(x).double()).dtype == torch.float64


def _tv_value_and_grad(x):
    jv, jg = jax.value_and_grad(jlosses.tv_loss)(jnp.asarray(x))
    t = _nchw(x).requires_grad_()
    v = losses.tv_loss(t)
    v.backward()
    return float(v.detach()), _nhwc(t.grad), float(jv), np.asarray(jg)


def test_tv_loss_value_and_gradient():
    got_v, got_g, want_v, want_g = _tv_value_and_grad(_img(2))
    assert abs(got_v - want_v) <= RTOL * abs(want_v)
    assert _rel(got_g, want_g) <= RTOL


def test_tv_loss_flat_image_has_finite_zero_gradient():
    """A flat image with one bright pixel: √0 everywhere else. torch.sqrt's
    gradient there is infinite; the safe root's is 0, as vst's."""
    x = np.full((1, 8, 8, 3), 0.5, np.float32)
    x[0, 4, 4] = 0.9
    got_v, got_g, want_v, want_g = _tv_value_and_grad(x)
    assert np.isfinite(got_g).all()
    np.testing.assert_array_equal(got_g == 0, want_g == 0)
    assert (got_g == 0).sum() > x.size // 2
    assert abs(got_v - want_v) <= RTOL * abs(want_v)
    assert _rel(got_g, want_g) <= RTOL


def test_normalize_imagenet():
    x = _img(3)
    want = np.asarray(jlosses.normalize_imagenet(jnp.asarray(x)))
    assert _rel(_nhwc(losses.normalize_imagenet(_nchw(x))), want) <= RTOL


@pytest.mark.parametrize("amp", [0.7, 4.0, 40.0])
def test_warp_masked(amp):
    """Small, medium and out-of-frame flows: the mask zeroes what leaves."""
    rng = np.random.RandomState(4)
    x = rng.rand(2, 10, 14, 3).astype(np.float32)
    flow = (amp * rng.randn(2, 10, 14, 2)).astype(np.float32)
    want = np.asarray(jsample.warp_masked(jnp.asarray(x), jnp.asarray(flow)))
    got = _nhwc(sample.warp_masked(_nchw(x), _nchw(flow)))
    assert _rel(got, want) <= RTOL
    np.testing.assert_array_equal(got == 0, want == 0)


def _he(module, seed):
    return vgg.he_randomized_(module, seed).eval()


@pytest.mark.parametrize("cls,convert,hw", [
    (vgg.Vgg16Features, jvgg.vgg16_params_from_torch, (32, 48)),
    (vgg.Vgg19Features, jvgg.vgg19_params_from_torch, (32, 32))], ids=["vgg16", "vgg19"])
def test_vgg_features(cls, convert, hw):
    net = _he(cls(), 5)
    x = _img(6, (2, *hw, 3))
    want = getattr(jvgg, cls.__name__)().apply({"params": convert(net.state_dict())},
                                               jnp.asarray(x))
    with torch.no_grad():
        got = net(_nchw(x))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _nhwc(g).shape == w.shape
        assert _rel(_nhwc(g), w) <= RTOL


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_caffe_vgg(pool):
    net = _he(vgg.CaffeVGG(pool), 7)
    keys = ["r11", "r21", "r31", "r41", "r51", "p1", "p4"]
    x = vgg.obst_prep(_nchw(_img(8, (1, 32, 32, 3))))
    want = jvgg.CaffeVGG(pool).apply(
        {"params": jvgg.caffe_vgg_params_from_torch(net.state_dict())},
        jnp.asarray(_nhwc(x)), keys)
    with torch.no_grad():
        got = net(x, keys)
    for g, w in zip(got, want):
        assert _rel(_nhwc(g), w) <= RTOL


ALL_CAFFE_KEYS = ["r11", "r12", "p1", "r21", "r22", "p2", "r31", "r32", "r33", "r34", "p3",
                  "r41", "r42", "r43", "r44", "p4", "r51"]


@pytest.mark.parametrize("keys", [["r21", "r31", "r41"], ["r42"], ["r21", "r31", "r41", "r42"],
                                  ["r42", "r21"], ["p1"], ALL_CAFFE_KEYS],
                         ids=["style", "content", "obst_closure", "reordered", "p1", "all"])
def test_caffe_vgg_stops_after_its_deepest_key(keys):
    """The key sets OBST asks for (and others) give the outputs of the whole
    pass bit for bit, in the asked order; the layers past the deepest key
    do not run."""
    net = _he(vgg.CaffeVGG("max"), 5)
    x = vgg.obst_prep(_nchw(_img(6, (1, 32, 32, 3))))
    ran = []
    hooks = [getattr(net, name).register_forward_hook(lambda m, i, o, n=name: ran.append(n))
             for name, ch in vgg.CAFFE_CFG if ch is not None]
    with torch.no_grad():
        whole = dict(zip(ALL_CAFFE_KEYS, net(x, ALL_CAFFE_KEYS)))
        del ran[:]
        got = net(x, keys)
    for h in hooks:
        h.remove()
    assert len(got) == len(keys)
    for k, g in zip(keys, got):
        assert torch.equal(g, whole[k]), k
    deepest = max(ALL_CAFFE_KEYS.index(k) for k in keys)
    assert ran[-1] == [n for n, ch in vgg.CAFFE_CFG[:deepest + 1] if ch is not None][-1]


def test_obst_prep_postp():
    x = _img(9)
    want = np.asarray(jvgg.obst_prep(jnp.asarray(x)))
    got = vgg.obst_prep(_nchw(x))
    assert _rel(_nhwc(got), want) <= RTOL
    want_back = np.asarray(jvgg.obst_postp(jnp.asarray(want)))
    assert _rel(_nhwc(vgg.obst_postp(got)), want_back) <= RTOL


def _vst_he(module, seed):
    params = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                         *(([["r11"]]) if isinstance(module, jvgg.CaffeVGG) else []))["params"]
    return jax.device_get(jvgg.he_randomized_params(params, seed))


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("name", ["Vgg16Features", "Vgg19Features", "CaffeVGG"])
def test_he_randomized_is_vsts_bit_for_bit(name, seed):
    """The same draws in vst's tree order (conv0, conv10, conv12, …, conv2,
    …), transposed: equal weights, zero biases."""
    params = _vst_he(getattr(jvgg, name)(), seed)
    bridge = caffe_vgg_state_dict_from_jax if name == "CaffeVGG" else vgg_state_dict_from_jax
    want = bridge(params)
    got = vgg.he_randomized_(getattr(vgg, name)(), seed).state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
        if k.endswith(".bias"):
            assert not v.any()


def test_vgg_bridge_round_trip_and_torchvision_keys():
    """vst → port → vst is exact, and a torchvision-sized state_dict (more
    features and a classifier) loads into the trunk it covers."""
    params = _vst_he(jvgg.Vgg16Features(), 1)
    sd = vgg_state_dict_from_jax(params)
    back = jvgg.vgg16_params_from_torch(sd)
    for i, node in params["trunk"].items():
        for leaf in ("kernel", "bias"):
            np.testing.assert_array_equal(back["trunk"][i]["Conv_0"][leaf],
                                          node["Conv_0"][leaf])
    full = {**sd, "features.24.weight": torch.zeros(512, 512, 3, 3),
            "classifier.0.weight": torch.zeros(4096, 25088)}
    net = vgg.load_features(vgg.Vgg16Features(), full)
    for k, v in net.state_dict().items():
        assert torch.equal(v, sd[k])
    with pytest.raises(RuntimeError):
        vgg.load_features(vgg.Vgg16Features(), {k: v for k, v in sd.items() if "21" not in k})
