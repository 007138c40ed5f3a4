"""vst_torch.metrics against vst.metrics on the CPU: the seeded He-randomized
Inception and AlexNet are vst's bit for bit; the port's ``state_dict`` carried
into vst through vst's converters gives activations within 1e-4 relative
(75×75, Inception's smallest input) and LPIPS within 1e-5; the host FID math
is vst's copy, equal within 1e-10; the learned LPIPS weights are a byte copy."""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.metrics import fid as jfid
from vst.metrics import lpips as jlpips
from vst.metrics.inception import InceptionV3Trunk as JTrunk
from vst.metrics.inception import inception_params_from_torch
from vst.perceptual.vgg import he_randomized_params
from vst_torch.metrics import fid, lpips
from vst_torch.metrics.inception import InceptionV3Trunk

ACT_RTOL = 1e-4
LPIPS_RTOL = 1e-5
FID_RTOL = 1e-10


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def images(seed, n=3, hw=75, lo=0.0):
    """n (N, H, W, 3) float32 images in [lo, 1]."""
    return (lo + (1 - lo) * np.random.RandomState(seed).rand(n, hw, hw, 3)).astype(np.float32)


def nchw(a):
    return np.ascontiguousarray(a.transpose(0, 3, 1, 2))


def flat(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def vst_random_he_inception(seed):
    """``vst.metrics.fid.InceptionV3(seed=seed).params`` without its eager
    flax init (36 s on a CPU, every kernel of which ``he_randomized_params``
    draws anew): vst's tree from ``jax.eval_shape`` of that init, its batch
    norm leaves at their initializers (vst/metrics/inception.py:40-43), then
    vst's ``he_randomized_params``."""
    shapes = jax.eval_shape(lambda: JTrunk().init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 75, 75, 3), jnp.float32))["params"])
    ones = ("bn_var", "bn_scale")
    tree = jax.tree_util.tree_map_with_path(
        lambda path, s: (np.ones if path[-1].key in ones else np.zeros)(s.shape, s.dtype),
        shapes)
    return jax.device_get(he_randomized_params(tree, seed))


def vst_inception(params):
    """vst's bound extractor on the given param tree, labelled as its
    seeded trunk."""
    j = jfid.InceptionV3(torch_state_dict={})
    j.params, j.backbone = params, "random-he"
    return j


@pytest.fixture(scope="module")
def inceptions():
    return vst_inception(vst_random_he_inception(2)), fid.InceptionV3(seed=2, device="cpu")


def test_inception_he_randomized_is_vsts_bit_for_bit(inceptions):
    """Every kernel drawn in the order of vst's nested tree; batch norms at
    their init (mean 0, var 1, scale 1, bias 0), convs without bias."""
    j, t = inceptions
    want = dict(flat(j.params))
    got = dict(flat(inception_params_from_torch(t.net.state_dict())))
    assert set(got) == set(want) and len(want) == 94 * 5
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert j.backbone == t.backbone == "random-he"


def test_inception_keys_are_torchvisions():
    keys = set(InceptionV3Trunk().state_dict())
    assert {"Conv2d_1a_3x3.conv.weight", "Conv2d_1a_3x3.bn.running_var",
            "Mixed_5b.branch_pool.bn.weight", "Mixed_7c.branch3x3dbl_3b.conv.weight"} <= keys
    assert not any(k.endswith("conv.bias") for k in keys)


def test_inception_activations_through_vsts_converter():
    """A torch-default trunk with random batch-norm statistics (so the bridge
    carries every leaf), through ``inception_params_from_torch``, at 75×75
    and 80×96: activations within 1e-4 relative, chunks padded alike."""
    torch.manual_seed(0)
    net = InceptionV3Trunk()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
    sd = net.state_dict()
    t = fid.InceptionV3(sd, device="cpu")
    j = jfid.InceptionV3(sd)
    assert t.backbone == j.backbone == "torchvision-inception"
    for seed, (h, w) in ((0, (75, 75)), (1, (80, 96))):
        x = np.random.RandomState(seed).rand(3, h, w, 3).astype(np.float32) * 2 - 1
        want = j(jnp.asarray(x), chunk=2)
        got = t(nchw(x), chunk=2)
        assert got.shape == (3, 2048) and got.dtype == np.float32
        assert rel(got, want) <= ACT_RTOL


def test_inception_seeded_activations(inceptions):
    j, t = inceptions
    x = images(3, n=2) * 2 - 1
    assert rel(t(torch.from_numpy(nchw(x))), j(jnp.asarray(x), chunk=2)) <= ACT_RTOL


def test_inception_refuses_inputs_under_75():
    with pytest.raises(RuntimeError):
        InceptionV3Trunk()(torch.zeros(1, 3, 64, 64))


def test_frechet_and_fid_are_vsts():
    rng = np.random.RandomState(4)
    a1, a2 = rng.randn(6, 32), rng.randn(5, 32) + 0.3
    for f in ("activation_stats",):
        for got, want in zip(getattr(fid, f)(a1), getattr(jfid, f)(a1)):
            np.testing.assert_array_equal(got, want)
    mu1, c1 = fid.activation_stats(a1)
    mu2, c2 = fid.activation_stats(a2)
    want = jfid.frechet_distance(mu1, c1, mu2, c2)
    assert abs(fid.frechet_distance(mu1, c1, mu2, c2) - want) <= FID_RTOL * abs(want)
    # both piles smaller than the features: the sample-subspace path; and
    # piles with an infinity, sanitized
    big1, big2 = rng.randn(4, 2048), rng.randn(5, 2048) + 0.1
    for p, q in ((a1, a2), (big1, big2), (np.full((3, 8), np.inf), a1[:3, :8])):
        want = jfid.fid_from_activations(p, q)
        assert abs(fid.fid_from_activations(p, q) - want) <= FID_RTOL * max(abs(want), 1.0)


def test_fid_from_image_batches(inceptions):
    j, t = inceptions
    b1, b2 = [images(5, n=2)], [images(6, n=2, lo=0.3)]
    want = jfid.fid_from_image_batches(j, [jnp.asarray(b) for b in b1],
                                       [jnp.asarray(b) for b in b2])
    got = fid.fid_from_image_batches(t, [nchw(b) for b in b1], [nchw(b) for b in b2])
    assert np.isfinite(got) and got > 0
    assert abs(got - want) <= ACT_RTOL * abs(want)


def test_lpips_lin_weights_are_a_byte_copy():
    assert filecmp.cmp(lpips._LIN_PATH, jlpips._LIN_PATH, shallow=False)
    for got, want in zip(lpips.load_lin_weights(), jlpips.load_lin_weights()):
        np.testing.assert_array_equal(got, want)
    assert [w.shape[0] for w in lpips.load_lin_weights()] == list(lpips.ALEX_CHANNELS)
    assert lpips.MU == jlpips.MU and lpips.SIGMA == jlpips.SIGMA


def test_convert_lin_weights_from_ckpt(tmp_path):
    ws = lpips.load_lin_weights()
    ckpt = tmp_path / "lpips_weights.ckpt"
    torch.save({f"lpips_weights.{i}.main.1.weight": torch.from_numpy(w).view(1, -1, 1, 1)
                for i, w in enumerate(ws)}, ckpt)
    out = lpips.convert_lin_weights_from_ckpt(str(ckpt), str(tmp_path / "lin.npz"))
    for got, want in zip(lpips.load_lin_weights(out), ws):
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def lpipses():
    return jlpips.LPIPS(seed=1), lpips.LPIPS(seed=1, device="cpu")


def test_alexnet_he_randomized_is_vsts_bit_for_bit(lpipses):
    j, t = lpipses
    want = dict(flat(jax.device_get(j.params)))
    got = dict(flat(jlpips.alexnet_params_from_torch(t.net.state_dict())))
    assert set(got) == set(want) and len(want) == 10
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=str(k))
    assert t.backbone == "random-he"


@pytest.mark.parametrize("hw", [32, 64])
def test_lpips_matches_vst(lpipses, hw):
    j, t = lpipses
    x, y = images(7, 2, hw) * 2 - 1, images(8, 2, hw) * 2 - 1
    want = j(jnp.asarray(x), jnp.asarray(y))
    got = t(nchw(x), nchw(y))
    assert got > 0 and abs(got - want) <= LPIPS_RTOL * want
    assert t(nchw(x), nchw(x)) == 0.0


def test_lpips_torchvision_weights_and_pairwise():
    torch.manual_seed(1)
    net = lpips.AlexNetFeatures()
    sd = dict(net.state_dict())
    sd["classifier.1.weight"] = torch.zeros(4, 4)  # a head this trunk drops
    t = lpips.LPIPS(sd, device="cpu")
    j = jlpips.LPIPS(jlpips_sd := net.state_dict())
    assert t.backbone == j.backbone == "torchvision-alexnet" and jlpips_sd
    group = [images(9 + i, 1, 32) * 2 - 1 for i in range(3)]
    want = jlpips.lpips_pairwise(j, [jnp.asarray(g) for g in group])
    got = lpips.lpips_pairwise(t, [nchw(g) for g in group])
    assert abs(got - want) <= LPIPS_RTOL * want
