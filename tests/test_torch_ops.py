"""vst_torch.ops against vst.ops: pads, resizes, pooling, InputPadder,
grid_sample in both align_corners modes, the flowtools warp and the
fb-consistency mask. Inputs come from numpy seeds; the port takes NCHW, vst
NHWC. Tolerance 1e-5 absolute (measured on a CPU: ≤ 2.4e-6, the bilinear
resize; warp 1.3e-6; the masks are equal)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from vst.ops import flowtools as jflow
from vst.ops import image as jimage
from vst.ops import sample as jsample
from vst_torch.ops import flowtools, image, sample

ATOL = 1e-5


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(a, (0, 3, 1, 2))))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _img(seed, shape=(2, 10, 14, 3)):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _smooth_flow(seed, b, h, w, amp=3.0):
    """Seeded smooth flow (B, H, W, 2): a translation plus a slow sinusoid."""
    rng = np.random.RandomState(seed)
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = np.zeros((b, h, w, 2), np.float32)
    for i in range(b):
        for c in range(2):
            t, a, fx, fy = rng.uniform(-1, 1, 4)
            out[i, ..., c] = amp * (t + 0.5 * a * np.sin(0.3 * fx * xs + 0.3 * fy * ys))
    return out


def test_pads_and_resizes():
    x = _img(0)
    np.testing.assert_allclose(_nhwc(image.reflect_pad(_nchw(x), 2)),
                               np.asarray(jimage.reflect_pad(jnp.asarray(x), 2)), atol=ATOL)
    pad = (1, 2, 3, 0)
    np.testing.assert_allclose(_nhwc(image.replicate_pad(_nchw(x), pad)),
                               np.asarray(jimage.replicate_pad(jnp.asarray(x), pad)), atol=ATOL)
    np.testing.assert_array_equal(_nhwc(image.resize_nearest(_nchw(x), 2)),
                                  np.asarray(jimage.resize_nearest(jnp.asarray(x), 2)))
    for ac in (True, False):
        got = _nhwc(image.resize_bilinear(_nchw(x), (23, 31), align_corners=ac))
        want = np.asarray(jimage.resize_bilinear(jnp.asarray(x), (23, 31), align_corners=ac))
        np.testing.assert_allclose(got, want, atol=ATOL)


def test_avg_pool2d():
    x = _img(1, (3, 9, 13, 1))
    np.testing.assert_allclose(_nhwc(image.avg_pool2d(_nchw(x), 2, 2)),
                               np.asarray(jimage.avg_pool2d(jnp.asarray(x), 2, 2)), atol=ATOL)


@pytest.mark.parametrize("mode", ["sintel", "other"])
def test_input_padder_matches_and_round_trips(mode):
    x = _img(2, (1, 436, 21, 3))
    tp = image.InputPadder(_nchw(x).shape, mode=mode)
    jp = jimage.InputPadder(x.shape, mode=mode)
    (padded,) = tp.pad(_nchw(x))
    assert padded.shape[-2] % 8 == 0 and padded.shape[-1] % 8 == 0
    np.testing.assert_array_equal(_nhwc(padded), np.asarray(jp.pad(jnp.asarray(x))[0]))
    np.testing.assert_array_equal(_nhwc(tp.unpad(padded)), x)


@pytest.mark.parametrize("align_corners", [True, False])
def test_grid_sample(align_corners):
    x = _img(3, (2, 9, 12, 4))
    grid = np.random.RandomState(4).uniform(-1.2, 1.2, (2, 7, 5, 2)).astype(np.float32)
    got = sample.grid_sample(_nchw(x), torch.from_numpy(grid), align_corners=align_corners)
    want = jsample.grid_sample(jnp.asarray(x), jnp.asarray(grid), align_corners=align_corners)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_bilinear_sample_pixel(padding_mode):
    x = _img(5, (2, 8, 11, 3))
    rng = np.random.RandomState(6)
    px = rng.uniform(-2, 13, (2, 6, 4)).astype(np.float32)
    py = rng.uniform(-2, 10, (2, 6, 4)).astype(np.float32)
    got = sample.bilinear_sample_pixel(_nchw(x), torch.from_numpy(px), torch.from_numpy(py),
                                       padding_mode=padding_mode)
    want = jsample.bilinear_sample_pixel(jnp.asarray(x), jnp.asarray(px), jnp.asarray(py),
                                         padding_mode=padding_mode)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_warp_keeps_the_flowtools_quirk():
    x = _img(7, (2, 12, 16, 3))
    flow = _smooth_flow(8, 2, 12, 16)
    got = sample.warp(_nchw(x), _nchw(flow))
    want = jsample.warp(jnp.asarray(x), jnp.asarray(flow))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=ATOL)


def test_gradient():
    x = _img(9, (2, 7, 9, 1))[..., 0]
    got = flowtools.gradient(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jflow.gradient(jnp.asarray(x))), atol=ATOL)


@pytest.mark.parametrize("use_occlusion", [True, False])
def test_fbc_mask(use_occlusion):
    ff = _smooth_flow(10, 2, 16, 24)
    bf = -ff + 0.3 * np.random.RandomState(11).randn(*ff.shape).astype(np.float32)
    got = flowtools.fbc_mask(_nchw(ff), _nchw(bf), use_occlusion=use_occlusion)
    want = np.asarray(jflow.fbc_mask(jnp.asarray(ff), jnp.asarray(bf),
                                     use_occlusion=use_occlusion))
    assert got.shape == (2, 1, 16, 24)
    assert 0.0 < float(want.mean()) < 1.0  # both classes present
    np.testing.assert_array_equal(_nhwc(got), want)
