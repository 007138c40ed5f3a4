"""vst_torch's synthetic motion clips (numpy only) against vst's generator,
which calls OpenCV. Flows and masks are analytic and must be bit for bit
vst's; frames go through the numpy ``warpAffine`` and agree within 1e-5 on
[0, 1] (measured on a CPU against OpenCV 5.0: 0, bit for bit, at every
shape here; the bare warp on a random image with its edge columns, 7.4e-6)."""

import cv2
import numpy as np
import pytest

from vst.data import synthetic as vsyn
from vst_torch.data import synthetic as tsyn

ATOL_FRAMES = 1e-5


def _both(hw, n_frames, seed):
    """The same clip from vst's generator and the port's."""
    out = []
    for mod in (vsyn, tsyn):
        rng = np.random.RandomState(seed)
        gen = mod.AffineMotionGenerator(crop_hw=hw, seed=seed)
        clip = gen.generate(mod._texture(rng, (hw[0] + 96, hw[1] + 96)), n_frames=n_frames)
        out.append((gen, clip))
    return out


@pytest.mark.parametrize("hw,n_frames,seed", [((32, 48), 8, 0), ((64, 64), 8, 1),
                                              ((36, 52), 24, 2), ((100, 60), 3, 3)])
def test_generator_matches_vst(hw, n_frames, seed):
    (vgen, (vf, vfl, vm)), (tgen, (tf, tfl, tm)) = _both(hw, n_frames, seed)
    assert tf.shape == vf.shape == (n_frames, *hw, 3) and tf.dtype == np.float32
    np.testing.assert_array_equal(tfl, vfl)
    np.testing.assert_array_equal(tm, vm)
    assert 0 < tm.mean() < 1  # the masks are not all one value
    np.testing.assert_allclose(tf, vf, rtol=0, atol=ATOL_FRAMES)
    for i, j in ((0, n_frames - 1), (n_frames - 2, n_frames - 1), (1, 0)):
        for a, b in zip(tgen.pairwise_flows(i, j), vgen.pairwise_flows(i, j)):
            np.testing.assert_array_equal(a, b)


def test_texture_matches_vst():
    np.testing.assert_array_equal(tsyn._texture(np.random.RandomState(5), (40, 70)),
                                  vsyn._texture(np.random.RandomState(5), (40, 70)))


@pytest.mark.parametrize("angle,scale", [(-32.0, 0.5), (0.0, 1.0), (17.0, 1.25), (31.0, 0.875)])
def test_rotation_matrix_is_opencvs(angle, scale):
    center = (1120 / 2, 532 / 2)
    np.testing.assert_array_equal(tsyn.rotation_matrix_2d(center, angle, scale),
                                  cv2.getRotationMatrix2D(center, angle, scale))


def test_warp_affine_against_opencv():
    """A random image (edges in every pixel) under one TSR map, corners
    outside the source read as 0."""
    img = np.random.RandomState(0).rand(45, 71, 3).astype(np.float32)
    tsr = tsyn._tsr_matrix(np.random.RandomState(1), img.shape[:2])
    m = np.linalg.inv(tsr)[:2]
    got = tsyn.warp_affine_linear(img, m, (71, 45))
    want = cv2.warpAffine(img, m, (71, 45), flags=cv2.INTER_LINEAR)
    assert (want == 0).any()  # part of the frame maps outside the source
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_FRAMES)


def test_pairwise_flows_need_a_clip():
    with pytest.raises(RuntimeError, match="generate"):
        tsyn.AffineMotionGenerator().pairwise_flows(0, 1)
