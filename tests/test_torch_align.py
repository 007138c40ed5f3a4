"""Face alignment (``vst_torch.models.align``) and the ``align-faces``
command against vst's, on the CPU, without the reference checkout that
``tests/test_align.py`` reads.

The geometry is the port's own numpy copy of vst's, so it is held equal on
random landmark sets. ``FaceAligner.align`` at output 64 and the command's
files run the same FAN weights on both sides (the port's seeded FAN through
vst's ``fan_params_from_torch``, and the same ``--wing-ckpt`` file) and are
held within one uint8 step (measured 0: the landmarks come out equal, and
the rest is the same numpy and cv2 code on the same pixels).
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from PIL import Image

import vst.cli.__main__ as vcli
import vst.models.align as jalign
import vst.models.wing as jwing
from test_torch_wing import _fan
from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst_torch.cli.__main__ import main as cli_main
from vst_torch.cli.__main__ import parser
from vst_torch.models import align

UINT8_STEP = 2.0 / 255.0  # one uint8 step on [−1, 1]


def _random_landmarks(seed):
    """vst's template, jittered, rotated, scaled and moved (as
    ``tests/test_align.py`` draws them)."""
    rng = np.random.RandomState(seed)
    lm = jalign.synthetic_reference_landmarks(256).copy()
    lm += rng.randn(*lm.shape).astype(np.float32) * 4
    ang, sc = rng.uniform(-0.4, 0.4), rng.uniform(0.8, 1.25)
    R = np.array([[np.cos(ang), -np.sin(ang)], [np.sin(ang), np.cos(ang)]])
    return ((lm - 128) @ R.T * sc + 128 + rng.uniform(-20, 20, size=(1, 2))).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geometry_is_vsts(seed):
    lm = _random_landmarks(seed)
    ref = align.synthetic_reference_landmarks(256)
    np.testing.assert_array_equal(ref, jalign.synthetic_reference_landmarks(256))
    np.testing.assert_array_equal(align.synthetic_reference_landmarks(512),
                                  jalign.synthetic_reference_landmarks(512))
    for name in ("landmarks2eyes", "landmarks2mouthends", "landmarks2xaxis"):
        np.testing.assert_array_equal(np.asarray(getattr(align, name)(lm)),
                                      np.asarray(getattr(jalign, name)(lm)), err_msg=name)
    for d in ("from", "to"):
        np.testing.assert_array_equal(align.points2T(lm, d), jalign.points2T(lm, d))
    np.testing.assert_array_equal(align.landmarks2S(lm, ref), jalign.landmarks2S(lm, ref))
    vx, vy = align.landmarks2xaxis(lm), align.landmarks2xaxis(ref)
    np.testing.assert_array_equal(align.vecs2R(vx, vy), jalign.vecs2R(vx, vy))
    np.testing.assert_array_equal(align.vecs2R(vy, vx), jalign.vecs2R(vy, vx))
    np.testing.assert_array_equal(align.landmarks2mat(lm, ref), jalign.landmarks2mat(lm, ref))
    img = (np.random.RandomState(seed).rand(40, 52, 3) * 255).astype(np.uint8)
    for got, want in zip(align.pad_mirror(img, lm), jalign.pad_mirror(img, lm)):
        np.testing.assert_array_equal(got, want)


def test_preds_from_heatmaps_are_vsts_with_ties():
    """Sub-pixel landmarks of random maps, and of maps whose maximum is tied
    (the first in row-major order wins on both sides, and a flat neighbour
    gives no nudge)."""
    hm = np.random.RandomState(3).rand(2, 5, 16, 16).astype(np.float32)
    hm[0, 0, 4, 9] = hm[0, 0, 11, 2] = 2.0  # a tie: (9, 4) is first
    hm[1, 2] = 0.5  # all tied: the first pixel, on the border (no nudge)
    hm[1, 3, 7, 6:9] = 3.0  # a tie along the row: the left one, nudged right
    got = align.get_preds_from_heatmaps(hm)
    np.testing.assert_array_equal(got, jalign.get_preds_from_heatmaps(hm))
    np.testing.assert_array_equal(np.abs(got[0, 0] - [9.5, 4.5]), [0.25, 0.25])  # at (9, 4)
    assert list(got[1, 2]) == [0.5, 0.5]
    assert got[1, 3, 0] == 6.75


@pytest.fixture(scope="module")
def fans():
    fan = _fan()
    return fan, jwing.FAN(), jwing.fan_params_from_torch(fan.state_dict())


def test_face_aligner_at_64_is_vsts(fans):
    fan, jfan, params = fans
    imgs = np.random.RandomState(4).uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    x = torch.from_numpy(imgs).permute(0, 3, 1, 2)
    lms = align.fan_landmarks(fan, x)
    np.testing.assert_array_equal(lms, jalign.fan_landmarks(jfan, params, jnp.asarray(imgs)))
    got = align.FaceAligner(fan, output_size=64).align(x)
    want = jalign.FaceAligner(jfan, params, output_size=64).align(imgs)
    assert got.shape == want.shape == (2, 64, 64, 3) and got.dtype == np.float32
    assert np.abs(got - want).max() <= UINT8_STEP
    assert got.min() >= -1.0 and got.max() <= 1.0


def test_align_faces_writes_vsts_files(fans, tmp_path):
    """Both commands on the same 2 PNGs, ``--wing-ckpt`` and template file:
    the same names, images within one uint8 unit, vst's printed line."""
    fan, _, _ = fans
    torch.save(fan.state_dict(), tmp_path / "wing.ckpt")
    np.savez(tmp_path / "lm.npz", mean=jalign.synthetic_reference_landmarks(256) + 3.0)
    src = tmp_path / "in"
    src.mkdir()
    rng = np.random.RandomState(5)
    for name in ("a.png", "b.png"):
        Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8)).save(src / name)
    common = ["--input-dir", str(src), "--img-size", "64", "--wing-ckpt",
              str(tmp_path / "wing.ckpt"), "--lm-path", str(tmp_path / "lm.npz")]
    line = cli_main(["align-faces", "--device", "cpu", *common,
                     "--output-dir-align", str(tmp_path / "port")])
    vcli.main(["align-faces", "--platform", "cpu", *common,
               "--output-dir-align", str(tmp_path / "vst")])
    assert line["aligned"] == 2 and line["img_size"] == 64 and line["seconds"] > 0
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == sorted(os.listdir(tmp_path / "vst")) == ["a.png", "b.png"]
    for name in names:
        got = np.asarray(Image.open(tmp_path / "port" / name))
        want = np.asarray(Image.open(tmp_path / "vst" / name))
        assert got.dtype == np.uint8 and got.shape == want.shape == (64, 64, 3)
        assert np.abs(got.astype(int) - want).max() <= 1


def test_align_faces_defaults_and_refuses_to_run_on_the_cpu_silently(tmp_path, monkeypatch):
    args = parser().parse_args(["align-faces", "--input-dir", "i", "--output-dir-align", "o"])
    assert args.device == "cuda" and args.img_size == 256 and args.wing_ckpt is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA"):
        cli_main(["align-faces", "--input-dir", str(tmp_path), "--output-dir-align",
                  str(tmp_path / "o")])
