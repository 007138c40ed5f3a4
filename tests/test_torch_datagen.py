"""vst_torch.data.datagen (and ``_scene``) against vst.data.datagen on the CPU.

* ``_scene`` and ``procedural_stylize``: host numpy with the same cv2 and
  numpy calls, bit for bit.
* ``pack_fc2_npy``: sample i from seed + i, as vst's. The frames go through
  the port's numpy warp where vst calls OpenCV, so they are held to the
  synthetic tolerance of ``tests/test_torch_synthetic.py`` (1e-5; measured
  0 here); flows and masks are analytic and must be equal.
* ``generate_fc2_corpus --styler procedural``: every ``.npy`` equal and
  every JPEG byte for byte vst's (PIL at imageio's quality 75; measured
  equal at 32², 6 pairs, so the decoded pixels are equal too).
* ``generate_styled_dataset``: OBST in float64 on both sides (jax x64), as
  ``tests/test_torch_gatys.py`` holds OBST, since torch's first L-BFGS step
  amplifies float32 noise (measured 2–9 % relative after one level in
  float32): the styled images within 1e-8 relative (measured ≤ 4e-11) and
  the written JPEGs equal.
* ``precompute_lt_flow`` with vst's stub RAFT (``tests/test_data_eval_utils.py:60-71``):
  the same files, masks equal, flows within 1e-6 (the stub's channel mean
  rounds in another order: measured 6e-8).
"""

import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from torch_train_parity import torch_threads  # noqa: F401 (autouse: 2 threads a worker)

import vst.models.gatys as jg
import vst.perceptual.vgg as jvgg
from vst.data import datagen as jdatagen
from vst.data import synthetic as jsynthetic
from vst.data.styles import load_style_images
from vst_torch.data import datagen, synthetic
from vst_torch.models import gatys
from vst_torch.perceptual import vgg as tvgg

FRAME_ATOL = 1e-5  # tests/test_torch_synthetic.py's ATOL_FRAMES
F64_RTOL = 1e-8  # tests/test_torch_gatys.py's
LT_FLOW_ATOL = 1e-6


@pytest.fixture
def x64():
    saved = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", saved)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize("hw,seed", [((160, 176), 0), ((128, 128), 1), ((40, 300), 2)])
def test_scene_is_vsts(hw, seed):
    got = synthetic._scene(np.random.RandomState(seed), hw)
    assert got.dtype == np.float32 and got.shape == (*hw, 3)
    np.testing.assert_array_equal(got, jsynthetic._scene(np.random.RandomState(seed), hw))


@pytest.mark.parametrize("sid", range(6))
def test_procedural_stylize_is_vsts(sid):
    img = np.random.RandomState(sid).rand(9, 13, 3).astype(np.float32)
    np.testing.assert_array_equal(datagen.procedural_stylize(img, sid),
                                  jdatagen.procedural_stylize(img, sid))


def test_pack_fc2_npy_writes_vsts_files(tmp_path):
    datagen.pack_fc2_npy(str(tmp_path / "p"), 5, hw=(16, 24), seed=2)
    jdatagen.pack_fc2_npy(str(tmp_path / "v"), 5, hw=(16, 24), seed=2)
    assert _files(tmp_path / "p") == _files(tmp_path / "v") == [f"{i:07d}.npy" for i in range(5)]
    for name in _files(tmp_path / "v"):
        got, want = np.load(tmp_path / "p" / name), np.load(tmp_path / "v" / name)
        assert got.shape == (1, 16, 24, 9) and got.dtype == np.float32
        np.testing.assert_allclose(got[..., :6], want[..., :6], rtol=0, atol=FRAME_ATOL)
        np.testing.assert_array_equal(got[..., 6:], want[..., 6:])


def test_procedural_corpus_is_vsts_byte_for_byte(tmp_path, capsys):
    datagen.generate_fc2_corpus(str(tmp_path / "p"), 6, hw=(32, 32), styler="procedural",
                                device="cpu")
    ours = capsys.readouterr().out
    jdatagen.generate_fc2_corpus(str(tmp_path / "v"), 6, hw=(32, 32), styler="procedural")
    assert ours == capsys.readouterr().out
    names = _files(tmp_path / "v")
    assert _files(tmp_path / "p") == names and len(names) == 6 + 2 * 4 * 6
    for name in names:
        assert filecmp.cmp(tmp_path / "p" / name, tmp_path / "v" / name, shallow=False), name
    grey = np.asarray(Image.open(tmp_path / "p" / "styled-files" / "style3" / "0000000.jpg"))
    assert np.abs(grey[..., 0].astype(int) - grey[..., 1]).max() <= 1


def test_procedural_corpus_skips_existing_files(tmp_path):
    root = str(tmp_path / "c")
    datagen.generate_fc2_corpus(root, 2, hw=(32, 32), styler="procedural", device="cpu")
    path = os.path.join(root, "styled-files", "style1", "0000001.jpg")
    stamp = os.stat(path).st_mtime_ns
    os.remove(os.path.join(root, "DATAFiles", "0000000.npy"))
    datagen.generate_fc2_corpus(root, 2, hw=(32, 32), styler="procedural", device="cpu")
    assert os.stat(path).st_mtime_ns == stamp
    assert os.path.exists(os.path.join(root, "DATAFiles", "0000000.npy"))


def test_generate_styled_dataset_float64(x64, tmp_path, monkeypatch):
    """Two 40×40 contents, 3 styles (style 3 grayscale), one 16×16 level of
    20 closure calls, batch 2; the styled floats are read at the
    post-process on both sides."""
    seen = {"vst": [], "port": []}
    jpost, tpost = jvgg.obst_postp, tvgg.obst_postp

    def j_record(x):
        seen["vst"].append(np.asarray(jpost(x)))
        return jpost(x)

    def t_record(x):
        seen["port"].append(tpost(x).permute(0, 2, 3, 1).numpy())
        return tpost(x)

    monkeypatch.setattr(jvgg, "obst_postp", j_record)
    monkeypatch.setattr(tvgg, "obst_postp", t_record)
    rng = np.random.RandomState(0)
    contents = [(f"{i:07d}", rng.rand(40, 40, 3)) for i in range(2)]
    styles = load_style_images(size=32)[:3]
    pyr = ((16, 16),)
    jdatagen.generate_styled_dataset(
        contents, styles, str(tmp_path / "v"), pyr_shapes=pyr, batch_size=2,
        obst=jg.OBST(max_iters=(1,), seed=0, compute_dtype=jnp.float64))
    datagen.generate_styled_dataset(
        contents, styles, str(tmp_path / "p"), pyr_shapes=pyr, batch_size=2,
        obst=gatys.OBST(max_iters=(1,), seed=0, compute_dtype=torch.float64, device="cpu"))
    assert len(seen["port"]) == len(seen["vst"]) == 3
    for got, want in zip(seen["port"], seen["vst"]):
        assert got.shape == want.shape == (2, 16, 16, 3) and got.dtype == np.float64
        assert np.abs(got - want).max() <= F64_RTOL * np.abs(want).max()
    names = _files(tmp_path / "v")
    assert _files(tmp_path / "p") == names and len(names) == 4 * 2
    for name in names:
        got = np.asarray(Image.open(tmp_path / "p" / name))
        np.testing.assert_array_equal(got, np.asarray(Image.open(tmp_path / "v" / name)))


def test_gatys_corpus_pads_the_tail_batch(tmp_path, monkeypatch):
    """3 pairs = 6 images a style in batches of 4: the second batch of 2 is
    padded to 4 with its first image, as vst's; only the real 2 are written."""
    shapes = []

    class Recorder(gatys.OBST):
        def run(self, pre, img, mask, pyr_shapes, weight_tcl=0.0):
            shapes.append((tuple(pre.shape), tuple(mask.shape), tuple(pyr_shapes), weight_tcl))
            assert torch.equal(pre, img)
            return pre

    monkeypatch.setattr(gatys, "OBST", Recorder)
    datagen.generate_fc2_corpus(str(tmp_path), 3, hw=(32, 32), iters=(1, 1, 1), batch_size=4,
                                device="cpu")
    pyr = ((8, 8), (16, 16), (32, 32))
    assert shapes == [((4, 3, 32, 32), (4, 1, 32, 32), pyr, 0.0)] * 6
    for tree, suffix in (("styled-files", ".jpg"), ("styled-files3", "_2.jpg")):
        for k in range(4):
            assert sorted(os.listdir(tmp_path / tree / f"style{k}")) == [
                f"{i:07d}{suffix}" for i in range(3)]
    # the identity styler writes the content back: style 1 is style 0
    a = np.asarray(Image.open(tmp_path / "styled-files" / "style1" / "0000002.jpg"), np.int32)
    b = np.asarray(Image.open(tmp_path / "styled-files" / "style0" / "0000002.jpg"), np.int32)
    assert np.abs(a - b).max() <= 1


def test_precompute_lt_flow_with_the_stub_raft(tmp_path):
    frames = jsynthetic.synthetic_batch(1, hw=(30, 36), n_frames=7, seed=4)["imgs"][0]

    def j_stub(i1, i2):
        d = jnp.mean(i1 - i2, axis=-1, keepdims=True)
        return None, jnp.concatenate([d, -d], axis=-1)

    def t_stub(i1, i2):
        assert i1.shape == (1, 3, 32, 40)  # InputPadder to multiples of 8
        d = (i1 - i2).mean(dim=1, keepdim=True)
        return None, torch.cat([d, -d], 1)

    want = jdatagen.precompute_lt_flow(frames, j_stub, out_dir=str(tmp_path / "v"))
    got = datagen.precompute_lt_flow(frames, t_stub, out_dir=str(tmp_path / "p"), device="cpu")
    assert _files(tmp_path / "p") == _files(tmp_path / "v") == ["frame_0005.npy", "frame_0006.npy"]
    assert len(got) == len(want) == 2
    for g, w, name in zip(got, want, _files(tmp_path / "v")):
        assert g.shape == (1, 30, 36, 3) and g.dtype == np.float32
        np.testing.assert_array_equal(np.load(tmp_path / "p" / name), g)
        np.testing.assert_allclose(g[..., :2], w[..., :2], rtol=0, atol=LT_FLOW_ATOL)
        np.testing.assert_array_equal(g[..., 2], w[..., 2])
        assert 0 < g[..., 2].mean() < 1
