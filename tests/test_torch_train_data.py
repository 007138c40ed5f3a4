"""vst_torch's training data against vst's on the same corpora: the
procedural styles and style files, ``synthetic_batch``, the FC2 / pickled
tuple / ChairsSDHom loaders (the FC2 one through the native reader, built
into ``vst_torch/_build/``), ``DeviceFC2Cache`` on the CPU and the metrics
logger.

Equal bit for bit, except ``synthetic_batch``'s frames: vst warps them with
OpenCV, the port with its numpy copy of OpenCV's float32 path, within the
≤ 7.4e-6 of the scalar tail columns at a right edge
(``tests/test_torch_synthetic.py``); its flows and masks are equal."""

import os

import numpy as np
import pytest
import torch
import jax

from torch_train_parity import torch_threads  # noqa: F401 (autouse)
from vst.core.metrics import MetricsLogger as JLogger
from vst.data import device_cache as jcache
from vst.data import loader as jloader
from vst.data import styles as jstyles
from vst.data import synthetic as jsynthetic
from vst_torch.core.metrics import MetricsLogger
from vst_torch.data import device_cache, loader, native_loader, styles, synthetic
from vst_torch.data.datagen import pack_fc2_npy

FRAME_ATOL = 7.4e-6


@pytest.mark.parametrize("seed,size", [(1000, 64), (1002, 33)])
def test_procedural_style(seed, size):
    np.testing.assert_array_equal(styles._procedural_style(seed, size),
                                  jstyles._procedural_style(seed, size))


def test_load_style_images_reads_files_and_falls_back(tmp_path):
    import cv2

    img = (np.random.RandomState(0).rand(40, 50, 3) * 255).astype(np.uint8)
    cv2.imwrite(str(tmp_path / "s2_the_scream.png"), img)
    got = styles.load_style_images(str(tmp_path), size=32)
    want = jstyles.load_style_images(str(tmp_path), size=32)
    assert got.shape == (3, 32, 32, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got[1], styles._procedural_style(1001, 32))


@pytest.mark.parametrize("hw,n_frames,seed", [((32, 32), 2, 0), ((24, 40), 3, 5)])
def test_synthetic_batch(hw, n_frames, seed):
    got = synthetic.synthetic_batch(3, hw=hw, n_frames=n_frames, seed=seed)
    want = jsynthetic.synthetic_batch(3, hw=hw, n_frames=n_frames, seed=seed)
    assert got["imgs"].shape == (3, n_frames, *hw, 3)
    np.testing.assert_allclose(got["imgs"], want["imgs"], rtol=0, atol=FRAME_ATOL)
    np.testing.assert_array_equal(got["flows"], want["flows"])
    np.testing.assert_array_equal(got["masks"], want["masks"])


def _fc2_corpus(root, n=5, hw=(16, 20), f64_at=None):
    """n FC2 files (1, H, W, 9); file ``f64_at`` as float64, which the
    native reader refuses and np.load reads."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.RandomState(1)
    for i in range(n):
        d = rng.rand(1, *hw, 9).astype(np.float32)
        d[..., 6] = d[..., 6] > 0.3
        d[..., 7:9] = d[..., 7:9] * 8 - 4
        np.save(os.path.join(root, f"{i:07d}.npy"), d.astype(np.float64) if i == f64_at else d)
    return root


def _epochs(ds, n=2):
    return [b for _ in range(n) for b in ds.epoch()]


def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_fc2_dataset_through_the_native_reader(tmp_path):
    root = _fc2_corpus(str(tmp_path / "fc2"), f64_at=3)
    got, want = loader.NpyDirDataset(root, 2, seed=4), jloader.NpyDirDataset(root, 2, seed=4)
    assert len(got) == len(want) == 2
    batches = _epochs(got)
    _assert_batches_equal(batches, _epochs(want))
    assert batches[0]["imgs"].shape == (2, 2, 16, 20, 3)
    assert native_loader.native_available()
    assert native_loader.library_path().parent == native_loader.BUILD_DIR
    assert native_loader.library_path().exists()
    with pytest.raises(ValueError):
        loader.NpyDirDataset(root, 2, expected_size=6)


def test_load_npy_batch_falls_back_per_file(tmp_path):
    root = _fc2_corpus(str(tmp_path / "fc2"), n=3, f64_at=1)
    paths = [os.path.join(root, f) for f in sorted(os.listdir(root))]
    got = native_loader.load_npy_batch(paths, (1, 16, 20, 9))
    np.testing.assert_array_equal(got, np.stack([np.load(p).astype(np.float32) for p in paths]))


def test_fc2_packer_writes_what_the_dataset_reads(tmp_path):
    """Sample i is drawn from seed + i, as vst's packer draws it."""
    pack_fc2_npy(str(tmp_path), 5, hw=(16, 24), seed=2)
    want = [synthetic.synthetic_batch(1, hw=(16, 24), seed=2 + i) for i in range(5)]
    got = next(loader.NpyDirDataset(str(tmp_path), 5).epoch(shuffle=False))
    for k in ("imgs", "masks", "flows"):
        np.testing.assert_array_equal(got[k], np.concatenate([w[k] for w in want]))


def test_tuple_dataset_and_packer(tmp_path):
    """vst's packed corpus reads the same through both loaders; the port's
    packer writes vst's corpus (frames to the synthetic tolerance)."""
    jloader.pack_tuple_npy(str(tmp_path / "vst"), 4, hw=(16, 24), n_frames=3, seed=2)
    loader.pack_tuple_npy(str(tmp_path / "port"), 4, hw=(16, 24), n_frames=3, seed=2)
    got = _epochs(loader.TupleNpyDataset(str(tmp_path / "vst"), 2, seed=1))
    _assert_batches_equal(got, _epochs(jloader.TupleNpyDataset(str(tmp_path / "vst"), 2, seed=1)))
    assert got[0]["masks"].shape == (2, 2, 16, 24, 1)
    ours = _epochs(loader.TupleNpyDataset(str(tmp_path / "port"), 2, seed=1))
    for g, w in zip(ours, got):
        np.testing.assert_allclose(g["imgs"], w["imgs"], rtol=0, atol=FRAME_ATOL)
        np.testing.assert_array_equal(g["flows"], w["flows"])
        np.testing.assert_array_equal(g["masks"], w["masks"])


def test_chairs_sdhom_and_combined(tmp_path):
    root = tmp_path / "chairs"
    root.mkdir()
    rng = np.random.RandomState(3)
    for i in range(3):
        np.save(root / f"{i:05d}.npy", rng.rand(24, 32, 9).astype(np.float32))
    got = loader.ChairsSDHomDataset(str(root), 1, seed=2, crop_hw=(16, 16))
    want = jloader.ChairsSDHomDataset(str(root), 1, seed=2, crop_hw=(16, 16))
    _assert_batches_equal(_epochs(got), _epochs(want))
    assert next(got.epoch(False))["flows"].shape == (1, 1, 16, 16, 2)

    fc2 = _fc2_corpus(str(tmp_path / "fc2"), n=4, hw=(16, 16))
    mixed = [loader.NpyDirDataset(fc2, 2, seed=0), loader.ChairsSDHomDataset(str(root), 1,
                                                                             crop_hw=(16, 16))]
    jmixed = [jloader.NpyDirDataset(fc2, 2, seed=0), jloader.ChairsSDHomDataset(str(root), 1,
                                                                                crop_hw=(16, 16))]
    assert len(loader.CombinedDataset(*mixed)) == len(jloader.CombinedDataset(*jmixed)) == 5
    _assert_batches_equal(list(loader.CombinedDataset(*mixed).epoch()),
                          list(jloader.CombinedDataset(*jmixed).epoch()))
    with pytest.raises(ValueError):
        loader.CombinedDataset()


def test_device_cache_on_the_cpu_is_vsts_gather(tmp_path):
    """The same draws (one RandomState per cache) give vst's batches,
    NHWC → NCHW: uint8 images over 255, 0/1 masks, float16 flows."""
    root = _fc2_corpus(str(tmp_path / "fc2"), n=6)
    got = device_cache.DeviceFC2Cache(root, limit=5, seed=7, device="cpu")
    want = jcache.DeviceFC2Cache(root, limit=5, seed=7, device=jax.devices("cpu")[0])
    assert got.n == want.n == 5
    assert got.imgs.dtype == torch.uint8 and got.flows.dtype == torch.float16
    for _ in range(3):
        g, w = got.sample(4), want.sample(4)
        assert g["imgs"].shape == (4, 2, 3, 16, 20) and g["imgs"].dtype == torch.float32
        np.testing.assert_array_equal(g["imgs"].permute(0, 1, 3, 4, 2).numpy(), np.asarray(w["imgs"]))
        for k in ("masks", "flows"):
            np.testing.assert_array_equal(g[k].permute(0, 1, 3, 4, 2).numpy(), np.asarray(w[k]))


def test_metrics_logger_writes_vsts_lines_and_curves(tmp_path):
    ours, theirs = MetricsLogger(str(tmp_path / "a" / "losses.txt")), JLogger(str(tmp_path / "b.txt"))
    for step in (10, 20):
        for logger in (ours, theirs):
            logger.log(step, loss=1.5 / step, content=0.25)
    ours.save_curves(str(tmp_path / "a.npy"))
    theirs.save_curves(str(tmp_path / "b.npy"))
    np.testing.assert_array_equal(np.load(tmp_path / "a.npy"), np.load(tmp_path / "b.npy"))
    strip = lambda text: [line.split("] ", 1)[1] for line in text.splitlines()]  # noqa: E731
    assert strip((tmp_path / "a" / "losses.txt").read_text()) == strip((tmp_path / "b.txt").read_text())
