"""vst_torch.flow.datasets against vst.flow.datasets on the CPU, on trees of
``.ppm`` / ``.png`` / ``.flo`` / ``.pfm`` / KITTI 16-bit PNG files that the
tests write in the layouts of vst's ``tests/test_flow_training.py:62-190``.

The augmentor is host numpy and cv2 on both sides, drawing from its own
seeded generator in the same order, and the images are read through PIL on
one side and imageio on the other (the same pixels for PNG and PPM): every
sample must be equal, bit for bit, in the same order."""

import os

import imageio.v2 as imageio
import numpy as np
import pytest

from test_flow_training import _make_things_tree, _write_kitti_png
from vst.flow import datasets as jd
from vst.flow.io import write_flo
from vst_torch.flow import datasets as td

H, W = 40, 56  # room for the augmentor's crop of 24×32 after any scale


def _assert_samples_equal(ours, ref, n=None):
    assert len(ours) == len(ref)
    for i in range(len(ref) if n is None else n):
        got, want = ours[i], ref[i]
        assert len(got) == len(want) == 4
        for a, b in zip(got, want):
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,crop,scales,flip", [(0, (24, 32), (-0.2, 0.5), True),
                                                   (1, (32, 48), (-0.1, 1.0), True),
                                                   (2, (24, 32), (0.0, 0.0), False)])
def test_augmentor_is_vsts(seed, crop, scales, flip):
    rng = np.random.RandomState(10 + seed)
    img1 = (rng.rand(H, W, 3) * 255).astype(np.float32)
    img2 = (rng.rand(H, W, 3) * 255).astype(np.float32)
    flow = (rng.randn(H, W, 2) * 3).astype(np.float32)
    ours = td.FlowAugmentor(crop, *scales, do_flip=flip, seed=seed)
    ref = jd.FlowAugmentor(crop, *scales, do_flip=flip, seed=seed)
    for _ in range(8):  # consecutive draws of one generator
        got, want = ours(img1, img2, flow), ref(img1, img2, flow)
        for a, b in zip(got, want):
            assert a.shape[:2] == crop
            np.testing.assert_array_equal(a, b)


def _chairs(root, rng, n=3):
    os.makedirs(root / "data")
    for i in range(n):
        for k in (1, 2):
            imageio.imwrite(root / "data" / f"{i:05d}_img{k}.ppm",
                            (rng.rand(H, W, 3) * 255).astype(np.uint8))
        write_flo(str(root / "data" / f"{i:05d}_flow.flo"), rng.randn(H, W, 2).astype(np.float32))


def _sintel(root, rng, scenes=("alley_1", "market_2"), n=3):
    for dstype in ("clean", "final"):
        for scene in scenes:
            os.makedirs(root / "training" / dstype / scene)
            for t in range(n):
                imageio.imwrite(root / "training" / dstype / scene / f"frame_{t:04d}.png",
                                (rng.rand(H, W, 3) * 255).astype(np.uint8))
    for scene in scenes:
        os.makedirs(root / "training" / "flow" / scene)
        for t in range(n - 1):
            write_flo(str(root / "training" / "flow" / scene / f"frame_{t:04d}.flo"),
                      (rng.randn(H, W, 2) * 2).astype(np.float32))


def _kitti(root, rng, n=2):
    (root / "training" / "image_2").mkdir(parents=True)
    (root / "training" / "flow_occ").mkdir(parents=True)
    for k in range(n):
        for suf in ("10", "11"):
            imageio.imwrite(root / "training" / "image_2" / f"00000{k}_{suf}.png",
                            (rng.rand(H, W, 3) * 255).astype(np.uint8))
        _write_kitti_png(root / "training" / "flow_occ" / f"00000{k}_10.png",
                         (rng.rand(H, W, 2) * 20 - 10).astype(np.float32),
                         (rng.rand(H, W) > 0.3).astype(np.float32))


def _hd1k(root, rng):
    (root / "hd1k_input" / "image_2").mkdir(parents=True)
    (root / "hd1k_flow_gt" / "flow_occ").mkdir(parents=True)
    for seq in range(2):
        for fr in range(3):
            imageio.imwrite(root / "hd1k_input" / "image_2" / ("%06d_%04d.png" % (seq, fr)),
                            (rng.rand(H, W) * 255).astype(np.uint8))
            _write_kitti_png(root / "hd1k_flow_gt" / "flow_occ" / ("%06d_%04d.png" % (seq, fr)),
                             rng.rand(H, W, 2).astype(np.float32), np.ones((H, W), np.float32))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    base = tmp_path_factory.mktemp("flow")
    rng = np.random.RandomState(0)
    out = {}
    for name, make in (("chairs", _chairs), ("sintel", _sintel), ("kitti", _kitti),
                       ("hd1k", _hd1k)):
        out[name] = base / name
        out[name].mkdir()
        make(out[name], rng)
    out["things"] = base / "things"
    out["things"].mkdir()
    _make_things_tree(out["things"], rng, H=H, W=W)
    return {k: str(v) for k, v in out.items()}


def test_flying_chairs(roots):
    ours = td.FlyingChairs(roots["chairs"], augmentor=td.FlowAugmentor((24, 32), seed=3))
    ref = jd.FlyingChairs(roots["chairs"], augmentor=jd.FlowAugmentor((24, 32), seed=3))
    assert ours.image_list == ref.image_list and ours.flow_list == ref.flow_list
    _assert_samples_equal(ours, ref)
    _assert_samples_equal(td.FlyingChairs(roots["chairs"]), jd.FlyingChairs(roots["chairs"]))


@pytest.mark.parametrize("dstype", ["clean", "final"])
def test_mpi_sintel(roots, dstype):
    ours, ref = td.MpiSintelFlow(roots["sintel"], dstype), jd.MpiSintelFlow(roots["sintel"], dstype)
    assert len(ours) == 4 and ours.image_list == ref.image_list
    _assert_samples_equal(ours, ref)


def test_kitti_and_hd1k_are_sparse(roots):
    for ours, ref in ((td.KITTIFlow(roots["kitti"]), jd.KITTIFlow(roots["kitti"])),
                      (td.HD1KFlow(roots["hd1k"]), jd.HD1KFlow(roots["hd1k"]))):
        assert ours.sparse and ours.flow_list == ref.flow_list
        _assert_samples_equal(ours, ref)
    _, _, _, valid = td.KITTIFlow(roots["kitti"])[0]
    assert 0 < valid.mean() < 1
    img1, _, _, _ = td.HD1KFlow(roots["hd1k"])[0]
    assert img1.shape == (H, W, 3)  # grayscale frames repeated to 3 channels


@pytest.mark.parametrize("dstype", ["frames_cleanpass", "frames_finalpass"])
def test_flying_things(roots, dstype):
    ours, ref = td.FlyingThings3D(roots["things"], dstype), jd.FlyingThings3D(roots["things"], dstype)
    assert len(ours) == 4 and ours.image_list == ref.image_list
    _assert_samples_equal(ours, ref)


def test_composition(roots):
    clean = td.FlyingThings3D(roots["things"])
    both = 2 * clean + td.FlyingThings3D(roots["things"], "frames_finalpass")
    assert isinstance(both, td.ConcatFlowDataset) and len(both) == 12
    ref = 2 * jd.FlyingThings3D(roots["things"]) + jd.FlyingThings3D(roots["things"],
                                                                     "frames_finalpass")
    _assert_samples_equal(both, ref)
    np.testing.assert_array_equal(both[-1][2], ref[11][2])
    with pytest.raises(IndexError):
        both[12]


@pytest.mark.parametrize("stage,train_ds,n", [("chairs", "C+T+K+S+H", 3), ("things", "", 8),
                                              ("sintel", "C+T+K+S+H", 100 * 8 + 2 * 200 + 5 * 4 + 4),
                                              ("sintel", "C+T+S", 100 * 8 + 4),
                                              ("kitti", "", 2)])
def test_fetch_flow_datasets(roots, stage, train_ds, n):
    ours = td.fetch_flow_datasets(stage, roots, crop_size=(24, 32), train_ds=train_ds, seed=5)
    ref = jd.fetch_flow_datasets(stage, roots, crop_size=(24, 32), train_ds=train_ds, seed=5)
    assert len(ours) == len(ref) == n
    for i in sorted({0, 1, len(ref) // 2, len(ref) - 1}):
        for a, b in zip(ours[i], ref[i]):
            np.testing.assert_array_equal(a, b)


def test_fetch_flow_datasets_rejects_an_unknown_stage(roots):
    with pytest.raises(ValueError, match="unknown stage"):
        td.fetch_flow_datasets("hd1k", roots)
