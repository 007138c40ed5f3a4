"""vst_torch.data.sintel.SintelDataset against vst's on vst's own test tree
(``tests/test_data_eval_utils.py:73``, extended with ragged frames, real
occlusion masks and long-term ``.npy`` files): the same reverse order, the
zero flow and mask at index 0, the inverted occlusion masks and the
long-term tuples, empty near both ends. Frames and masks are read through
PIL where vst uses imageio: equal for PNGs, so every comparison is exact."""

import os

import imageio.v2 as imageio
import numpy as np

from vst.data.sintel import SintelDataset as JSintel
from vst.flow.io import write_flo
from vst_torch.data.sintel import SintelDataset

H, W, T = 16, 24, 8
VID = "alley_1"


def _tree(root):
    rng = np.random.RandomState(0)
    for sub in ("final", "flow", "occlusions", "lt/" + VID):
        os.makedirs(root / sub / VID if sub != "lt/" + VID else root / sub)
    for t in range(T):
        imageio.imwrite(str(root / "final" / VID / f"frame_{t:04d}.png"),
                        (rng.rand(H, W, 3) * 255).astype(np.uint8))
    for t in range(T - 1):
        write_flo(str(root / "flow" / VID / f"frame_{t:04d}.flo"),
                  rng.randn(H, W, 2).astype(np.float32))
        imageio.imwrite(str(root / "occlusions" / VID / f"frame_{t:04d}.png"),
                        ((rng.rand(H, W) > 0.7) * 255).astype(np.uint8))
    for t in range(5, T):  # what precompute_lt_flow writes
        np.save(str(root / "lt" / VID / f"frame_{t:04d}.npy"),
                rng.rand(1, H, W, 3).astype(np.float32))


def test_sintel_dataset_matches_vst(tmp_path):
    _tree(tmp_path)
    for lt in (None, str(tmp_path / "lt")):
        ours = SintelDataset(str(tmp_path), VID, lt_path=lt)
        ref = JSintel(str(tmp_path), VID, lt_path=lt)
        assert len(ours) == len(ref) == T
        assert ours.frames_list == ref.frames_list == sorted(ref.frames_list, reverse=True)
        n_lt = 0
        for i in range(T):
            (f, m, fl, (lf, lm)), (jf, jm, jfl, (jlf, jlm)) = ours[i], ref[i]
            for a, b in ((f, jf), (m, jm), (fl, jfl)):
                assert a.dtype == np.float32
                np.testing.assert_array_equal(a, b)
            assert (lf is None) == (jlf is None) and (lm is None) == (jlm is None)
            if lf is not None:
                n_lt += 1
                np.testing.assert_array_equal(lf, jlf)
                np.testing.assert_array_equal(lm, jlm)
        assert n_lt == (2 if lt else 0)  # indices 5 and 6: none at 0–4 nor at the last


def test_index_zero_is_the_last_frame_with_zero_flow(tmp_path):
    _tree(tmp_path)
    f0, m0, fl0, (lf, lm) = SintelDataset(str(tmp_path), VID)[0]
    want = imageio.imread(str(tmp_path / "final" / VID / f"frame_{T - 1:04d}.png")) / 255.0
    np.testing.assert_allclose(f0, want, rtol=0, atol=1e-7)
    assert fl0.max() == fl0.min() == 0 and m0.max() == 0 and lf is None and lm is None
    _, m1, _, _ = SintelDataset(str(tmp_path), VID)[1]
    occ = imageio.imread(str(tmp_path / "occlusions" / VID / f"frame_{T - 2:04d}.png")) / 255.0
    np.testing.assert_array_equal(m1[..., 0], 1.0 - occ.astype(np.float32))
