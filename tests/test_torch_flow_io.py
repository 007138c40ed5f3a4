"""vst_torch.flow.io against vst.flow.io on files the tests write: ``.flo``
byte for byte and equal after reading, PFM in both its colour ('PF') and
greyscale ('Pf') forms and both byte orders, KITTI's 16-bit PNG (written
with cv2, as RAFT's ``writeFlowKITTI`` does) read equal. Host numpy on both
sides, so every comparison is exact."""

import numpy as np
import pytest

from vst.flow import io as jio
from vst_torch.flow import io as tio


def test_flo_round_trip_matches_vst(tmp_path):
    flow = (np.random.RandomState(0).randn(7, 11, 2) * 5).astype(np.float32)
    tio.write_flo(str(tmp_path / "p.flo"), flow)
    jio.write_flo(str(tmp_path / "v.flo"), flow)
    assert (tmp_path / "p.flo").read_bytes() == (tmp_path / "v.flo").read_bytes()
    for path in ("p.flo", "v.flo"):
        got = tio.read_flo(str(tmp_path / path))
        assert got.dtype == np.float32 and got.shape == (7, 11, 2)
        np.testing.assert_array_equal(got, jio.read_flo(str(tmp_path / path)))
        np.testing.assert_array_equal(got, flow)
    np.testing.assert_array_equal(tio.read_flow(str(tmp_path / "p.flo")), flow)


def test_bad_flo_and_unknown_formats_raise(tmp_path):
    (tmp_path / "bad.flo").write_bytes(np.asarray([1.0, 2, 3], np.float32).tobytes())
    with pytest.raises(ValueError, match="magic"):
        tio.read_flo(str(tmp_path / "bad.flo"))
    with pytest.raises(ValueError, match="unsupported"):
        tio.read_flow(str(tmp_path / "x.png"))


def _write_pfm(path, arr, little_endian):
    h, w = arr.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if arr.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n" if little_endian else b"1.0\n")
        np.flipud(arr.astype("<f4" if little_endian else ">f4")).tofile(f)


@pytest.mark.parametrize("shape", [(5, 9, 3), (5, 9)], ids=["PF", "Pf"])
@pytest.mark.parametrize("little_endian", [True, False], ids=["le", "be"])
def test_pfm_matches_vst(tmp_path, shape, little_endian):
    arr = np.random.RandomState(1).randn(*shape).astype(np.float32)
    path = str(tmp_path / "f.pfm")
    _write_pfm(path, arr, little_endian)
    got = tio.read_pfm(path)
    np.testing.assert_array_equal(got, jio.read_pfm(path))
    np.testing.assert_array_equal(got, arr)


def test_kitti_png_matches_vst(tmp_path):
    import cv2

    rng = np.random.RandomState(2)
    flow = (rng.rand(6, 10, 2) * 40 - 20).round(2).astype(np.float32)
    valid = (rng.rand(6, 10) > 0.3)
    raw = np.zeros((6, 10, 3), np.uint16)
    raw[..., :2] = (flow * 64.0 + 2 ** 15).astype(np.uint16)
    raw[..., 2] = valid
    path = str(tmp_path / "000000_10.png")
    cv2.imwrite(path, raw[..., ::-1])
    got = tio.read_kitti_png(path)
    np.testing.assert_array_equal(got, jio.read_kitti_png(path))
    np.testing.assert_allclose(got[..., :2], flow, atol=1 / 64.0)
    np.testing.assert_array_equal(got[..., 2], valid)
