"""Flow file I/O on the host (numpy), port of ``vst/flow/io.py``
(``utils/flowlib.py``, RAFT's ``frame_utils.py``).

``.flo`` (Middlebury): the float32 magic 202021.25 ("PIEH"), int32 width,
int32 height, then H·W·2 float32 (u, v) interleaved (``flowlib.py:33-55``).
PFM is FlyingThings3D's flow storage, KITTI's 16-bit PNG the sparse flow of
KITTI and HD1K; the PNG is read through cv2, imported inside the reader.
"""

from __future__ import annotations

import numpy as np

_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Returns (H, W, 2) float32 flow."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size == 0 or magic[0] != np.float32(_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    """flow: (H, W, 2), written as float32."""
    h, w = flow.shape[:2]
    with open(path, "wb") as f:
        np.asarray([_MAGIC], np.float32).tofile(f)
        np.asarray([w, h], np.int32).tofile(f)
        flow.astype(np.float32).tofile(f)


def read_flow(path: str) -> np.ndarray:
    """``flowlib.read`` (:13-21): ``.flo`` only, as vst's; PFM and KITTI PNG
    have their own readers."""
    if path.endswith(".flo"):
        return read_flo(path)
    raise ValueError(f"unsupported flow format: {path}")


def read_pfm(path: str) -> np.ndarray:
    """PFM (``frame_utils.py`` readPFM): 'PF' (H, W, 3) or 'Pf' (H, W),
    rows stored bottom to top, the scale's sign giving the byte order."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header not in (b"PF", b"Pf"):
            raise ValueError("not a PFM file")
        color = header == b"PF"
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (h, w, 3) if color else (h, w)
    return np.flipud(data.reshape(shape))


def read_kitti_png(path: str) -> np.ndarray:
    """KITTI 16-bit PNG flow (``frame_utils.py`` readFlowKITTI): (H, W, 3)
    float32 = (u, v, valid), flow = (png[..., :2] − 2¹⁵) / 64."""
    import cv2

    raw = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_COLOR)
    if raw is None:
        raise FileNotFoundError(path)
    raw = raw[:, :, ::-1].astype(np.float32)  # BGR → RGB channel order
    flow = (raw[:, :, :2] - 2 ** 15) / 64.0
    return np.concatenate([flow, raw[:, :, 2:3]], axis=-1)
