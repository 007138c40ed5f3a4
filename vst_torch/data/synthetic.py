"""Synthetic affine-motion clips (host numpy), port of
``vst/data/synthetic.py``: ``AffineMotionGenerator`` (``generate``,
``pairwise_flows``), the ``_texture`` and ``_scene`` content images and
``synthetic_batch``.

From a still image, a clip is made by random translate-scale-rotate (TSR)
affine maps, each frame the previous one warped; the forward / backward flow
between any two frames is exact, derived from the composed matrices, so the
generator doubles as a motion oracle (``eval-sintel`` without Sintel).

vst calls OpenCV for two steps of the generator; this module computes them
in numpy, so the clips need no cv2:

- ``cv2.getRotationMatrix2D`` is a closed formula (OpenCV's documentation):
  α = s·cos θ, β = s·sin θ, centre terms (1 − α)·cx − β·cy and
  β·cx + (1 − α)·cy, in float64 with the centre in float32 (``Point2f``).
- ``cv2.warpAffine(..., INTER_LINEAR)`` with a constant 0 border samples the
  source at the inverse map of the matrix it is given, inverted in float64
  and rounded to float32. The flows and masks are analytic and so bit for bit
  vst's; the frames agree with OpenCV 5.0's float32 path to rounding
  (``tests/test_torch_synthetic.py`` states the bound).

``_scene``, the shape scenes of ``datagen-corpus``, draws OpenCV's
anti-aliased circles, rectangles and lines, as vst does: it imports cv2
inside the function.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

f32 = np.float32
MARGIN = 96  # the texture is this much larger than the crop, as vst's


def rotation_matrix_2d(center, angle_deg: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: (2, 3) float64."""
    cx, cy = (float(f32(c)) for c in center)
    angle = angle_deg * (math.pi / 180)
    alpha = math.cos(angle) * scale
    beta = math.sin(angle) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _invert_affine(m: np.ndarray) -> np.ndarray:
    """``cv2.invertAffineTransform`` in float64, OpenCV's operation order."""
    d = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22, a12, a21 = m[1, 1] * d, m[0, 0] * d, -m[0, 1] * d, -m[1, 0] * d
    return np.array([[a11, a12, -a11 * m[0, 2] - a12 * m[1, 2]],
                     [a21, a22, -a21 * m[0, 2] - a22 * m[1, 2]]])


def _fma32(a, b, c) -> np.ndarray:
    """float32 a·b + c rounded once, as a fused multiply-add: the float64
    product of two float32 values is exact."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(f32)


def warp_affine_linear(image: np.ndarray, m: np.ndarray, dsize) -> np.ndarray:
    """``cv2.warpAffine(image, m, dsize, flags=INTER_LINEAR)``, border 0, for a
    float32 (H, W, C) image: dst(x, y) = src(A·(x, y, 1)) with A = m⁻¹ in
    float32, coordinates fma(a00, x, a01·y + a02), bilinear weights from the
    coordinates' fractions, corners outside the source read as 0."""
    w, h = dsize
    a = _invert_affine(np.asarray(m, np.float64)).astype(f32)
    ys, xs = np.mgrid[0:h, 0:w].astype(f32)
    sx = _fma32(a[0, 0], xs, a[0, 1] * ys + a[0, 2])
    sy = _fma32(a[1, 0], xs, a[1, 1] * ys + a[1, 2])
    x0, y0 = np.floor(sx), np.floor(sy)
    fx, fy = (sx - x0)[..., None], (sy - y0)[..., None]
    xi, yi = x0.astype(np.int64), y0.astype(np.int64)
    sh, sw = image.shape[:2]
    flat = image.reshape(sh * sw, -1)

    def corner(dy, dx):  # whole pixels gathered by flat index, the warp's largest cost
        yy, xx = yi + dy, xi + dx
        v = np.take(flat, np.clip(yy, 0, sh - 1) * sw + np.clip(xx, 0, sw - 1), axis=0)
        v[(xx < 0) | (xx >= sw) | (yy < 0) | (yy >= sh)] = 0
        return v

    p00, p01, p10, p11 = corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)
    top = _fma32(fx, p01 - p00, p00)
    bottom = _fma32(fx, p11 - p10, p10)
    return _fma32(fy, bottom - top, top)


def _tsr_matrix(rng: np.random.RandomState, hw, pmin=-32, pmax=32) -> np.ndarray:
    """Random translate/scale/rotate 3×3 matrix (``coco-generation.py:150-172``):
    shifts and rotation in [−32, 32), scale from the same pixel range
    relative to min(h, w). Draws from ``rng`` as vst does."""
    shift_y, shift_x, rot = rng.randint(pmin, pmax, size=3)
    scal_px = rng.choice(np.arange(pmin, pmax + 2, 2))
    rows, cols = hw
    size = min(rows, cols)
    scal = (size + scal_px) / size
    t = np.float32([[1, 0, shift_x], [0, 1, shift_y], [0, 0, 1]])
    rs = rotation_matrix_2d((cols / 2, rows / 2), float(rot), float(scal))
    return np.matmul(t, np.vstack((rs, np.float32([0, 0, 1]))))


def _affine_flow(tsr: np.ndarray, hw) -> Tuple[np.ndarray, np.ndarray]:
    """Exact flows of an affine map on the full grid: forward at p,
    A⁻¹·p − p; backward, A·p − p (``coco-generation.py:209-223``, evaluated
    analytically)."""
    h, w = hw
    xs, ys = np.meshgrid(np.arange(w, dtype=f32), np.arange(h, dtype=f32))
    grid = np.stack([xs, ys, np.ones_like(xs)], axis=-1)
    inv = np.linalg.inv(tsr).astype(f32)
    fw = np.einsum("ij,hwj->hwi", inv[:2], grid) - grid[..., :2]
    bw = np.einsum("ij,hwj->hwi", tsr[:2].astype(f32), grid) - grid[..., :2]
    return fw, bw


def _fbc_mask_np(ff: np.ndarray, bf: np.ndarray) -> np.ndarray:
    """Host fb-consistency mask with ``utils/flowtools.py:34-57``'s
    thresholds, the warp sampled at the nearest pixel and 0 outside the
    frame. (H, W, 1) float32."""
    h, w, _ = bf.shape
    xs, ys = np.meshgrid(np.arange(w, dtype=f32), np.arange(h, dtype=f32))
    fx = xs + bf[..., 0]
    fy = ys + bf[..., 1]
    sx = np.clip(np.round(fx).astype(np.int64), 0, w - 1)
    sy = np.clip(np.round(fy).astype(np.int64), 0, h - 1)
    inside = ((fx >= 0) & (fx <= w - 1) & (fy >= 0) & (fy <= h - 1))[..., None]
    wf = np.where(inside, ff[sy, sx], 0.0)

    norm_wb = np.sum((wf + bf) ** 2, axis=-1)
    norm_w = np.sum(wf ** 2, axis=-1)
    norm_b = np.sum(bf ** 2, axis=-1)
    occ = norm_wb > 0.01 * (norm_w + norm_b) + 0.5

    def grad(x):
        dx = (np.pad(x, ((0, 0), (0, 1)))[:, 1:] - np.pad(x, ((0, 0), (1, 0)))[:, :-1]) / 2
        dy = (np.pad(x, ((0, 1), (0, 0)))[1:, :] - np.pad(x, ((1, 0), (0, 0)))[:-1, :]) / 2
        return dx, dy

    gux, guy = grad(bf[..., 0])
    gvx, gvy = grad(bf[..., 1])
    mob = (gux ** 2 + guy ** 2 + gvx ** 2 + gvy ** 2) > 0.01 * norm_b + 0.002
    mask = np.ones((h, w), f32)
    mask[occ | mob] = 0.0
    return mask[..., None]


class AffineMotionGenerator:
    """(frames, flows, masks) from a still image: frames (n, ch, cw, 3)
    float32 [0, 1], backward flows frame_{i+1} → frame_i (n−1, ch, cw, 2),
    masks (n−1, ch, cw, 1); frames centre-cropped to ``crop_hw``."""

    def __init__(self, crop_hw=(256, 256), seed: int = 0):
        self.crop_hw = crop_hw
        self.rng = np.random.RandomState(seed)
        self._mats: List[np.ndarray] = []
        self._full_hw = None

    def _center_crop(self, x: np.ndarray) -> np.ndarray:
        ch, cw = self.crop_hw
        h, w = x.shape[:2]
        cy, cx = h // 2, w // 2
        return x[cy - ch // 2: cy + ch - ch // 2, cx - cw // 2: cx + cw - cw // 2]

    def generate(self, image: np.ndarray, n_frames: int = 2):
        """image: (H, W, 3) float32 [0, 1], H, W ≥ crop + 2·32 margin."""
        h, w = image.shape[:2]
        frames = [self._center_crop(image)]
        flows: List[np.ndarray] = []
        masks: List[np.ndarray] = []
        cur = image
        self._mats = [np.eye(3, dtype=f32)]
        for _ in range(n_frames - 1):
            tsr = _tsr_matrix(self.rng, (h, w))
            nxt = warp_affine_linear(cur, np.linalg.inv(tsr)[:2], (w, h))
            fw, bw = _affine_flow(tsr, (h, w))
            fw_c, bw_c = self._center_crop(fw), self._center_crop(bw)
            flows.append(bw_c.astype(f32))
            masks.append(_fbc_mask_np(fw_c, bw_c))
            frames.append(self._center_crop(nxt))
            cur = nxt
            # frame_k(p) = image(T_k·p), T_k = tsr_1 @ … @ tsr_k
            self._mats.append((self._mats[-1] @ tsr).astype(f32))
        self._full_hw = (h, w)
        return np.stack(frames).astype(f32), np.stack(flows), np.stack(masks)

    def pairwise_flows(self, i: int, j: int):
        """Exact flows between frames i (earlier) and j of the last
        ``generate`` call, centre-cropped: (ff i→j, bf j→i)."""
        if not self._mats:
            raise RuntimeError("call generate() first")
        t_ij = (np.linalg.inv(self._mats[i]) @ self._mats[j]).astype(f32)
        fw, bw = _affine_flow(t_ij, self._full_hw)
        return self._center_crop(fw).astype(f32), self._center_crop(bw).astype(f32)


def _texture(rng: np.random.RandomState, hw) -> np.ndarray:
    """Deterministic colourful texture: a sum of random 2-D sinusoids."""
    h, w = hw
    ys, xs = np.meshgrid(np.arange(h, dtype=f32), np.arange(w, dtype=f32), indexing="ij")
    img = np.zeros((h, w, 3), f32)
    for _ in range(6):
        fx, fy = rng.uniform(0.01, 0.12, 2)
        phase = rng.uniform(0, 2 * np.pi, 3)
        amp = rng.uniform(0.1, 0.4, 3)
        for c in range(3):
            img[..., c] += amp[c] * np.sin(2 * np.pi * (fx * xs + fy * ys) + phase[c])
    img -= img.min()
    img /= max(img.max(), 1e-6)
    return img


def _scene(rng: np.random.RandomState, hw) -> np.ndarray:
    """Structured content image (``vst/data/synthetic.py:178-219``): a
    gradient background, 6–13 random anti-aliased shapes (circles,
    rectangles, lines) and a mild multiplicative ``_texture``; edges and
    flat regions, where ``_texture`` has neither. (H, W, 3) float32 [0, 1]."""
    import cv2

    h, w = hw
    ys, xs = np.meshgrid(np.linspace(0, 1, h, dtype=f32), np.linspace(0, 1, w, dtype=f32),
                         indexing="ij")
    c0 = rng.uniform(0.1, 0.9, 3).astype(f32)
    c1 = rng.uniform(0.1, 0.9, 3).astype(f32)
    ang = rng.uniform(0, 2 * np.pi)
    t = np.cos(ang) * xs + np.sin(ang) * ys
    t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
    canvas = np.ascontiguousarray(c0[None, None] * (1 - t[..., None]) + c1[None, None] * t[..., None])
    for _ in range(rng.randint(6, 14)):
        color = tuple(float(v) for v in rng.uniform(0.05, 0.95, 3))
        kind = rng.randint(3)
        if kind == 0:
            center = (int(rng.randint(0, w)), int(rng.randint(0, h)))
            cv2.circle(canvas, center, int(rng.randint(8, max(min(h, w) // 4, 9))),
                       color, -1, lineType=cv2.LINE_AA)
        elif kind == 1:
            x0, y0 = rng.randint(0, w), rng.randint(0, h)
            x1 = np.clip(x0 + rng.randint(10, w // 2), 0, w - 1)
            y1 = np.clip(y0 + rng.randint(10, h // 2), 0, h - 1)
            cv2.rectangle(canvas, (int(x0), int(y0)), (int(x1), int(y1)), color, -1,
                          lineType=cv2.LINE_AA)
        else:
            p0 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
            p1 = (int(rng.randint(0, w)), int(rng.randint(0, h)))
            cv2.line(canvas, p0, p1, color, int(rng.randint(2, 8)), lineType=cv2.LINE_AA)
    tex = _texture(rng, hw)
    return np.clip(canvas * (0.85 + 0.3 * tex), 0.0, 1.0).astype(f32)


def synthetic_batch(batch_size: int, hw=(256, 256), n_frames: int = 2, seed: int = 0):
    """An FC2-style training batch from procedural textures, vst's NHWC
    layout: dict(imgs (B, n, H, W, 3) in [0, 1], flows (B, n−1, H, W, 2)
    backward flows as in the FC2 files, masks (B, n−1, H, W, 1))."""
    rng = np.random.RandomState(seed)
    gen = AffineMotionGenerator(crop_hw=hw, seed=seed + 1)
    big = (hw[0] + MARGIN, hw[1] + MARGIN)
    frames, flows, masks = [], [], []
    for _ in range(batch_size):
        f, fl, m = gen.generate(_texture(rng, big), n_frames=n_frames)
        frames.append(f)
        flows.append(fl)
        masks.append(m)
    return {"imgs": np.stack(frames), "flows": np.stack(flows), "masks": np.stack(masks)}
