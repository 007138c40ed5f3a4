"""Face alignment, port of ``vst/models/align.py`` (the reference's
FaceAligner / ``align_faces``, ``StarGANv2Adv/core/wing.py:280-436``).

The geometry is host-side numpy and cv2, the port's own copy of vst's, so it
gives vst's numbers; only the FAN's landmarks run on the device, through
``vst_torch.models.wing``. The CelebA mean-landmark template
(``celeba_lm_mean.npz``) is a downloaded asset of the reference; any (98, 2)
template serves, and :func:`synthetic_reference_landmarks` is a
deterministic stand-in.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from vst_torch.models.wing import FAN, get_heatmap


# -- landmarks from heatmaps (wing.py:27-46) --------------------------------

def get_preds_from_heatmaps(hm: np.ndarray) -> np.ndarray:
    """(B, K, H, W) heatmaps → (B, K, 2) sub-pixel landmarks, as
    ``get_preds_fromhm``: the argmax (the first of tied maxima), a ±0.25 px
    nudge by the sign of the neighbours' difference, −0.5."""
    B, K, H, W = hm.shape
    flat = hm.reshape(B, K, H * W)
    idx = flat.argmax(axis=2)
    px = (idx % W).astype(np.float32)
    py = (idx // W).astype(np.float32)
    preds = np.stack([px + 1.0, py + 1.0], axis=-1)  # 1-based like torch
    for i in range(B):
        for j in range(K):
            x0, y0 = int(px[i, j]), int(py[i, j])
            if 0 < x0 < W - 1 and 0 < y0 < H - 1:
                d = np.array([hm[i, j, y0, x0 + 1] - hm[i, j, y0, x0 - 1],
                              hm[i, j, y0 + 1, x0] - hm[i, j, y0 - 1, x0]])
                preds[i, j] += np.sign(d) * 0.25
    return preds - 0.5


def fan_landmarks(fan: FAN, x: torch.Tensor) -> np.ndarray:
    """x: (B, 3, H, W) in [−1, 1] on the FAN's device → (B, 98, 2)
    landmarks at the input's scale (the 64² heatmaps' × H // 64)."""
    hm = get_heatmap(fan, x, preprocess=False).float().cpu().numpy()
    return get_preds_from_heatmaps(hm) * (x.shape[2] // hm.shape[2])


# -- alignment geometry (wing.py:325-436) -----------------------------------

def points2T(points: np.ndarray, direction: str) -> np.ndarray:
    T = np.eye(3)
    coef = -1.0 if direction == "from" else 1.0
    T[:2, 2] = coef * points.mean(axis=0)
    return T


def landmarks2eyes(lm: np.ndarray):
    idx_l = np.array(list(range(60, 68)) + [96])
    idx_r = np.array(list(range(68, 76)) + [97])
    return lm[idx_l].mean(axis=0), lm[idx_r].mean(axis=0)


def landmarks2mouthends(lm: np.ndarray):
    return lm[76], lm[82]


def _rotate90(v):
    return np.array([v[1], -v[0]])


def landmarks2xaxis(lm: np.ndarray) -> np.ndarray:
    eye_l, eye_r = landmarks2eyes(lm)
    mouth_l, mouth_r = landmarks2mouthends(lm)
    xp = eye_r - eye_l
    yp = (eye_l + eye_r) * 0.5 - (mouth_l + mouth_r) * 0.5
    xaxis = xp - _rotate90(yp)
    return xaxis / np.linalg.norm(xaxis)


def vecs2R(vx: np.ndarray, vy: np.ndarray) -> np.ndarray:
    vx = vx / np.linalg.norm(vx)
    vy = vy / np.linalg.norm(vy)
    c = float(np.dot(vx, vy))
    s = float(np.sqrt(max(1 - c * c, 0.0)) * np.sign(vx[0] * vy[1] - vx[1] * vy[0]))
    return np.array(((c, -s, 0.0), (s, c, 0.0), (0.0, 0.0, 1.0)))


def landmarks2S(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    xv = x - x.mean(axis=0)
    yv = y - y.mean(axis=0)
    xn = np.linalg.norm(xv, axis=1)
    yn = np.linalg.norm(yv, axis=1)
    idx = [96, 97, 76, 82]  # eyes + lip ends
    scale = float((yn / np.maximum(xn, 1e-9))[idx].mean())
    S = np.eye(3)
    S[0, 0] = S[1, 1] = scale
    return S


def landmarks2mat(lm: np.ndarray, ref: np.ndarray,
                  xaxis_ref: Optional[np.ndarray] = None) -> np.ndarray:
    """The similarity transform onto the template: T_ref · S · R · T_origin."""
    if xaxis_ref is None:
        xaxis_ref = landmarks2xaxis(ref)
    T_o = points2T(lm, "from")
    R = vecs2R(landmarks2xaxis(lm), xaxis_ref)
    S = landmarks2S(lm, ref)
    T_r = points2T(ref, "to")
    return T_r @ S @ R @ T_o


def pad_mirror(img: np.ndarray, landmarks: np.ndarray):
    """Reflect-pad by half a side and blend into a blurred border
    (``wing.py:395-410``); img (H, W, 3) uint8, landmarks at its scale."""
    import cv2

    H, W, _ = img.shape
    img = np.pad(img, ((H // 2, H // 2), (W // 2, W // 2), (0, 0)), "reflect")
    small = cv2.resize(img, (W, H)).astype(np.float32)
    k = max((H // 100) * 2 + 1, 3)
    small_blurred = cv2.GaussianBlur(small / 255.0, (k, k), H // 100)
    blurred = cv2.resize(small_blurred, (W * 2, H * 2)) * 255.0

    H2, W2, _ = img.shape
    ys, xs = np.meshgrid(np.arange(H2), np.arange(W2), indexing="ij")
    wy = np.clip(ys / (H2 // 4), 0, 1)
    wx = np.clip(xs / (H2 // 4), 0, 1)
    wy = np.minimum(wy, np.flip(wy, axis=0))
    wx = np.minimum(wx, np.flip(wx, axis=1))
    weight = np.minimum(wy, wx)[..., None] ** 4
    out = img * weight + blurred * (1 - weight)
    return out, landmarks + np.array([W // 2, H // 2])


def synthetic_reference_landmarks(size: int = 256) -> np.ndarray:
    """A deterministic (98, 2) WFLW-layout template in place of the CelebA
    mean: a frontal face, eyes at 0.38 / 0.62 of the width, the mouth at
    0.72 of the height."""
    lm = np.zeros((98, 2), np.float32)
    s = float(size)
    t = np.linspace(np.pi * 0.15, np.pi * 0.85, 33)  # contour 0..32: an ellipse
    lm[0:33, 0] = s * (0.5 - 0.38 * np.cos(t))
    lm[0:33, 1] = s * (0.45 + 0.42 * np.sin(t))
    lm[33:60] = s * 0.5  # brows + nose cluster (unused by the geometry)
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)  # eye rings 60..75, centres 96, 97
    lm[60:68, 0] = s * (0.38 + 0.05 * np.cos(ang))
    lm[60:68, 1] = s * (0.45 + 0.03 * np.sin(ang))
    lm[96] = [s * 0.38, s * 0.45]
    lm[68:76, 0] = s * (0.62 + 0.05 * np.cos(ang))
    lm[68:76, 1] = s * (0.45 + 0.03 * np.sin(ang))
    lm[97] = [s * 0.62, s * 0.45]
    ang2 = np.linspace(0, 2 * np.pi, 20, endpoint=False)  # mouth 76..95, ends 76 / 82
    lm[76:96, 0] = s * (0.5 + 0.12 * np.cos(ang2))
    lm[76:96, 1] = s * (0.72 + 0.05 * np.sin(ang2))
    lm[76] = [s * 0.38, s * 0.72]
    lm[82] = [s * 0.62, s * 0.72]
    return lm


class FaceAligner:
    """FAN landmarks → the similarity transform onto the template → a
    LANCZOS warp, cropped to ``output_size``. ``ref_landmarks``: the CelebA
    mean template ((98, 2) at 256 scale) or None for the synthetic one."""

    def __init__(self, fan: FAN, output_size: int = 256,
                 ref_landmarks: Optional[np.ndarray] = None):
        self.fan = fan
        scale = output_size // 256
        ref = (ref_landmarks if ref_landmarks is not None
               else synthetic_reference_landmarks(256))
        self.ref = ref.astype(np.float32) * max(scale, 1)
        self.xaxis_ref = landmarks2xaxis(self.ref)
        self.output_size = output_size

    def align(self, imgs: torch.Tensor) -> np.ndarray:
        """imgs: (B, 3, H, W) in [−1, 1] on the FAN's device, H = W =
        ``output_size`` → the aligned batch, (B, H, W, 3) float32 numpy in
        [−1, 1]. The warp runs on float32 and is clipped to uint8's range,
        as vst's."""
        import cv2

        lms = fan_landmarks(self.fan, imgs)
        nhwc = imgs.float().permute(0, 2, 3, 1).cpu().numpy()
        out = np.array(nhwc)
        for i in range(nhwc.shape[0]):
            img_np = ((nhwc[i] * 0.5 + 0.5) * 255).astype(np.uint8)
            padded, lm = pad_mirror(img_np, lms[i].copy())
            M = landmarks2mat(lm, self.ref, self.xaxis_ref)
            rows = max(padded.shape[0], self.output_size)
            cols = max(padded.shape[1], self.output_size)
            warped = cv2.warpPerspective(padded.astype(np.float32), M, (cols, rows),
                                         flags=cv2.INTER_LANCZOS4)
            crop = np.clip(warped[:self.output_size, :self.output_size], 0.0, 255.0)
            out[i] = crop / 255.0 * 2.0 - 1.0
        return out
