"""RAFT's training data and loss, port of ``vst/flow/datasets.py`` (the
vendored ``utils/raft/raft/datasets.py``, ``utils/augmentor.py``,
``frame_utils.py``, and ``train.py``'s sequence loss).

The datasets and the augmentor are host numpy, as vst's: samples are
(img1, img2, flow, valid), images (H, W, 3) float32 in [0, 255], flow
(H, W, 2), valid (H, W). The augmentor draws from its own
``np.random.RandomState(seed)`` in vst's order and resizes through cv2
(imported inside), so a seeded sample is vst's bit for bit. Images are read
through PIL where vst uses imageio (the same pixels for PNG and PPM; the port
does not require imageio). :func:`flow_sequence_loss` is torch, NCHW.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vst_torch.data.fc2 import _read_image
from vst_torch.flow.io import read_flo, read_kitti_png, read_pfm


class FlowAugmentor:
    """Photometric + spatial augmentation (augmentor.py): color jitter
    (brightness/contrast/saturation/hue-lite via channel scaling), asymmetric
    eraser, random scale, horizontal/vertical flips, random crop — flow
    vectors rescaled/flipped consistently."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: bool = True, seed: int = 0):
        self.crop_size = crop_size
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.do_flip = do_flip
        self.rng = np.random.RandomState(seed)

    def _photometric(self, img1, img2):
        # asymmetric jitter with p=0.2 (augmentor.py asymmetric_color_aug_prob)
        def jitter(img):
            b = self.rng.uniform(0.6, 1.4)
            c = self.rng.uniform(0.6, 1.4)
            s = self.rng.uniform(0.6, 1.4)
            mean = img.mean(axis=(0, 1), keepdims=True)
            gray = img.mean(axis=2, keepdims=True)
            img = (img - mean) * c + mean
            img = img * b
            img = gray + (img - gray) * s
            return np.clip(img, 0, 255)

        if self.rng.rand() < 0.2:
            return jitter(img1), jitter(img2)
        j = jitter(np.concatenate([img1, img2], axis=0))
        return j[: img1.shape[0]], j[img1.shape[0]:]

    def _eraser(self, img2, bounds=(50, 100)):
        if self.rng.rand() < 0.5:
            mean = img2.reshape(-1, 3).mean(axis=0)
            for _ in range(self.rng.randint(1, 3)):
                x0 = self.rng.randint(0, img2.shape[1])
                y0 = self.rng.randint(0, img2.shape[0])
                dx = self.rng.randint(*bounds)
                dy = self.rng.randint(*bounds)
                img2[y0:y0 + dy, x0:x0 + dx] = mean
        return img2

    def _spatial(self, img1, img2, flow):
        import cv2

        ht, wd = img1.shape[:2]
        min_scale = max((self.crop_size[0] + 8) / ht, (self.crop_size[1] + 8) / wd)
        scale = 2 ** self.rng.uniform(self.min_scale, self.max_scale)
        scale = max(scale, min_scale)
        if self.rng.rand() < 0.8:
            img1 = cv2.resize(img1, None, fx=scale, fy=scale,
                              interpolation=cv2.INTER_LINEAR)
            img2 = cv2.resize(img2, None, fx=scale, fy=scale,
                              interpolation=cv2.INTER_LINEAR)
            flow = cv2.resize(flow, None, fx=scale, fy=scale,
                              interpolation=cv2.INTER_LINEAR) * scale

        if self.do_flip:
            if self.rng.rand() < 0.5:  # h-flip
                img1 = img1[:, ::-1]
                img2 = img2[:, ::-1]
                flow = flow[:, ::-1] * [-1.0, 1.0]
            if self.rng.rand() < 0.1:  # v-flip
                img1 = img1[::-1]
                img2 = img2[::-1]
                flow = flow[::-1] * [1.0, -1.0]

        y0 = self.rng.randint(0, img1.shape[0] - self.crop_size[0] + 1)
        x0 = self.rng.randint(0, img1.shape[1] - self.crop_size[1] + 1)
        sl = np.s_[y0:y0 + self.crop_size[0], x0:x0 + self.crop_size[1]]
        return img1[sl], img2[sl], flow[sl]

    def __call__(self, img1, img2, flow):
        img1, img2 = self._photometric(img1, img2)
        img2 = self._eraser(img2.copy())
        img1, img2, flow = self._spatial(img1, img2, flow)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class FlowDataset:
    """Base: list of (img1, img2, flow) file triplets → augmented samples.

    ``sparse=True`` switches to the KITTI/HD1K convention
    (``utils/raft/raft/datasets.py:161-196``): flow stored as 16-bit PNGs
    whose third channel is the validity mask (frame_utils readFlowKITTI);
    the dense-flow magnitude gate is replaced by that mask. The augmentor is
    skipped for sparse samples — the reference's SparseFlowAugmentor resizes
    valid pixels by coordinate scatter, which vst's training recipe (dense
    FlyingChairs/Sintel) never exercises; sparse layouts ship for data
    parity and evaluation, not augmentation."""

    def __init__(self, augmentor: Optional[FlowAugmentor] = None,
                 sparse: bool = False):
        self.image_list: List[Tuple[str, str]] = []
        self.flow_list: List[str] = []
        self.augmentor = augmentor
        self.sparse = sparse

    def __len__(self):
        return len(self.image_list)

    def __rmul__(self, v: int):
        """``100 * sintel_clean`` oversampling (datasets.py:93-96)."""
        self.flow_list = v * self.flow_list
        self.image_list = v * self.image_list
        return self

    def __add__(self, other):
        """``clean + final`` mixture — dispatching concat (the reference
        rides torch's ConcatDataset), so sparse (KITTI/HD1K) and dense
        members keep their own read paths."""
        return ConcatFlowDataset([self, other])

    def __getitem__(self, idx):
        p1, p2 = self.image_list[idx]
        img1 = _read_image(p1).astype(np.float32)
        img2 = _read_image(p2).astype(np.float32)
        if img1.ndim == 2:  # HD1K grayscale inputs
            img1 = np.repeat(img1[..., None], 3, axis=-1)
            img2 = np.repeat(img2[..., None], 3, axis=-1)
        if self.sparse:
            fv = read_kitti_png(self.flow_list[idx])
            flow, valid = fv[..., :2], fv[..., 2] > 0.5
            return (img1, img2, flow.astype(np.float32),
                    valid.astype(np.float32))
        fpath = self.flow_list[idx]
        if fpath.endswith(".pfm"):  # FlyingThings3D flow storage
            flow = read_pfm(fpath)[..., :2]
        else:
            flow = read_flo(fpath)
        if self.augmentor is not None:
            img1, img2, flow = self.augmentor(img1, img2, flow)
        valid = (np.abs(flow[..., 0]) < 1000) & (np.abs(flow[..., 1]) < 1000)
        return img1, img2, flow.astype(np.float32), valid.astype(np.float32)


class ConcatFlowDataset:
    """Index-dispatching concatenation of flow datasets (the reference's
    ``a + b`` goes through torch ConcatDataset, datasets.py:199-224): each
    item is served by its member dataset, preserving per-member sparse vs
    dense read paths and augmentors."""

    def __init__(self, parts):
        self.parts: List = []
        for p in parts:
            if isinstance(p, ConcatFlowDataset):
                self.parts.extend(p.parts)
            else:
                self.parts.append(p)

    def __len__(self):
        return sum(len(p) for p in self.parts)

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        for p in self.parts:
            if idx < len(p):
                return p[idx]
            idx -= len(p)
        raise IndexError(idx)

    def __add__(self, other):
        return ConcatFlowDataset([self, other])


class FlyingChairs(FlowDataset):
    """datasets.py FlyingChairs layout: ``data/*.ppm`` pairs + ``*.flo``."""

    def __init__(self, root: str, split: str = "training",
                 augmentor: Optional[FlowAugmentor] = None):
        super().__init__(augmentor)
        images = sorted(
            [os.path.join(root, "data", f) for f in os.listdir(os.path.join(root, "data"))
             if f.endswith(".ppm")]
        )
        flows = sorted(
            [os.path.join(root, "data", f) for f in os.listdir(os.path.join(root, "data"))
             if f.endswith(".flo")]
        )
        assert len(images) // 2 == len(flows)
        for i in range(len(flows)):
            self.flow_list.append(flows[i])
            self.image_list.append((images[2 * i], images[2 * i + 1]))


class MpiSintelFlow(FlowDataset):
    """datasets.py MpiSintel layout: training/<dstype>/<scene> frames +
    training/flow/<scene>/*.flo."""

    def __init__(self, root: str, dstype: str = "clean",
                 augmentor: Optional[FlowAugmentor] = None):
        super().__init__(augmentor)
        image_root = os.path.join(root, "training", dstype)
        flow_root = os.path.join(root, "training", "flow")
        for scene in sorted(os.listdir(image_root)):
            frames = sorted(os.listdir(os.path.join(image_root, scene)))
            for i in range(len(frames) - 1):
                self.image_list.append((
                    os.path.join(image_root, scene, frames[i]),
                    os.path.join(image_root, scene, frames[i + 1]),
                ))
            for f in sorted(os.listdir(os.path.join(flow_root, scene))):
                self.flow_list.append(os.path.join(flow_root, scene, f))


class KITTIFlow(FlowDataset):
    """KITTI-2015 layout (``utils/raft/raft/datasets.py:161-177``):
    ``<split>/image_2/*_10.png`` / ``*_11.png`` pairs; training flow from
    ``<split>/flow_occ/*_10.png`` 16-bit sparse PNGs."""

    def __init__(self, root: str, split: str = "training"):
        super().__init__(sparse=True)
        base = os.path.join(root, split)
        img_dir = os.path.join(base, "image_2")
        first = sorted(f for f in os.listdir(img_dir) if f.endswith("_10.png"))
        second = sorted(f for f in os.listdir(img_dir) if f.endswith("_11.png"))
        for a, b in zip(first, second):
            self.image_list.append((os.path.join(img_dir, a),
                                    os.path.join(img_dir, b)))
        if split == "training":
            flow_dir = os.path.join(base, "flow_occ")
            self.flow_list = [os.path.join(flow_dir, f)
                              for f in sorted(os.listdir(flow_dir))
                              if f.endswith("_10.png")]


class HD1KFlow(FlowDataset):
    """HD1K layout (``utils/raft/raft/datasets.py:180-196``): per-sequence
    ``hd1k_input/image_2/%06d_*.png`` frames with
    ``hd1k_flow_gt/flow_occ/%06d_*.png`` sparse flows; consecutive-frame
    pairs within each sequence (the last frame of a sequence has no flow)."""

    def __init__(self, root: str):
        super().__init__(sparse=True)
        import glob as _glob

        seq_ix = 0
        while True:
            flows = sorted(_glob.glob(os.path.join(
                root, "hd1k_flow_gt", "flow_occ", "%06d_*.png" % seq_ix)))
            images = sorted(_glob.glob(os.path.join(
                root, "hd1k_input", "image_2", "%06d_*.png" % seq_ix)))
            if not flows:
                break
            for i in range(len(flows) - 1):
                self.flow_list.append(flows[i])
                self.image_list.append((images[i], images[i + 1]))
            seq_ix += 1


class FlyingThings3D(FlowDataset):
    """FlyingThings3D layout (``utils/raft/raft/datasets.py:137-158``):
    ``<dstype>/TRAIN/<abc>/<seq>/left`` frame dirs paired with
    ``optical_flow/TRAIN/<abc>/<seq>/{into_future,into_past}/left`` .pfm
    flows; into_future pairs (i, i+1) with flow[i], into_past pairs
    (i+1, i) with flow[i+1]. Left camera only, like the reference."""

    def __init__(self, root: str, dstype: str = "frames_cleanpass",
                 augmentor: Optional[FlowAugmentor] = None):
        super().__init__(augmentor)
        import glob as _glob

        for direction in ("into_future", "into_past"):
            image_dirs = sorted(_glob.glob(
                os.path.join(root, dstype, "TRAIN", "*", "*")))
            image_dirs = [os.path.join(f, "left") for f in image_dirs]
            flow_dirs = sorted(_glob.glob(
                os.path.join(root, "optical_flow", "TRAIN", "*", "*")))
            flow_dirs = [os.path.join(f, direction, "left")
                         for f in flow_dirs]
            for idir, fdir in zip(image_dirs, flow_dirs):
                images = sorted(_glob.glob(os.path.join(idir, "*.png")))
                flows = sorted(_glob.glob(os.path.join(fdir, "*.pfm")))
                for i in range(len(flows) - 1):
                    if direction == "into_future":
                        self.image_list.append((images[i], images[i + 1]))
                        self.flow_list.append(flows[i])
                    else:
                        self.image_list.append((images[i + 1], images[i]))
                        self.flow_list.append(flows[i + 1])


def fetch_flow_datasets(stage: str, roots: Dict[str, str],
                        crop_size: Tuple[int, int] = (368, 496),
                        train_ds: str = "C+T+K+S+H", seed: int = 0):
    """Stage → composed training dataset, mirroring the reference's
    ``fetch_dataloader`` recipes (``datasets.py:199-230``): per-stage
    augmentation scale ranges and the C+T+K+S+H mixture weights
    (100×sintel_clean + 100×sintel_final + 200×kitti + 5×hd1k + things).
    ``roots`` maps dataset name → directory ('chairs', 'things', 'sintel',
    'kitti', 'hd1k'); sparse members (KITTI/HD1K) carry no augmentor (see
    FlowDataset docstring). Iteration and batching are the caller's."""

    def aug(mn, mx, do_flip=True):
        return FlowAugmentor(crop_size, min_scale=mn, max_scale=mx,
                             do_flip=do_flip, seed=seed)

    if stage == "chairs":
        return FlyingChairs(roots["chairs"], split="training",
                            augmentor=aug(-0.1, 1.0))
    if stage == "things":
        clean = FlyingThings3D(roots["things"], dstype="frames_cleanpass",
                               augmentor=aug(-0.4, 0.8))
        final = FlyingThings3D(roots["things"], dstype="frames_finalpass",
                               augmentor=aug(-0.4, 0.8))
        return clean + final
    if stage == "sintel":
        things = FlyingThings3D(roots["things"], dstype="frames_cleanpass",
                                augmentor=aug(-0.2, 0.6))
        clean = MpiSintelFlow(roots["sintel"], dstype="clean",
                              augmentor=aug(-0.2, 0.6))
        final = MpiSintelFlow(roots["sintel"], dstype="final",
                              augmentor=aug(-0.2, 0.6))
        if train_ds == "C+T+K+S+H":
            kitti = KITTIFlow(roots["kitti"], split="training")
            hd1k = HD1KFlow(roots["hd1k"])
            return (100 * clean + 100 * final + 200 * kitti + 5 * hd1k
                    + things)
        return 100 * clean + 100 * final + things
    if stage == "kitti":
        return KITTIFlow(roots["kitti"], split="training")
    raise ValueError(f"unknown stage {stage!r}")


def flow_sequence_loss(flow_preds, flow_gt: torch.Tensor, valid: torch.Tensor,
                       gamma: float = 0.8, max_flow: float = 400.0) -> torch.Tensor:
    """RAFT's exponentially weighted sequence loss (``train.py`` upstream, in
    vst's form): Σᵢ γ^(n−i−1)·mean(v·|predᵢ − gt|₁), the L1 norm over the
    two flow channels, v = valid·(|gt| < max_flow). flow_preds: n flows
    (B, 2, H, W), e.g. ``RAFT(train_mode=True)``'s (n, B, 2, H, W); flow_gt
    (B, 2, H, W); valid (B, H, W)."""
    n = len(flow_preds)
    mag = torch.sqrt(torch.sum(flow_gt ** 2, dim=1))
    v = valid * (mag < max_flow)
    loss = 0.0
    for i, pred in enumerate(flow_preds):
        w = gamma ** (n - i - 1)
        loss = loss + w * torch.mean(v * (pred - flow_gt).abs().sum(dim=1))
    return loss
