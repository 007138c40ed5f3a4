"""Dataset generation: the pseudo-paired styled corpus, the FC2 training
files and the long-term flow, port of ``vst/data/datagen.py``.

* :func:`generate_styled_dataset`: the Gatys batch styler
  (``datasets/generation/datagen.py:150-321``): per style image, OBST
  stylizes every content crop, a batch at a time on the device, over the
  pyramid; writes ``out_dir/style{k}/<name>.jpg`` with the content itself as
  ``style0`` and style 3 made grayscale (:131-148, :313-316).
* :func:`generate_fc2_corpus`: the whole corpus the trainers read
  (``DATAFiles/``, ``styled-files/``, ``styled-files3/``), from shape scenes
  under affine motion, styled by OBST or by :func:`procedural_stylize`.
* :func:`precompute_lt_flow`: the Sintel5 / FC5 long-term flow
  (``flyingchairs2-generation.py:150-220``) from a RAFT callable: per frame
  t ≥ offset, the backward flow t → t − offset and its fb-consistency mask,
  packed (1, H, W, 3).
* :func:`pack_fc2_npy`: the FC2 training tuples (img1 ⊕ img2 ⊕ mask ⊕ flow,
  ``methods/learning-based/datasets.py:52-54``) from the affine-motion
  synthesizer.

Images are written through PIL at quality 75, the quality imageio's Pillow
writer uses, so a JPEG's bytes are vst's for the same pixels (the port does
not require imageio). Host arrays are NHWC [0, 1], as vst's; OBST and RAFT
run NCHW on ``device``.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from vst_torch.data.fc2 import to_grayscale3
from vst_torch.data.synthetic import MARGIN, AffineMotionGenerator, _scene, synthetic_batch

JPEG_QUALITY = 75  # imageio's Pillow writer's default, which vst writes with


def save_image(path: str, img01: np.ndarray) -> None:
    """vst's ``save``: NaN (which L-BFGS can leave in a pixel) → 0.5, clip to
    [0, 1], ×255 truncated to uint8; JPEG at :data:`JPEG_QUALITY`."""
    from PIL import Image

    img01 = np.nan_to_num(img01, nan=0.5)
    Image.fromarray((np.clip(img01, 0, 1) * 255).astype(np.uint8)).save(
        path, quality=JPEG_QUALITY)


def _nchw(batch: np.ndarray, device) -> torch.Tensor:
    """(B, H, W, 3) host array → (B, 3, H, W) on ``device``, its dtype kept."""
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device).permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.permute(0, 2, 3, 1).cpu().numpy()


def _stylize_batch(obst, batch: torch.Tensor, pyr_shapes, weight_tcl: float) -> np.ndarray:
    """OBST from the content itself, mask 0: (B, 3, H, W) RGB [0, 1] on the
    OBST's device → (B, H, W, 3) host [0, 1]."""
    from vst_torch.perceptual.vgg import obst_postp, obst_prep

    x = obst_prep(batch)
    styled = obst.run(x, x, torch.zeros_like(x[:, :1]), pyr_shapes, weight_tcl=weight_tcl)
    return _nhwc(obst_postp(styled))


def generate_styled_dataset(
    content_images: Iterable,  # (name, (H, W, 3) float [0, 1]) pairs
    style_images: np.ndarray,  # (S, h, w, 3) [0, 1]
    out_dir: str,
    obst=None,
    pyr_shapes: Sequence = ((64, 64), (128, 128), (256, 256)),
    weight_tcl: float = 0.0,
    batch_size: int = 32,
    grayscale_styles: Sequence[int] = (3,),
    skip_existing: bool = True,
    device="cuda",
):
    """Writes ``out_dir/style{k}``: style0 the content resized to
    ``pyr_shapes[-1]``, style k ≥ 1 the content stylized by OBST (a
    ``vst_torch.models.gatys.OBST``; a seeded one on ``device`` if None) in
    batches of ``batch_size`` (the reference batches 32, datagen.py:222)."""
    from vst_torch.models.gatys import OBST
    from vst_torch.ops.image import resize_bilinear

    obst = obst or OBST(device=device)
    device = obst.device
    S = style_images.shape[0]
    for k in range(S + 1):
        os.makedirs(os.path.join(out_dir, f"style{k}"), exist_ok=True)
    items = list(content_images)

    def resized(img) -> torch.Tensor:
        return resize_bilinear(_nchw(img[None], device), pyr_shapes[-1], align_corners=False)

    # style0 = the content crops themselves (datagen.py:259-266)
    for name, img in items:
        p = os.path.join(out_dir, "style0", name + ".jpg")
        if not (skip_existing and os.path.exists(p)):
            save_image(p, _nhwc(resized(img))[0])

    for sid in range(S):
        obst.set_style(style_images[sid], pyr_shapes)
        for i in range(0, len(items), batch_size):
            todo = [(name, img) for name, img in items[i:i + batch_size]
                    if not (skip_existing and os.path.exists(
                        os.path.join(out_dir, f"style{sid + 1}", name + ".jpg")))]
            if not todo:
                continue
            batch = torch.cat([resized(img) for _, img in todo])
            rgb = _stylize_batch(obst, batch, pyr_shapes, weight_tcl)
            for (name, _), img01 in zip(todo, rgb):
                if (sid + 1) in grayscale_styles:
                    img01 = to_grayscale3(img01)
                save_image(os.path.join(out_dir, f"style{sid + 1}", name + ".jpg"), img01)


@torch.no_grad()
def precompute_lt_flow(
    frames: np.ndarray,  # (N, H, W, 3) float32 [0, 1]
    raft_apply: Callable,
    out_dir: Optional[str] = None,
    offset: int = 5,
    device="cuda",
):
    """Long-term backward flow t → t − ``offset`` and its fb-consistency
    mask, per frame t ≥ ``offset``. ``raft_apply(a, b)`` takes (1, 3, H, W)
    frames as given here, padded with ``InputPadder`` to multiples of 8, and
    returns (flow_low, flow_up) NCHW, as ``RAFT.forward``. Returns the list
    of (1, H, W, 3) float32 arrays (flow u, flow v, mask) and, with
    ``out_dir``, writes each as ``frame_{t:04d}.npy``."""
    from vst_torch.ops.flowtools import fbc_mask
    from vst_torch.ops.image import InputPadder

    def flow(i1, i2):
        padder = InputPadder(i1.shape)
        _, up = raft_apply(*padder.pad(i1, i2))
        return padder.unpad(up)

    out = []
    for t in range(offset, frames.shape[0]):
        cur = _nchw(frames[t][None], device)
        past = _nchw(frames[t - offset][None], device)
        bf = flow(cur, past)
        ff = flow(past, cur)
        packed = _nhwc(torch.cat([bf, fbc_mask(ff, bf)], 1)).astype(np.float32)
        out.append(packed)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            np.save(os.path.join(out_dir, f"frame_{t:04d}.npy"), packed)
    return out


def procedural_stylize(img: np.ndarray, sid: int) -> np.ndarray:
    """Deterministic per-domain appearance transforms, the stand-in for the
    Gatys styler where no pretrained VGG weights exist (the reference styles
    its corpus with ``Models/vgg_conv.pth``, not in the repository):

    * style1: a warm channel mix and a gamma lift;
    * style2: a cool channel mix and 6-level posterization;
    * style3: grayscale, the reference's style-3 post-process
      (datagen.py:131-148);
    * further domains rotate through the style-1 / 2 mixes with more gamma.

    Pixelwise, so both frames of a pair keep their analytic flow and mask.
    img (H, W, 3) float [0, 1]."""
    if sid == 0:
        return img
    if sid == 3:
        return to_grayscale3(img)
    if sid == 1:
        m = np.array([[0.85, 0.25, 0.05], [0.10, 0.75, 0.10], [0.05, 0.15, 0.55]], np.float32)
        out = np.einsum("...c,cd->...d", img, m.T)
        return np.clip(out ** 0.8, 0.0, 1.0)
    if sid == 2:
        m = np.array([[0.55, 0.15, 0.05], [0.10, 0.75, 0.25], [0.05, 0.25, 0.85]], np.float32)
        out = np.clip(np.einsum("...c,cd->...d", img, m.T), 0.0, 1.0)
        return np.round(out * 5.0) / 5.0
    return np.clip(procedural_stylize(img, 1 + sid % 2) ** 1.1, 0.0, 1.0)


def generate_fc2_corpus(
    out_root: str,
    n_samples: int,
    hw=(256, 256),
    style_dir: Optional[str] = None,
    iters: Sequence[int] = (30, 25, 20),
    batch_size: int = 16,
    seed: int = 0,
    grayscale_styles: Sequence[int] = (3,),
    skip_existing: bool = True,
    styler: str = "gatys",
    device="cuda",
):
    """The complete pseudo-paired FC2 corpus that ``DatasetFC2``,
    ``CycleGANFC2Dataset`` and ``DeviceStyledCache`` read (the reference's
    ``core/data_loader.py:232-250`` layout):

    * ``DATAFiles/<name>.npy``: (1, H, W, 9) img1 ⊕ img2 ⊕ mask ⊕ backward flow;
    * ``styled-files/style{k}/<name>.jpg``: frame 1 in domain k;
    * ``styled-files3/style{k}/<name>_2.jpg``: frame 2 in domain k.

    Content: ``_scene`` images under affine motion (analytic flow and mask);
    style0 the content, style k ≥ 1 OBST-stylized (``styler="gatys"``, both
    frames in batches of ``batch_size`` on ``device``, the tail batch padded
    to ``batch_size`` with its first image, as vst's) or
    :func:`procedural_stylize`'d (``styler="procedural"``); style 3 made
    grayscale like the reference's."""
    from vst_torch.data.styles import load_style_images

    data_dir = os.path.join(out_root, "DATAFiles")
    sdir = os.path.join(out_root, "styled-files")
    tdir = os.path.join(out_root, "styled-files3")
    styles = load_style_images(style_dir, size=256)
    n_styles = styles.shape[0]
    os.makedirs(data_dir, exist_ok=True)
    for k in range(n_styles + 1):
        os.makedirs(os.path.join(sdir, f"style{k}"), exist_ok=True)
        os.makedirs(os.path.join(tdir, f"style{k}"), exist_ok=True)

    def todo(path):
        return not (skip_existing and os.path.exists(path))

    # content frames with their analytic flow and mask
    rng = np.random.RandomState(seed)
    gen = AffineMotionGenerator(crop_hw=hw, seed=seed + 1)
    big = (hw[0] + MARGIN, hw[1] + MARGIN)
    names, f1s, f2s = [], [], []
    for i in range(n_samples):
        name = f"{i:07d}"
        names.append(name)
        frames, flows, masks = gen.generate(_scene(rng, big), n_frames=2)
        f1s.append(frames[0])
        f2s.append(frames[1])
        npy = os.path.join(data_dir, name + ".npy")
        if todo(npy):
            np.save(npy, np.concatenate([frames[0], frames[1], masks[0], flows[0]],
                                        axis=-1)[None].astype(np.float32))
        for path, frame in ((os.path.join(sdir, "style0", name + ".jpg"), frames[0]),
                            (os.path.join(tdir, "style0", name + "_2.jpg"), frames[1])):
            if todo(path):
                save_image(path, frame)

    if styler == "procedural":
        for sid in range(1, n_styles + 1):
            n_done = 0
            for name, f1, f2 in zip(names, f1s, f2s):
                p1 = os.path.join(sdir, f"style{sid}", name + ".jpg")
                p2 = os.path.join(tdir, f"style{sid}", name + "_2.jpg")
                if todo(p1):
                    save_image(p1, procedural_stylize(f1, sid))
                    n_done += 1
                if todo(p2):
                    save_image(p2, procedural_stylize(f2, sid))
            print(f"corpus: style{sid} done procedurally ({n_done} images)", flush=True)
        return

    from vst_torch.models.gatys import OBST

    pyr = ((hw[0] // 4, hw[1] // 4), (hw[0] // 2, hw[1] // 2), tuple(hw))
    obst = OBST(max_iters=tuple(iters), device=device)
    for sid in range(n_styles):
        obst.set_style(styles[sid], pyr)
        jobs = []  # (out path, content) over both frames
        for name, f1, f2 in zip(names, f1s, f2s):
            jobs.append((os.path.join(sdir, f"style{sid + 1}", name + ".jpg"), f1))
            jobs.append((os.path.join(tdir, f"style{sid + 1}", name + "_2.jpg"), f2))
        jobs = [(p, img) for p, img in jobs if todo(p)]
        for i in range(0, len(jobs), batch_size):
            chunk = jobs[i:i + batch_size]
            batch = np.stack([img for _, img in chunk])
            if batch.shape[0] < batch_size:  # pad the tail, as vst's (one program shape)
                batch = np.concatenate(
                    [batch, batch[:1].repeat(batch_size - batch.shape[0], 0)], 0)
            rgb = _stylize_batch(obst, _nchw(batch, obst.device), pyr, 0.0)
            for (path, _), img01 in zip(chunk, rgb):
                if (sid + 1) in grayscale_styles:
                    img01 = to_grayscale3(img01)
                save_image(path, img01)
        print(f"corpus: style{sid + 1} done ({len(jobs)} images)", flush=True)


def pack_fc2_npy(out_dir: str, n_samples: int, hw=(256, 256), seed: int = 0) -> None:
    """FC2-format files ((1, H, W, 9) float32: img1 ⊕ img2 ⊕ mask ⊕ backward
    flow, what ``NpyDirDataset`` reads) from the affine-motion synthesizer,
    sample i drawn from seed ``seed + i``, as vst's."""
    os.makedirs(out_dir, exist_ok=True)
    for i in range(n_samples):
        b = synthetic_batch(1, hw=hw, n_frames=2, seed=seed + i)
        packed = np.concatenate(
            [b["imgs"][0, 0], b["imgs"][0, 1], b["masks"][0, 0], b["flows"][0, 0]], axis=-1)
        np.save(os.path.join(out_dir, f"{i:07d}.npy"), packed[None].astype(np.float32))
