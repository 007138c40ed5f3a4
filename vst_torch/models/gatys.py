"""OBST — optimization-based style transfer (Gatys with a temporal warm
start), port of ``vst/models/gatys.py`` (``obst_eval.py:236-410``).

L-BFGS descends on the image itself against a caffe VGG19's Gram targets,
coarse to fine over a 3-level pyramid, with a masked temporal term in the
objective and a warm start from the warped previous stylized frame:

* style layers r21 / r31 / r41 weighted β/n² (β = 100, n ∈ {128, 256, 512}),
  content layer r42 weighted 1 (``obst_eval.py:262-274``);
* the objective adds ``weight_tcl·mean((mask·(opt − warp))²)`` (:391);
* each level bilinearly resizes the previous level's result and the
  content / warp / mask targets (align_corners=False, :359-371);
* the warm start is ``mask·warp(prev_styled, bf) + (1−mask)·img`` (:500);
* L-BFGS is ``vst_torch.ops.lbfgs`` in its compact form, at the reference
  driver's closure-call counts ([50, 40, 30] runs [60, 60, 40]).

Images are caffe-space BGR ×255 NCHW tensors (``obst_prep``). The VGG is
frozen, so autograd computes the image's gradient only. ``compute_dtype``
is float32, bfloat16 or float64: in bfloat16 the VGG's weights and the
image are cast once, and the Grams and the content term accumulate in
``acc_dtype`` (float32; float64 when everything runs double, as the parity
tests do); the L-BFGS state keeps the image's dtype.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch

from vst_torch.ops.image import resize_bilinear
from vst_torch.ops.lbfgs import lbfgs_minimize, torch_eval_counts
from vst_torch.ops.losses import gram_matrix
from vst_torch.ops.sample import warp
from vst_torch.perceptual.vgg import CaffeVGG, he_randomized_, load_features, obst_prep

STYLE_LAYERS = ("r21", "r31", "r41")
CONTENT_LAYERS = ("r42",)
STYLE_WEIGHTS = tuple(1e2 / n ** 2 for n in (128, 256, 512))
CONTENT_WEIGHTS = (1e0,)

PYR_FC2 = ((64, 64), (128, 128), (256, 256))
PYR_SINTEL = ((109, 256), (218, 512), (436, 1024))
MAX_ITERS = (50, 40, 30)


class OBST:
    """Owns the frozen VGG and the style targets.

    ``vgg_state``: the reference's ``vgg_conv.pth`` ``state_dict`` (keys
    ``conv1_1.weight`` …), or None for vst's He-randomized VGG from ``seed``
    (bit for bit vst's). Entry points run on ``device`` (CUDA by default).
    The L-BFGS history holds each level's iterations, as in vst (whose
    ``memory_size`` is stored and never read)."""

    def __init__(self, vgg_state: Optional[Dict[str, torch.Tensor]] = None,
                 max_iters: Sequence[int] = MAX_ITERS, seed: int = 0,
                 compute_dtype: torch.dtype = torch.float32, device="cuda"):
        vgg = CaffeVGG(pool="max")
        if vgg_state is None:
            he_randomized_(vgg, seed)
        else:
            load_features(vgg, vgg_state)
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.acc_dtype = torch.float64 if compute_dtype == torch.float64 else torch.float32
        self.vgg = vgg.requires_grad_(False).eval().to(self.device, compute_dtype)
        self.max_iters = tuple(max_iters)
        self.style_targets: Optional[List[List[torch.Tensor]]] = None

    def _features(self, img: torch.Tensor, keys: Sequence[str]) -> List[torch.Tensor]:
        return self.vgg(img.to(self.compute_dtype), list(keys))

    # -- style targets (obst_eval.py:324-340) --------------------------------

    @torch.no_grad()
    def set_style(self, style_img, pyr_shapes: Sequence[Tuple[int, int]]) -> None:
        """style_img: (H, W, 3) RGB [0, 1], numpy or a tensor. Per pyramid
        shape, the Gram targets of the style image resized to it, through
        the closure's own compute path (a bf16 bias cancels in gram − target)."""
        img = torch.as_tensor(style_img).to(self.device).permute(2, 0, 1)[None]
        self.style_targets = [
            [gram_matrix(f) for f in self._features(
                obst_prep(resize_bilinear(img, shape, align_corners=False)), STYLE_LAYERS)]
            for shape in pyr_shapes]

    # -- objective ------------------------------------------------------------

    def _loss(self, opt_img, style_grams, content_feats, warp_img, mask_img, weight_tcl):
        feats = self._features(opt_img, STYLE_LAYERS + CONTENT_LAYERS)
        loss = 0.0
        for w, f, g_t in zip(STYLE_WEIGHTS, feats[:len(STYLE_LAYERS)], style_grams):
            loss = loss + w * torch.mean((gram_matrix(f) - g_t) ** 2)
        for w, f, f_t in zip(CONTENT_WEIGHTS, feats[len(STYLE_LAYERS):], content_feats):
            loss = loss + w * torch.mean((f.to(self.acc_dtype) - f_t) ** 2)
        return loss + weight_tcl * torch.mean((mask_img * (opt_img - warp_img)) ** 2)

    def descend(self, opt_img, style_grams, content_feats, warp_img, mask_img, weight_tcl,
                iters: int):
        """One pyramid level: ``iters`` L-BFGS iterations (already the
        closure-call count of the reference's driver), compact direction.
        Returns (image, losses)."""
        return lbfgs_minimize(
            lambda x: self._loss(x, style_grams, content_feats, warp_img, mask_img, weight_tcl),
            opt_img, num_iters=iters, impl="compact")

    # -- main entry (obst_eval.py:342-410) --------------------------------------

    def run(self, pre, img, mask, pyr_shapes: Sequence[Tuple[int, int]],
            weight_tcl: float = 0.0) -> torch.Tensor:
        """pre: the warm start (1, 3, H, W), caffe space, full size; img: the
        content frame (same space and size); mask: (1, 1, H, W). Returns the
        stylized image at ``pyr_shapes[-1]``."""
        if self.style_targets is None:
            raise RuntimeError("call set_style first")
        mimg = mask.expand(-1, 3, -1, -1)
        warp_targets, mask_targets, content_targets = [], [], []
        with torch.no_grad():
            for shape in pyr_shapes:
                warp_targets.append(resize_bilinear(pre, shape, align_corners=False))
                mask_targets.append(resize_bilinear(mimg, shape, align_corners=False))
                c = resize_bilinear(img, shape, align_corners=False)
                content_targets.append([f.to(self.acc_dtype)
                                        for f in self._features(c, CONTENT_LAYERS)])
        opt_img = pre
        for lvl, (shape, iters) in enumerate(zip(pyr_shapes, torch_eval_counts(self.max_iters))):
            opt_img = resize_bilinear(opt_img, shape, align_corners=False)
            opt_img, _ = self.descend(opt_img, self.style_targets[lvl], content_targets[lvl],
                                      warp_targets[lvl], mask_targets[lvl], weight_tcl, iters)
        return opt_img

    def warm_start(self, prev_styled, img, bf, mask):
        """``obst_eval.py:500``: ``pre = mask·warp(prev_styled, bf) + (1−mask)·img``."""
        return mask * warp(prev_styled, bf) + (1.0 - mask) * img
