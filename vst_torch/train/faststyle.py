"""Perceptual training of the feed-forward family, port of
``vst/train/faststyle.py`` (the reference's ``fast_style_transfer.py:165-264``
and ``fs_{johnson,dumoulin,huang,reconet,ruder}.py``).

One trainer, five loss heads (emphasis parameters are ``fs_tests.py:51-72``'s):

* johnson  (α, β, δ):         content relu3_3 + Σ Gram + TV
* dumoulin (α, β):            johnson − TV, multi-style norms
* huang    (α, β, γ, δ):      two frames + output temporal loss
* reconet  (α, β, γf, γo, δ): + feature temporal loss + luminance-compensated
  output temporal loss
* ruder    (α, β, γ):         7-channel input (frame, mask, warped previous
  output); a coin picks the unrolled sequence or the zero-context mode;
  frame 0 bootstrapped by a pretrained 3-input net

A step is vst's: one forward and backward pass, then Adam with the
reference's decay; no gradient accumulation and no mixed precision.

Quirks kept (PARITY.md): images enter the net in [0, 1] and leave as
pixels / 255; Johnson always uses style 0's Gram targets; ReCoNet scales flow
channel 0 by the H ratio and channel 1 by the W ratio (``fs_reconet.py:58-59``).

Batches are dicts of NCHW tensors: imgs (B, n, 3, H, W), masks
(B, n−1, 1, H, W), flows (B, n−1, 2, H, W) (:func:`batch_to_tensors` from
the loaders' NHWC numpy). vst draws Ruder's coin from the step's PRNG key
inside the jitted step; here a seeded ``torch.Generator`` draws it on the
host and Python branches, and ``loss_fn`` / ``train_step`` take it as an
argument too.

Data parallel (``mesh``, ``vst_torch.parallel``): each rank holds its shard
of the global batch; a step builds the rank's share of the global loss (the
batch means over the world size, Johnson's, Huang's and ReCoNet's TV, a sum
over the batch, as it is), all-reduces the gradients before Adam and the
terms after, so that the step at world size N is the step at world size 1
on the global batch, as vst's sharded step is its single-device step. The
coin comes from the same seeded generator on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from vst_torch.models.faststyle import FastStyleNet
from vst_torch.nn.conv import cudnn_enabled
from vst_torch.ops.image import resize_bilinear
from vst_torch.ops.losses import gram_matrix, normalize_imagenet, tv_loss
from vst_torch.ops.sample import warp_masked
from vst_torch.parallel.mesh import (Mesh, all_reduce_gradients, all_reduce_metrics, replicate,
                                     share_of_global)
from vst_torch.perceptual.vgg import Vgg16Features, he_randomized_, load_features

Tensors = Dict[str, torch.Tensor]

# the number of emphasis parameters of each head
N_EMPHASIS = {"johnson": 3, "dumoulin": 2, "huang": 4, "reconet": 5, "ruder": 3}
# each head's terms that are sums over the batch (vst/ops/losses.py:56); the
# others are batch means
SUM_TERMS = {"johnson": ("tv",), "huang": ("tv",), "reconet": ("tv",)}

# whether a training step's convolutions run on cuDNN (float32, TF32 off):
# at 16×3×256×256 on an H100, cuDNN runs VGG16's forward and input gradient
# 1.05× and FastStyleNet's forward and backward 1.43× faster than PyTorch's
# own convolutions (chip_smoke.py phase 13, conv_split), for 7 GiB more
# workspace
ON_CUDNN = True


def ref_lr_schedule(lr0: float, batch_size: int, floor: float = 1e-4) -> Callable[[int], float]:
    """The reference's ``prep_adam`` decay (``fast_style_transfer.py:788-793``):
    divide by 1.2 every ``int(500 / batch_size)`` iterations, floor 1e-4.
    Update i (0-based) uses ``schedule(i)``: optax reads the count before it
    increments it, and the reference decays before its step."""
    k = max(int(500 / batch_size), 1)

    def schedule(count: int) -> float:
        try:
            return max(lr0 / 1.2 ** ((count + 1) // k), floor)
        except OverflowError:  # 1.2 ** n past the float range: lr0 / inf
            return floor

    return schedule


def _mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).mean()


def _luma709(x: torch.Tensor) -> torch.Tensor:
    """Rec.709 luminance over the channel axis (``fs_reconet.py:67``)."""
    return (0.2126 * x[:, 0] + 0.7152 * x[:, 1] + 0.0722 * x[:, 2])[:, None]


def batch_to_tensors(batch: Dict[str, np.ndarray], device) -> Tensors:
    """A loader's batch (vst's NHWC numpy: imgs (B, n, H, W, 3), masks
    (B, n−1, H, W, 1), flows (B, n−1, H, W, 2)) as float32 NCHW tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(device)
            .permute(0, 1, 4, 2, 3).contiguous() for k, v in batch.items()}


@dataclasses.dataclass
class FastStyleConfig:
    method: str = "johnson"
    n_styles: int = 1
    emphasis: Tuple[float, ...] = (1e0, 1e1, 1e-4)
    lr: float = 1e-3
    batch_size: int = 16
    lr_floor: float = 1e-4
    n_frames: int = 2  # frames per training tuple (2 FC2, 3 CO2, 5 HW2/CO5)

    def __post_init__(self):
        if self.method not in N_EMPHASIS:
            raise ValueError(f"unknown method {self.method}")
        if len(self.emphasis) != N_EMPHASIS[self.method]:
            raise ValueError(f"{self.method} takes {N_EMPHASIS[self.method]} emphasis params")


def _seeded(seed: int, build: Callable[[], torch.nn.Module]) -> torch.nn.Module:
    """``build()`` on the CPU with torch's CPU generator seeded, leaving the
    caller's random state as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.default_generator.manual_seed(seed)
        return build()


class FastStyleTrainer:
    """Owns the net, the frozen VGG16, the style Gram targets and Adam.

    ``style_images``: (S, H, W, 3) float32 in [0, 1]. ``vgg_state``: a
    torchvision vgg16 ``state_dict``, or None for He-randomized features
    drawn from ``seed`` (vst's for the same seed). ``pre_style_state``:
    Ruder's pretrained 3-input bootstrap net, or None for a seeded one (the
    reference requires a trained one). The net is initialised from torch's
    generator seeded with ``seed``, the bootstrap with ``seed + 1``. With a
    ``mesh`` the trainer runs on the mesh's device, starts from rank 0's
    nets and takes data-parallel steps (``cfg.batch_size`` is the global
    batch).
    """

    def __init__(self, cfg: FastStyleConfig, style_images: np.ndarray,
                 vgg_state: Optional[Tensors] = None, pre_style_state: Optional[Tensors] = None,
                 seed: int = 0, device="cuda", mesh: Optional[Mesh] = None):
        self.cfg = cfg
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)
        num_inp = 7 if cfg.method == "ruder" else 3
        self.model = _seeded(seed, lambda: FastStyleNet(num_inp, cfg.n_styles)).to(self.device)
        self.pre_model = None
        if cfg.method == "ruder":
            self.pre_model = _seeded(seed + 1, lambda: FastStyleNet(3, cfg.n_styles))
            if pre_style_state is not None:
                self.pre_model.load_state_dict(pre_style_state)
            self.pre_model.requires_grad_(False).to(self.device)

        vgg = Vgg16Features()
        if vgg_state is None:
            he_randomized_(vgg, seed)
        else:
            load_features(vgg, vgg_state)
        self.vgg = vgg.requires_grad_(False).to(self.device)
        replicate([self.model, self.pre_model], mesh)

        # Gram targets (fast_style_transfer.py:740-756): normalize → VGG → Gram
        # per tap, one style at a time, stacked per tap: (S, C_i, C_i)
        with torch.no_grad(), cudnn_enabled(ON_CUDNN):
            grams: List[List[torch.Tensor]] = []
            for img in style_images:
                x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]
                grams.append([gram_matrix(f)[0] for f in self._vgg_feats(x.to(self.device))])
        self.style_grams = [torch.stack(tap) for tap in zip(*grams)]

        self.schedule = ref_lr_schedule(cfg.lr, cfg.batch_size, cfg.lr_floor)
        self.opt = torch.optim.Adam(self.model.parameters(), lr=self.schedule(0),
                                    betas=(0.9, 0.999), eps=1e-8)
        self.step = 0
        self.coin = torch.Generator().manual_seed(seed)

    def to_dtype(self, dtype: torch.dtype) -> "FastStyleTrainer":
        """The nets, the VGG and the Gram targets in ``dtype``; float64 serves
        the gradient checks (``vst_torch.train.parity``)."""
        for net in (self.model, self.vgg, self.pre_model):
            if net is not None:
                net.to(dtype)
        self.style_grams = [g.to(dtype) for g in self.style_grams]
        return self

    # -- pieces ----------------------------------------------------------------

    def _vgg_feats(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return self.vgg(normalize_imagenet(x))

    def _style_loss(self, feats, style_id: int) -> torch.Tensor:
        loss = 0.0
        for g_all, f in zip(self.style_grams, feats):
            g_s = g_all[min(max(style_id, 0), g_all.shape[0] - 1)]  # vst's mode="clip"
            loss = loss + _mse(gram_matrix(f), g_s[None])
        return loss

    def _apply_with_features(self, net, x, sid) -> Tuple[torch.Tensor, torch.Tensor]:
        fmap, styled = net(x, 1.0, sid)
        return fmap, styled / 255.0

    def _apply(self, x, sid) -> torch.Tensor:
        return self._apply_with_features(self.model, x, sid)[1]

    def _content_style(self, styled, img, style_id):
        """(content, style) of one styled frame against its input frame,
        unweighted."""
        sf, cf = self._vgg_feats(styled), self._vgg_feats(img)
        return _mse(sf[2], cf[2]), self._style_loss(sf, style_id)

    # -- the heads -------------------------------------------------------------

    def _loss_johnson(self, batch, style_id, sid, coin):
        alpha, beta, delta = self.cfg.emphasis
        img = batch["imgs"][:, 0]
        styled = self._apply(img, sid)
        # quirk: style 0's Gram targets whatever the style (fs_johnson.py:40)
        content, style = self._content_style(styled, img, 0)
        content, style, tv = alpha * content, beta * style, delta * tv_loss(styled)
        loss = content + style + tv
        return loss, {"loss": loss, "content": content, "style": style, "tv": tv}

    def _loss_dumoulin(self, batch, style_id, sid, coin):
        alpha, beta = self.cfg.emphasis
        img = batch["imgs"][:, 0]
        content, style = self._content_style(self._apply(img, sid), img, style_id)
        content, style = alpha * content, beta * style
        loss = content + style
        return loss, {"loss": loss, "content": content, "style": style}

    def _two_frames(self, batch, style_id, sid, with_features=False):
        """Both frames through the net, and the content and style terms
        averaged over them."""
        img1, img2 = batch["imgs"][:, 0], batch["imgs"][:, 1]
        f1, s1 = self._apply_with_features(self.model, img1, sid)
        f2, s2 = self._apply_with_features(self.model, img2, sid)
        c1, st1 = self._content_style(s1, img1, style_id)
        c2, st2 = self._content_style(s2, img2, style_id)
        alpha, beta = self.cfg.emphasis[:2]
        return (img1, img2, f1, f2, s1, s2,
                (alpha / 2) * (c1 + c2), (beta / 2) * (st1 + st2))

    def _loss_huang(self, batch, style_id, sid, coin):
        gamma, delta = self.cfg.emphasis[2:]
        mask, flow = batch["masks"][:, 0], batch["flows"][:, 0]
        _, _, _, _, s1, s2, content, style = self._two_frames(batch, style_id, sid)
        temporal = gamma * ((mask * (s2 - warp_masked(s1, flow))) ** 2).mean()
        tv = delta * tv_loss(s1)
        loss = content + style + temporal + tv
        return loss, {"loss": loss, "content": content, "style": style,
                      "temporal": temporal, "tv": tv}

    def _loss_reconet(self, batch, style_id, sid, coin):
        gamma_f, gamma_o, delta = self.cfg.emphasis[2:]
        mask, flow = batch["masks"][:, 0], batch["flows"][:, 0]
        img1, img2, f1, f2, s1, s2, content, style = self._two_frames(batch, style_id, sid)
        tv = (delta / 2) * (tv_loss(s1) + tv_loss(s2))

        fh, fw = f1.shape[2:]
        H, W = flow.shape[2:]
        feat_flow = resize_bilinear(flow, (fh, fw), align_corners=False)
        # the reference's quirk: channel 0 by the H ratio, channel 1 by the W ratio
        scale = torch.tensor([fh / H, fw / W], dtype=feat_flow.dtype, device=feat_flow.device)
        feat_flow = feat_flow * scale[:, None, None]
        feat_mask = resize_bilinear(mask, (fh, fw), align_corners=False)
        f_temporal = gamma_f * ((feat_mask * (f2 - warp_masked(f1, feat_flow))) ** 2).mean()

        out_term = s2 - warp_masked(s1, flow)
        in_term = _luma709(img2 - warp_masked(img1, flow))
        o_temporal = gamma_o * ((mask * (out_term - in_term)) ** 2).mean()

        loss = content + style + f_temporal + o_temporal + tv
        return loss, {"loss": loss, "content": content, "style": style,
                      "f_temporal": f_temporal, "o_temporal": o_temporal, "tv": tv}

    def _loss_ruder(self, batch, style_id, sid, coin):
        alpha, beta, gamma = self.cfg.emphasis
        imgs, masks, flows = batch["imgs"], batch["masks"], batch["flows"]
        n = imgs.shape[1]
        if coin:
            # sequence mode (fs_ruder.py:46-75): frame 0 through the bootstrap
            # net, then the flow-aware net unrolled over any n ≥ 2
            with torch.no_grad():
                styled = self._apply_with_features(self.pre_model, imgs[:, 0], sid)[1]
            warped = styled
            for t in range(1, n):
                warped = warp_masked(styled, flows[:, t - 1])
                styled = self._apply(torch.cat([imgs[:, t], masks[:, t - 1], warped], 1), sid)
            temporal = gamma * ((masks[:, -1] * (warped - styled)) ** 2).mean()
            loss_img = imgs[:, n - 1]
        else:  # zero-context mode: frame 1, no mask, nothing warped
            x = torch.cat([imgs[:, 1], torch.zeros_like(masks[:, 0]),
                           torch.zeros_like(imgs[:, 1])], 1)
            styled = self._apply(x, sid)
            temporal = torch.zeros((), dtype=styled.dtype, device=styled.device)
            loss_img = imgs[:, 1]
        content, style = self._content_style(styled, loss_img, style_id)
        content, style = alpha * content, beta * style
        loss = content + style + temporal
        return loss, {"loss": loss, "content": content, "style": style, "temporal": temporal}

    # -- the step --------------------------------------------------------------

    def draw_coin(self) -> bool:
        """Ruder's branch: True (unrolled sequence) with probability 1/2."""
        return bool(torch.rand((), generator=self.coin).item() < 0.5)

    def loss_fn(self, batch: Tensors, style_id: int = 0,
                coin: Optional[bool] = None) -> Tuple[torch.Tensor, Tensors]:
        """(loss, aux terms) of the current net on ``batch``. ``coin``
        (Ruder only): the branch, drawn with :meth:`draw_coin` when None."""
        if self.cfg.method == "ruder" and coin is None:
            coin = self.draw_coin()
        sid = torch.tensor(style_id, device=self.device)
        return getattr(self, f"_loss_{self.cfg.method}")(batch, style_id, sid, coin)

    def train_step(self, batch: Tensors, style_id: int = 0,
                   coin: Optional[bool] = None) -> Tensors:
        """One forward and backward pass and one Adam update at the
        schedule's rate for this update; returns the aux terms, detached
        (no host synchronisation). With a mesh, ``batch`` is the rank's
        shard and the terms are the global batch's."""
        self.opt.zero_grad(set_to_none=True)
        with cudnn_enabled(ON_CUDNN):
            loss, aux = self.loss_fn(batch, style_id, coin)
            loss, aux = share_of_global(loss, aux, self.mesh, SUM_TERMS.get(self.cfg.method, ()))
            loss.backward()
        self.apply_gradients()
        return all_reduce_metrics({k: v.detach() for k, v in aux.items()}, self.mesh)

    def apply_gradients(self) -> None:
        """One Adam update from the parameters' ``.grad`` (summed over the
        mesh's ranks first), at the rate the schedule gives this update."""
        all_reduce_gradients([self.opt], self.mesh)
        for group in self.opt.param_groups:
            group["lr"] = self.schedule(self.step)
        self.opt.step()
        self.step += 1

    def stylize_fn(self) -> Callable[[torch.Tensor, int], torch.Tensor]:
        """Per-frame inference: (img in [0, 1], style_id) → clamp(net / 255, 0,
        1) (``infer_method`` + clamp, ``fast_style_transfer.py:838-841``)."""

        @torch.no_grad()
        def fn(img: torch.Tensor, style_id: int = 0) -> torch.Tensor:
            sid = torch.tensor(style_id, device=img.device)
            return (self.model(img, 1.0, sid)[1] / 255.0).clamp(0.0, 1.0)

        return fn
