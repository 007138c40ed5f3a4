"""VGG feature extractors (NCHW), port of ``vst/perceptual/vgg.py``.

* ``Vgg16Features``: torchvision vgg16's ``features`` up to relu4_3, returning
  (relu1_2, relu2_2, relu3_3, relu4_3) (``methods/learning-based/network.py:10-43``).
* ``Vgg19Features``: vgg19's up to relu5_1, returning (relu1_1, relu2_1,
  relu3_1, relu4_1, relu5_1) (``network.py:45-78``).
* ``CaffeVGG``: the OBST caffe-layout VGG19 truncated after conv5_1, named
  outputs, max or avg pooling (``methods/optimization-based/obst_eval.py:164-220``).

The trunks are ``features.{i}`` with i torchvision's feature index, and
CaffeVGG's convs are ``conv{a}_{b}``, so a torchvision or OBST ``state_dict``
loads through :func:`load_features`. No weights ship with the repository and
nothing is downloaded: without a user's ``state_dict`` the trainers draw
:func:`he_randomized_`, which for a given seed is vst's
``he_randomized_params`` bit for bit.
"""

from __future__ import annotations

from typing import Dict, Iterable, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from vst_torch.ops.image import avg_pool2d

# torchvision `features` configs: ints are conv output channels, 'M' a maxpool
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")
VGG19_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M",
             512, 512, 512, 512, "M", 512, 512, 512, 512, "M")

CAFFE_CFG = (("conv1_1", 64), ("conv1_2", 64), ("p1", None),
             ("conv2_1", 128), ("conv2_2", 128), ("p2", None),
             ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256), ("p3", None),
             ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512), ("p4", None),
             ("conv5_1", 512))


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


class _VggTrunk(nn.Module):
    """torchvision's ``features`` Sequential, built up to the last tap;
    ``forward`` returns the post-ReLU outputs at the ``taps`` indices."""

    def __init__(self, cfg: Tuple, taps: Tuple[int, ...]):
        super().__init__()
        self.taps = taps
        layers = []
        cin = 3
        for c in cfg:
            if len(layers) > max(taps):
                break
            if c == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, c, 3, padding=1), nn.ReLU()]
                cin = c
        self.features = nn.Sequential(*layers)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                outs.append(x)
        return tuple(outs)


class Vgg16Features(_VggTrunk):
    """relu1_2, relu2_2, relu3_3, relu4_3 (vgg16 feature indices 3, 8, 15, 22)."""

    def __init__(self):
        super().__init__(VGG16_CFG, (3, 8, 15, 22))


class Vgg19Features(_VggTrunk):
    """relu1_1, relu2_1, relu3_1, relu4_1, relu5_1 (vgg19 indices 1, 6, 11, 20, 29)."""

    def __init__(self):
        super().__init__(VGG19_CFG, (1, 6, 11, 20, 29))


class CaffeVGG(nn.Module):
    """OBST VGG: named outputs r11…r51 and p1…p4. Input is caffe-preprocessed
    BGR (``obst_prep``); ``pool='max'`` is the reference default."""

    def __init__(self, pool: str = "max"):
        super().__init__()
        self.pool = _max_pool if pool == "max" else avg_pool2d
        cin = 3
        for name, ch in CAFFE_CFG:
            if ch is not None:
                setattr(self, name, nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x: torch.Tensor, out_keys: Sequence[str]):
        """The ``out_keys`` outputs, in that order. Stops after the deepest
        of them: XLA drops the unused layers from vst's program, eager
        PyTorch would run them (for OBST's r42, conv4_3 to conv5_1)."""
        want = set(out_keys)
        out: Dict[str, torch.Tensor] = {}
        h = x
        for name, ch in CAFFE_CFG:
            if want.issubset(out):
                break
            if ch is None:
                h = self.pool(h)
                out[name] = h
            else:
                h = F.relu(getattr(self, name)(h))
                out["r" + name[4] + name[6]] = h
        return [out[k] for k in out_keys]


def load_features(module: nn.Module, state_dict: Dict[str, torch.Tensor]) -> nn.Module:
    """Load the entries of a torchvision (vgg16 / vgg19, inception_v3,
    alexnet) or OBST ``vgg_conv`` ``state_dict`` that ``module`` holds (a
    trunk keeps only the layers it runs); every one of them must be there."""
    keys = module.state_dict().keys()
    module.load_state_dict({k: v for k, v in state_dict.items() if k in keys}, strict=True)
    return module


# ---------------------------------------------------------------------------
# OBST caffe pre/post-processing (obst_eval.py:306-322, 431-441)
# ---------------------------------------------------------------------------

CAFFE_MEAN_BGR = (0.40760392, 0.45795686, 0.48501961)


def _bgr_mean(x: torch.Tensor) -> torch.Tensor:
    return torch.tensor(CAFFE_MEAN_BGR, dtype=x.dtype, device=x.device)[:, None, None]


def obst_prep(img: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] (B, 3, H, W) → BGR, mean-subtracted, ×255."""
    return (img.flip(1) - _bgr_mean(img)) * 255.0


def obst_postp(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`obst_prep` with [0, 1] clipping (postpa + clip)."""
    x = x / 255.0 + _bgr_mean(x)
    return x.clamp(0.0, 1.0).flip(1)


# ---------------------------------------------------------------------------
# the no-pretrained-weights fallback
# ---------------------------------------------------------------------------

def _vst_path(name: str) -> Tuple[str, ...]:
    """The conv's scopes in vst's param tree: a trunk's (or AlexNet's)
    ``features.{i}`` is ``conv{i}``; any other module keeps its dotted path
    (CaffeVGG's ``conv{a}_{b}``, Inception's ``Mixed_5b.branch1x1.conv``)."""
    if name.startswith("features."):
        return ("conv" + name.split(".")[1],)
    return tuple(name.split("."))


def _convs_in_vst_order(module: nn.Module) -> Iterable[nn.Conv2d]:
    """The convs in the order ``jax.tree_util.tree_flatten_with_path`` visits
    vst's nested tree: depth first with each level's keys sorted as strings,
    which is the order of the sorted path tuples (conv0, conv10, conv12, …,
    conv2, …; ``('Mixed_5b', 'branch1x1', …)`` before
    ``('Mixed_5b', 'branch3x3dbl_1', …)``)."""
    named = [(_vst_path(n), m) for n, m in module.named_modules() if isinstance(m, nn.Conv2d)]
    return [m for _, m in sorted(named, key=lambda item: item[0])]


@torch.no_grad()
def he_randomized_(module: nn.Module, seed: int = 0) -> nn.Module:
    """Re-draw every conv kernel He-normal (fan_in, gain √2) and zero the
    biases, in place: vst's ``he_randomized_params`` (``vgg.py:208``); any
    other parameter or buffer (a batch norm's) keeps its init, as there.
    torch's default init shrinks activations about 2× a layer, so by relu3_3
    a random VGG maps every image to near-identical features; He-scaled
    random features keep their variance at depth (the "style transfer with
    random weights" regime).

    One ``np.random.RandomState(seed)`` draws each kernel as (kh, kw, ci, co)
    in vst's tree order (:func:`_convs_in_vst_order`), then the kernel is
    transposed to (co, ci, kh, kw): for a given seed the weights are vst's
    bit for bit."""
    rng = np.random.RandomState(seed)
    for conv in _convs_in_vst_order(module):
        co, ci, kh, kw = conv.weight.shape
        std = np.sqrt(2.0 / (kh * kw * ci))
        w = (rng.randn(kh, kw, ci, co) * std).astype(np.float32)
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))
        if conv.bias is not None:
            conv.bias.zero_()
    return module
