"""Weights from vst's flax param trees into the port's ``state_dict``s.

The inverses of ``vst.models.faststyle.faststyle_params_from_torch``,
``vst.flow.raft.raft_params_from_torch``, ``vst.perceptual.vgg``'s
``vgg16/19_params_from_torch`` and ``caffe_vgg_params_from_torch``, and
``vst.models.stargan2``'s four ``*_params_from_torch``; and the bridges
vst does not have, StarGAN v1's and the CycleGAN family's (generators,
discriminators, ConGAN's fusion block). Each takes the param tree (without the
outer ``"params"`` key) with numpy leaves; conv kernels go (kh, kw, I, O) →
(O, I, kh, kw) (a transposed conv's (kh, kw, O, I) → (I, O, kh, kw), the
same permutation), dense kernels (in, out) → (out, in).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_NORM_LEAVES = (("scale", "weight"), ("bias", "bias"),
                ("running_mean", "running_mean"), ("running_var", "running_var"))


def _j2t(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.ndim == 4:
        a = a.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(a, order="C"))  # a writable copy


def _put_conv(sd: Dict[str, torch.Tensor], key: str, conv: dict) -> None:
    """conv: a flax ``Conv_0`` scope with kernel and, where it has one, bias."""
    sd[f"{key}.weight"] = _j2t(conv["kernel"])
    if "bias" in conv:
        sd[f"{key}.bias"] = _j2t(conv["bias"])


def _put_dense(sd: Dict[str, torch.Tensor], key: str, dense: dict) -> None:
    """dense: a flax ``Dense_0`` scope, kernel (in, out) and bias."""
    sd[f"{key}.weight"] = torch.from_numpy(np.array(np.asarray(dense["kernel"]).T, order="C"))
    sd[f"{key}.bias"] = _j2t(dense["bias"])


def _put_norm(sd: Dict[str, torch.Tensor], key: str, norm: dict) -> None:
    for leaf, name in _NORM_LEAVES:
        if leaf in norm:
            sd[f"{key}.{name}"] = _j2t(norm[leaf])


def faststyle_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``FastStyleNet`` params → ``vst_torch.models.faststyle.FastStyleNet``
    state_dict (single-style affine norms or the conditional ``bn`` +
    ``embed`` layout, whichever the tree holds)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv_layer(key, scope):
        _put_conv(sd, f"{key}.conv2d", scope["TorchConv_0"]["Conv_0"])

    def style_norm(key, scope):
        if "InstanceNorm_0" in scope:
            _put_norm(sd, key, scope["InstanceNorm_0"])
        else:
            cin = scope["ConditionalInstanceNorm_0"]
            _put_norm(sd, f"{key}.bn", cin)
            sd[f"{key}.embed.weight"] = _j2t(cin["embed"])

    for i in range(3):
        conv_layer(f"conv{i + 1}", params[f"ConvLayer_{i}"])
        style_norm(f"conv{i + 1}.instance", params[f"_Norm_{i}"])
    for j in range(5):
        block = params[f"ResidualBlock_{j}"]
        sd[f"res{j + 1}.layer_strength"] = _j2t(block["layer_strength"])
        for m in range(2):
            conv_layer(f"res{j + 1}.conv{m + 1}", block[f"ConvLayer_{m}"])
            _put_norm(sd, f"res{j + 1}.in{m + 1}", block[f"InstanceNorm_{m}"])
    for i in range(2):
        conv_layer(f"deconv{i + 1}", params[f"UpsampleConvLayer_{i}"])
        style_norm(f"deconv{i + 1}.instance", params[f"_Norm_{3 + i}"])
    conv_layer("deconv3", params["ConvTanh_0"]["ConvLayer_0"])
    return sd


def raft_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``RAFT`` params → ``vst_torch.flow.raft.RAFT`` state_dict. A
    strided block's shortcut norm (norm3, or norm4 in bottleneck blocks)
    appears twice, as ``normX`` and ``downsample.1``, as in the reference."""
    sd: Dict[str, torch.Tensor] = {}
    for net in ("fnet", "cnet"):
        for name, node in params[net].items():
            if name.startswith("conv"):
                _put_conv(sd, f"{net}.{name}", node["Conv_0"])
            elif name.startswith("norm"):
                _put_norm(sd, f"{net}.{name}", node)
            elif name.startswith("layer"):
                i, j = name[len("layer"):].split("_")
                prefix = f"{net}.layer{i}.{j}"
                for sub, snode in node.items():
                    if sub == "downsample":
                        _put_conv(sd, f"{prefix}.downsample.0", snode["Conv_0"])
                    elif sub.startswith("conv"):
                        _put_conv(sd, f"{prefix}.{sub}", snode["Conv_0"])
                    elif sub in ("norm3", "norm4"):
                        _put_norm(sd, f"{prefix}.{sub}", snode)
                        _put_norm(sd, f"{prefix}.downsample.1", snode)
                    elif sub.startswith("norm"):
                        _put_norm(sd, f"{prefix}.{sub}", snode)
                    else:
                        raise KeyError(f"unmapped scope {net}/{name}/{sub}")
            else:
                raise KeyError(f"unmapped scope {net}/{name}")
    for part, node in params["update_iter"]["block"].items():
        for conv, cnode in node.items():
            _put_conv(sd, f"update_block.{part}.{conv}", cnode["Conv_0"])
    for name, node in params["mask_head"].items():
        _put_conv(sd, f"update_block.mask.{name[len('mask_'):]}", node["Conv_0"])
    return sd


def vgg_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``Vgg16Features`` / ``Vgg19Features`` params (``trunk/conv{i}``) →
    the port's trunk state_dict (torchvision's ``features.{i}``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params["trunk"].items():
        _put_conv(sd, f"features.{name[len('conv'):]}", node["Conv_0"])
    return sd


def caffe_vgg_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``CaffeVGG`` params (``conv{a}_{b}``) → the port's state_dict, the
    OBST ``vgg_conv.pth`` keys."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        _put_conv(sd, name, node["Conv_0"])
    return sd


def _put_resblk(sd: Dict[str, torch.Tensor], key: str, block: dict) -> None:
    """A StarGAN v2 ``ResBlk`` or ``AdainResBlk`` scope: its convs, and its
    affine norms or its AdaINs' ``fc``."""
    for name, node in block.items():
        if name.startswith("conv"):
            _put_conv(sd, f"{key}.{name}", node["Conv_0"])
        elif "fc" in node:
            _put_dense(sd, f"{key}.{name}.fc", node["fc"]["Dense_0"])
        else:
            _put_norm(sd, f"{key}.{name}", node)


def _put_trunk(sd: Dict[str, torch.Tensor], key: str, params: dict) -> int:
    """The StyleEncoder's / Discriminator's trunk under ``key``
    (``shared`` / ``main``): from_rgb at 0, ``block_i`` at 1 + i, conv_out
    after the leaky ReLU that follows the blocks. Returns conv_out's index."""
    _put_conv(sd, f"{key}.0", params["from_rgb"]["Conv_0"])
    n = sum(1 for name in params if name.startswith("block_"))
    for i in range(n):
        _put_resblk(sd, f"{key}.{i + 1}", params[f"block_{i}"])
    _put_conv(sd, f"{key}.{n + 2}", params["conv_out"]["Conv_0"])
    return n + 2


def stargan2_generator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst StarGAN v2 ``Generator`` params → ``vst_torch.models.stargan2.
    Generator`` state_dict (the inverse of ``generator_params_from_torch``)."""
    sd: Dict[str, torch.Tensor] = {}
    _put_conv(sd, "from_rgb", params["from_rgb"]["Conv_0"])
    for name, node in params.items():
        if name.startswith(("encode_", "decode_")):
            part, i = name.split("_")
            _put_resblk(sd, f"{part}.{i}", node)
    _put_norm(sd, "to_rgb.0", params["to_rgb_norm"])
    _put_conv(sd, "to_rgb.2", params["to_rgb"]["Conv_0"])
    return sd


def stargan2_mapping_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``MappingNetwork`` params → the port's state_dict: ``shared_i`` and
    ``unshared_{d}_{i}`` are the linears at Sequential index 2i."""
    sd: Dict[str, torch.Tensor] = {}
    for name, node in params.items():
        part, *idx = name.split("_")
        *d, i = idx
        _put_dense(sd, ".".join([part, *d, str(2 * int(i))]), node["Dense_0"])
    return sd


def stargan2_style_encoder_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``StyleEncoder`` params → the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    _put_trunk(sd, "shared", params)
    for name, node in params.items():
        if name.startswith("unshared_"):
            _put_dense(sd, f"unshared.{name.split('_')[1]}", node["Dense_0"])
    return sd


def stargan2_discriminator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst StarGAN v2 ``Discriminator`` params → the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}
    conv_out = _put_trunk(sd, "main", params)
    _put_conv(sd, f"main.{conv_out + 2}", params["head"]["Conv_0"])
    return sd


def stargan_generator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst StarGAN v1 ``Generator`` params (flax's names: ``_Conv_k``,
    ``InstanceNorm_k``, ``ResidualBlock_k``, ``_ConvT_k`` in call order) →
    the reference's ``main.{i}`` keys: conv, norm, ReLU; 2 × (conv, norm,
    ReLU); the residual blocks; 2 × (transposed conv, norm, ReLU); conv, tanh."""
    sd: Dict[str, torch.Tensor] = {}
    n_res = sum(1 for name in params if name.startswith("ResidualBlock_"))
    convs = iter(range(4))
    norms = iter(range(5))
    i = 0
    for _ in range(3):
        _put_conv(sd, f"main.{i}", params[f"_Conv_{next(convs)}"]["Conv_0"])
        _put_norm(sd, f"main.{i + 1}", params[f"InstanceNorm_{next(norms)}"])
        i += 3
    for r in range(n_res):
        block = params[f"ResidualBlock_{r}"]
        for m in range(2):
            _put_conv(sd, f"main.{i}.main.{3 * m}", block[f"_Conv_{m}"]["Conv_0"])
            _put_norm(sd, f"main.{i}.main.{3 * m + 1}", block[f"InstanceNorm_{m}"])
        i += 1
    for t in range(2):
        _put_conv(sd, f"main.{i}", params[f"_ConvT_{t}"]["ConvTranspose_0"])
        _put_norm(sd, f"main.{i + 1}", params[f"InstanceNorm_{next(norms)}"])
        i += 3
    _put_conv(sd, f"main.{i}", params[f"_Conv_{next(convs)}"]["Conv_0"])
    return sd


def stargan_discriminator_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst StarGAN v1 ``Discriminator`` params (``_Conv_0`` … ``_Conv_{R-1}``
    the stride-2 convs, then ``_Conv_R`` the source head and ``_Conv_{R+1}``
    the domain head) → the reference's ``main.{2k}``, ``conv1``, ``conv2``."""
    sd: Dict[str, torch.Tensor] = {}
    n = sum(1 for name in params if name.startswith("_Conv_")) - 2
    for k in range(n):
        _put_conv(sd, f"main.{2 * k}", params[f"_Conv_{k}"]["Conv_0"])
    _put_conv(sd, "conv1", params[f"_Conv_{n}"]["Conv_0"])
    _put_conv(sd, "conv2", params[f"_Conv_{n + 1}"]["Conv_0"])
    return sd


def _put_norm_if(sd: Dict[str, torch.Tensor], key: str, params: dict, name: str) -> None:
    """A CycleGAN ``_Norm``: a scope only where it has parameters ('batch')."""
    if name in params:
        _put_norm(sd, key, params[name])


def _unet_level_key(level: int) -> str:
    """The ``model`` Sequential of U-Net level ``level`` (0 outermost):
    ``model.model``, ``model.model.1.model``, then ``….model.3.model``."""
    key = "model"
    for i in range(level):
        key += ".model.1" if i == 0 else ".model.3"
    return key + ".model"


def cyclegan_generator_state_dict_from_jax(params: dict, netG: str) -> Dict[str, torch.Tensor]:
    """vst ``ResnetGenerator`` / ``UnetGenerator`` params → the port's (and
    junyanz's) keys. flax names the convs in call order: a resnet's
    ``_Conv_0..2`` the stem and downs, ``ResnetBlock_r/_Conv_{0,1}``,
    ``_ConvT_{0,1}``, ``_Conv_3`` the head; a U-Net's ``_Conv_L`` is level
    L's down conv and ``_ConvT_k`` level n−1−k's up conv (the innermost
    returns first). 'batch' norms (``_Norm_k``, call order) come along."""
    sd: Dict[str, torch.Tensor] = {}
    if netG.startswith("resnet"):
        n = sum(1 for name in params if name.startswith("ResnetBlock_"))
        for c, i in enumerate((1, 4, 7)):
            _put_conv(sd, f"model.{i}", params[f"_Conv_{c}"]["Conv_0"])
            _put_norm_if(sd, f"model.{i + 1}", params, f"_Norm_{c}")
        for r in range(n):
            block = params[f"ResnetBlock_{r}"]
            for m, i in enumerate((1, 5)):
                _put_conv(sd, f"model.{10 + r}.conv_block.{i}", block[f"_Conv_{m}"]["Conv_0"])
                _put_norm_if(sd, f"model.{10 + r}.conv_block.{i + 1}", block, f"_Norm_{m}")
        for t in range(2):
            i = 10 + n + 3 * t
            _put_conv(sd, f"model.{i}", params[f"_ConvT_{t}"]["ConvTranspose_0"])
            _put_norm_if(sd, f"model.{i + 1}", params, f"_Norm_{3 + t}")
        _put_conv(sd, f"model.{17 + n}", params["_Conv_3"]["Conv_0"])
        return sd
    n = sum(1 for name in params if name.startswith("_Conv_"))
    for level in range(n):
        key = _unet_level_key(level)
        outermost, innermost = level == 0, level == n - 1
        _put_conv(sd, f"{key}.{0 if outermost else 1}", params[f"_Conv_{level}"]["Conv_0"])
        up = 3 if outermost or innermost else 5
        _put_conv(sd, f"{key}.{up}", params[f"_ConvT_{n - 1 - level}"]["ConvTranspose_0"])
        if not outermost:
            if not innermost:
                _put_norm_if(sd, f"{key}.2", params, f"_Norm_{level - 1}")
            _put_norm_if(sd, f"{key}.{up + 1}", params, f"_Norm_{2 * n - 3 - level}")
    return sd


def cyclegan_discriminator_state_dict_from_jax(params: dict, netD: str) -> Dict[str, torch.Tensor]:
    """vst ``NLayerDiscriminator`` (basic, n_layers) or ``PixelDiscriminator``
    params → the port's (and junyanz's) ``model.{i}`` / ``net.{i}`` keys."""
    sd: Dict[str, torch.Tensor] = {}
    if netD == "pixel":
        for c, i in enumerate((0, 2, 5)):
            _put_conv(sd, f"net.{i}", params[f"_Conv_{c}"]["Conv_0"])
        _put_norm_if(sd, "net.3", params, "_Norm_0")
        return sd
    n_layers = sum(1 for name in params if name.startswith("_Conv_")) - 2
    _put_conv(sd, "model.0", params["_Conv_0"]["Conv_0"])
    for k in range(1, n_layers + 1):
        i = 2 + 3 * (k - 1)
        _put_conv(sd, f"model.{i}", params[f"_Conv_{k}"]["Conv_0"])
        _put_norm_if(sd, f"model.{i + 1}", params, f"_Norm_{k - 1}")
    _put_conv(sd, f"model.{2 + 3 * n_layers}", params[f"_Conv_{n_layers + 1}"]["Conv_0"])
    return sd


def fusion_block_state_dict_from_jax(params: dict) -> Dict[str, torch.Tensor]:
    """vst ``FusionBlock`` params (``ConvLayer_{0,1,2}``,
    ``InstanceNorm_{0,1}``) → the port's ``conv{1,2,3}.conv2d``, ``in{1,2}``."""
    sd: Dict[str, torch.Tensor] = {}
    for i in range(3):
        _put_conv(sd, f"conv{i + 1}.conv2d", params[f"ConvLayer_{i}"]["TorchConv_0"]["Conv_0"])
    for i in range(2):
        _put_norm(sd, f"in{i + 1}", params[f"InstanceNorm_{i}"])
    return sd
