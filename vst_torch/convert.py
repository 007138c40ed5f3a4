"""Weights from vst's flax param trees into the port's ``state_dict``s.

The inverses of ``vst.models.faststyle.faststyle_params_from_torch`` and
``vst.flow.raft.raft_params_from_torch``. Both take the param tree (without
the outer ``"params"`` key) with numpy leaves; conv kernels go
(kh, kw, I, O) → (O, I, kh, kw).
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
    """conv: a flax ``Conv_0`` scope with kernel and bias."""
    sd[f"{key}.weight"] = _j2t(conv["kernel"])
    sd[f"{key}.bias"] = _j2t(conv["bias"])


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
