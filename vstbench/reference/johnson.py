"""FastStyleNet (Johnson et al. 2016, arXiv:1603.08155) with Dumoulin et
al.'s conditional instance norm (arXiv:1610.07629), in plain PyTorch: the
benchmark's reference of the ``johnson`` configuration's stylize net.

The thesis' layout (``methods/learning-based/network.py``): reflection-padded
convs 9x9/32, 3x3 s2/64, 3x3 s2/128, each with a conditional instance norm
(an affine instance norm, then a per-style gamma and beta row) and ReLU; five
residual blocks of two 3x3/128 convs with affine instance norms and a gated
residual 2|s w|/(1 + |s w|) * out + x (w learned, s the style strength); two
nearest-2x-upsample 3x3 convs (64, 32) with conditional norms and ReLU; a
9x9/3 conv and tanh(y/255)*150 + 255/2. Instance norms are
``F.instance_norm`` (two-pass statistics). State-dict keys are the thesis'.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from vstbench.reference import seeded

# The output conv is drawn at this multiple of PyTorch's default bound. At the
# default, the random net's pre-tanh output has a standard deviation of about
# 0.35 against the head's scale of 255, so every styled pixel would read
# 0.5 +- 0.004 and the TCL would be about 0 whatever the program did; at 300
# times the styled frames span most of [0, 1], as a trained net's do.
OUT_SCALE = 300.0


class Conv(nn.Module):
    def __init__(self, cin, cout, k, stride=1, upsample=False):
        super().__init__()
        self.k, self.upsample = k, upsample
        self.conv2d = nn.Conv2d(cin, cout, k, stride)

    def forward(self, x):
        if self.upsample:
            x = F.interpolate(x, scale_factor=2, mode="nearest")
        return self.conv2d(F.pad(x, [self.k // 2] * 4, mode="reflect"))


class AffineNorm(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x):
        return F.instance_norm(x, weight=self.weight, bias=self.bias, eps=1e-5)


class CondNorm(nn.Module):
    def __init__(self, c, n_styles):
        super().__init__()
        self.bn = AffineNorm(c)
        self.embed = nn.Embedding(n_styles, 2 * c)

    def forward(self, x, style):
        gamma, beta = self.embed.weight[style].chunk(2)
        return gamma[:, None, None] * self.bn(x) + beta[:, None, None]


class ConvNormRelu(Conv):
    def __init__(self, cin, cout, k, stride, n_styles, upsample=False):
        super().__init__(cin, cout, k, stride, upsample)
        self.instance = CondNorm(cout, n_styles)

    def forward(self, x, style):
        return F.relu(self.instance(super().forward(x), style))


class Residual(nn.Module):
    def __init__(self, c=128):
        super().__init__()
        self.conv1 = Conv(c, c, 3)
        self.in1 = AffineNorm(c)
        self.conv2 = Conv(c, c, 3)
        self.in2 = AffineNorm(c)
        self.layer_strength = nn.Parameter(torch.ones(1))

    def forward(self, x, strength):
        s = (strength * self.layer_strength).abs()
        out = self.in2(self.conv2(F.relu(self.in1(self.conv1(x)))))
        return 2 * s / (1 + s) * out + x


class FastStyleNet(nn.Module):
    def __init__(self, n_styles: int = 3):
        super().__init__()
        self.conv1 = ConvNormRelu(3, 32, 9, 1, n_styles)
        self.conv2 = ConvNormRelu(32, 64, 3, 2, n_styles)
        self.conv3 = ConvNormRelu(64, 128, 3, 2, n_styles)
        for j in range(1, 6):
            setattr(self, f"res{j}", Residual(128))
        self.deconv1 = ConvNormRelu(128, 64, 3, 1, n_styles, upsample=True)
        self.deconv2 = ConvNormRelu(64, 32, 3, 1, n_styles, upsample=True)
        self.deconv3 = Conv(32, 3, 9)

    def forward(self, x, style: int, strength: float = 1.0):
        """x (B, 3, H, W), H and W multiples of 4 -> the net's raw output,
        about [-22.5, 277.5]."""
        x = self.conv3(self.conv2(self.conv1(x, style), style), style)
        for j in range(1, 6):
            x = getattr(self, f"res{j}")(x, strength)
        x = self.deconv2(self.deconv1(x, style), style)
        return torch.tanh(self.deconv3(x) / 255.0) * 150.0 + 255.0 / 2.0


def init_rule(net: FastStyleNet):
    weights = dict(net.state_dict(keep_vars=True))

    def rule(name, t):
        if name.endswith("embed.weight"):
            # gamma ~ N(1, 0.02), beta = 0: drawn as N(1, 0.02) and beta zeroed after
            return ("normal", 1.0, 0.02)
        if name.endswith("layer_strength") or (name.endswith(".weight") and t.dim() == 1):
            return ("const", 1.0)
        if name.endswith(".bias") and name.rsplit(".", 1)[0] + ".weight" in weights \
                and weights[name.rsplit(".", 1)[0] + ".weight"].dim() == 1:
            return ("const", 0.0)
        kind, bound = seeded.torch_default(name, t, weights)
        return kind, bound * (OUT_SCALE if name.startswith("deconv3.") else 1.0)

    return rule


def make(n_styles: int, generator: torch.Generator) -> FastStyleNet:
    net = seeded.build(lambda: FastStyleNet(n_styles), generator.device)
    seeded.fill(net, generator, init_rule(net))
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, CondNorm):
                m.embed.weight[:, m.embed.weight.shape[1] // 2:] = 0.0
    return net.eval()

