"""InceptionV3 feature extractor for FID (NCHW), port of
``vst/metrics/inception.py``.

The torchvision ``inception_v3`` trunk the reference slices
(``utils/metrics/fid.py:27-53``): Conv2d_1a … Conv2d_4a with two 3×3/2 max
pools, Mixed_5b … Mixed_6e, Mixed_7a … Mixed_7c and a global average pool,
pool3 activations (B, 2048). The reference calls the blocks directly in an
``nn.Sequential``, bypassing torchvision's ``_transform_input``: the inputs
are whatever the eval loader produced.

Modules and parameters keep torchvision's key names
(``Mixed_5b.branch1x1.conv.weight``, ``….bn.{weight,bias,running_mean,
running_var}``), so a torchvision ``state_dict`` loads with no converter and
vst's ``inception_params_from_torch`` carries this module's into vst.
``BasicConv2d`` is a conv without bias, a batch norm on its stored
statistics (eps 1e-3, inference whatever the module's mode) and a ReLU.
The 3×3 stride-1 average pools count their padding (divide by 9,
``count_include_pad``); the max pools have none. Like torchvision's, the
trunk needs inputs of 75×75 or more (vst's VALID convs leave an empty map
below that, and its pool is NaN).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class BasicConv2d(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: Sequence[int], stride: int = 1,
                 pad: Sequence[int] = (0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, tuple(kernel), stride=stride, padding=tuple(pad),
                              bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=1e-3)

    def forward(self, x):
        bn = self.bn
        x = F.batch_norm(self.conv(x), bn.running_mean, bn.running_var, bn.weight, bn.bias,
                         False, 0.0, bn.eps)
        return F.relu(x)


def _maxpool3s2(x):
    return F.max_pool2d(x, 3, 2)


def _avgpool3s1p1(x):
    return F.avg_pool2d(x, 3, 1, 1)  # count_include_pad: divide by 9 everywhere


class InceptionA(nn.Module):
    def __init__(self, cin: int, pool_features: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 64, (1, 1))
        self.branch5x5_1 = BasicConv2d(cin, 48, (1, 1))
        self.branch5x5_2 = BasicConv2d(48, 64, (5, 5), pad=(2, 2))
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), pad=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), pad=(1, 1))
        self.branch_pool = BasicConv2d(cin, pool_features, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b5 = self.branch5x5_2(self.branch5x5_1(x))
        b3 = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([b1, b5, b3, bp], 1)


class InceptionB(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3 = BasicConv2d(cin, 384, (3, 3), stride=2)
        self.branch3x3dbl_1 = BasicConv2d(cin, 64, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(64, 96, (3, 3), pad=(1, 1))
        self.branch3x3dbl_3 = BasicConv2d(96, 96, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3(x)
        bd = self.branch3x3dbl_3(self.branch3x3dbl_2(self.branch3x3dbl_1(x)))
        return torch.cat([b3, bd, _maxpool3s2(x)], 1)


class InceptionC(nn.Module):
    def __init__(self, cin: int, channels_7x7: int):
        super().__init__()
        c7 = channels_7x7
        self.branch1x1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7_2 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7_3 = BasicConv2d(c7, 192, (7, 1), pad=(3, 0))
        self.branch7x7dbl_1 = BasicConv2d(cin, c7, (1, 1))
        self.branch7x7dbl_2 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_3 = BasicConv2d(c7, c7, (1, 7), pad=(0, 3))
        self.branch7x7dbl_4 = BasicConv2d(c7, c7, (7, 1), pad=(3, 0))
        self.branch7x7dbl_5 = BasicConv2d(c7, 192, (1, 7), pad=(0, 3))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b7 = self.branch7x7_3(self.branch7x7_2(self.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(self, f"branch7x7dbl_{i}")(bd)
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([b1, b7, bd, bp], 1)


class InceptionD(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch3x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch3x3_2 = BasicConv2d(192, 320, (3, 3), stride=2)
        self.branch7x7x3_1 = BasicConv2d(cin, 192, (1, 1))
        self.branch7x7x3_2 = BasicConv2d(192, 192, (1, 7), pad=(0, 3))
        self.branch7x7x3_3 = BasicConv2d(192, 192, (7, 1), pad=(3, 0))
        self.branch7x7x3_4 = BasicConv2d(192, 192, (3, 3), stride=2)

    def forward(self, x):
        b3 = self.branch3x3_2(self.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(self, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _maxpool3s2(x)], 1)


class InceptionE(nn.Module):
    def __init__(self, cin: int):
        super().__init__()
        self.branch1x1 = BasicConv2d(cin, 320, (1, 1))
        self.branch3x3_1 = BasicConv2d(cin, 384, (1, 1))
        self.branch3x3_2a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3_2b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch3x3dbl_1 = BasicConv2d(cin, 448, (1, 1))
        self.branch3x3dbl_2 = BasicConv2d(448, 384, (3, 3), pad=(1, 1))
        self.branch3x3dbl_3a = BasicConv2d(384, 384, (1, 3), pad=(0, 1))
        self.branch3x3dbl_3b = BasicConv2d(384, 384, (3, 1), pad=(1, 0))
        self.branch_pool = BasicConv2d(cin, 192, (1, 1))

    def forward(self, x):
        b1 = self.branch1x1(x)
        b3 = self.branch3x3_1(x)
        b3 = torch.cat([self.branch3x3_2a(b3), self.branch3x3_2b(b3)], 1)
        bd = self.branch3x3dbl_2(self.branch3x3dbl_1(x))
        bd = torch.cat([self.branch3x3dbl_3a(bd), self.branch3x3dbl_3b(bd)], 1)
        bp = self.branch_pool(_avgpool3s1p1(x))
        return torch.cat([b1, b3, bd, bp], 1)


class InceptionV3Trunk(nn.Module):
    """Pool3 activations (B, 2048), the FID feature."""

    def __init__(self):
        super().__init__()
        self.Conv2d_1a_3x3 = BasicConv2d(3, 32, (3, 3), stride=2)
        self.Conv2d_2a_3x3 = BasicConv2d(32, 32, (3, 3))
        self.Conv2d_2b_3x3 = BasicConv2d(32, 64, (3, 3), pad=(1, 1))
        self.Conv2d_3b_1x1 = BasicConv2d(64, 80, (1, 1))
        self.Conv2d_4a_3x3 = BasicConv2d(80, 192, (3, 3))
        self.Mixed_5b = InceptionA(192, 32)
        self.Mixed_5c = InceptionA(256, 64)
        self.Mixed_5d = InceptionA(288, 64)
        self.Mixed_6a = InceptionB(288)
        self.Mixed_6b = InceptionC(768, 128)
        self.Mixed_6c = InceptionC(768, 160)
        self.Mixed_6d = InceptionC(768, 160)
        self.Mixed_6e = InceptionC(768, 192)
        self.Mixed_7a = InceptionD(768)
        self.Mixed_7b = InceptionE(1280)
        self.Mixed_7c = InceptionE(2048)

    def forward(self, x):
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_maxpool3s2(x)))
        x = _maxpool3s2(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d", "Mixed_6a", "Mixed_6b", "Mixed_6c",
                     "Mixed_6d", "Mixed_6e", "Mixed_7a", "Mixed_7b", "Mixed_7c"):
            x = getattr(self, name)(x)
        return x.mean(dim=(2, 3))  # adaptive average pool to 1×1
