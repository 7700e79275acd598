"""SSD's VGG16 backbone, its extra-layer neck and L2Norm, NCHW.

Port of `jdet_tpu/models/backbones/ssd_vgg.py` (`L2Norm` :21, `SSDVGG`
:33, `SSDNeck` :69). Attribute names mirror the reference's parameter
paths (`blocks.<i>.<j>`, `fc6`, `fc7`, `l2norm.weight`,
`extra.<i>.<0|1>`), so that `models/convert.py` maps weights one to one.

Padding follows flax: the 3x3 convs pad 1 ('SAME' at stride 1); the 2x2
stride-2 pools after the first four blocks pad 'SAME' with -inf (0, 1)
where the size is odd (75 -> 38), and pool5 is 3x3 stride 1 'SAME'
(`layers.max_pool`); fc6 pads 6 with dilation 6; the neck's 3x3 convs pad
1 at stride 2 in its first two layers and nothing ('VALID') after.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES, NECKS
from ..layers import Conv2d, max_pool

VGG16 = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))


class L2Norm(nn.Module):
    """x / sqrt(sum_c x^2 + 1e-10) * weight, per position over the channels
    (the reference's eps sits inside the root, unlike `F.normalize`)."""

    def __init__(self, channels, scale=20.0):
        super().__init__()
        self.weight = nn.Parameter(torch.full((channels,), float(scale)))

    def forward(self, x):
        norm = torch.sqrt((x * x).sum(1, keepdim=True) + 1e-10)
        return x / norm * self.weight[:, None, None]


@BACKBONES.register_module()
class SSDVGG(nn.Module):
    """VGG16 to conv5_3, then fc6 / fc7 as dilated convs; outputs the
    L2-normalized conv4_3 (512 channels) and conv7 (1024)."""

    def __init__(self, in_channels=3, *, generator=None):
        super().__init__()
        blocks, ch = [], in_channels
        for n, c in VGG16:
            convs = []
            for _ in range(n):
                convs.append(Conv2d(ch, c, 3, generator=generator))
                ch = c
            blocks.append(nn.ModuleList(convs))
        self.blocks = nn.ModuleList(blocks)
        self.fc6 = Conv2d(512, 1024, 3, padding=6, dilation=6, generator=generator)
        self.fc7 = Conv2d(1024, 1024, 1, generator=generator)
        self.l2norm = L2Norm(512)
        self.out_channels = [512, 1024]

    def forward(self, x):
        outs = []
        for i, block in enumerate(self.blocks):
            for conv in block:
                x = F.relu(conv(x))
            if i == 3:
                outs.append(self.l2norm(x))
            x = max_pool(x, 2, 2) if i < 4 else max_pool(x, 3, 1)
        x = F.relu(self.fc6(x))
        outs.append(F.relu(self.fc7(x)))
        return tuple(outs)


@NECKS.register_module()
class SSDNeck(nn.Module):
    """The extra layers after conv7: each a 1x1 conv to half the width and
    a 3x3 conv to the full width, stride 2 in the first two."""

    def __init__(self, in_channels=(512, 1024), extra_channels=(512, 256, 256, 256), *,
                 generator=None):
        super().__init__()
        layers, ch = [], in_channels[-1]
        for i, c in enumerate(extra_channels):
            stride, pad = (2, 1) if i < 2 else (1, 0)
            layers.append(nn.ModuleList([
                Conv2d(ch, c // 2, 1, generator=generator),
                Conv2d(c // 2, c, 3, stride, padding=pad, generator=generator),
            ]))
            ch = c
        self.extra = nn.ModuleList(layers)
        self.out_channels = list(in_channels) + list(extra_channels)

    def forward(self, inputs):
        outs = list(inputs)
        x = inputs[-1]
        for reduce, expand in self.extra:
            x = F.relu(expand(F.relu(reduce(x))))
            outs.append(x)
        return tuple(outs)
