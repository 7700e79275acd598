"""ReResNet: a rotation-equivariant ResNet over C8 regular fields, NCHW.

Port of `jdet_tpu/models/backbones/re_resnet.py` (`REBottleneck` :27,
`REDownsample` :52, `ReResNet` :64): the ResNet of bottlenecks whose
convs are the C8 group convs of `models/equivariant/econv.py`, so every
tensor carries 8 orientation channels per field (orientation fastest).
ReResNet-50 with base_fields=8 outputs 256 / 512 / 1024 / 2048 channels
(32 / 64 / 128 / 256 fields). The stem is the 7x7/s2 lifting conv
(padding 3 on every side), its InnerBatchNorm, a ReLU and flax's 3x3/s2
SAME max pool. Every depth, 18 included, is made of bottlenecks, as in
the reference.

Freezing follows `ResNet` (`backbones/resnet.py`): the stem and the
first `frozen_stages` stages take no gradient, their norms always use
running statistics, and with `norm_eval` every backbone norm does. The
blocks run one after another; the reference's `lax.scan` over a stage
exists for XLA's compile time only.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..equivariant.econv import N_ORIENT, InnerBatchNorm, REConv2d, REConv2dLift
from ..layers import max_pool


class REBottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_f, f, stride=1, downsample=None, *, generator=None):
        super().__init__()
        self.conv1 = REConv2d(in_f, f, 1, generator=generator)
        self.bn1 = InnerBatchNorm(f)
        self.conv2 = REConv2d(f, f, 3, stride=stride, generator=generator)
        self.bn2 = InnerBatchNorm(f)
        self.conv3 = REConv2d(f, f * 4, 1, generator=generator)
        self.bn3 = InnerBatchNorm(f * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


class REDownsample(nn.Module):
    def __init__(self, in_f, out_f, stride, *, generator=None):
        super().__init__()
        self.conv = REConv2d(in_f, out_f, 1, stride=stride, generator=generator)
        self.bn = InnerBatchNorm(out_f)

    def forward(self, x):
        return self.bn(self.conv(x))


_ARCH = {18: (2, 2, 2, 2), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@BACKBONES.register_module()
class ReResNet(nn.Module):
    def __init__(
        self,
        depth=50,
        in_channels=3,
        base_fields=8,
        return_stages=("layer1", "layer2", "layer3", "layer4"),
        frozen_stages=-1,
        norm_eval=True,
        *,
        generator=None,
    ):
        super().__init__()
        self.depth = depth
        self.return_stages = tuple(return_stages)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.conv1 = REConv2dLift(in_channels, base_fields, 7, stride=2, generator=generator)
        self.bn1 = InnerBatchNorm(base_fields)
        in_f = base_fields
        for i, n in enumerate(_ARCH[depth]):
            f = base_fields * 2**i
            blocks = []
            for b in range(n):
                s = (1 if i == 0 else 2) if b == 0 else 1
                ds = None
                if b == 0 and (s != 1 or in_f != f * 4):
                    ds = REDownsample(in_f, f * 4, s, generator=generator)
                blocks.append(REBottleneck(in_f, f, s, ds, generator=generator))
                in_f = f * 4
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_fields = [base_fields * 2**i * 4 for i in range(4)]
        self.out_channels = [f * N_ORIENT for f in self.out_fields]
        for m in self._frozen_modules():
            m.requires_grad_(False)
        self.train()

    def _frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return [self.conv1, self.bn1] + [
            getattr(self, f"layer{i}") for i in range(1, self.frozen_stages + 1)
        ]

    def train(self, mode=True):
        super().train(mode)
        if mode:
            frozen = self.modules() if self.norm_eval else (
                sub for m in self._frozen_modules() for sub in m.modules()
            )
            for m in frozen:
                if isinstance(m, InnerBatchNorm):
                    m.eval()
        return self

    def forward(self, x):
        x = max_pool(F.relu(self.bn1(self.conv1(x))), 3, 2)
        outs = []
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                x = blk(x)
            if f"layer{i}" in self.return_stages:
                outs.append(x)
        return tuple(outs)
