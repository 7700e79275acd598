"""ResNet backbone, NCHW.

Port of `jdet_tpu/models/backbones/resnet.py` (`BasicBlock` :30,
`Bottleneck` :49, `Downsample` :71 without avg-down, `ResNet` :100).
Attribute names mirror the reference's parameter paths, so that
`models/convert.py` maps weights one to one.

Freezing follows the reference's rules (:160-182): the stem and the first
`frozen_stages` stages take no gradient, their BNs always use running
statistics, and with `norm_eval` every backbone BN does.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm2d, Conv2d, max_pool


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch, ch, stride=1, downsample=None, *, generator=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, ch, 3, stride, bias=False, generator=generator)
        self.bn1 = BatchNorm2d(ch)
        self.conv2 = Conv2d(ch, ch, 3, bias=False, generator=generator)
        self.bn2 = BatchNorm2d(ch)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, downsample=None, *, generator=None):
        super().__init__()
        self.conv1 = Conv2d(in_ch, ch, 1, bias=False, generator=generator)
        self.bn1 = BatchNorm2d(ch)
        self.conv2 = Conv2d(ch, ch, 3, stride, bias=False, generator=generator)
        self.bn2 = BatchNorm2d(ch)
        self.conv3 = Conv2d(ch, ch * 4, 1, bias=False, generator=generator)
        self.bn3 = BatchNorm2d(ch * 4)
        self.downsample = downsample

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        return F.relu(out + identity)


class Downsample(nn.Module):
    def __init__(self, in_ch, out_ch, stride, *, generator=None):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, 1, stride, bias=False, generator=generator)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x):
        return self.bn(self.conv(x))


_ARCH = {
    18: (BasicBlock, (2, 2, 2, 2)),
    34: (BasicBlock, (3, 4, 6, 3)),
    50: (Bottleneck, (3, 4, 6, 3)),
    101: (Bottleneck, (3, 4, 23, 3)),
    152: (Bottleneck, (3, 8, 36, 3)),
}


@BACKBONES.register_module()
class ResNet(nn.Module):
    def __init__(
        self,
        depth=50,
        in_channels=3,
        return_stages=("layer1", "layer2", "layer3", "layer4"),
        frozen_stages=-1,
        norm_eval=True,
        *,
        generator=None,
    ):
        super().__init__()
        block, layers = _ARCH[depth]
        self.depth = depth
        self.return_stages = tuple(return_stages)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval

        self.conv1 = Conv2d(in_channels, 64, 7, 2, bias=False, generator=generator)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for i, n in enumerate(layers):
            ch = 64 * 2**i
            blocks = []
            for b in range(n):
                s = (1 if i == 0 else 2) if b == 0 else 1
                ds = None
                if b == 0 and (s != 1 or in_ch != ch * block.expansion):
                    ds = Downsample(in_ch, ch * block.expansion, s,
                                    generator=generator)
                blocks.append(block(in_ch, ch, s, ds, generator=generator))
                in_ch = ch * block.expansion
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_channels = [64 * 2**i * block.expansion for i in range(4)]
        for m in self._frozen_modules():
            m.requires_grad_(False)
        # from the start, as in the reference (whose BNs read `train` at
        # each call): a built backbone's BNs under norm_eval or in a frozen
        # stage never update their statistics, whichever mode it is left in
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
                if isinstance(m, nn.BatchNorm2d):
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
