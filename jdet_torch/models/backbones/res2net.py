"""Res2Net backbone, NCHW.

Port of `jdet_tpu/models/backbones/res2net.py` (`Bottle2neck` :21,
`Res2Net` :79). The bottleneck's 3x3 stage is split into `scales` groups
of `width` channels, run one after another, each added to the previous
group's output (in "normal" blocks); the first block of a stage ("stage"
blocks, those with a shortcut conv) passes its last group through a
`stride` x `stride` average pool instead. Attribute names mirror the
reference's parameter paths (`convs.i`, `bns.i`), so that
`models/convert.py` maps weights one to one, and `models/pretrained.py`
reads a torchvision-style Res2Net file through `resnet_to_flat`.

Traps, each as the reference computes it:
- flax's SAME padding is asymmetric under stride 2, on the stem and on
  the stride-2 split convs (`layers.Conv2d` pads as flax does);
- the "stage" pool is `reduce_window` add over SAME padding, then a
  division by stride²: padded zeros count in the divisor, which
  `F.avg_pool2d` (`ceil_mode`) does not do at an odd size;
- BN momentum 0.9 (torch's 0.1); the stem and the first `frozen_stages`
  stages take no gradient and their BNs use running statistics, and with
  `norm_eval` every BN does (`ResNet`'s rules, as the reference's
  optimizer freezes the same parameters).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm2d, Conv2d, same_pads
from .resnet import Downsample, ResNet, avg_pool_valid


def avg_pool_same(x, s):
    """flax's `reduce_window` add over SAME padding at window and stride
    s, divided by s * s (padded zeros count in the divisor)."""
    ph = same_pads(x.shape[-2], s, s)
    pw = same_pads(x.shape[-1], s, s)
    if any(ph + pw):
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return avg_pool_valid(x, s)


class Bottle2neck(nn.Module):
    expansion = 4

    def __init__(self, in_ch, ch, stride=1, downsample=None, scales=4, base_width=26, *,
                 generator=None):
        super().__init__()
        width = int(ch * base_width / 64.0)
        self.width = width
        self.scales = scales
        self.stride = stride
        self.stype = "stage" if downsample is not None else "normal"
        self.conv1 = Conv2d(in_ch, width * scales, 1, bias=False, generator=generator)
        self.bn1 = BatchNorm2d(width * scales)
        self.convs = nn.ModuleList(
            Conv2d(width, width, 3, stride, bias=False, generator=generator)
            for _ in range(scales - 1))
        self.bns = nn.ModuleList(BatchNorm2d(width) for _ in range(scales - 1))
        self.conv3 = Conv2d(width * scales, ch * 4, 1, bias=False, generator=generator)
        self.bn3 = BatchNorm2d(ch * 4)
        self.downsample = downsample

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        splits = torch.split(out, self.width, dim=1)
        outs = []
        prev = None
        for i, (conv, bn) in enumerate(zip(self.convs, self.bns)):
            sp = splits[i] if i == 0 or self.stype == "stage" else splits[i] + prev
            prev = F.relu(bn(conv(sp)))
            outs.append(prev)
        last = splits[-1]
        if self.stype == "stage" and self.stride != 1:
            last = avg_pool_same(last, self.stride)
        outs.append(last)
        out = self.bn3(self.conv3(torch.cat(outs, 1)))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(out + identity)


_ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


@BACKBONES.register_module()
class Res2Net(ResNet):
    """Res2Net-50 / 101 (26w x 4s by default) with ResNet's stem, stages,
    freezing and `norm_eval`."""

    def __init__(
        self,
        depth=50,
        scales=4,
        base_width=26,
        in_channels=3,
        return_stages=("layer1", "layer2", "layer3", "layer4"),
        frozen_stages=-1,
        norm_eval=True,
        *,
        generator=None,
    ):
        nn.Module.__init__(self)
        layers = _ARCH[depth]
        self.depth = depth
        self.scales = scales
        self.base_width = base_width
        self.return_stages = tuple(return_stages)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.deep_stem = False
        self.conv1 = Conv2d(in_channels, 64, 7, 2, bias=False, generator=generator)
        self.bn1 = BatchNorm2d(64)
        in_ch = 64
        for i, n in enumerate(layers):
            ch = 64 * 2**i
            blocks = []
            for b in range(n):
                s = (1 if i == 0 else 2) if b == 0 else 1
                ds = None
                if b == 0 and (s != 1 or in_ch != ch * 4):
                    ds = Downsample(in_ch, ch * 4, s, generator=generator)
                blocks.append(Bottle2neck(in_ch, ch, s, ds, scales, base_width,
                                          generator=generator))
                in_ch = ch * 4
            setattr(self, f"layer{i + 1}", nn.ModuleList(blocks))
        self.out_channels = [64 * 2**i * 4 for i in range(4)]
        for m in self._frozen_modules():
            m.requires_grad_(False)
        self.train()
