"""ResNet backbone, NCHW.

Port of `jdet_tpu/models/backbones/resnet.py` (`BasicBlock` :30,
`Bottleneck` :49, `Downsample` :71, `ResNet` :100 with its deep stem
:118-126 and avg-down :141, `ResNet_v1d` :185). Attribute names mirror
the reference's parameter paths (`conv1a/b/c`, `bn1a/b/c` for the deep
stem), so that `models/convert.py` maps weights one to one.

Freezing follows the reference's rules (:160-182): the stem (all three
convs of the deep stem) and the first `frozen_stages` stages take no
gradient, their BNs always use running statistics, and with `norm_eval`
every backbone BN does.
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
    """1x1 conv + BN on the shortcut. With `avg_pool_first` (v1d) and a
    stride, a VALID stride x stride average pool comes first and the conv
    runs at stride 1."""

    def __init__(self, in_ch, out_ch, stride, avg_pool_first=False, *, generator=None):
        super().__init__()
        self.avg_pool_first = avg_pool_first and stride != 1
        self.stride = stride
        self.conv = Conv2d(in_ch, out_ch, 1, 1 if self.avg_pool_first else stride,
                           bias=False, generator=generator)
        self.bn = BatchNorm2d(out_ch)

    def forward(self, x):
        if self.avg_pool_first:
            x = avg_pool_valid(x, self.stride)
        return self.bn(self.conv(x))


def avg_pool_valid(x, s):
    """VALID s x s average pool at stride s, as the reference writes it:
    the window summed in x's dtype (a reduce_window add), then divided by
    s * s. `F.avg_pool2d` accumulates bf16 windows in float32, so the sum
    is written out here: the s * s strided views added in window order."""
    h, w = x.shape[-2] // s * s, x.shape[-1] // s * s
    total = None
    for i in range(s):
        for j in range(s):
            v = x[..., i:h:s, j:w:s]
            total = v if total is None else total + v
    return total / (s * s)


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
        deep_stem=False,
        avg_down=False,
        *,
        generator=None,
    ):
        super().__init__()
        block, layers = _ARCH[depth]
        self.depth = depth
        self.return_stages = tuple(return_stages)
        self.frozen_stages = frozen_stages
        self.norm_eval = norm_eval
        self.deep_stem = deep_stem

        if deep_stem:
            # three 3x3 convs, 32/32/64, the first at stride 2 (flax SAME
            # pads it (0, 1) on an even size: `Conv2d` pads as flax does)
            self.conv1a = Conv2d(in_channels, 32, 3, 2, bias=False, generator=generator)
            self.bn1a = BatchNorm2d(32)
            self.conv1b = Conv2d(32, 32, 3, bias=False, generator=generator)
            self.bn1b = BatchNorm2d(32)
            self.conv1c = Conv2d(32, 64, 3, bias=False, generator=generator)
            self.bn1c = BatchNorm2d(64)
        else:
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
                                    avg_pool_first=avg_down, generator=generator)
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

    def _stem_modules(self):
        if self.deep_stem:
            return [self.conv1a, self.bn1a, self.conv1b, self.bn1b, self.conv1c, self.bn1c]
        return [self.conv1, self.bn1]

    def _frozen_modules(self):
        if self.frozen_stages < 0:
            return []
        return self._stem_modules() + [
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
        stem = self._stem_modules()
        for conv, bn in zip(stem[::2], stem[1::2]):
            x = F.relu(bn(conv(x)))
        x = max_pool(x, 3, 2)
        outs = []
        for i in range(1, 5):
            for blk in getattr(self, f"layer{i}"):
                x = blk(x)
            if f"layer{i}" in self.return_stages:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register_module()
class ResNet_v1d(ResNet):
    """Deep stem + avg-down (the reference's `ResNet_v1d`, :185)."""

    def __init__(self, **kw):
        kw.setdefault("deep_stem", True)
        kw.setdefault("avg_down", True)
        super().__init__(**kw)


def Resnet18(**kw):
    return ResNet(depth=18, **kw)


def Resnet34(**kw):
    return ResNet(depth=34, **kw)


def Resnet50(**kw):
    return ResNet(depth=50, **kw)


def Resnet101(**kw):
    return ResNet(depth=101, **kw)


def Resnet152(**kw):
    return ResNet(depth=152, **kw)


# the JDet registry names (the reference's `resnet.py:195-215`)
for _f in (Resnet18, Resnet34, Resnet50, Resnet101, Resnet152):
    BACKBONES.register_module(_f)


def load_torch_resnet(model, state_dict):
    """Load a torchvision ResNet state dict (`torch.load` of resnet50.pth)
    into `model`, every backbone tensor required (the reference's
    `load_torch_resnet`, :219); `fc.*` and `num_batches_tracked` are
    skipped. Returns `model`."""
    from ..pretrained import assign_state, resnet_to_flat

    _, missing, _ = assign_state(model, resnet_to_flat(state_dict), strict=True)
    if missing:
        raise KeyError(f"load_torch_resnet: the state dict lacks {missing[:8]}")
    return model
