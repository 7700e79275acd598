"""LSKNet and StripNet backbones, NCHW.

Port of `jdet_tpu/models/backbones/lsknet.py` (`DropPath` :47, `Mlp` :61,
`LSKblock` :72, `StripBlock` :95, `SpatialAttention` :110, `Block` :123,
`OverlapPatchEmbed` :144, `_LargeKernelNet` :157, `LSKNet` :219,
`StripNet` :231). Attribute names mirror the reference's parameter paths
(`patch_embeds`, `stages`, `stage_norms`, `attn.gate`, `ls1`/`ls2`), so
that `models/convert.py` and `models/pretrained.py` map weights one to
one.

- Every depthwise conv has groups = channels: the LSK block's 5x5 (pad 2)
  and 7x7 at dilation 3 (pad 9), the strip block's 5x5 and (k1, k2) /
  (k2, k1) strips (pad k // 2 on each axis: (0, 9) / (9, 0) for 1x19),
  the MLP's 3x3. The patch embeds pad k // 2 on every side (7x7/s4, then
  3x3/s2); `conv_squeeze` (7x7, flax's SAME at stride 1) pads 3. The
  depthwise and 1x1 convs run as `F.conv2d` (cuDNN on the card), as the
  reference computes them outside any Pallas kernel.
- GELU is the tanh form (`jax.nn.gelu`'s default); each stage ends in a
  LayerNorm over channels with flax's epsilon 1e-6. Under the bf16
  policy GELU and the gate's sigmoid run step by step in bf16 as XLA
  expands them (`layers.gelu`, `layers.sigmoid`).
- `ls1`/`ls2` are per-channel layer scales, 1e-2 at init.
- `DropPath` is the identity: the reference's `Block` never passes it a
  key (:133-140), so its stochastic depth never runs.
- The BNs (epsilon 1e-5, flax's momentum 0.9) use their running
  statistics under `norm_eval` (the default). With `norm_eval=False`,
  training mode takes the batch statistics and moves the running ones as
  flax does, biased variance included (`layers.BatchNorm2d`).
"""
from __future__ import annotations

import torch
from torch import nn

from ...utils.registry import BACKBONES
from ..layers import BatchNorm2d, Conv2d, LayerNorm2d, gelu, sigmoid


def _dwconv(dim, k, dilation=1, padding=None, *, generator=None):
    k = (k, k) if isinstance(k, int) else tuple(k)
    if padding is None:
        padding = (k[0] // 2, k[1] // 2)
    return Conv2d(dim, dim, k, padding=padding, dilation=dilation, groups=dim,
                  generator=generator)


class DropPath(nn.Module):
    """The reference's stochastic depth, which its blocks never key: the
    identity."""

    def __init__(self, rate):
        super().__init__()
        self.rate = rate

    def forward(self, x):
        return x


class Mlp(nn.Module):
    def __init__(self, dim, hidden, *, generator=None):
        super().__init__()
        self.fc1 = Conv2d(dim, hidden, 1, generator=generator)
        self.dwconv = _dwconv(hidden, 3, generator=generator)
        self.fc2 = Conv2d(hidden, dim, 1, generator=generator)

    def forward(self, x):
        return self.fc2(gelu(self.dwconv(self.fc1(x))))


class LSKblock(nn.Module):
    def __init__(self, dim, *, generator=None):
        super().__init__()
        self.conv0 = _dwconv(dim, 5, generator=generator)
        self.conv_spatial = _dwconv(dim, 7, dilation=3, padding=9, generator=generator)
        self.conv1 = Conv2d(dim, dim // 2, 1, generator=generator)
        self.conv2 = Conv2d(dim, dim // 2, 1, generator=generator)
        self.conv_squeeze = Conv2d(2, 2, 7, padding=3, generator=generator)
        self.conv = Conv2d(dim // 2, dim, 1, generator=generator)

    def forward(self, x):
        attn1 = self.conv0(x)
        attn2 = self.conv_spatial(attn1)
        attn1 = self.conv1(attn1)
        attn2 = self.conv2(attn2)
        attn = torch.cat([attn1, attn2], 1)
        agg = torch.cat([attn.mean(1, keepdim=True), attn.amax(1, keepdim=True)], 1)
        sig = sigmoid(self.conv_squeeze(agg))
        attn = attn1 * sig[:, 0:1] + attn2 * sig[:, 1:2]
        return x * self.conv(attn)


class StripBlock(nn.Module):
    def __init__(self, dim, k1, k2, *, generator=None):
        super().__init__()
        self.conv0 = _dwconv(dim, 5, generator=generator)
        self.conv_spatial1 = _dwconv(dim, (k1, k2), generator=generator)
        self.conv_spatial2 = _dwconv(dim, (k2, k1), generator=generator)
        self.conv1 = Conv2d(dim, dim, 1, generator=generator)

    def forward(self, x):
        attn = self.conv_spatial2(self.conv_spatial1(self.conv0(x)))
        return x * self.conv1(attn)


class SpatialAttention(nn.Module):
    def __init__(self, dim, gating, *, generator=None):
        super().__init__()
        self.proj_1 = Conv2d(dim, dim, 1, generator=generator)
        self.gate = gating
        self.proj_2 = Conv2d(dim, dim, 1, generator=generator)

    def forward(self, x):
        return self.proj_2(self.gate(gelu(self.proj_1(x)))) + x


class Block(nn.Module):
    def __init__(self, dim, mlp_ratio, drop_path, gating, *, generator=None):
        super().__init__()
        self.norm1 = BatchNorm2d(dim)
        self.norm2 = BatchNorm2d(dim)
        self.attn = SpatialAttention(dim, gating, generator=generator)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), generator=generator)
        self.drop_path = DropPath(drop_path)
        self.ls1 = nn.Parameter(torch.full((dim,), 1e-2))
        self.ls2 = nn.Parameter(torch.full((dim,), 1e-2))

    def forward(self, x):
        x = x + self.drop_path(self.ls1[:, None, None] * self.attn(self.norm1(x)))
        return x + self.drop_path(self.ls2[:, None, None] * self.mlp(self.norm2(x)))


class OverlapPatchEmbed(nn.Module):
    def __init__(self, in_ch, dim, patch_size=7, stride=4, *, generator=None):
        super().__init__()
        self.proj = Conv2d(in_ch, dim, patch_size, stride, padding=patch_size // 2,
                           generator=generator)
        self.norm = BatchNorm2d(dim)

    def forward(self, x):
        return self.norm(self.proj(x))


class _LargeKernelNet(nn.Module):
    def __init__(
        self,
        embed_dims,
        depths,
        mlp_ratios=(8, 8, 4, 4),
        drop_path_rate=0.1,
        out_indices=(0, 1, 2, 3),
        in_channels=3,
        strip_kernels=None,
        norm_eval=True,
        *,
        generator=None,
    ):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.norm_eval = norm_eval
        # the reference's float32 linspace of the (unused) drop-path rates
        dpr = torch.linspace(0, drop_path_rate, sum(depths)).tolist()
        cur = 0
        self.patch_embeds = nn.ModuleList()
        self.stages = nn.ModuleList()
        self.stage_norms = nn.ModuleList()
        for i, (dim, depth) in enumerate(zip(embed_dims, depths)):
            self.patch_embeds.append(OverlapPatchEmbed(
                in_channels if i == 0 else embed_dims[i - 1], dim,
                patch_size=7 if i == 0 else 3, stride=4 if i == 0 else 2, generator=generator))
            blocks = []
            for j in range(depth):
                gating = (LSKblock(dim, generator=generator) if strip_kernels is None
                          else StripBlock(dim, *strip_kernels, generator=generator))
                blocks.append(Block(dim, mlp_ratios[i], dpr[cur + j], gating,
                                    generator=generator))
            cur += depth
            self.stages.append(nn.ModuleList(blocks))
            self.stage_norms.append(LayerNorm2d(dim))
        self.out_channels = [embed_dims[i] for i in self.out_indices]
        # from the start, as in the reference (whose BNs read `train` at
        # each call): under norm_eval the BNs never update their statistics
        self.train()

    def train(self, mode=True):
        super().train(mode)
        if mode and self.norm_eval:
            for m in self.modules():
                if isinstance(m, nn.BatchNorm2d):
                    m.eval()
        return self

    def forward(self, x):
        outs = []
        for i, (embed, blocks, norm) in enumerate(zip(self.patch_embeds, self.stages,
                                                      self.stage_norms)):
            x = embed(x)
            for blk in blocks:
                x = blk(x)
            x = norm(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


_ARCH = {"t": dict(embed_dims=(32, 64, 160, 256), depths=(3, 3, 5, 2)),
         "s": dict(embed_dims=(64, 128, 320, 512), depths=(2, 2, 4, 2))}


@BACKBONES.register_module()
class LSKNet(_LargeKernelNet):
    """LSKNet-T (dims 32-64-160-256, depths 3-3-5-2) or -S (64-128-320-512,
    2-2-4-2); keyword arguments override the arch's."""

    def __init__(self, arch="s", **kw):
        super().__init__(strip_kernels=None, **{**_ARCH[arch], **kw})


@BACKBONES.register_module()
class StripNet(_LargeKernelNet):
    """StripNet-S: LSKNet-S's shapes with (k1, k2) = (1, 19) strip gating."""

    def __init__(self, arch="s", k1=1, k2=19, **kw):
        if arch != "s":
            raise KeyError(f"StripNet arch {arch!r}: only 's' exists")
        super().__init__(strip_kernels=(k1, k2), **{**_ARCH[arch], **kw})
