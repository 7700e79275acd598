"""Feature Pyramid Network, NCHW.

Port of `jdet_tpu/models/necks/fpn.py::FPN` (:22) for the branch the
Rotated RetinaNet configs use: lateral 1x1 convs, nearest top-down
pathway, 3x3 output convs, and extra levels from stride-2 3x3 convs on
the last input ("on_input").
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import NECKS
from ..layers import Conv2d, resize_nearest


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: int = 256,
        num_outs: int = 5,
        start_level: int = 0,
        add_extra_convs="on_input",
        *,
        generator=None,
    ):
        super().__init__()
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        extra_levels = num_outs - (self.num_ins - self.start_level)
        if extra_levels > 0 and add_extra_convs not in (True, "on_input"):
            raise NotImplementedError(
                f"add_extra_convs={add_extra_convs!r} is not ported"
            )

        levels = range(self.start_level, self.num_ins)
        self.lateral_convs = nn.ModuleList(
            [Conv2d(in_channels[i], out_channels, 1, generator=generator)
             for i in levels]
        )
        self.fpn_convs = nn.ModuleList(
            [Conv2d(out_channels, out_channels, 3, generator=generator)
             for _ in levels]
        )
        self.extra_convs = nn.ModuleList(
            [
                Conv2d(in_channels[-1] if i == 0 else out_channels,
                       out_channels, 3, 2, generator=generator)
                for i in range(max(extra_levels, 0))
            ]
        )
        self.out_channels = out_channels

    def forward(self, inputs):
        if len(inputs) != self.num_ins:
            raise ValueError(f"expected {self.num_ins} inputs, got {len(inputs)}")
        laterals = [
            conv(inputs[self.start_level + i])
            for i, conv in enumerate(self.lateral_convs)
        ]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(
                laterals[i], laterals[i - 1].shape[-2:]
            )
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        x = inputs[-1]
        for conv in self.extra_convs:
            x = conv(x)
            outs.append(x)
        return tuple(outs)
