"""Feature Pyramid Network, NCHW.

Port of `jdet_tpu/models/necks/fpn.py::FPN` (:22): lateral 1x1 convs,
nearest top-down pathway, 3x3 output convs, and the extra levels beyond
the inputs either by 1x1 stride-2 max pools of the last output (the
default, `add_extra_convs=False`) or by stride-2 3x3 convs on the last
input ("on_input"), the last lateral ("on_lateral") or the last output
("on_output"); `add_extra_convs=True` means "on_input", or "on_output"
with `extra_convs_on_inputs=False`. `relu_before_extra_convs` puts a
ReLU before every extra conv but the first.
"""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from ...utils.registry import NECKS
from ..layers import Conv2d, max_pool, resize_nearest


@NECKS.register_module()
class FPN(nn.Module):
    def __init__(
        self,
        in_channels: Sequence[int],
        out_channels: int = 256,
        num_outs: int = 5,
        start_level: int = 0,
        end_level: int = -1,
        add_extra_convs=False,
        extra_convs_on_inputs=True,
        relu_before_extra_convs=False,
        *,
        generator=None,
    ):
        super().__init__()
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.end_level = self.num_ins if end_level == -1 else end_level
        self.relu_before_extra_convs = relu_before_extra_convs
        if add_extra_convs is True:
            add_extra_convs = "on_input" if extra_convs_on_inputs else "on_output"
        if add_extra_convs not in (False, "on_input", "on_lateral", "on_output"):
            raise ValueError(f"add_extra_convs={add_extra_convs!r}")
        self.add_extra_convs = add_extra_convs

        levels = range(self.start_level, self.end_level)
        self.lateral_convs = nn.ModuleList(
            [Conv2d(in_channels[i], out_channels, 1, generator=generator)
             for i in levels]
        )
        self.fpn_convs = nn.ModuleList(
            [Conv2d(out_channels, out_channels, 3, generator=generator)
             for _ in levels]
        )
        extra_levels = num_outs - (self.end_level - self.start_level)
        self.extra_convs = nn.ModuleList(
            [
                Conv2d(in_channels[self.end_level - 1]
                       if i == 0 and add_extra_convs == "on_input" else out_channels,
                       out_channels, 3, 2, generator=generator)
                for i in range(extra_levels if add_extra_convs else 0)
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
        if not self.add_extra_convs:
            for _ in range(self.num_outs - len(outs)):
                outs.append(max_pool(outs[-1], 1, 2, "VALID"))
            return tuple(outs)
        x = {"on_input": inputs[self.end_level - 1], "on_lateral": laterals[-1],
             "on_output": outs[-1]}[self.add_extra_convs]
        for i, conv in enumerate(self.extra_convs):
            if i > 0 and self.relu_before_extra_convs:
                x = F.relu(x)
            x = conv(x)
            outs.append(x)
        return tuple(outs)
