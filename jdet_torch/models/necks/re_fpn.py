"""ReFPN: a feature pyramid over C8 regular fields, NCHW.

Port of `jdet_tpu/models/necks/re_fpn.py::ReFPN` (:22): lateral 1x1 and
output 3x3 C8 group convs (`models/equivariant/econv.py::REConv2d`), a
nearest top-down pathway, and the levels beyond the inputs from stride-2
3x3 group convs, the first on the last input with
add_extra_convs="on_input" (the default) and on the last output
otherwise, as the reference builds them for any value of the option.
Channel counts are totals (fields * 8).
"""
from __future__ import annotations

from typing import Sequence

from torch import nn

from ...utils.registry import NECKS
from ..equivariant.econv import N_ORIENT, REConv2d
from ..layers import resize_nearest


@NECKS.register_module()
class ReFPN(nn.Module):
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
        if out_channels % N_ORIENT:
            raise ValueError(f"out_channels {out_channels} is not a multiple of {N_ORIENT}")
        out_f = out_channels // N_ORIENT
        in_fields = [c // N_ORIENT for c in in_channels]
        self.num_ins = len(in_channels)
        self.num_outs = num_outs
        self.start_level = start_level
        self.add_extra_convs = add_extra_convs
        levels = range(start_level, self.num_ins)
        self.lateral_convs = nn.ModuleList(
            [REConv2d(in_fields[i], out_f, 1, generator=generator) for i in levels])
        self.fpn_convs = nn.ModuleList(
            [REConv2d(out_f, out_f, 3, generator=generator) for _ in levels])
        n_extra = num_outs - (self.num_ins - start_level)
        self.extra_convs = nn.ModuleList([
            REConv2d(in_fields[-1] if i == 0 and add_extra_convs == "on_input" else out_f,
                     out_f, 3, stride=2, generator=generator)
            for i in range(n_extra)
        ])
        self.out_channels = out_channels

    def forward(self, inputs):
        laterals = [conv(inputs[self.start_level + i])
                    for i, conv in enumerate(self.lateral_convs)]
        for i in range(len(laterals) - 1, 0, -1):
            laterals[i - 1] = laterals[i - 1] + resize_nearest(laterals[i],
                                                               laterals[i - 1].shape[-2:])
        outs = [conv(lat) for conv, lat in zip(self.fpn_convs, laterals)]
        x = inputs[-1] if self.add_extra_convs == "on_input" else outs[-1]
        for conv in self.extra_convs:
            x = conv(x)
            outs.append(x)
        return tuple(outs)
