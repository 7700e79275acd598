"""R3Det's feature refinement module, NCHW.

Port of `jdet_tpu/ops/roi_ops_extra.py::FeatureRefineModule` (:216). The
rest of that file (position-sensitive RoI align, RoI max-pool) is not
ported yet (ROADMAP queue 1).
"""
from __future__ import annotations

import torch
from torch import nn

from ..models.layers import Conv2d
from .deform_conv import bilinear_sample


class FeatureRefineModule(nn.Module):
    """Re-samples each level's features at its refined boxes' centres (and,
    with points=5, at their four edge midpoints, summed) and adds that to
    the features as a residual. The sampled map is a 5x1 then 1x5 conv
    (explicit (2, 2) pads, not flax's SAME) plus a 1x1 conv of the level's
    features. Centres are the boxes' pixel coordinates over the level's
    stride, with no half-pixel shift."""

    def __init__(self, in_channels, featmap_strides=(8, 16, 32, 64, 128), points=1, *,
                 generator=None):
        super().__init__()
        if points not in (1, 5):
            raise ValueError(f"points must be 1 or 5, got {points}")
        self.points = points
        self.featmap_strides = tuple(featmap_strides)
        self.conv_5_1 = Conv2d(in_channels, in_channels, (5, 1), padding=(2, 0),
                               generator=generator)
        self.conv_1_5 = Conv2d(in_channels, in_channels, (1, 5), padding=(0, 2),
                               generator=generator)
        self.conv_1_1 = Conv2d(in_channels, in_channels, 1, generator=generator)

    def refine_single(self, x, boxes, stride):
        """x (B, C, H, W); boxes (B, H, W, 5) in image coordinates."""
        feat = self.conv_1_5(self.conv_5_1(x)) + self.conv_1_1(x)
        cx = boxes[..., 0] / stride
        cy = boxes[..., 1] / stride
        if self.points == 1:
            return x + bilinear_sample(feat, cy, cx)
        w = boxes[..., 2] / stride
        h = boxes[..., 3] / stride
        cos, sin = torch.cos(boxes[..., 4]), torch.sin(boxes[..., 4])
        pts_x = torch.stack([cx, cx + cos * w / 2, cx - cos * w / 2,
                             cx - sin * h / 2, cx + sin * h / 2], -1)
        pts_y = torch.stack([cy, cy + sin * w / 2, cy - sin * w / 2,
                             cy + cos * h / 2, cy - cos * h / 2], -1)
        return x + bilinear_sample(feat, pts_y, pts_x).sum(-1)

    def forward(self, feats, refine_boxes):
        """feats: [(B, C, H, W)] per level; refine_boxes: [(B, H, W, 5)]."""
        return [self.refine_single(x, b, s)
                for x, b, s in zip(feats, refine_boxes, self.featmap_strides)]
