"""Level-routed rotated RoI feature extraction.

Port of `jdet_tpu/models/roi_extractors/single_level.py` (`_map_levels`
:31, `SingleRoIExtractor` :37, `OrientedSingleRoIExtractor` :72): each
RoI goes to the FPN level clamp(floor(log2(sqrt(w * h) / finest_scale)),
0, L - 1) and is aligned there only
(`ops/roi_align_rotated.py::roi_align_rotated_multilevel`). A horizontal
RoI (x1, y1, x2, y2) is aligned as the rotated RoI (cx, cy, w, h, 0); a
rotated one has its w and h first scaled by `extend_factor`.
"""
from __future__ import annotations

import torch

from ...ops.roi_align_rotated import roi_align_rotated_multilevel


def _map_levels(scale, num_levels, finest_scale=56):
    lvl = torch.floor(torch.log2(scale / finest_scale + 1e-6))
    return lvl.clamp(0, num_levels - 1).long()


class SingleRoIExtractor:
    """Horizontal RoIs (B, R, 4) -> (B, R, out_size, out_size, C)
    features, from the first len(featmap_strides) of the pyramid's
    levels."""

    def __init__(self, out_size=7, sampling_ratio=2, featmap_strides=(4, 8, 16, 32),
                 finest_scale=56):
        self.out_size = out_size
        self.sampling_ratio = sampling_ratio
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale

    def __call__(self, feats, rois, valid=None):
        num_levels = len(self.featmap_strides)
        w = rois[..., 2] - rois[..., 0]
        h = rois[..., 3] - rois[..., 1]
        lvl = _map_levels(torch.sqrt((w * h).clamp(min=1e-6)), num_levels, self.finest_scale)
        rrois = torch.stack([(rois[..., 0] + rois[..., 2]) * 0.5,
                             (rois[..., 1] + rois[..., 3]) * 0.5, w, h, torch.zeros_like(w)], -1)
        return roi_align_rotated_multilevel(feats[:num_levels], rrois, lvl,
                                            self.featmap_strides, self.out_size,
                                            self.sampling_ratio, valid)


class OrientedSingleRoIExtractor:
    """Rotated RoIs (B, R, 5) -> (B, R, out_size, out_size, C) features,
    from the first len(featmap_strides) of the pyramid's levels."""

    def __init__(self, out_size=7, sampling_ratio=2, featmap_strides=(4, 8, 16, 32),
                 finest_scale=56, extend_factor=(1.0, 1.0)):
        self.out_size = out_size
        self.sampling_ratio = sampling_ratio
        self.featmap_strides = tuple(featmap_strides)
        self.finest_scale = finest_scale
        self.extend_factor = tuple(extend_factor)

    def __call__(self, feats, rois, valid=None):
        num_levels = len(self.featmap_strides)
        ew, eh = self.extend_factor
        rois = torch.cat([rois[..., :2], rois[..., 2:3] * ew, rois[..., 3:4] * eh,
                          rois[..., 4:5]], -1)
        scale = torch.sqrt((rois[..., 2] * rois[..., 3]).clamp(min=1e-6))
        lvl = _map_levels(scale, num_levels, self.finest_scale)
        return roi_align_rotated_multilevel(feats[:num_levels], rois, lvl,
                                            self.featmap_strides, self.out_size,
                                            self.sampling_ratio, valid)
