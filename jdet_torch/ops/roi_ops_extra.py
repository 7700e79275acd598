"""Position-sensitive RoI align, RoI max-pool, deformable RoI pooling and
R3Det's feature refinement module, NCHW features, in plain PyTorch.

Port of `jdet_tpu/ops/roi_ops_extra.py` (`psroi_align` :18, `roi_pool`
:50, `dcn_v2_pooling` :92, `DCNPooling` :160, `FeatureRefineModule`
:216). The first two run on `roi_align_rotated.py`'s hbb `roi_align`, the
deformable pooling on one `F.embedding_bag` over the features' NHWC rows
(as the align does), with the reference's clipped bilinear corners.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d, Linear
from .deform_conv import bilinear_sample
from .roi_align_rotated import roi_align


def psroi_align(feat, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2, valid=None):
    """Position-sensitive RoI align: feat (B, C_out * P * P, H, W), rois
    (B, R, 4) (x1, y1, x2, y2); bin (i, j) reads channel group i * P + j
    of each output channel (channel c_out * P * P + i * P + j). Returns
    (B, R, P, P, C_out)."""
    B, C = feat.shape[:2]
    P = out_size
    c_out = C // (P * P)
    aligned = roi_align(feat, rois, P, spatial_scale, sampling_ratio, valid)  # (B, R, P, P, C)
    x = aligned.reshape(B, -1, P, P, c_out, P * P)
    bins = torch.arange(P * P, device=feat.device).reshape(1, 1, P, P, 1, 1)
    return torch.gather(x, -1, bins.expand(*x.shape[:-1], 1))[..., 0]


def roi_pool(feat, rois, out_size=7, spatial_scale=1.0, valid=None):
    """RoI max pooling: a (4 P, 4 P) grid of single bilinear samples per
    RoI (rois (B, R, 4)), max over each 4 x 4 window. Returns (B, R, P,
    P, C)."""
    g = 4
    dense = roi_align(feat, rois, out_size * g, spatial_scale, 1, valid)
    B, R, _, _, C = dense.shape
    return dense.reshape(B, R, out_size, g, out_size, g, C).amax((3, 5))


def dcn_v2_pooling(feat, rois, offset=None, spatial_scale=1.0, pooled_size=7,
                   no_trans=False, group_size=1, part_size=None, sample_per_part=4,
                   trans_std=0.0):
    """Deformable (position-sensitive) RoI pooling, as the reference's
    CUDA kernel `dcn_v2_pooling_forward` does it: each of the P x P bins
    averages the sample_per_part^2 bilinear samples that lie within half a
    pixel of the map, each bin shifted by trans_std * offset * the RoI's
    size; with group_size G > 1, output channel c of bin (i, j) reads
    input channel (c * G + g_i) * G + g_j.

    feat (B, C, H, W); rois (R, 5) (batch index, x1, y1, x2, y2); offset
    (R, 2, part, part) (dx, dy) or None. Returns (R, P, P, C // G^2)."""
    B, C, H, W = feat.shape
    R = rois.shape[0]
    P, S, G = pooled_size, sample_per_part, group_size
    part = part_size or P
    dev, dt = feat.device, feat.dtype

    bidx = rois[:, 0].long()
    x1 = torch.round(rois[:, 1]) * spatial_scale - 0.5
    y1 = torch.round(rois[:, 2]) * spatial_scale - 0.5
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale - 0.5
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale - 0.5
    rw = (x2 - x1).clamp(min=0.1)
    rh = (y2 - y1).clamp(min=0.1)
    bin_w = (rw / P)[:, None, None]
    bin_h = (rh / P)[:, None, None]

    ph = torch.arange(P, device=dev)
    part_h = ((ph * part) // P).clamp(0, part - 1)
    if no_trans or offset is None:
        tx = ty = torch.zeros(R, P, P, dtype=dt, device=dev)
    else:
        tx = offset[:, 0][:, part_h][:, :, part_h] * trans_std
        ty = offset[:, 1][:, part_h][:, :, part_h] * trans_std
    phf = ph.to(dt)
    wstart = phf[None, None, :] * bin_w + x1[:, None, None] + tx * rw[:, None, None]
    hstart = phf[None, :, None] * bin_h + y1[:, None, None] + ty * rh[:, None, None]

    ii = torch.arange(S, device=dev).to(dt)
    wpos = wstart[..., None, None] + ii * (bin_w / S)[..., None, None]  # (R, P, P, 1, S)
    hpos = hstart[..., None, None] + ii[:, None] * (bin_h / S)[..., None, None]  # (R, P, P, S, 1)
    wpos, hpos = torch.broadcast_tensors(wpos, hpos)  # (R, P, P, S, S)
    ok = (wpos >= -0.5) & (wpos <= W - 0.5) & (hpos >= -0.5) & (hpos <= H - 0.5)
    wc = wpos.clamp(0.0, W - 1.0)
    hc = hpos.clamp(0.0, H - 1.0)
    y0 = torch.floor(hc)
    x0 = torch.floor(wc)
    wy = hc - y0
    wx = wc - x0
    count = ok.sum((-1, -2), keepdim=True).clamp(min=1).to(dt)
    keep = ok.to(dt) / count
    base = (bidx * H * W).reshape(R, 1, 1, 1, 1)
    rows, weights = [], []
    for dy, dx, cw in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        # the reference clips each corner's index into the map
        y = (y0 + dy).clamp(0, H - 1).long()
        x = (x0 + dx).clamp(0, W - 1).long()
        rows.append(base + y * W + x)
        weights.append(cw * keep)
    rows = torch.stack(rows, -1).reshape(R * P * P, S * S * 4)
    weights = torch.stack(weights, -1).reshape(R * P * P, S * S * 4)
    table = feat.permute(0, 2, 3, 1).reshape(B * H * W, C)
    out = F.embedding_bag(rows, table, per_sample_weights=weights, mode="sum")
    out = out.reshape(R, P, P, C)
    if G > 1:
        c_out = C // (G * G)
        gh = ((ph * G) // P).clamp(0, G - 1)
        cidx = (torch.arange(c_out, device=dev)[None, None, :] * G
                + gh[:, None, None]) * G + gh[None, :, None]
        out = torch.gather(out, -1, cidx[None].expand(R, P, P, c_out))
    return out


class DCNPooling(nn.Module):
    """Deformable RoI pooling with learned offsets and mask (the
    reference's `DCNPooling`, :160): a pooling pass without offsets feeds
    an MLP (fc1, fc2 with ReLU; fc3 zero-initialised) that predicts per bin
    (dx, dy, mask logit); the second, shifted pass is scaled by the mask's
    sigmoid. The MLP reads each RoI's (P, P, C) features flattened in that
    (NHWC) order, as the reference does, so its weights carry over."""

    def __init__(self, spatial_scale, pooled_size, output_dim, no_trans, group_size=1,
                 part_size=None, sample_per_part=4, trans_std=0.0, deform_fc_dim=1024, *,
                 generator=None):
        super().__init__()
        self.spatial_scale = spatial_scale
        self.pooled_size = pooled_size
        self.output_dim = output_dim
        self.no_trans = no_trans
        self.group_size = group_size
        self.part_size = part_size or pooled_size
        self.sample_per_part = sample_per_part
        self.trans_std = trans_std
        if not no_trans:
            P = pooled_size
            self.fc1 = Linear(P * P * output_dim, deform_fc_dim, generator=generator)
            self.fc2 = Linear(deform_fc_dim, deform_fc_dim, generator=generator)
            self.fc3 = Linear(deform_fc_dim, P * P * 3, kernel_init=lambda w, g: w.zero_(),
                              generator=generator)

    def _pool(self, feat, rois, offset, no_trans):
        return dcn_v2_pooling(feat, rois, offset, spatial_scale=self.spatial_scale,
                              pooled_size=self.pooled_size, no_trans=no_trans,
                              group_size=self.group_size, part_size=self.part_size,
                              sample_per_part=self.sample_per_part, trans_std=self.trans_std)

    def forward(self, feat, rois):
        """feat (B, C, H, W), rois (R, 5) -> (R, P, P, output_dim)."""
        if self.no_trans:
            return self._pool(feat, rois, None, True)
        P = self.pooled_size
        n = rois.shape[0]
        x = torch.relu(self.fc1(self._pool(feat, rois, None, True).reshape(n, -1)))
        x = torch.relu(self.fc2(x))
        om = self.fc3(x).reshape(n, 3, P, P)
        mask = torch.sigmoid(om[:, 2])
        return self._pool(feat, rois, om[:, :2], False) * mask[..., None]


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
