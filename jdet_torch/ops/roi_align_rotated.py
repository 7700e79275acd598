"""Rotated RoI align, single-level and level-routed, in plain PyTorch.

Port of `jdet_tpu/ops/roi_align_rotated.py` (`roi_align_rotated` :28,
`roi_align` :58 on horizontal RoIs, `_rotated_sample_coords` :78,
`roi_align_rotated_multilevel` :110), with
the sampling semantics of `jdet_tpu/ops/deform_conv.py::
corner_weights_and_rows` (:61). Each of a RoI's out_size x out_size bins
averages sampling_ratio^2 bilinear samples on a grid rotated by theta
about the RoI's center, in the feature coordinates of the RoI's own
level (w and h clamped to >= 1 there) with the -0.5 "aligned" offset; a
sample outside (-1, H) x (-1, W) is zero, and so is every corner of a
sample that falls outside the image. Invalid RoIs give zeros.

The reference's corner table, its 8-aligned row pitch and `ops/gather.py`
are TPU layout workarounds and are not ported. Here the levels' features
are flattened into one (B * sum H_l * W_l, C) table of NHWC rows, each
RoI's 16 (4 corners x 4 samples) rows are indexed on its own level's
part of the table, and one `F.embedding_bag(mode="sum")` with the corner
weights (the bin mean folded in) reads and sums them: the (B, R, P, P,
16, C) samples are never formed, and its backward is the scatter-add of
the reference's gather. The weights are computed in the features' dtype,
as the reference casts them (:172-173).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .box_convert import hbox_to_cxcywh


def _rotated_sample_coords(rois, out_size, sampling_ratio):
    """Sample points of a rotated RoI's bins: rois (..., 5) (cx, cy, w,
    h, theta) in feature coordinates -> sy, sx (..., P, P, G), G =
    sampling_ratio^2."""
    P, g = out_size, sampling_ratio
    dev = rois.device
    cx, cy = rois[..., 0], rois[..., 1]
    w = rois[..., 2].clamp(min=1.0)
    h = rois[..., 3].clamp(min=1.0)
    theta = rois[..., 4]
    gs = (torch.arange(g, dtype=torch.float32, device=dev) + 0.5) / g
    f = torch.arange(P, dtype=torch.float32, device=dev)
    sub_y = ((f[:, None, None, None] + gs[None, None, :, None]) / P).expand(P, P, g, g)
    sub_x = ((f[None, :, None, None] + gs[None, None, None, :]) / P).expand(P, P, g, g)
    sub_y = sub_y.reshape(P, P, g * g)
    sub_x = sub_x.reshape(P, P, g * g)

    def ex(t):
        return t[..., None, None, None]

    ly = (sub_y - 0.5) * ex(h)
    lx = (sub_x - 0.5) * ex(w)
    cos = ex(torch.cos(theta))
    sin = ex(torch.sin(theta))
    sy = ex(cy) + sin * lx + cos * ly
    sx = ex(cx) + cos * lx - sin * ly
    return sy, sx


def _align(feats, rois, lvl, scales, out_size, sampling_ratio, valid):
    """The level-routed align: feats a list of (B, C, H_l, W_l), rois
    (B, R, 5) in image coordinates, lvl (B, R) int64, scales (L,) float32
    image-to-feature factors. Returns (B, R, P, P, C)."""
    B, C = feats[0].shape[:2]
    dtype = feats[0].dtype
    dev = rois.device
    hs = [f.shape[-2] for f in feats]
    ws = [f.shape[-1] for f in feats]
    offs = [0]
    for h, w in zip(hs, ws):
        offs.append(offs[-1] + h * w)
    T = offs[-1]
    table = torch.cat([f.permute(0, 2, 3, 1).reshape(B, -1, C) for f in feats], 1)

    Hl = torch.tensor(hs, device=dev)[lvl]
    Wl = torch.tensor(ws, device=dev)[lvl]
    base = torch.tensor(offs[:-1], device=dev)[lvl]
    inv = scales.to(dev)[lvl][..., None]
    rois_feat = torch.cat([rois[..., :4] * inv, rois[..., 4:5]], -1)
    sy, sx = _rotated_sample_coords(rois_feat, out_size, sampling_ratio)
    sy = sy - 0.5
    sx = sx - 0.5

    def ex(t):
        return t[..., None, None, None]

    H, W = ex(Hl), ex(Wl)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    wy = (sy - y0).to(dtype)
    wx = (sx - x0).to(dtype)
    inside = ((sy > -1) & (sy < H) & (sx > -1) & (sx < W)).to(dtype)
    G = sy.shape[-1]
    y0 = y0.long()
    x0 = x0.long()
    rows, weights = [], []
    for dy, dx, cw in ((0, 0, (1 - wy) * (1 - wx)), (0, 1, (1 - wy) * wx),
                       (1, 0, wy * (1 - wx)), (1, 1, wy * wx)):
        y, x = y0 + dy, x0 + dx
        # a corner outside the image is zero: its weight is 0, its row any
        on = (y >= 0) & (y < H) & (x >= 0) & (x < W)
        rows.append(ex(base) + y.clamp(min=0) * W + x.clamp(min=0))
        rows[-1] = torch.where(on, rows[-1], ex(base))
        weights.append(torch.where(on, cw * inside * (1.0 / G), 0.0).to(dtype))
    boff = torch.arange(B, device=dev).reshape(B, 1, 1, 1, 1) * T
    rows = torch.stack(rows, -1) + boff[..., None]  # (B, R, P, P, G, 4)
    weights = torch.stack(weights, -1)
    P = out_size
    R = rois.shape[1]
    out = F.embedding_bag(rows.reshape(-1, G * 4), table.reshape(B * T, C),
                          per_sample_weights=weights.reshape(-1, G * 4), mode="sum")
    out = out.reshape(B, R, P, P, C)
    if valid is not None:
        out = out * valid[..., None, None, None].to(out.dtype)
    return out


def roi_align_rotated(feat, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2,
                      valid=None):
    """Rotated RoI align on one level: feat (B, C, H, W), rois (B, R, 5)
    (cx, cy, w, h, theta) in image coordinates, valid (B, R) or None ->
    (B, R, out_size, out_size, C)."""
    lvl = torch.zeros(rois.shape[:2], dtype=torch.long, device=rois.device)
    scales = torch.tensor([spatial_scale], dtype=torch.float32)
    return _align([feat], rois, lvl, scales, out_size, sampling_ratio, valid)


def roi_align(feat, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2, valid=None):
    """RoI align of horizontal RoIs on one level: rois (B, R, 4) (x1, y1,
    x2, y2) in image coordinates, aligned as the zero-angle rotated RoIs of
    their centres and sizes. Returns (B, R, out_size, out_size, C)."""
    rrois = F.pad(hbox_to_cxcywh(rois), (0, 1))
    return roi_align_rotated(feat, rrois, out_size, spatial_scale, sampling_ratio, valid)


def roi_align_rotated_multilevel(feats, rois, lvl, strides, out_size=7, sampling_ratio=2,
                                 valid=None):
    """Level-routed rotated RoI align: feats a list of (B, C, H_l, W_l),
    rois (B, R, 5) in image coordinates, lvl (B, R) the level of each RoI,
    strides the levels' strides. Each RoI samples only its own level.
    Returns (B, R, out_size, out_size, C)."""
    scales = 1.0 / torch.tensor(strides, dtype=torch.float32)
    return _align(list(feats), rois, lvl.long(), scales, out_size, sampling_ratio, valid)
