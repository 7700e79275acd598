"""Rotated-box codecs on tensors.

Port of `jdet_tpu/ops/box_convert.py` (`norm_angle` :28, `regular_theta`
:36, `regular_obb` :45, `mintheta_obb` :58, `rbox_to_poly`
:103, `poly_to_rbox` :119, `poly_to_hbox` :140, `rbox_to_hbox` :149,
`hbox_to_rbox` :157, `rbox2delta` :232, `delta2rbox` :257, `hbox2delta`
:290, `delta2hbox` :313, `distance2obb` :368, `points_in_rbox` :385, `integral` :399,
`integral_angle` :410). All functions take arbitrary leading batch
dimensions.

Conventions: rbox = (cx, cy, w, h, theta) with theta in radians, canonical
range [-pi/4, 3*pi/4); hbox = (x1, y1, x2, y2); poly = 4 corners
(x0, y0, ..., x3, y3).
"""
from __future__ import annotations

import math

import torch

PI = math.pi


def norm_angle(angle, start=-PI / 4, rng=PI):
    """Normalize angle into [start, start + rng).

    `%` on a float tensor is `torch.remainder`, which takes the sign of the
    divisor like Python's `%` (`torch.fmod` would not)."""
    return (angle - start) % rng + start


def regular_theta(theta, mode="180", start=-PI / 2):
    """Normalize theta into [start, start + pi) ('180') or
    [start, start + 2 pi) ('360'); `%` is the floor-mod, as in JAX."""
    cycle = 2 * PI if mode == "360" else PI
    return (theta - start) % cycle + start


def regular_obb(obboxes):
    """The same box with w >= h and theta in [-pi/2, pi/2): where w <= h
    the sides swap and theta turns by pi/2."""
    x, y, w, h, theta = obboxes.split(1, dim=-1)
    wide = w > h
    return torch.cat([x, y, torch.where(wide, w, h), torch.where(wide, h, w),
                      regular_theta(torch.where(wide, theta, theta + PI / 2))], -1)


def mintheta_obb(obboxes):
    """The same box in whichever of its two (w, h, theta) forms has the
    smaller |theta| (theta in [-pi/2, pi/2); the first form on a tie)."""
    x, y, w, h, theta = obboxes.split(1, dim=-1)
    theta1 = regular_theta(theta)
    theta2 = regular_theta(theta + PI / 2)
    pick1 = theta1.abs() < theta2.abs()
    return torch.cat([x, y, torch.where(pick1, w, h), torch.where(pick1, h, w),
                      torch.where(pick1, theta1, theta2)], -1)


def distance2obb(points, distance):
    """FCOS-OBB decode: a point (..., 2) and its (l, t, r, b, theta)
    (..., 5), the distances to the box's sides in the box's frame -> the
    rbox, in `regular_obb`'s form."""
    dist, theta = distance[..., :4], distance[..., 4]
    c, s = torch.cos(theta), torch.sin(theta)
    w = dist[..., 0] + dist[..., 2]
    h = dist[..., 1] + dist[..., 3]
    ox = (dist[..., 2] - dist[..., 0]) / 2
    oy = (dist[..., 3] - dist[..., 1]) / 2
    cx = points[..., 0] + c * ox - s * oy
    cy = points[..., 1] + s * ox + c * oy
    return regular_obb(torch.stack([cx, cy, w, h, theta], -1))


def rbox_to_corners(rboxes):
    """(..., 5) rboxes -> (..., 4, 2) corners, traversed cyclically from
    the rotated (-w/2, h/2), as the reference's `rbox_to_corners` (:73)
    orders them (not `rbox_to_poly`'s order)."""
    cx, cy, w, h, a = rboxes.unbind(-1)
    cos2 = torch.cos(a) * 0.5
    sin2 = torch.sin(a) * 0.5
    x0 = cx - sin2 * h - cos2 * w
    y0 = cy + cos2 * h - sin2 * w
    x1 = cx + sin2 * h - cos2 * w
    y1 = cy - cos2 * h - sin2 * w
    xs = torch.stack([x0, x1, 2 * cx - x0, 2 * cx - x1], -1)
    ys = torch.stack([y0, y1, 2 * cy - y0, 2 * cy - y1], -1)
    return torch.stack([xs, ys], -1)


def hbox_to_cxcywh(hboxes):
    """(..., 4) (x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = hboxes.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def cxcywh_to_hbox(boxes):
    """(..., 4 + r) (cx, cy, w, h, ...) -> (x1, y1, x2, y2, ...)."""
    cx, cy, w, h = boxes[..., :4].unbind(-1)
    out = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    return torch.cat([out, boxes[..., 4:]], -1) if boxes.shape[-1] > 4 else out


def get_best_begin_point(polys):
    """(..., 8) quads with their vertices rotated (cyclic order kept) to
    start nearest the top-left of their bounding box: the rotation whose
    vertices lie least far from the box's corners (the reference's :196)."""
    p = polys.reshape(*polys.shape[:-1], 4, 2)
    lo, hi = p.amin(-2), p.amax(-2)
    dst = torch.stack([lo, torch.stack([hi[..., 0], lo[..., 1]], -1), hi,
                       torch.stack([lo[..., 0], hi[..., 1]], -1)], -2)
    idx = (torch.arange(4)[:, None] + torch.arange(4)[None, :]) % 4
    cand = p[..., idx.to(polys.device), :]  # (..., 4 rotations, 4, 2)
    force = torch.linalg.norm(cand - dst[..., None, :, :], dim=-1).sum(-1)
    best = force.argmin(-1)
    out = torch.gather(cand, -3, best[..., None, None, None].expand(*best.shape, 1, 4, 2))
    return out.reshape(*polys.shape[:-1], 8)


def distance2hbox(points, distance, max_shape=None):
    """(l, t, r, b) distances from points (..., 2) -> (x1, y1, x2, y2),
    clipped to an (h, w) max_shape if given."""
    x1 = points[..., 0] - distance[..., 0]
    y1 = points[..., 1] - distance[..., 1]
    x2 = points[..., 0] + distance[..., 2]
    y2 = points[..., 1] + distance[..., 3]
    if max_shape is not None:
        x1, x2 = x1.clamp(0, max_shape[1]), x2.clamp(0, max_shape[1])
        y1, y2 = y1.clamp(0, max_shape[0]), y2.clamp(0, max_shape[0])
    return torch.stack([x1, y1, x2, y2], -1)


def rbox_to_poly(rboxes):
    """(..., 5) rbox -> (..., 8) polygon: the rotation of
    [(-w/2,-h/2), (w/2,-h/2), (w/2,h/2), (-w/2,h/2)] by theta, translated
    to (cx, cy)."""
    cx, cy, w, h, a = rboxes.split(1, dim=-1)
    c, s = torch.cos(a), torch.sin(a)
    dx = torch.cat([-w / 2, w / 2, w / 2, -w / 2], dim=-1)
    dy = torch.cat([-h / 2, -h / 2, h / 2, h / 2], dim=-1)
    xs = cx + c * dx - s * dy
    ys = cy + s * dx + c * dy
    return torch.stack([xs, ys], dim=-1).reshape(*rboxes.shape[:-1], 8)


def poly_to_rbox(polys):
    """(..., 8) quad, a (near-)rectangle -> (..., 5) rbox: the longer of
    the first two edges gives w and the angle, normalized to
    [-pi/4, 3*pi/4); the center is the midpoint of corners 0 and 2."""
    p = polys.reshape(*polys.shape[:-1], 4, 2)
    pt1, pt2, pt3, pt4 = p.unbind(-2)
    e1 = pt1 - pt2
    e2 = pt2 - pt3
    edge1 = torch.sqrt(e1[..., 0] * e1[..., 0] + e1[..., 1] * e1[..., 1])
    edge2 = torch.sqrt(e2[..., 0] * e2[..., 0] + e2[..., 1] * e2[..., 1])
    angle1 = torch.atan2(pt2[..., 1] - pt1[..., 1], pt2[..., 0] - pt1[..., 0])
    angle2 = torch.atan2(pt4[..., 1] - pt1[..., 1], pt4[..., 0] - pt1[..., 0])
    angle = norm_angle(torch.where(edge1 > edge2, angle1, angle2))
    cx = (pt1[..., 0] + pt3[..., 0]) / 2.0
    cy = (pt1[..., 1] + pt3[..., 1]) / 2.0
    return torch.stack([cx, cy, torch.maximum(edge1, edge2),
                        torch.minimum(edge1, edge2), angle], dim=-1)


def poly_to_hbox(polys):
    """(..., 8) -> (..., 4) axis-aligned bounding box."""
    xs = polys[..., 0::2]
    ys = polys[..., 1::2]
    return torch.stack(
        [xs.amin(-1), ys.amin(-1), xs.amax(-1), ys.amax(-1)], dim=-1
    )


def rbox_to_hbox(rboxes):
    """(..., 5) -> (..., 4) enclosing axis-aligned box."""
    return poly_to_hbox(rbox_to_poly(rboxes))


def rbox2delta(proposals, gt, means=(0.0,) * 5, stds=(1.0,) * 5):
    """Rotated-box deltas in the proposal's local frame: dx/dy are the
    center offset rotated into the proposal frame, da the normalized angle
    difference / pi."""
    pw = proposals[..., 2]
    ph = proposals[..., 3]
    pa = proposals[..., 4]
    cosa = torch.cos(pa)
    sina = torch.sin(pa)
    ox = gt[..., 0] - proposals[..., 0]
    oy = gt[..., 1] - proposals[..., 1]
    dx = (cosa * ox + sina * oy) / pw
    dy = (-sina * ox + cosa * oy) / ph
    dw = torch.log(gt[..., 2].clamp(min=1e-6) / pw.clamp(min=1e-6))
    dh = torch.log(gt[..., 3].clamp(min=1e-6) / ph.clamp(min=1e-6))
    da = norm_angle(gt[..., 4] - pa) / PI
    deltas = torch.stack([dx, dy, dw, dh, da], dim=-1)
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    return (deltas - means) / stds


def delta2rbox(
    rois,
    deltas,
    means=(0.0,) * 5,
    stds=(1.0,) * 5,
    wh_ratio_clip=16 / 1000,
):
    """Inverse of rbox2delta. Handles (..., 5) or (..., K*5) deltas against
    (..., 5) rois."""
    means = deltas.new_tensor(means)
    stds = deltas.new_tensor(stds)
    k = deltas.shape[-1] // 5
    d = deltas.reshape(*deltas.shape[:-1], k, 5) * stds + means
    dx, dy, dw, dh, da = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    rx = rois[..., 0:1]
    ry = rois[..., 1:2]
    rw = rois[..., 2:3]
    rh = rois[..., 3:4]
    ra = rois[..., 4:5]
    gx = dx * rw * torch.cos(ra) - dy * rh * torch.sin(ra) + rx
    gy = dx * rw * torch.sin(ra) + dy * rh * torch.cos(ra) + ry
    gw = rw * torch.exp(dw)
    gh = rh * torch.exp(dh)
    ga = norm_angle(PI * da + ra)
    out = torch.stack([gx, gy, gw, gh, ga], dim=-1)
    return out.reshape(*deltas.shape[:-1], k * 5) if k > 1 else out[..., 0, :]


def hbox_to_rbox(hboxes):
    """(..., 4) (x1, y1, x2, y2) -> (..., 5) rbox with w >= h: theta 0 for
    a wide box, pi/2 for a tall one (w and h swapped), through
    `norm_angle`."""
    x1, y1, x2, y2 = hboxes.split(1, dim=-1)
    cx = (x1 + x2) * 0.5
    cy = (y1 + y2) * 0.5
    w = x2 - x1
    h = y2 - y1
    wide = w >= h
    theta = torch.where(wide, 0.0, PI / 2).to(w.dtype)
    return torch.cat([cx, cy, torch.where(wide, w, h), torch.where(wide, h, w),
                      norm_angle(theta)], dim=-1)


def hbox2delta(proposals, gt, means=(0.0,) * 4, stds=(1.0,) * 4):
    """Horizontal-box deltas (dx, dy, dw, dh) of gt against proposals,
    mmdet-v2's convention (no +1 on the sizes)."""
    px = (proposals[..., 0] + proposals[..., 2]) * 0.5
    py = (proposals[..., 1] + proposals[..., 3]) * 0.5
    pw = proposals[..., 2] - proposals[..., 0]
    ph = proposals[..., 3] - proposals[..., 1]
    gx = (gt[..., 0] + gt[..., 2]) * 0.5
    gy = (gt[..., 1] + gt[..., 3]) * 0.5
    gw = gt[..., 2] - gt[..., 0]
    gh = gt[..., 3] - gt[..., 1]
    dx = (gx - px) / pw.clamp(min=1e-6)
    dy = (gy - py) / ph.clamp(min=1e-6)
    dw = torch.log(gw.clamp(min=1e-6) / pw.clamp(min=1e-6))
    dh = torch.log(gh.clamp(min=1e-6) / ph.clamp(min=1e-6))
    deltas = torch.stack([dx, dy, dw, dh], dim=-1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def delta2hbox(rois, deltas, means=(0.0,) * 4, stds=(1.0,) * 4, wh_ratio_clip=16 / 1000):
    """Inverse of hbox2delta, dw and dh clipped to |log(wh_ratio_clip)|.
    Handles (..., 4) or (..., K*4) deltas against (..., 4) rois."""
    k = deltas.shape[-1] // 4
    d = deltas.reshape(*deltas.shape[:-1], k, 4) * deltas.new_tensor(stds) \
        + deltas.new_tensor(means)
    dx, dy, dw, dh = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = ((rois[..., 0] + rois[..., 2]) * 0.5)[..., None]
    py = ((rois[..., 1] + rois[..., 3]) * 0.5)[..., None]
    pw = (rois[..., 2] - rois[..., 0])[..., None]
    ph = (rois[..., 3] - rois[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    out = torch.stack([gx - gw * 0.5, gy - gh * 0.5, gx + gw * 0.5, gy + gh * 0.5], dim=-1)
    return out.reshape(*deltas.shape[:-1], k * 4) if k > 1 else out[..., 0, :]


def points_in_rbox(points, rboxes):
    """Strict containment of points (..., n, 2) in rboxes (..., m, 5) ->
    (..., n, m) bool, leading dimensions broadcast: the offset's length
    projected on the box's axes, below half its w and h."""
    off = points[..., :, None, :2] - rboxes[..., None, :, :2]
    ang = torch.atan2(off[..., 1], off[..., 0])
    dist = torch.sqrt((off * off).sum(-1))
    da = ang - rboxes[..., None, :, 4]
    dw = (dist * torch.cos(da)).abs()
    dh = (dist * torch.sin(da)).abs()
    return (dw < rboxes[..., None, :, 2] / 2) & (dh < rboxes[..., None, :, 3] / 2)


def integral(x, n, lo=-2.0, hi=2.0):
    """Distributions over n + 1 bins -> their expectations over
    linspace(lo, hi, n + 1) (GFL / LD), 4 sides: (..., 4 * (n + 1)) ->
    (rows, 4). The bins are float32, as the reference's, so the result
    is at least float32."""
    e = torch.linspace(lo, hi, n + 1, device=x.device)
    y = torch.softmax(x.reshape(-1, n + 1), dim=1)
    return (y * e).sum(dim=1).reshape(-1, 4)


def integral_angle(x, n, lo=-5.0, hi=2.0):
    """The angle's distribution over n + 1 bins -> its expectation over
    linspace(lo, hi, n + 1): (..., n + 1) -> (rows,)."""
    e = torch.linspace(lo, hi, n + 1, device=x.device)
    y = torch.softmax(x.reshape(-1, n + 1), dim=1)
    return (y * e).sum(dim=1).reshape(-1)
