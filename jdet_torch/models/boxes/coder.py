"""The midpoint-offset coder of Oriented R-CNN's RPN, the gliding-vertex
coder, and CSL's angle coder.

Port of `jdet_tpu/models/boxes/coder.py` (`midpoint_offset_encode` :23,
`midpoint_offset_decode` :60, `gv_fix_encode` :112, `gv_fix_decode` :131,
`gv_ratio_encode` :159, `CSLCoder` :176). Midpoint offset: an
oriented box is coded against a horizontal proposal (x1, y1, x2, y2) as
the hbb deltas (dx, dy, dw, dh) of its enclosing box, plus the offsets of
its topmost vertex's x and its rightmost vertex's y from that box's
center, over its width and height. Gliding vertex: a quad against its
hbb as the glide ratios of the vertices that touch the top, right,
bottom and left edges along them, and the quad's area over the hbb's.
Every function takes arbitrary leading batch dimensions.
"""
from __future__ import annotations

import math

import torch

from ...ops.box_convert import poly_to_rbox, rbox_to_hbox, rbox_to_poly


def midpoint_offset_encode(hbb_proposals, gt_rboxes, means=(0.0,) * 6, stds=(1.0,) * 6):
    """(..., 4) hbb proposals x (..., 5) gt rboxes -> (..., 6) deltas."""
    px = (hbb_proposals[..., 0] + hbb_proposals[..., 2]) * 0.5
    py = (hbb_proposals[..., 1] + hbb_proposals[..., 3]) * 0.5
    pw = (hbb_proposals[..., 2] - hbb_proposals[..., 0]).clamp(min=1e-6)
    ph = (hbb_proposals[..., 3] - hbb_proposals[..., 1]).clamp(min=1e-6)

    poly = rbox_to_poly(gt_rboxes)
    hbb = rbox_to_hbox(gt_rboxes)
    gx = (hbb[..., 0] + hbb[..., 2]) * 0.5
    gy = (hbb[..., 1] + hbb[..., 3]) * 0.5
    gw = (hbb[..., 2] - hbb[..., 0]).clamp(min=1e-6)
    gh = (hbb[..., 3] - hbb[..., 1]).clamp(min=1e-6)

    xs = poly[..., 0::2]
    ys = poly[..., 1::2]
    y_min = ys.amin(-1, keepdim=True)
    x_max = xs.amax(-1, keepdim=True)
    # x of the topmost vertex (the largest x among those within 0.1 of
    # the top), y of the rightmost vertex likewise
    ga = torch.where((ys - y_min).abs() > 0.1, -1e9, xs).amax(-1)
    gb = torch.where((xs - x_max).abs() > 0.1, -1e9, ys).amax(-1)

    deltas = torch.stack([(gx - px) / pw, (gy - py) / ph, torch.log(gw / pw),
                          torch.log(gh / ph), (ga - gx) / gw, (gb - gy) / gh], -1)
    return (deltas - deltas.new_tensor(means)) / deltas.new_tensor(stds)


def midpoint_offset_decode(hbb_proposals, deltas, means=(0.0,) * 6, stds=(1.0,) * 6,
                           wh_ratio_clip=16 / 1000):
    """Inverse of `midpoint_offset_encode`: (..., 4) proposals and
    (..., k * 6) deltas -> (..., k * 5) rboxes. The decoded midpoint
    polygon is made a rectangle by scaling each half-diagonal to the
    longest one."""
    k = deltas.shape[-1] // 6
    d = deltas.reshape(*deltas.shape[:-1], k, 6) * deltas.new_tensor(stds) \
        + deltas.new_tensor(means)
    dx, dy, dw, dh, da, db = d.unbind(-1)
    max_ratio = abs(math.log(wh_ratio_clip))
    dw = dw.clamp(-max_ratio, max_ratio)
    dh = dh.clamp(-max_ratio, max_ratio)
    px = ((hbb_proposals[..., 0] + hbb_proposals[..., 2]) * 0.5)[..., None]
    py = ((hbb_proposals[..., 1] + hbb_proposals[..., 3]) * 0.5)[..., None]
    pw = (hbb_proposals[..., 2] - hbb_proposals[..., 0])[..., None]
    ph = (hbb_proposals[..., 3] - hbb_proposals[..., 1])[..., None]
    gw = pw * torch.exp(dw)
    gh = ph * torch.exp(dh)
    gx = px + pw * dx
    gy = py + ph * dy
    x1 = gx - gw * 0.5
    y1 = gy - gh * 0.5
    x2 = gx + gw * 0.5
    y2 = gy + gh * 0.5
    da = da.clamp(-0.5, 0.5)
    db = db.clamp(-0.5, 0.5)
    ga = gx + da * gw
    _ga = gx - da * gw
    gb = gy + db * gh
    _gb = gy - db * gh
    polys = torch.stack([ga, y1, x2, gb, _ga, y2, x1, _gb], -1)
    center = torch.stack([gx, gy] * 4, -1)
    cp = polys - center
    diag = torch.sqrt(cp[..., 0::2] ** 2 + cp[..., 1::2] ** 2 + 1e-12)
    scale = diag.amax(-1, keepdim=True) / diag.clamp(min=1e-6)
    rect = cp * scale.repeat_interleave(2, -1) + center
    out = poly_to_rbox(rect)
    return out.reshape(*deltas.shape[:-1], k * 5) if k > 1 else out[..., 0, :]


def gv_fix_encode(hbbs, polys):
    """(..., 4) hbbs and (..., 8) quads (vertices in any cyclic order) ->
    (..., 4) glide ratios: the x of the vertex on the top edge from x1,
    the y of the one on the right edge from y1, the x of the one on the
    bottom edge from x2 and the y of the one on the left edge from y2,
    over the width or height. A vertex is picked by exact equality with
    the extreme coordinate (the largest x at the top, the largest y on
    the right, the smallest x at the bottom, the smallest y on the
    left), as the reference picks it."""
    xs = polys[..., 0::2]
    ys = polys[..., 1::2]
    x1, y1, x2, y2 = hbbs.unbind(-1)
    w = (x2 - x1).clamp(min=1e-6)
    h = (y2 - y1).clamp(min=1e-6)
    t_x = torch.where(ys == ys.amin(-1, keepdim=True), xs, -1e9).amax(-1)
    r_y = torch.where(xs == xs.amax(-1, keepdim=True), ys, -1e9).amax(-1)
    d_x = torch.where(ys == ys.amax(-1, keepdim=True), xs, 1e9).amin(-1)
    l_y = torch.where(xs == xs.amin(-1, keepdim=True), ys, 1e9).amin(-1)
    return torch.stack([(t_x - x1) / w, (r_y - y1) / h, (x2 - d_x) / w, (y2 - l_y) / h], -1)


def gv_fix_decode(hbbs, fix_deltas):
    """(..., 4) hbbs and (..., k * 4) glide ratios, each clipped to
    [0, 1] -> (..., k * 8) quads: the top, right, bottom and left
    vertices, in that order."""
    k = fix_deltas.shape[-1] // 4
    d = fix_deltas.reshape(*fix_deltas.shape[:-1], k, 4).clamp(0, 1)
    x1, y1, x2, y2 = (hbbs[..., i][..., None] for i in range(4))
    w = x2 - x1
    h = y2 - y1
    t_x = x1 + w * d[..., 0]
    r_y = y1 + h * d[..., 1]
    d_x = x2 - w * d[..., 2]
    l_y = y2 - h * d[..., 3]
    polys = torch.stack([t_x, y1.expand_as(t_x), x2.expand_as(r_y), r_y,
                         d_x, y2.expand_as(d_x), x1.expand_as(l_y), l_y], -1)
    return polys.reshape(*fix_deltas.shape[:-1], k * 8) if k > 1 else polys[..., 0, :]


def gv_ratio_encode(hbbs, polys):
    """(..., 4) hbbs and (..., 8) quads -> (..., 1): the quad's area (the
    shoelace formula) over the hbb's (at least 1e-6)."""
    x1, y1, x2, y2 = hbbs.unbind(-1)
    h_area = ((x2 - x1) * (y2 - y1)).clamp(min=1e-6)
    xs = polys[..., 0::2]
    ys = polys[..., 1::2]
    xs_n = torch.roll(xs, -1, -1)
    ys_n = torch.roll(ys, -1, -1)
    p_area = 0.5 * (xs * ys_n - xs_n * ys).sum(-1).abs()
    return (p_area / h_area)[..., None]


class CSLCoder:
    """Circular smooth label: an angle (radians, in [-pi/4, 3pi/4), offset
    45 degrees) -> a window (gaussian, triangle, rect or pulse) over
    180 / omega circular bins around its bin; decode takes the argmax
    bin's center, (argmax + 0.5) * omega - 45 degrees. The CSL head codes
    its encoded delta angle."""

    def __init__(self, omega=1, window="gaussian", radius=6):
        if window not in ("gaussian", "triangle", "rect", "pulse"):
            raise ValueError(f"unknown CSL window {window!r}")
        self.angle_range = 180
        self.angle_offset = 45
        self.omega = omega
        self.window = window
        self.radius = radius
        self.coding_len = int(self.angle_range // omega)

    def encode(self, angle):
        """angle (...,) radians -> (..., coding_len) smooth labels."""
        deg = angle * (180.0 / math.pi)
        # truncation toward zero, as the reference's `.long()`
        center = torch.trunc((deg + self.angle_offset) / self.omega)
        bins = torch.arange(self.coding_len, dtype=angle.dtype, device=angle.device)
        d = bins - center[..., None]
        d = (d + self.coding_len / 2) % self.coding_len - self.coding_len / 2
        if self.window == "gaussian":
            return torch.exp(-(d ** 2) / (2 * self.radius ** 2))
        if self.window == "triangle":
            return torch.where(d.abs() < self.radius, 1.0 - d.abs() / self.radius, 0.0)
        if self.window == "rect":
            # the window is [-radius, radius), as the reference scatters it
            return ((d >= -self.radius) & (d < self.radius)).to(angle.dtype)
        return (d.abs() < 0.5).to(angle.dtype)

    def decode(self, logits):
        """(..., coding_len) -> angle (...,) radians."""
        idx = logits.argmax(-1).to(logits.dtype)
        deg = ((idx + 0.5) * self.omega) % self.angle_range - self.angle_offset
        return deg * (math.pi / 180.0)
