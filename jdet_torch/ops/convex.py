"""Convex geometry over small point sets (RepPoints' 9 points, quads).

Port of `jdet_tpu/ops/convex.py` (`_prev_next_valid` :27,
`convex_hull_mask` :44, `_clip_ring` :83, `_ring_area` :110,
`hull_quad_intersection_area` :120, `hull_area` :139, `_quad_ccw` :144,
`convex_iou` :151, `convex_iou_chunked` :172, `convex_giou` :188,
`convex_giou_loss` :212, `min_area_rect` :223), plain PyTorch:

  - the hull: points sorted by angle about their centroid (a stable
    sort, as `jnp.argsort`: equal angles keep their order), then a masked sweep
    that drops every corner whose cross product is not above 1e-12, `n`
    times, never below 3 points;
  - hull ∩ quad: Sutherland-Hodgman against the quad's four half-planes
    (the quad turned counter-clockwise first), the shoelace area of what
    is left.

The reference keeps each ring in a masked buffer that doubles at every
clip (9 -> 18 -> 36 -> 72 -> 144 slots) and finds a slot's neighbours
with an (n, n) table. Here a ring is compacted after each clip: its
valid vertices, in the reference's order, at the front of a buffer as
wide as the longest ring of the batch (`_compact`), so a vertex's next
is the next slot, the first after the last. The vertices, their order
and every product are the reference's; only the sums' order differs.
`_prev_next_valid` (the hull sweep's, on the uncompacted sorted slots)
takes a cumulative min/max over the doubled ring: O(n), the same indices
as the reference's table, a row with no valid slot giving 0 and one with
a single valid slot itself.

`convex_iou` evaluates only the pairs whose axis-aligned boxes overlap
(and, in `convex_iou_batched`, only real gt rows): every other pair is
0.0, as the reference's clip makes it, and the pairs are clipped
`PAIR_CHUNK` at a time. The GIoU's gradient is autograd's through the same
operations, as the reference takes `jax.grad`'s: `torch.maximum` (ties
split the gradient, as `jnp.maximum`'s), `torch.where`, and `_abs`,
whose gradient at 0 is +1 as `jnp.abs`'s (a degenerate hull's area is
exactly 0).
"""
from __future__ import annotations

import torch

from .box_convert import regular_obb

CROSS_EPS = 1e-12
PAIR_CHUNK = 65536  # pairs clipped at once


def _prev_next_valid(valid):
    """For each slot of a ring (..., n), the index of the previous and of
    the next valid slot, the slot itself excluded unless it is the only
    one; 0 where no slot is valid."""
    n = valid.shape[-1]
    idx = torch.arange(2 * n, device=valid.device)
    v2 = torch.cat([valid, valid], -1)
    # next: the least q in (i, i + n] of the doubled ring that is valid
    suffix_min = torch.where(v2, idx, 2 * n).flip(-1).cummin(-1).values.flip(-1)
    nq = suffix_min[..., 1:n + 1]
    nxt = torch.where(nq < 2 * n, nq % n, 0)
    # previous: the largest q in [i, i + n) that is valid
    prefix_max = torch.where(v2, idx, -1).cummax(-1).values
    pq = prefix_max[..., n - 1:2 * n - 1]
    prv = torch.where(pq >= 0, pq % n, 0)
    return prv, nxt


def _seq_sum(x, dim=-1):
    """Sum along `dim` left to right, in the reference's order (XLA's
    reduction on the CPU): a ring's zero slots then add nothing, and the
    compacted ring sums to the reference's masked one."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _abs(x):
    """|x| with `jnp.abs`'s gradient: +1 at 0 (torch's `abs` gives 0
    there, where a degenerate ring's area lives)."""
    return torch.where(x >= 0, x, -x)


def _take(x, idx):
    """x (..., n, 2) gathered along the slots by idx (..., m)."""
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, x.shape[-1]))


def convex_hull_mask(pts):
    """(order, hull mask in sorted order, sorted points) of (..., n, 2)
    point sets: `order` sorts the points by angle about their centroid;
    the mask marks the sorted slots that survive the concavity sweep (the
    hull's vertices, counter-clockwise)."""
    n = pts.shape[-2]
    center = _seq_sum(pts, -2)[..., None, :] / n
    rel = pts - center
    order = torch.argsort(torch.atan2(rel[..., 1], rel[..., 0]), dim=-1, stable=True)
    p = _take(pts, order)
    keep = torch.ones(pts.shape[:-1], dtype=torch.bool, device=pts.device)
    for _ in range(n):
        prv, nxt = _prev_next_valid(keep)
        e1 = p - _take(p, prv)
        e2 = _take(p, nxt) - p
        cross = e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]
        new_keep = keep & (cross > CROSS_EPS)
        enough = new_keep.sum(-1, keepdim=True) >= 3
        keep = torch.where(enough, new_keep, keep)
    return order, keep, p


def _compact(x, y, v):
    """The valid slots of masked rings (..., w), in order, at the front of
    buffers as wide as the longest ring: (x, y, counts)."""
    count = v.sum(-1)
    width = max(int(count.max()), 1) if count.numel() else 1
    idx = torch.argsort((~v).to(torch.int8), dim=-1, stable=True)[..., :width]
    return torch.gather(x, -1, idx), torch.gather(y, -1, idx), count


def _next_slot(x, count):
    """The slot after each of a compacted ring's, the first after the
    last."""
    i = torch.arange(x.shape[-1], device=x.device)
    return torch.where(i + 1 < count[..., None], i + 1, 0).expand_as(x)


def _clip_ring(px, py, count, ax, ay, bx, by):
    """One Sutherland-Hodgman step on compacted rings: each vertex if it
    lies inside (left of a->b, counter-clockwise), then the crossing of
    its edge to the next if the edge crosses; the result compacted."""
    valid = torch.arange(px.shape[-1], device=px.device) < count[..., None]
    nxt = _next_slot(px, count)
    nx_ = torch.gather(px, -1, nxt)
    ny_ = torch.gather(py, -1, nxt)
    ex = bx - ax
    ey = by - ay
    d1 = ex * (py - ay) - ey * (px - ax)
    d2 = ex * (ny_ - ay) - ey * (nx_ - ax)
    in1 = d1 >= 0
    in2 = d2 >= 0
    denom = torch.where((d1 - d2).abs() < 1e-12, 1.0, d1 - d2)
    t = d1 / denom
    ix = px + t * (nx_ - px)
    iy = py + t * (ny_ - py)
    out_x = torch.stack([px, ix], -1).flatten(-2)
    out_y = torch.stack([py, iy], -1).flatten(-2)
    out_v = torch.stack([valid & in1, valid & (in1 != in2)], -1).flatten(-2)
    return _compact(out_x, out_y, out_v)


def _ring_area(px, py, count):
    """Shoelace area of compacted counter-clockwise rings."""
    nxt = _next_slot(px, count)
    cross = px * torch.gather(py, -1, nxt) - torch.gather(px, -1, nxt) * py
    valid = torch.arange(px.shape[-1], device=px.device) < count[..., None]
    return 0.5 * _abs(_seq_sum(torch.where(valid, cross, 0.0)))


def hull_ring(pts):
    """The hull of (..., n, 2) point sets as compacted rings: (x, y,
    counts)."""
    _, keep, p = convex_hull_mask(pts)
    return _compact(p[..., 0], p[..., 1], keep)


def _clip_by_quad(px, py, count, quad):
    for e in range(4):
        a, b = quad[..., e, :], quad[..., (e + 1) % 4, :]
        px, py, count = _clip_ring(px, py, count, a[..., 0:1], a[..., 1:2], b[..., 0:1],
                                   b[..., 1:2])
    return _ring_area(px, py, count)


def hull_quad_intersection_area(pts, quad):
    """area(hull(pts) ∩ quad). pts (..., n, 2); quad (..., 4, 2)
    counter-clockwise."""
    return _clip_by_quad(*hull_ring(pts), quad)


def hull_area(pts):
    return _ring_area(*hull_ring(pts))


def _quad_ccw(quad):
    """(..., 4, 2) quads, reversed where they turn clockwise."""
    x, y = quad[..., 0], quad[..., 1]
    s = _seq_sum(x * y.roll(-1, -1) - x.roll(-1, -1) * y)
    return torch.where(s[..., None, None] < 0, quad.flip(-2), quad)


def poly_area(polys):
    """Shoelace area of (..., 8) quads, either orientation."""
    xs, ys = polys[..., 0::2], polys[..., 1::2]
    return 0.5 * _abs(_seq_sum(xs * ys.roll(-1, -1) - xs.roll(-1, -1) * ys))


def _iou(inter, a_p, a_g):
    union = a_p + a_g - inter
    return torch.where(union > 1e-9, inter / torch.maximum(union, union.new_tensor(1e-9)), 0.0)


def _pair_ious(hull, a_p, quads, a_g, pi, gi):
    """The IoU of hull rings `hull` (x, y, counts) at rows `pi` against
    quads at rows `gi`, `PAIR_CHUNK` pairs at a time."""
    hx, hy, hc = hull
    out = []
    for s in range(0, pi.numel(), PAIR_CHUNK):
        i, j = pi[s:s + PAIR_CHUNK], gi[s:s + PAIR_CHUNK]
        # a chunk's rings are cut to its own longest
        w = max(int(hc[i].max()), 1)
        inter = _clip_by_quad(hx[i, :w], hy[i, :w], hc[i], quads[j])
        out.append(_iou(inter, a_p[i], a_g[j]))
    return torch.cat(out) if out else a_p.new_zeros(0)


def _overlapping(pts_lo, pts_hi, q_lo, q_hi):
    """Whether axis-aligned boxes (.., 2) overlap or touch, broadcast."""
    return ((pts_lo[..., 0] <= q_hi[..., 0]) & (q_lo[..., 0] <= pts_hi[..., 0])
            & (pts_lo[..., 1] <= q_hi[..., 1]) & (q_lo[..., 1] <= pts_hi[..., 1]))


def convex_iou_batched(pointsets, gt_polys, gt_mask=None):
    """IoU of each image's point-set hulls with its gt quads: pointsets
    (B, N, 2P), gt_polys (B, K, 8), gt_mask (B, K) -> (B, K, N). Pairs
    whose boxes are disjoint, and rows outside `gt_mask`, are 0."""
    B, N, _ = pointsets.shape
    K = gt_polys.shape[1]
    pts = pointsets.reshape(B, N, -1, 2)
    hull = hull_ring(pts.reshape(B * N, -1, 2))
    a_p = _ring_area(*hull)
    quads = _quad_ccw(gt_polys.reshape(B * K, 4, 2))
    a_g = poly_area(gt_polys).reshape(B * K)
    q = gt_polys.reshape(B, K, 4, 2)
    pairs = _overlapping(pts.amin(2)[:, None], pts.amax(2)[:, None],
                         q.amin(2)[:, :, None], q.amax(2)[:, :, None])  # (B, K, N)
    if gt_mask is not None:
        pairs &= gt_mask[..., None]
    b, k, n = pairs.nonzero(as_tuple=True)
    ious = _pair_ious(hull, a_p, quads, a_g, b * N + n, b * K + k)
    out = pointsets.new_zeros(B, K, N)
    out[b, k, n] = ious
    return out


def convex_iou(pointsets, gt_polys):
    """Pairwise IoU of the hulls of pointsets (n, 2P) with gt quads
    (m, 8): (n, m), the reference's `convex_iou` (and
    `convex_iou_chunked`, whose chunks only bound its memory)."""
    return convex_iou_batched(pointsets[None], gt_polys[None])[0].T


def convex_giou(pointsets, gt_polys):
    """Aligned convex GIoU: pointsets (n, 2P) against gt quads (n, 8)."""
    n = pointsets.shape[0]
    pts = pointsets.reshape(n, -1, 2)
    quad = _quad_ccw(gt_polys.reshape(n, 4, 2))
    hx, hy, hc = hull_ring(pts)
    inter = _clip_by_quad(hx, hy, hc, quad)
    a_p = _ring_area(hx, hy, hc)
    union = a_p + poly_area(gt_polys) - inter
    iou = inter / torch.maximum(union, union.new_tensor(1e-9))
    c_area = hull_area(torch.cat([pts, quad], -2))
    return iou - (c_area - union) / torch.maximum(c_area, c_area.new_tensor(1e-9))


def convex_giou_loss(pointsets, gt_polys, weight=None, avg_factor=None):
    """1 - GIoU, summed and divided by `avg_factor` (the number of pairs
    by default; at least 1)."""
    loss = 1.0 - convex_giou(pointsets, gt_polys)
    if weight is not None:
        loss = loss * weight
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1)
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=loss.dtype,
                                                    device=loss.device), min=1.0)


def min_area_rect(pointsets):
    """The least-area rectangle holding each (..., n, 2) point set, over
    the hull's edge directions (the first such edge in the hull's order):
    (..., 5) rboxes, `regular_obb`'s form."""
    _, keep, p = convex_hull_mask(pointsets)
    _, nxt = _prev_next_valid(keep)
    edge = _take(p, nxt) - p
    theta = torch.atan2(edge[..., 1], edge[..., 0])  # (..., n)
    c = torch.cos(-theta)[..., None]
    s = torch.sin(-theta)[..., None]
    x = p[..., None, :, 0]
    y = p[..., None, :, 1]
    rx = c * x - s * y
    ry = s * x + c * y
    vmask = keep[..., None, :]
    big = 1e18
    min_x = torch.where(vmask, rx, big).amin(-1)
    max_x = torch.where(vmask, rx, -big).amax(-1)
    min_y = torch.where(vmask, ry, big).amin(-1)
    max_y = torch.where(vmask, ry, -big).amax(-1)
    areas = torch.where(keep, (max_x - min_x) * (max_y - min_y), big)
    best = areas.argmin(-1, keepdim=True)

    def take(a):
        return torch.gather(a, -1, best)[..., 0]

    bx0, bx1, by0, by1, bth = (take(a) for a in (min_x, max_x, min_y, max_y, theta))
    cxr = (bx0 + bx1) / 2
    cyr = (by0 + by1) / 2
    cbt, sbt = torch.cos(bth), torch.sin(bth)
    cx = cbt * cxr - sbt * cyr
    cy = sbt * cxr + cbt * cyr
    return regular_obb(torch.stack([cx, cy, bx1 - bx0, by1 - by0, bth], -1))
