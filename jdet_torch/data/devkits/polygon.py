"""Host-side polygon geometry: IoU and NMS over quads.

Port of `jdet_tpu/data/devkits/polygon.py` (`poly_iou` :100,
`poly_iou_aligned` :120, `nms_poly_np` :126 and the helpers they use),
for evaluation and tile merging. As in the reference, `poly_iou` and
`nms_poly_np` run on the native library (`csrc/polygon.cpp`, built with
g++ by `ops/polygon_native.py`); `poly_iou_plain` and `nms_poly_plain`
are the numpy versions of the same functions, which the tests hold the
library against. Sutherland–Hodgman clipping gives the exact convex
intersection area.
"""
from __future__ import annotations

import numpy as np

from ...ops import polygon_native


def _polygon_area(pts_x, pts_y, counts):
    """Shoelace over (N, V) vertex buffers with per-row counts."""
    n, v = pts_x.shape
    idx = np.arange(v)
    nxt = (idx + 1) % np.maximum(counts, 1)[:, None]
    take = idx[None, :] < counts[:, None]
    x2 = np.take_along_axis(pts_x, nxt, 1)
    y2 = np.take_along_axis(pts_y, nxt, 1)
    cross = pts_x * y2 - x2 * pts_y
    return 0.5 * np.abs(np.where(take, cross, 0.0).sum(1))


def quad_area(quads):
    q = quads.reshape(-1, 4, 2)
    x, y = q[..., 0], q[..., 1]
    x2 = np.roll(x, -1, 1)
    y2 = np.roll(y, -1, 1)
    return 0.5 * np.abs((x * y2 - x2 * y).sum(1))


def _clip_polys(px, py, counts, ax, ay, bx, by):
    """Clip each polygon (px, py, counts) by the half-plane left of a->b
    (counter-clockwise interior). Vectorized Sutherland–Hodgman step."""
    n, v = px.shape
    out_x = np.zeros((n, v + 1))
    out_y = np.zeros((n, v + 1))
    out_c = np.zeros(n, np.int64)
    ex = bx - ax
    ey = by - ay
    for i in range(v):
        valid = i < counts
        j = (i + 1) % np.maximum(counts, 1)
        cx_, cy_ = px[:, i], py[:, i]
        nx_ = np.take_along_axis(px, j[:, None], 1)[:, 0]
        ny_ = np.take_along_axis(py, j[:, None], 1)[:, 0]
        d1 = ex * (cy_ - ay) - ey * (cx_ - ax)
        d2 = ex * (ny_ - ay) - ey * (nx_ - ax)
        in1 = d1 >= 0
        in2 = d2 >= 0
        denom = np.where(np.abs(d1 - d2) < 1e-12, 1.0, d1 - d2)
        t = d1 / denom
        ix = cx_ + t * (nx_ - cx_)
        iy = cy_ + t * (ny_ - cy_)
        # emit current vertex if inside
        emit1 = valid & in1
        pos = out_c.copy()
        rows = np.where(emit1)[0]
        out_x[rows, pos[rows]] = cx_[rows]
        out_y[rows, pos[rows]] = cy_[rows]
        out_c = out_c + emit1
        # emit intersection if edge crosses
        emit2 = valid & (in1 != in2)
        pos = out_c.copy()
        rows = np.where(emit2)[0]
        out_x[rows, pos[rows]] = ix[rows]
        out_y[rows, pos[rows]] = iy[rows]
        out_c = out_c + emit2
    return out_x, out_y, out_c


def _ensure_ccw(quads):
    q = quads.reshape(-1, 4, 2).astype(np.float64)
    x, y = q[..., 0], q[..., 1]
    x2 = np.roll(x, -1, 1)
    y2 = np.roll(y, -1, 1)
    signed = 0.5 * (x * y2 - x2 * y).sum(1)
    flip = signed < 0
    q[flip] = q[flip, ::-1]
    return q


def poly_intersection_areas(p1, p2):
    """(n, 8) x (n, 8) aligned quads -> (n,) exact intersection areas."""
    p1 = _ensure_ccw(p1)
    p2 = _ensure_ccw(p2)
    px = np.concatenate([p1[..., 0], np.zeros((len(p1), 4))], 1)
    py = np.concatenate([p1[..., 1], np.zeros((len(p1), 4))], 1)
    counts = np.full(len(p1), 4, np.int64)
    for e in range(4):
        ax, ay = p2[:, e, 0], p2[:, e, 1]
        bx, by = p2[:, (e + 1) % 4, 0], p2[:, (e + 1) % 4, 1]
        px, py, counts = _clip_polys(px[:, :8], py[:, :8], counts, ax, ay, bx, by)
    return _polygon_area(px, py, counts)


def poly_iou(p1, p2):
    """Pairwise IoU matrix (n, m) of 8-coord quads (reference `iou_poly`,
    ops/nms_poly.py:247), on the native library."""
    return polygon_native.poly_iou_matrix(p1, p2)


def poly_iou_plain(p1, p2):
    """`poly_iou` in numpy."""
    n, m = len(p1), len(p2)
    if n == 0 or m == 0:
        return np.zeros((n, m))
    pp1 = np.repeat(p1, m, 0)
    pp2 = np.tile(p2, (n, 1))
    inter = poly_intersection_areas(pp1, pp2).reshape(n, m)
    a1 = quad_area(p1)[:, None]
    a2 = quad_area(p2)[None, :]
    union = a1 + a2 - inter
    return np.where(union > 1e-9, inter / np.maximum(union, 1e-9), 0.0)


def poly_iou_aligned(p1, p2):
    inter = poly_intersection_areas(p1, p2)
    union = quad_area(p1) + quad_area(p2) - inter
    return np.where(union > 1e-9, inter / np.maximum(union, 1e-9), 0.0)


def nms_poly_np(polys, scores, iou_thr):
    """Greedy poly NMS with hbb prefilter (reference
    `py_cpu_nms_poly_fast`, devkits/result_merge.py:69-130), on the
    native library. Returns kept indices in score order."""
    return polygon_native.poly_nms(polys, scores, iou_thr)


def nms_poly_plain(polys, scores, iou_thr):
    """`nms_poly_np` in numpy."""
    if len(polys) == 0:
        return np.zeros((0,), np.int64)
    xs = polys[:, 0::2]
    ys = polys[:, 1::2]
    hbb = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
    areas = (hbb[:, 2] - hbb[:, 0]) * (hbb[:, 3] - hbb[:, 1])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        if order.size == 1:
            break
        rest = order[1:]
        xx1 = np.maximum(hbb[i, 0], hbb[rest, 0])
        yy1 = np.maximum(hbb[i, 1], hbb[rest, 1])
        xx2 = np.minimum(hbb[i, 2], hbb[rest, 2])
        yy2 = np.minimum(hbb[i, 3], hbb[rest, 3])
        w = np.maximum(0.0, xx2 - xx1)
        h = np.maximum(0.0, yy2 - yy1)
        hbb_inter = w * h
        hbb_iou = hbb_inter / np.maximum(areas[i] + areas[rest] - hbb_inter, 1e-9)
        cand = np.where(hbb_iou > 0)[0]
        iou = np.zeros(len(rest))
        if len(cand):
            iou[cand] = poly_iou_aligned(
                np.repeat(polys[i][None], len(cand), 0), polys[rest[cand]]
            )
        order = rest[iou <= iou_thr]
    return np.asarray(keep, np.int64)
