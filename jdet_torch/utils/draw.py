"""A numpy rasterizer for the two OpenCV calls the visualizer makes.

The GPU machine has neither cv2 nor PIL, so the port draws the
reference's `cv2.polylines(img, [pts], True, color, thickness)` (LINE_8)
and `cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color, 1,
LINE_AA)` (`jdet_tpu/utils/visualization.py:29-34, 129-135`) itself, on
uint8 (H, W, 3) arrays, in OpenCV's integer and 16.16 fixed-point
arithmetic (`modules/imgproc/src/drawing.cpp`):

- thickness 1: each edge is one 8-connected Bresenham line
  (`LineIterator`, drawn left to right), clipped to the image first
  (`clipLine`);
- thickness t > 1: each edge is a quad of half-width t / 2 around it,
  filled as a convex polygon in 16.16 fixed point (`FillConvexPoly`: its
  edges by the fixed-point `Line2`, then the scan lines), and each
  edge's end gets a filled disc of radius (t * 2^15 + 2^15) >> 16
  (`Circle`), which rounds the joins;
- text: each glyph is a coverage mask at the font scale, placed with its
  top-left corner at the pen's integer position and blended into the
  image; the pen moves by the glyph's integer advance. OpenCV 5 renders
  its Hershey faces from an outline font, not from Hershey's strokes, so
  the masks and advances (`hershey_simplex.npz`, printable ASCII at
  scales 0.5 and 0.4, the two the reference draws with) were taken from
  cv2 5.0's own renderings by `tests/derive_hershey_glyphs.py`; another
  scale raises.

Everything clips to the image: a corner or a text origin may lie outside.
"""
from __future__ import annotations

import math
import os

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT

_GLYPHS = os.path.join(os.path.dirname(__file__), "hershey_simplex.npz")
_glyph_cache = {}


def _tdiv(a, b):
    """C's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _clip_line(width, height, x1, y1, x2, y2):
    """OpenCV's `clipLine` on a (width, height) box: the segment clipped
    to [0, width - 1] x [0, height - 1], or None if it misses the box."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _put(mask, xs, ys):
    h, w = mask.shape
    ok = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[ok], xs[ok]] = True


def _line8(mask, x1, y1, x2, y2):
    """OpenCV's `Line` with 8-connectivity: `LineIterator(img, pt1, pt2,
    8, leftToRight=true)` over integer end points."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = _clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    sx = sy = 1
    if dx < 0:
        dx, dy = -dx, -dy
        x1, y1, x2, y2 = x2, y2, x1, y1
    if dy < 0:
        dy, sy = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    i = np.arange(dx + 1, dtype=np.int64)
    # minor-axis steps taken before pixel i: ceil((2 dy i - dx) / (2 dx))
    k = -((dx - 2 * dy * i) // (2 * dx)) if dx else np.zeros_like(i)
    if vert:
        xs, ys = x1 + sx * k, y1 + sy * i
    else:
        xs, ys = x1 + sx * i, y1 + sy * k
    _put(mask, xs, ys)


def _line2(mask, x1, y1, x2, y2):
    """OpenCV's `Line2`: an 8-connected line between 16.16 fixed-point
    end points."""
    h, w = mask.shape
    clipped = _clip_line(w << XY_SHIFT, h << XY_SHIFT, x1, y1, x2, y2)
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dy << XY_SHIFT, ax | 1)
        ecount = (x2 - x1) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        step = _tdiv(dx << XY_SHIFT, ay | 1)
        ecount = (y2 - y1) >> XY_SHIFT
    x1 += XY_ONE >> 1
    y1 += XY_ONE >> 1
    _put(mask, np.array([(x2 + (XY_ONE >> 1)) >> XY_SHIFT]),
         np.array([(y2 + (XY_ONE >> 1)) >> XY_SHIFT]))
    i = np.arange(ecount + 1, dtype=np.int64)
    if ax > ay:
        xs = (x1 >> XY_SHIFT) + i
        ys = (y1 + i * step) >> XY_SHIFT
    else:
        xs = (x1 + i * step) >> XY_SHIFT
        ys = (y1 >> XY_SHIFT) + i
    _put(mask, xs, ys)


def _fill_convex(mask, pts):
    """OpenCV's `FillConvexPoly` for LINE_8 on 16.16 fixed-point corners
    `pts` [(x, y), ...]: the outline by `_line2`, then the scan lines."""
    h, w = mask.shape
    n = len(pts)
    delta = XY_ONE >> 1
    p0 = pts[-1]
    for p in pts:
        _line2(mask, p0[0], p0[1], p[0], p[1])
        p0 = p
    xs = [p[0] for p in pts]
    ys = [p[1] for p in pts]
    imin = min(range(n), key=lambda i: (ys[i], i))
    xmin, xmax = (min(xs) + delta) >> XY_SHIFT, (max(xs) + delta) >> XY_SHIFT
    ymin, ymax = (min(ys) + delta) >> XY_SHIFT, (max(ys) + delta) >> XY_SHIFT
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edge_idx = [imin, imin]
    edge_di = [1, n - 1]
    edge_x = [-XY_ONE, -XY_ONE]
    edge_dx = [0, 0]
    edge_ye = [ymin, ymin]
    edges = n
    y = ymin
    while True:
        for i in range(2):
            if y >= edge_ye[i]:
                idx0 = edge_idx[i]
                di = edge_di[i]
                idx = idx0 + di
                if idx >= n:
                    idx -= n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (ys[idx] + delta) >> XY_SHIFT
                    if ty > y:
                        xs0, xe = xs[idx0], xs[idx]
                        edge_ye[i] = ty
                        edge_dx[i] = _tdiv((xe - xs0) * 2 + (ty - y), 2 * (ty - y))
                        edge_x[i] = xs0
                        edge_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= n:
                        idx -= n
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if edge_x[0] > edge_x[1] else (0, 1)
            xx1 = (edge_x[left] + delta) >> XY_SHIFT
            xx2 = (edge_x[right] + delta) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                mask[y, max(xx1, 0):min(xx2, w - 1) + 1] = True
        edge_x[0] += edge_dx[0]
        edge_x[1] += edge_dx[1]
        y += 1
        if y > ymax:
            break


def _circle_fill(mask, cx, cy, radius):
    """OpenCV's filled `Circle` (the integer midpoint circle, filled by
    horizontal spans)."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for (xa, xb), yy in (((cx - dx, cx + dx), cy - dy), ((cx - dx, cx + dx), cy + dy),
                             ((cx - dy, cx + dy), cy - dx), ((cx - dy, cx + dy), cy + dx)):
            if 0 <= yy < h and xa < w and xb >= 0:
                mask[yy, max(xa, 0):min(xb, w - 1) + 1] = True
        dy += 1
        err += plus
        plus += 2
        m = 0 if err <= 0 else -1
        err -= minus & m
        dx += m
        minus -= m & 2


def _thick_line(mask, p0, p1, thickness, flags):
    """OpenCV's `ThickLine` for LINE_8 on integer end points (shift 0).
    A thick line is first clipped to the image grown by `thickness` on
    every side, as cv2 5.0 does."""
    if thickness <= 1:
        _line8(mask, p0[0], p0[1], p1[0], p1[1])
        return
    h, w = mask.shape
    t = thickness
    clipped = _clip_line(w + 2 * t, h + 2 * t, p0[0] + t, p0[1] + t, p1[0] + t, p1[1] + t)
    if clipped is None:
        return
    x0, y0, x1, y1 = ((v - t) << XY_SHIFT for v in clipped)
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx = int(np.rint(dy * r))
        dpy = int(np.rint(dx * r))
        _fill_convex(mask, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                            (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)])
    radius = (thickness + (XY_ONE >> 1)) >> XY_SHIFT
    for i, (px, py) in enumerate(((x0, y0), (x1, y1))):
        if flags & (i + 1):
            _circle_fill(mask, (px + (XY_ONE >> 1)) >> XY_SHIFT,
                         (py + (XY_ONE >> 1)) >> XY_SHIFT, radius)


def polyline_mask(shape, pts, closed=True, thickness=1):
    """The pixels `cv2.polylines(img, [pts], closed, color, thickness)`
    (LINE_8, shift 0) paints, as a bool (H, W) mask. pts: (n, 2) int."""
    pts = [(int(x), int(y)) for x, y in np.asarray(pts).reshape(-1, 2)]
    mask = np.zeros(shape[:2], bool)
    n = len(pts)
    if n == 0:
        return mask
    i = n - 1 if closed else 0
    flags = 2 + (not closed)
    p0 = pts[i]
    for i in range(0 if closed else 1, n):
        _thick_line(mask, p0, pts[i], thickness, flags)
        p0 = pts[i]
        flags = 2
    return mask


def polylines(img, pts, closed, color, thickness=1):
    """`cv2.polylines(img, [pts], closed, color, thickness)` with LINE_8,
    in place on a uint8 (H, W, C) array; color has C entries."""
    mask = polyline_mask(img.shape, pts, closed, thickness)
    img[mask] = np.asarray(color, np.uint8)[: img.shape[2]]
    return img


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------


def _glyph_table(scale):
    key = round(float(scale), 6)
    if key not in _glyph_cache:
        with np.load(_GLYPHS) as data:
            scales = [round(float(s), 6) for s in data["scales"]]
            if key not in scales:
                raise ValueError(f"put_text: FONT_HERSHEY_SIMPLEX is tabulated at scales "
                                 f"{scales}, not {scale}")
            j = scales.index(key)
            _glyph_cache[key] = dict(
                alpha=data["alpha"][j],        # (95, gh, gw) uint8 coverage
                origin=data["origin"][j],      # (95, 2) mask corner minus the pen (x, y)
                advance=data["advance"][j],    # (95,) integer pen advance
                size=data["size"][j],          # (95, 2) the mask's used (w, h)
            )
    return _glyph_cache[key]


def _blend(dst, color, alpha):
    """cv2 5.0's anti-aliased text blend of `color` into uint8 `dst` with
    uint8 coverage `alpha`: (dst * (255 - a) + color * a + 127) // 255."""
    d = dst.astype(np.int32)
    a = alpha.astype(np.int32)[..., None]
    c = np.asarray(color, np.int32)[: dst.shape[-1]]
    return ((d * (255 - a) + c * a + 127) // 255).astype(np.uint8)


def put_text(img, text, org, scale, color):
    """`cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, scale, color, 1,
    LINE_AA)` in place on a uint8 (H, W, C) array. org: the text's
    bottom-left (x, y); it may lie outside the image. A character outside
    printable ASCII is drawn as "?"."""
    table = _glyph_table(scale)
    h, w = img.shape[:2]
    pen_x, pen_y = int(org[0]), int(org[1])
    for ch in text:
        c = ord(ch) - 32
        if not 0 <= c < 95:
            c = ord("?") - 32
        gw, gh = (int(v) for v in table["size"][c])
        if gw and gh:
            x0 = pen_x + int(table["origin"][c][0])
            y0 = pen_y + int(table["origin"][c][1])
            xa, ya = max(x0, 0), max(y0, 0)
            xb, yb = min(x0 + gw, w), min(y0 + gh, h)
            if xa < xb and ya < yb:
                a = table["alpha"][c][ya - y0:yb - y0, xa - x0:xb - x0]
                region = img[ya:yb, xa:xb]
                on = a > 0
                region[on] = _blend(region[on], color, a[on])
        pen_x += int(table["advance"][c])
    return img
