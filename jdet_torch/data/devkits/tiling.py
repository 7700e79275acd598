"""DOTA tiling and labelTxt -> labels.pkl, without cv2.

Port of `jdet_tpu/data/devkits/tiling.py` (`_clip_quad_to_window` :35,
`_poly5_to_poly4` :65, `_best_point_order` :84,
`split_objects_for_window` :101, `window_grid` :136, `parse_dota_label`
:151, `split_single_image` :171, `process` :216, `convert_to_pkl` :262),
itself after the reference's ImgSplit and convert_data_to_mmdet:

  - sliding `subsize` windows with `gap` overlap, edge tiles padded with
    zeros, tile names `name__rate__left___up`;
  - gt quads clipped to each window; a quad cut by the window keeps its
    clipped polygon (a 5-gon merged to 4 points on its shortest edge,
    more vertices dropped) and becomes difficult=2 when at most `thresh`
    of its area lies inside;
  - labelTxt -> labels.pkl: quads -> (cx, cy, w, h, theta),
    difficult 1 -> the ignore lists, difficult 2 dropped.

The reference reads and writes through cv2, which the GPU machine lacks.
Here the source scenes are read with the port's PNG reader (RGB) and the
tiles written with its PNG writer, the Sub filter on every row as cv2
writes them; cv2 reads and writes BGR, so in both packages a tile's file
holds its source file's channel order. `convert_to_pkl` reads a tile's
size from its PNG header. Only PNG scenes can be read (the reader names
the file of any other), and only PNG tiles written.

At a rate other than 1.0 the scene is first resized as the reference's
`cv2.resize(img, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)`
and its quads multiplied by the rate (`resize_cubic`, OpenCV's own
uint8 bicubic on numpy, byte for byte).
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..image_io import imread, imwrite, png_size
from ..transforms import poly_to_rbox_np
from .polygon import _clip_polys, _polygon_area, quad_area

SUB_FILTER = 1
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif")
IO_THREADS = 4  # scenes tiled at once (zlib and numpy release the GIL)
COEF_BITS = 11  # OpenCV's INTER_RESIZE_COEF_BITS
SIMD_LANES = 8  # values of a row that OpenCV's vertical pass takes at once
RESIZE_ROWS = 256  # output rows resized at once


def _cubic_taps(n_out, n_in, rate):
    """Per output pixel, the 4 source indices (replicated at the borders)
    and OpenCV's fixed-point cubic weights (A = -0.75, scaled by 2^11)."""
    f = ((np.arange(n_out) + 0.5) * (1.0 / rate) - 0.5).astype(np.float32)
    start = np.floor(f).astype(np.int64)
    x = (f - start.astype(np.float32)).astype(np.float32)
    a, one = np.float32(-0.75), np.float32(1.0)
    c0 = ((a * (x + one) - np.float32(5) * a) * (x + one) + np.float32(8) * a) * (x + one) \
        - np.float32(4) * a
    c1 = ((a + np.float32(2)) * x - (a + np.float32(3))) * x * x + one
    c2 = ((a + np.float32(2)) * (one - x) - (a + np.float32(3))) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    weights = np.rint(np.stack([c0, c1, c2, c3], -1) * np.float32(1 << COEF_BITS))
    return np.clip(start[:, None] - 1 + np.arange(4), 0, n_in - 1), weights.astype(np.int64)


def resize_cubic(img, rate):
    """`cv2.resize(img, None, fx=rate, fy=rate, interpolation=INTER_CUBIC)`
    of a uint8 (H, W) or (H, W, C) image, as OpenCV computes it without
    Intel IPP: the output size rounded half to even; per output pixel
    float32 source coordinates and cubic weights in 11-bit fixed point; a
    horizontal pass in integers; a vertical pass that, like OpenCV's SIMD
    loop, takes each row's first multiple of `SIMD_LANES` values in
    float32 (S0 b0 + (S1 b1 + (S2 b2 + S3 b3)), rounded half to even) and
    the rest in integers ((sum + 2^21) >> 22), saturated to uint8."""
    h, w = img.shape[:2]
    src = img.reshape(h, w, -1).astype(np.int64)
    ow, oh = int(np.rint(w * rate)), int(np.rint(h * rate))
    xi, xw = _cubic_taps(ow, w, rate)
    yi, yw = _cubic_taps(oh, h, rate)
    hor = np.zeros((h, ow, src.shape[2]), np.int64)
    for k in range(4):
        hor += src[:, xi[:, k]] * xw[None, :, k, None]
    hor = hor.reshape(h, -1)
    n_simd = hor.shape[1] // SIMD_LANES * SIMD_LANES
    bf = (yw.astype(np.float32) * np.float32(2.0 ** (-2 * COEF_BITS))).astype(np.float32)
    out = np.empty((oh, hor.shape[1]), np.uint8)
    for r0 in range(0, oh, RESIZE_ROWS):
        rows = slice(r0, min(r0 + RESIZE_ROWS, oh))
        taps = [hor[yi[rows, k]] for k in range(4)]
        acc = taps[3][:, :n_simd].astype(np.float32) * bf[rows, 3, None]
        for k in (2, 1, 0):
            acc = taps[k][:, :n_simd].astype(np.float32) * bf[rows, k, None] + acc
        exact = sum(t[:, n_simd:] * yw[rows, k, None] for k, t in enumerate(taps))
        out[rows, :n_simd] = np.clip(np.rint(acc), 0, 255)
        out[rows, n_simd:] = np.clip((exact + (1 << (2 * COEF_BITS - 1))) >> (2 * COEF_BITS),
                                     0, 255)
    return out.reshape((oh, ow) + img.shape[2:])


def _clip_quad_to_window(polys, left, up, right, down):
    """Clip (n, 8) quads to a window: (xs, ys, vertex counts, areas)."""
    n = len(polys)
    if n == 0:
        return np.zeros((0, 10)), np.zeros((0, 10)), np.zeros(0, np.int64), np.zeros(0)
    # ensure CCW for the clipper
    p = polys.reshape(n, 4, 2).astype(np.float64)
    x, y = p[..., 0], p[..., 1]
    signed = 0.5 * (x * np.roll(y, -1, 1) - np.roll(x, -1, 1) * y).sum(1)
    flip = signed < 0
    p[flip] = p[flip, ::-1]
    px = np.concatenate([p[..., 0], np.zeros((n, 6))], 1)
    py = np.concatenate([p[..., 1], np.zeros((n, 6))], 1)
    counts = np.full(n, 4, np.int64)
    window = [
        (left, up, right, up),
        (right, up, right, down),
        (right, down, left, down),
        (left, down, left, up),
    ]
    for ax, ay, bx, by in window:
        px, py, counts = _clip_polys(
            px[:, :9], py[:, :9], counts,
            np.full(n, ax, float), np.full(n, ay, float),
            np.full(n, bx, float), np.full(n, by, float),
        )
    return px, py, counts, _polygon_area(px, py, counts)


def _poly5_to_poly4(coords):
    """Merge the shortest edge of a 5-gon (ImgSplit GetPoly4FromPoly5)."""
    pts = coords.reshape(5, 2)
    d = np.linalg.norm(pts - np.roll(pts, -1, 0), axis=1)
    pos = int(d.argmin())
    out = []
    i = 0
    while len(out) < 4:
        j = i % 5
        if j == pos:
            out.append((pts[j] + pts[(j + 1) % 5]) / 2)
            i += 2
        else:
            out.append(pts[j])
            i += 1
    return np.asarray(out).reshape(8)


def _best_point_order(poly, ref):
    """The cyclic order (either direction) of `poly` nearest to `ref`
    (ImgSplit choose_best_pointorder_fit_another)."""
    p = poly.reshape(4, 2)
    r = ref.reshape(4, 2)
    best = None
    best_d = np.inf
    for rev in (p, p[::-1]):
        for k in range(4):
            cand = np.roll(rev, -k, 0)
            d = np.abs(cand - r).sum()
            if d < best_d:
                best_d = d
                best = cand
    return best.reshape(8)


def split_objects_for_window(polys, names, difficults, left, up, right, down,
                             subsize, thresh=0.7):
    """Clip one window's objects; returns [(poly8, name, difficult)]."""
    out = []
    if len(polys) == 0:
        return out
    areas = quad_area(polys)
    px, py, counts, inter_areas = _clip_quad_to_window(polys, left, up, right, down)
    half_ious = np.where(areas > 0, inter_areas / np.maximum(areas, 1e-9), 0.0)
    for i in range(len(polys)):
        if areas[i] <= 0 or half_ious[i] <= 0:
            continue
        if half_ious[i] >= 1 - 1e-9:
            poly = polys[i] - np.tile([left, up], 4)
            out.append((poly.astype(np.float32), names[i], int(difficults[i])))
            continue
        c = int(counts[i])
        if c < 4:
            continue
        coords = np.stack([px[i, :c], py[i, :c]], -1).reshape(-1)
        if c == 5:
            coords = _poly5_to_poly4(coords)
        elif c > 5:
            continue
        coords = _best_point_order(coords, polys[i])
        poly = np.clip(coords - np.tile([left, up], 4), 1, subsize)
        diff = int(difficults[i]) if half_ious[i] > thresh else 2
        out.append((poly.astype(np.float32), names[i], diff))
    return out


def window_grid(w, h, subsize, gap):
    """Sliding-window origins (ImgSplit:271-293), rows of lefts per up."""
    slide = subsize - gap
    lefts = list(range(0, max(w - subsize, 0) + 1, slide))
    if not lefts or lefts[-1] + subsize < w:
        lefts.append(max(w - subsize, 0))
    ups = list(range(0, max(h - subsize, 0) + 1, slide))
    if not ups or ups[-1] + subsize < h:
        ups.append(max(h - subsize, 0))
    return [(l, u) for u in sorted(set(ups)) for l in sorted(set(lefts))]


def parse_dota_label(path):
    """labelTxt -> (polys (n, 8), names, difficults); header lines and a
    missing file give no objects."""
    polys, names, diffs = [], [], []
    if not os.path.exists(path):
        return np.zeros((0, 8), np.float32), [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(" ")
            if len(parts) < 9:
                continue
            try:
                coords = [float(x) for x in parts[:8]]
            except ValueError:
                continue
            polys.append(coords)
            names.append(parts[8])
            diffs.append(int(parts[9]) if len(parts) > 9 else 0)
    return np.asarray(polys, np.float32).reshape(-1, 8), names, diffs


def split_single_image(img, polys, names, difficults, base_name, out_image_dir,
                       out_label_dir, subsize=1024, gap=200, rate=1.0, thresh=0.7):
    """Tile one image (H, W, 3) and its labels (ImgSplit
    SplitSingle/savepatches) into `.png` tiles, the image and the quads
    scaled by `rate` first; returns the tile names."""
    os.makedirs(out_image_dir, exist_ok=True)
    os.makedirs(out_label_dir, exist_ok=True)
    if rate != 1.0:
        img = resize_cubic(img, rate)
        polys = polys * rate
    h, w = img.shape[:2]
    written = []
    for left, up in window_grid(w, h, subsize, gap):
        right = min(left + subsize, w)
        down = min(up + subsize, h)
        objs = split_objects_for_window(
            polys, names, difficults, left, up, left + subsize, up + subsize,
            subsize, thresh,
        )
        tile_name = f"{base_name}__{rate}__{left}___{up}"
        tile = np.zeros((subsize, subsize, img.shape[2]), img.dtype)
        tile[: down - up, : right - left] = img[up:down, left:right]
        imwrite(os.path.join(out_image_dir, tile_name + ".png"), tile, filter_type=SUB_FILTER)
        with open(os.path.join(out_label_dir, tile_name + ".txt"), "w") as f:
            for poly, name, diff in objs:
                coords = " ".join(str(float(x)) for x in poly)
                f.write(f"{coords} {name} {diff}\n")
        written.append(tile_name)
    return written


def process(src_image_dir, src_label_dir, out_dir, subsize=1024, gap=200, rates=(1.0,),
            thresh=0.7):
    """Tile a whole dataset (ImgSplit process/splitdata) into
    out_dir/images and out_dir/labelTxt; returns the tile names."""
    out_image_dir = os.path.join(out_dir, "images")
    out_label_dir = os.path.join(out_dir, "labelTxt")
    names = sorted(
        os.path.splitext(f)[0]
        for f in os.listdir(src_image_dir)
        if f.lower().endswith(IMAGE_EXTS)
    )

    def one(name):
        img_path = next(p for p in (os.path.join(src_image_dir, name + e) for e in IMAGE_EXTS)
                        if os.path.exists(p))
        img = imread(img_path)
        polys, obj_names, diffs = parse_dota_label(
            os.path.join(src_label_dir, name + ".txt")
        ) if src_label_dir else (np.zeros((0, 8), np.float32), [], [])
        tiles = []
        for rate in rates:
            tiles += split_single_image(
                img, polys, obj_names, diffs, name,
                out_image_dir, out_label_dir, subsize, gap, rate, thresh,
            )
        return tiles

    with ThreadPoolExecutor(max_workers=IO_THREADS) as pool:
        return sum(pool.map(one, names), [])


def convert_to_pkl(src_path, out_path, class_names, filter_empty_gt=True):
    """Tiled labelTxt -> labels.pkl (convert_data_to_mmdet.py:34-72), the
    reference's `trainval=True` records."""
    label_ids = {n: i + 1 for i, n in enumerate(class_names)}
    img_dir = os.path.join(src_path, "images")
    label_dir = os.path.join(src_path, "labelTxt")
    records = []
    for fname in sorted(os.listdir(img_dir)):
        name = os.path.splitext(fname)[0]
        height, width = png_size(os.path.join(img_dir, fname))
        info = {"filename": fname, "height": height, "width": width}
        polys, names, diffs = parse_dota_label(os.path.join(label_dir, name + ".txt"))
        boxes, labels, boxes_ig, labels_ig = [], [], [], []
        for poly, cname, diff in zip(polys, names, diffs):
            if cname not in label_ids:
                continue
            rb = poly_to_rbox_np(poly[None])[0]
            if diff == 0:
                boxes.append(rb)
                labels.append(label_ids[cname])
            elif diff == 1:
                boxes_ig.append(rb)
                labels_ig.append(label_ids[cname])
        if filter_empty_gt and not boxes:
            continue
        info["ann"] = {
            "bboxes": np.asarray(boxes, np.float32).reshape(-1, 5),
            "labels": np.asarray(labels, np.int64),
            "bboxes_ignore": np.asarray(boxes_ig, np.float32).reshape(-1, 5),
            "labels_ignore": np.asarray(labels_ig, np.int64),
        }
        records.append(info)
    with open(out_path, "wb") as f:
        pickle.dump(records, f)
    return out_path
