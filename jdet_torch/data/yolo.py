"""YOLOv5-style dataset: txt labels, the 4-image mosaic, letterbox, HSV and
affine augmentations, on numpy.

Port of `jdet_tpu/data/yolo.py` (`letterbox` :25, `augment_hsv` :48,
`random_affine` :66, `YoloDataset` :108: `_load_raw` :140, `_load_mosaic`
:187, `load_sample` :249, `collate` :282, `evaluate` :319). The reference
calls cv2; the port computes what cv2 5.0 computes with IPP off
(`cv2.ipp.setUseIPP(False)`): the float32 resizes through
`transforms.resize_linear`, the HSV round trip through `rgb_to_hsv_u8` /
`hsv_to_rgb_u8`, and the float32 `warpAffine` through `warp_affine`
below (`warp_affine_plain` in numpy; the loader runs its compiled form in
the g++ codec library). With IPP on, cv2's float32 resizes differ from
these by up to 3.05e-5 on the mosaic's 2x reduction and up to 0.0037 on
other scales; its `warpAffine` does not depend on IPP.

Each sample's draws come from its `numpy.random.Generator` in the
reference's order: the mosaic's centre (`yc`, `xc`) and three image
indices, the affine's angle, scale and two translations, then the HSV
gains and the flip.

The batch contract is the reference's: images (B, S, S, 3) float32 RGB
in 0..1, `gt_hboxes` (B, K, 4) xyxy pixels, `gt_labels` (B, K) 1-based,
`gt_mask` (B, K), what `YOLO.loss` reads.
"""
from __future__ import annotations

import math
import os
import pickle

import numpy as np

from ..utils.registry import DATASETS
from .custom import CustomDataset
from .image_io import imread
from .transforms import hsv_to_rgb_u8, resize_linear, rgb_to_hsv_u8

# cv2 5.0's float warp computes a row's pixels 16 at a time in vector code
# and the rest one at a time, each with its own coordinate arithmetic
WARP_VECTOR_PIXELS = 16


def letterbox(img, new_size, color=114, scaleup=True):
    """Aspect-preserving resize and constant pad to (S, S). Returns (img,
    scale, (left, top))."""
    h, w = img.shape[:2]
    s = min(new_size / h, new_size / w)
    if not scaleup:
        s = min(s, 1.0)
    nw, nh = int(round(w * s)), int(round(h * s))
    dw = (new_size - nw) / 2
    dh = (new_size - nh) / 2
    if (w, h) != (nw, nh):
        img = resize_linear(img, (nw, nh))
    top, bottom = int(round(dh - 0.1)), int(round(dh + 0.1))
    left, right = int(round(dw - 0.1)), int(round(dw + 0.1))
    out = np.full((nh + top + bottom, nw + left + right) + img.shape[2:], color, img.dtype)
    out[top:top + nh, left:left + nw] = img
    return out, s, (left, top)


def augment_hsv(img, rng, hgain=0.015, sgain=0.7, vgain=0.4):
    """HSV colour jitter: the float image truncated to uint8, cv2's uint8
    RGB -> HSV, float64 lookup tables, HSV -> RGB, back to float32."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = rgb_to_hsv_u8(img.astype(np.uint8))
    x = np.arange(256)
    luts = (((x * r[0]) % 180).astype(np.uint8),
            np.clip(x * r[1], 0, 255).astype(np.uint8),
            np.clip(x * r[2], 0, 255).astype(np.uint8))
    hsv = np.stack([lut[hsv[..., i]] for i, lut in enumerate(luts)], -1)
    return hsv_to_rgb_u8(hsv).astype(np.float32)


def get_rotation_matrix_2d(center, angle, scale):
    """`cv2.getRotationMatrix2D`: (2, 3) float64, the centre taken as
    float32 (cv2's Point2f), the angle in degrees."""
    cx, cy = (float(np.float32(c)) for c in center)
    a = angle * math.pi / 180
    alpha = math.cos(a) * scale
    beta = math.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def invert_affine(M):
    """cv2's inverse of a (2, 3) affine map, in float64 (as `warpAffine`
    inverts M without WARP_INVERSE_MAP)."""
    m = [float(v) for v in np.asarray(M, np.float64).reshape(-1)]
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[4] = a11, a22
    m[1] *= -d
    m[3] *= -d
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return np.array(m).reshape(2, 3)


def _fma(a, b, c):
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def warp_affine(img, M, dsize, border_value=0.0):
    """`warp_affine_plain` compiled (`csrc/image_codecs.cpp`), with the same
    bits: the loader warps a 1280² canvas per mosaic, ~0.35 s in numpy."""
    from .image_codecs import warp_affine_f32

    src = img.reshape(img.shape[0], img.shape[1], -1)
    m = invert_affine(M).astype(np.float32)
    return warp_affine_f32(src, m, dsize, border_value).reshape(
        (dsize[1], dsize[0]) + img.shape[2:])


def warp_affine_plain(img, M, dsize, border_value=0.0):
    """`cv2.warpAffine(img, M, dsize, borderValue=(v, v, v))` of a float32
    (H, W) or (H, W, C) image, INTER_LINEAR with BORDER_CONSTANT, as cv2
    5.0 computes it: M inverted in float64 and rounded to float32; each
    destination pixel's source coordinates in float32, x = fma(m0, col,
    m1 * row + m2) in the vector code (16 pixels at a time) and
    fma(col, m0, m1 * row) + m2 in the scalar tail; the four neighbours of
    floor(x), floor(y), those outside the image reading the border value;
    and three fused lerps, v0 = fma(a, p01 - p00, p00), v1 likewise,
    v = fma(b, v1 - v0, v0), with a and b the coordinates' fractions."""
    w, h = dsize
    m = invert_affine(M).astype(np.float32).reshape(-1)
    src = img.reshape(img.shape[0], img.shape[1], -1).astype(np.float32, copy=False)
    H, W = src.shape[:2]
    f32 = np.float32
    rows = np.arange(h, dtype=f32)[:, None]
    cols = np.arange(w, dtype=f32)[None, :]
    vector = np.arange(w) < w // WARP_VECTOR_PIXELS * WARP_VECTOR_PIXELS

    def coord(m0, m1, m2):
        vec = _fma(m0, cols, m1 * rows + m2)
        tail = _fma(cols, m0, m1 * rows) + m2
        return np.where(vector, vec, tail)

    sx, sy = coord(*m[:3]), coord(*m[3:])
    fx, fy = np.floor(sx), np.floor(sy)
    a, b = (sx - fx)[..., None], (sy - fy)[..., None]
    # beyond int range the neighbours are all outside anyway
    ix = np.clip(fx, -2, W + 1).astype(np.int64)
    iy = np.clip(fy, -2, H + 1).astype(np.int64)
    fill = f32(border_value)

    def pixel(yy, xx):
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        v = src[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(inside[..., None], v, fill)

    p00, p01 = pixel(iy, ix), pixel(iy, ix + 1)
    p10, p11 = pixel(iy + 1, ix), pixel(iy + 1, ix + 1)
    v0 = _fma(a, p01 - p00, p00)
    v1 = _fma(a, p11 - p10, p10)
    out = _fma(b, v1 - v0, v0)
    return out.reshape((h, w) + img.shape[2:])


def random_affine(img, boxes, labels, rng, degrees=0.0, translate=0.1, scale=0.5, fill=114):
    """Scale / translate / rotate with the boxes remapped and degenerate
    ones dropped (the reference's `box_candidates` filter)."""
    h, w = img.shape[:2]
    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    M = get_rotation_matrix_2d((w / 2, h / 2), a, s)
    M[0, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * w - w / 2
    M[1, 2] += rng.uniform(0.5 - translate, 0.5 + translate) * h - h / 2
    img = warp_affine(img.astype(np.float32), M, (w, h), border_value=fill)
    if len(boxes):
        n = len(boxes)
        pts = np.ones((n * 4, 3))
        pts[:, :2] = boxes[:, [0, 1, 2, 1, 2, 3, 0, 3]].reshape(n * 4, 2)
        pts = (pts @ M.T).reshape(n, 8)
        xs = pts[:, 0::2]
        ys = pts[:, 1::2]
        new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
        new[:, 0::2] = new[:, 0::2].clip(0, w)
        new[:, 1::2] = new[:, 1::2].clip(0, h)
        ow = boxes[:, 2] - boxes[:, 0]
        oh = boxes[:, 3] - boxes[:, 1]
        nw_ = new[:, 2] - new[:, 0]
        nh_ = new[:, 3] - new[:, 1]
        ar = np.maximum(nw_ / (nh_ + 1e-16), nh_ / (nw_ + 1e-16))
        keep = ((nw_ > 2) & (nh_ > 2)
                & (nw_ * nh_ / (ow * oh * s * s + 1e-16) > 0.1) & (ar < 20))
        boxes = new[keep]
        labels = labels[keep]
    return img, boxes, labels


@DATASETS.register_module()
class YoloDataset(CustomDataset):
    """YOLO txt-label dataset ("cls cx cy w h", normalized, 0-based) with
    the mosaic and letterbox train augmentations. Images are listed from
    `images_dir` (.jpg, .jpeg, .png, .bmp), their labels read from
    `labels_dir` (default: `labels` beside the images' directory); or,
    with `annotations_file`, the records of a `labels.pkl`."""

    def __init__(self, images_dir="", labels_dir=None, annotations_file=None, img_size=640,
                 mosaic=True, augment=True, degrees=0.0, translate=0.1, scale=0.5,
                 fliplr=0.5, hsv=True, max_gt=128, **kw):
        kw.setdefault("image_size", (img_size, img_size))
        kw.setdefault("filter_empty_gt", False)
        super().__init__(annotations_file=None, images_dir=images_dir, max_gt=max_gt, **kw)
        self.img_size = img_size
        self.mosaic = mosaic
        self.augment = augment
        self.degrees = degrees
        self.translate = translate
        self.scale = scale
        self.fliplr = fliplr
        self.hsv = hsv
        self.labels_dir = labels_dir
        if annotations_file is not None:
            with open(annotations_file, "rb") as f:
                self.img_infos = pickle.load(f)
        else:
            exts = (".jpg", ".jpeg", ".png", ".bmp")
            files = sorted(
                f for f in os.listdir(images_dir) if f.lower().endswith(exts)
            ) if os.path.isdir(images_dir) else []
            self.img_infos = [{"filename": f} for f in files]

    # ------------------------------------------------------------------
    def _load_raw(self, idx):
        """Image (RGB float32), xyxy pixel boxes, labels (1-based)."""
        info = self.img_infos[idx]
        img = imread(os.path.join(self.images_dir, info["filename"])).astype(np.float32)
        h, w = img.shape[:2]
        if "ann" in info:
            hb = np.asarray(info["ann"].get("hboxes", info["ann"].get("bboxes")), np.float32)
            if hb.ndim == 2 and hb.shape[-1] == 5:
                # a labels.pkl's rotated (n, 5) boxes: their axis-aligned hull
                cx, cy, bw, bh, a = hb.T
                ca, sa = np.abs(np.cos(a)), np.abs(np.sin(a))
                ex = (bw * ca + bh * sa) / 2
                ey = (bw * sa + bh * ca) / 2
                hb = np.stack([cx - ex, cy - ey, cx + ex, cy + ey], 1)
            hb = hb.reshape(-1, 4).astype(np.float32)
            labels = np.asarray(info["ann"]["labels"], np.int64).reshape(-1)
            return img, hb, labels
        stem = os.path.splitext(info["filename"])[0]
        lab_dir = self.labels_dir or os.path.join(
            os.path.dirname(self.images_dir.rstrip("/")), "labels")
        path = os.path.join(lab_dir, stem + ".txt")
        rows = []
        if os.path.exists(path):
            with open(path) as f:
                for line in f.read().splitlines():
                    p = line.split()
                    if len(p) >= 5:
                        rows.append([float(v) for v in p[:5]])
        if not rows:
            return img, np.zeros((0, 4), np.float32), np.zeros((0,), np.int64)
        arr = np.asarray(rows, np.float32)
        cx, cy = arr[:, 1] * w, arr[:, 2] * h
        bw, bh = arr[:, 3] * w, arr[:, 4] * h
        hb = np.stack([cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], 1)
        return img, hb, arr[:, 0].astype(np.int64) + 1  # 0-based -> 1-based

    def _load_mosaic(self, idx, rng):
        """Four images on a 2S x 2S canvas around a jittered centre, the
        affine, then the 2x reduction to S x S."""
        s = self.img_size
        yc = int(rng.uniform(s // 2, 2 * s - s // 2))
        xc = int(rng.uniform(s // 2, 2 * s - s // 2))
        idxs = [idx] + [int(rng.integers(len(self))) for _ in range(3)]
        canvas = np.full((2 * s, 2 * s, 3), 114.0, np.float32)
        all_b, all_l = [], []
        for i, ix in enumerate(idxs):
            img, hb, lab = self._load_raw(ix)
            h0, w0 = img.shape[:2]
            r = s / max(h0, w0)
            if r != 1:
                img = resize_linear(img, (int(w0 * r), int(h0 * r)))
                hb = hb * r
            h, w = img.shape[:2]
            if i == 0:  # top left
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
                x1b, y1b = 0, h - (y2a - y1a)
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(2 * s, yc + h)
                x1b, y1b = w - (x2a - x1a), 0
            else:  # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(2 * s, yc + h)
                x1b, y1b = 0, 0
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y1b + (y2a - y1a), x1b:x1b + (x2a - x1a)]
            if len(hb):
                b = hb.copy()
                b[:, 0::2] += x1a - x1b
                b[:, 1::2] += y1a - y1b
                all_b.append(b)
                all_l.append(lab)
        if all_b:
            boxes = np.concatenate(all_b, 0).clip(0, 2 * s)
            labels = np.concatenate(all_l, 0)
        else:
            boxes = np.zeros((0, 4), np.float32)
            labels = np.zeros((0,), np.int64)
        canvas, boxes, labels = random_affine(
            canvas, boxes, labels, rng, degrees=self.degrees, translate=self.translate,
            scale=self.scale)
        return resize_linear(canvas, (s, s)), boxes * 0.5, labels

    # ------------------------------------------------------------------
    def load_sample(self, idx, rng=None):
        rng = rng or np.random.default_rng()
        if self.augment and self.mosaic:
            img, boxes, labels = self._load_mosaic(idx, rng)
        else:
            img, boxes, labels = self._load_raw(idx)
            img, s, (dx, dy) = letterbox(img, self.img_size, scaleup=self.augment)
            if len(boxes):
                boxes = boxes * s
                boxes[:, 0::2] += dx
                boxes[:, 1::2] += dy
        if self.augment:
            if self.hsv:
                img = augment_hsv(img, rng)
            if rng.random() < self.fliplr:
                img = np.ascontiguousarray(img[:, ::-1])
                if len(boxes):
                    w = img.shape[1]
                    boxes = boxes.copy()
                    boxes[:, [0, 2]] = w - boxes[:, [2, 0]]
        target = {
            "hboxes": boxes.astype(np.float32),
            "labels": labels.astype(np.int64),
            "img_size": (img.shape[1], img.shape[0]),
            "ori_img_size": (img.shape[1], img.shape[0]),
            "scale_factor": 1.0,
            "filename": self.img_infos[idx]["filename"],
            "img_id": idx,
        }
        return img.astype(np.float32) / 255.0, target

    # ------------------------------------------------------------------
    def collate(self, samples):
        B, S, K = len(samples), self.img_size, self.max_gt
        images = np.zeros((B, S, S, 3), np.float32)
        gt_hboxes = np.zeros((B, K, 4), np.float32)
        gt_labels = np.zeros((B, K), np.int32)
        gt_mask = np.zeros((B, K), bool)
        metas = []
        for i, (img, t) in enumerate(samples):
            h, w = img.shape[:2]
            images[i, :min(h, S), :min(w, S)] = img[:S, :S]
            k = min(len(t["hboxes"]), K)
            if k:
                gt_hboxes[i, :k] = t["hboxes"][:k]
                gt_labels[i, :k] = t["labels"][:k]
                gt_mask[i, :k] = True
            metas.append({k2: t.get(k2) for k2 in
                          ("img_size", "ori_img_size", "scale_factor", "filename", "img_id")})
            # the gts evaluate() reads: letterboxed xyxy boxes, 1-based labels
            metas[-1]["hboxes"] = t["hboxes"]
            metas[-1]["labels"] = t["labels"]
        batch = {
            "images": images,
            "targets": {
                "gt_hboxes": gt_hboxes,
                "gt_labels": gt_labels,
                "gt_mask": gt_mask,
                "scale_factor": np.asarray([m["scale_factor"] for m in metas], np.float32),
            },
        }
        return batch, metas

    # ------------------------------------------------------------------
    def evaluate(self, results, work_dir=None, epoch=None, **kw):
        """COCO-protocol hbb mAP (`coco.py::coco_map`) of the detections
        against the gts the batches carried."""
        from .coco import coco_map

        dets, gts = {}, {}
        max_label = 0
        for det, meta in results:
            img_id = meta["img_id"]
            hbb = np.asarray(det["boxes"]).reshape(-1, 4)
            valid = np.asarray(det.get("valid", np.ones(len(hbb), bool))).astype(bool)
            dets[img_id] = (hbb[valid], np.asarray(det["scores"])[valid],
                            np.asarray(det["labels"])[valid])
            ghbb = np.asarray(meta.get("hboxes", np.zeros((0, 4)))).reshape(-1, 4)
            glab = np.asarray(meta.get("labels", np.zeros(0))).reshape(-1)
            gts[img_id] = (ghbb, glab)
            if len(glab):
                max_label = max(max_label, int(glab.max()))
        num_classes = len(self.CLASSES) if getattr(self, "CLASSES", None) else max(max_label, 1)
        ap = coco_map(dets, gts, num_classes)
        return {"eval/coco_mAP": ap["mAP"], "eval/coco_mAP50": ap["mAP50"],
                "eval/0_meanAP": ap["mAP50"]}
