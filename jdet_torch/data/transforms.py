"""Host-side per-sample transforms (numpy) for the DOTA RetinaNet configs.

Port of `jdet_tpu/data/transforms.py`: the box helpers
(`norm_angle_np`, `rbox_to_poly_np`, `poly_to_rbox_np`, :32-61),
`Compose` :71, `Resize`/`RotatedResize` :95-157,
`RotatedRandomFlip`/`RandomFlip` :160-221, `RandomRotateAug` :224, `Pad`
:280, SSD's `MinIoURandomCrop` :353, `Expand` :427 and
`PhotoMetricDistortion` :455 (with `rgb_to_hsv_u8` / `hsv_to_rgb_u8`,
cv2's uint8 HSV conversions on numpy), and `Normalize` :507, registered
in `TRANSFORMS` under the same names. A transform maps (image, target, rng) to (image, target), where
target holds rboxes/polys/hboxes (and their *_ignore) numpy arrays and
meta keys, and rng is a `np.random.Generator`.

`Resize` does not call cv2: `resize_linear` is `cv2.resize(INTER_LINEAR)`
on numpy, OpenCV's own fixed point for uint8 images, to the last bit.
"""
from __future__ import annotations

import math

import numpy as np

from ..utils.registry import TRANSFORMS, build_from_cfg


def norm_angle_np(a):
    return (a - (-np.pi / 4)) % np.pi + (-np.pi / 4)


def rbox_to_poly_np(rb):
    if rb is None or len(rb) == 0:
        return np.zeros((0, 8), np.float32)
    cx, cy, w, h, t = rb[:, 0], rb[:, 1], rb[:, 2], rb[:, 3], rb[:, 4]
    c, s = np.cos(t), np.sin(t)
    dx = np.stack([-w / 2, w / 2, w / 2, -w / 2], 1)
    dy = np.stack([-h / 2, -h / 2, h / 2, h / 2], 1)
    xs = cx[:, None] + c[:, None] * dx - s[:, None] * dy
    ys = cy[:, None] + s[:, None] * dx + c[:, None] * dy
    return np.stack([xs, ys], -1).reshape(-1, 8).astype(np.float32)


def poly_to_rbox_np(polys):
    if polys is None or len(polys) == 0:
        return np.zeros((0, 5), np.float32)
    p = polys.reshape(-1, 4, 2).astype(np.float64)
    e1 = np.linalg.norm(p[:, 0] - p[:, 1], axis=-1)
    e2 = np.linalg.norm(p[:, 1] - p[:, 2], axis=-1)
    a1 = np.arctan2(p[:, 1, 1] - p[:, 0, 1], p[:, 1, 0] - p[:, 0, 0])
    a2 = np.arctan2(p[:, 3, 1] - p[:, 0, 1], p[:, 3, 0] - p[:, 0, 0])
    ang = norm_angle_np(np.where(e1 > e2, a1, a2))
    cx = (p[:, 0, 0] + p[:, 2, 0]) / 2
    cy = (p[:, 0, 1] + p[:, 2, 1]) / 2
    w = np.maximum(e1, e2)
    h = np.minimum(e1, e2)
    return np.stack([cx, cy, w, h, ang], 1).astype(np.float32)


INTER_RESIZE_COEF_BITS = 11


def _linear_taps(n_out, n_in, clamp):
    """OpenCV's `resizeGeneric_` source indices and float32 weights:
    fx = float((d + 0.5) * scale - 0.5) with scale = 1 / (n_out / n_in) in
    double, split into floor and fraction. Columns clamp at the borders
    (index 0 or n_in - 1, fraction 0); rows do not (`clamp=False`): their
    source rows clip into the image while both weights stay."""
    scale = 1.0 / (n_out / n_in)
    f = ((np.arange(n_out) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    if clamp:
        edge = (i0 < 0) | (i0 >= n_in - 1)
        f[edge] = 0
        i0 = np.clip(i0, 0, n_in - 1)
    return i0, np.float32(1) - f, f


def resize_linear(image, size):
    """`cv2.resize(image, size, interpolation=INTER_LINEAR)` for an (H, W)
    or (H, W, C) image, size=(w, h), to the last bit.

    uint8 runs OpenCV's fixed point (`INTER_RESIZE_COEF_BITS` = 11): each
    weight rounded to nearest as `saturate_cast<short>(w * 2048)`, the
    horizontal pass summed exactly in int32, and the vertical pass as
    OpenCV's `VResizeLinearVec_32s8u` sums it, each row's term shifted
    right by 4, multiplied by its weight keeping the high 16 bits, the two
    added and shifted right by 2 with rounding, then saturated. With IPP on
    or off, cv2 5.0 gives these bytes. Other dtypes take OpenCV's own float
    path, horizontal then vertical in float32; cv2 with IPP on (its
    default) runs IPP's float resize instead, up to ~0.007 away on 0..255
    values, so equality holds against `cv2.ipp.setUseIPP(False)`.
    An exact 2x reduction is INTER_AREA's 2x2 mean, as in OpenCV."""
    nw, nh = size
    h, w = image.shape[:2]
    if (nw, nh) == (w, h):
        return image.copy()
    src = image.reshape(h, w, -1)
    if (w, h) == (2 * nw, 2 * nh):
        q = src.reshape(nh, 2, nw, 2, -1)
        if image.dtype == np.uint8:
            blocks = q.astype(np.int32).sum((1, 3))
            return ((blocks + 2) >> 2).astype(np.uint8).reshape(nh, nw, *image.shape[2:])
        a, b, c, d = (q[:, i, :, j].reshape(nh, -1).astype(np.float32)
                      for i in (0, 1) for j in (0, 1))
        # OpenCV's 4-lane vector loop (1 or 4 channels) pairs the rows over
        # the row's first multiple of 4 values; its scalar loop sums left
        # to right
        total = a + b + c + d
        if src.shape[2] in (1, 4):
            k = total.shape[1] // 4 * 4
            total[:, :k] = (a[:, :k] + b[:, :k]) + (c[:, :k] + d[:, :k])
        return (total * np.float32(0.25)).astype(image.dtype).reshape(nh, nw, *image.shape[2:])
    x0, a0, a1 = _linear_taps(nw, w, clamp=True)
    x1 = np.minimum(x0 + 1, w - 1)
    y0, b0, b1 = _linear_taps(nh, h, clamp=False)
    r0, r1 = np.clip(y0, 0, h - 1), np.clip(y0 + 1, 0, h - 1)
    if image.dtype == np.uint8:
        one = np.float32(1 << INTER_RESIZE_COEF_BITS)
        a0, a1, b0, b1 = (np.rint(c * one).astype(np.int32) for c in (a0, a1, b0, b1))
        img = src.astype(np.int32)
        rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
        t0 = ((rows[r0] >> 4) * b0[:, None, None]) >> 16
        t1 = ((rows[r1] >> 4) * b1[:, None, None]) >> 16
        out = np.clip((t0 + t1 + 2) >> 2, 0, 255).astype(np.uint8)
    else:
        img = src.astype(np.float32)
        rows = img[:, x0] * a0[None, :, None] + img[:, x1] * a1[None, :, None]
        out = (rows[r0] * b0[:, None, None] + rows[r1] * b1[:, None, None]).astype(image.dtype)
    return out.reshape(nh, nw, *image.shape[2:])


_BOX_KEYS = [
    "bboxes", "hboxes", "rboxes", "polys",
    "hboxes_ignore", "polys_ignore", "rboxes_ignore",
]


@TRANSFORMS.register_module()
class Compose:
    def __init__(self, transforms=None):
        self.transforms = [
            build_from_cfg(t, TRANSFORMS) if isinstance(t, dict) else t
            for t in transforms or []
        ]

    def __call__(self, image, target=None, rng=None):
        for t in self.transforms:
            image, target = t(image, target, rng=rng)
        return image, target


@TRANSFORMS.register_module()
class Resize:
    """min/max-size resize with optional ratio clamp (transforms.py:95)."""

    def __init__(self, min_size, max_size=None, keep_ratio=True):
        self.min_size = min_size if isinstance(min_size, (list, tuple)) else [min_size]
        self.max_size = max_size
        self.keep_ratio = keep_ratio

    def _pick_size(self, w, h, rng):
        size = self.min_size[
            0 if len(self.min_size) == 1 else int(rng.integers(len(self.min_size)))
        ]
        if not self.keep_ratio:
            return int(size), int(size)
        # size-ratio clamp (reference transforms.py:94-99): the sampled
        # multi-scale size is clipped to [short/1.5, short*1.5] so extreme
        # rescales never enter the train distribution
        short = w if w <= h else h
        size = int(np.clip(size, int(short / 1.5), int(short * 1.5)))
        if self.max_size is not None:
            mn, mx = float(min(w, h)), float(max(w, h))
            if mx / mn * size > self.max_size:
                size = int(round(self.max_size * mn / mx))
        if (w <= h and w == size) or (h <= w and h == size):
            return int(w), int(h)
        if w < h:
            return int(size), int(size * h / w)
        return int(size * w / h), int(size)

    def _resize_boxes(self, target, old_size, new_size):
        ow, oh = old_size
        nw, nh = new_size
        for key in _BOX_KEYS:
            b = target.get(key)
            if b is None or getattr(b, "ndim", 0) != 2 or len(b) == 0:
                continue
            if "rboxes" in key:
                b = rbox_to_poly_np(b)
            b = b.copy()
            b[:, 0::2] *= nw / ow
            b[:, 1::2] *= nh / oh
            b[:, 0::2] = np.clip(b[:, 0::2], 0, nw - 1)
            b[:, 1::2] = np.clip(b[:, 1::2], 0, nh - 1)
            if "rboxes" in key:
                b = poly_to_rbox_np(b)
            target[key] = b

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        h, w = image.shape[:2]
        nw, nh = self._pick_size(w, h, rng)
        resized = resize_linear(image, (nw, nh))
        if target is not None:
            self._resize_boxes(target, (w, h), (nw, nh))
            target["img_size"] = (nw, nh)
            target["scale_factor"] = nw / w
        return resized, target


@TRANSFORMS.register_module()
class RotatedResize(Resize):
    """Alias — box handling already goes through the poly roundtrip."""


@TRANSFORMS.register_module()
class RotatedRandomFlip:
    """Flip image + rotated boxes (transforms.py:160-221)."""

    def __init__(self, prob=0.5, direction="horizontal"):
        if direction not in ("horizontal", "vertical"):
            raise ValueError(f"flip direction must be horizontal or vertical, got {direction!r}")
        self.prob = prob
        self.direction = direction

    def _flip_rboxes(self, b, w, h):
        out = b.copy()
        if self.direction == "horizontal":
            out[:, 0] = w - b[:, 0] - 1
            out[:, 4] = norm_angle_np(np.pi - b[:, 4])
        else:
            out[:, 1] = h - b[:, 1] - 1
            out[:, 4] = norm_angle_np(-b[:, 4])
        return out

    def _flip_polys(self, b, w, h):
        out = b.copy()
        if self.direction == "horizontal":
            out[:, 0::2] = w - b[:, 0::2] - 1
        else:
            out[:, 1::2] = h - b[:, 1::2] - 1
        return out

    def _flip_hboxes(self, b, w, h):
        out = b.copy()
        if self.direction == "horizontal":
            out[:, 0] = w - b[:, 2]
            out[:, 2] = w - b[:, 0]
        else:
            out[:, 1] = h - b[:, 3]
            out[:, 3] = h - b[:, 1]
        return out

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() >= self.prob:
            return image, target
        h, w = image.shape[:2]
        image = image[:, ::-1] if self.direction == "horizontal" else image[::-1]
        image = np.ascontiguousarray(image)
        if target is not None:
            for key in _BOX_KEYS:
                b = target.get(key)
                if b is None or len(b) == 0:
                    continue
                if "rboxes" in key:
                    target[key] = self._flip_rboxes(b, w, h)
                elif "polys" in key:
                    target[key] = self._flip_polys(b, w, h)
                else:
                    target[key] = self._flip_hboxes(b, w, h)
            target["flip"] = self.direction
        return image, target


@TRANSFORMS.register_module()
class RandomFlip(RotatedRandomFlip):
    """Horizontal-box flip (transforms.py:212)."""


@TRANSFORMS.register_module()
class RandomRotateAug:
    """k*90-degree random rotation ("ra90", transforms.py:224)."""

    def __init__(self, rotate_ratio=1.0):
        self.rotate_ratio = rotate_ratio

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() >= self.rotate_ratio:
            return image, target
        k = int(rng.integers(0, 4))
        if k == 0:
            return image, target
        h, w = image.shape[:2]
        image = np.ascontiguousarray(np.rot90(image, k))
        if target is not None:
            # rotate by -k*90 deg in image coords (rot90 is CCW in array
            # space = CW in y-down image space)
            theta = -k * np.pi / 2
            c, s = math.cos(theta), math.sin(theta)
            cx0, cy0 = (w - 1) / 2.0, (h - 1) / 2.0
            nh, nw = image.shape[:2]
            cx1, cy1 = (nw - 1) / 2.0, (nh - 1) / 2.0

            def rot_pts(x, y):
                xr = c * (x - cx0) - s * (y - cy0) + cx1
                yr = s * (x - cx0) + c * (y - cy0) + cy1
                return xr, yr

            for key in _BOX_KEYS:
                b = target.get(key)
                if b is None or len(b) == 0:
                    continue
                if "rboxes" in key:
                    out = b.copy()
                    out[:, 0], out[:, 1] = rot_pts(b[:, 0], b[:, 1])
                    out[:, 4] = norm_angle_np(b[:, 4] + theta)
                    target[key] = out
                elif "polys" in key:
                    out = b.copy()
                    out[:, 0::2], out[:, 1::2] = rot_pts(b[:, 0::2], b[:, 1::2])
                    target[key] = out
                else:
                    polys = np.stack(
                        [b[:, 0], b[:, 1], b[:, 2], b[:, 1],
                         b[:, 2], b[:, 3], b[:, 0], b[:, 3]], 1
                    )
                    xr, yr = rot_pts(polys[:, 0::2], polys[:, 1::2])
                    target[key] = np.stack(
                        [xr.min(1), yr.min(1), xr.max(1), yr.max(1)], 1
                    ).astype(b.dtype)
            target["img_size"] = (nw, nh)
        return image, target


@TRANSFORMS.register_module()
class Pad:
    def __init__(self, size=None, size_divisor=None, pad_val=0):
        if (size is None) == (size_divisor is None):
            raise ValueError("Pad takes exactly one of size and size_divisor")
        self.size = size
        self.size_divisor = size_divisor
        self.pad_val = pad_val

    def __call__(self, image, target=None, rng=None):
        h, w = image.shape[:2]
        if self.size is not None:
            pw, ph = self.size
        else:
            ph = int(np.ceil(h / self.size_divisor)) * self.size_divisor
            pw = int(np.ceil(w / self.size_divisor)) * self.size_divisor
        out = np.full((ph, pw, image.shape[2]), self.pad_val, image.dtype)
        out[:h, :w] = image
        if target is not None:
            target["pad_shape"] = (pw, ph)
        return out, target


def _hbb_iou_np(patch, boxes):
    """IoU of one (4,) patch against (n, 4) boxes (reference :301)."""
    x1 = np.maximum(patch[0], boxes[:, 0])
    y1 = np.maximum(patch[1], boxes[:, 1])
    x2 = np.minimum(patch[2], boxes[:, 2])
    y2 = np.minimum(patch[3], boxes[:, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area_p = (patch[2] - patch[0]) * (patch[3] - patch[1])
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return inter / np.clip(area_p + area_b - inter, 1e-9, None)


def _box_centers(target):
    """(n, 2) centres from the first box key present: hboxes, bboxes,
    rboxes, polys (reference :313)."""
    for key in ("hboxes", "bboxes"):
        b = target.get(key)
        if b is not None and len(b):
            return (b[:, :2] + b[:, 2:4]) / 2, key
    b = target.get("rboxes")
    if b is not None and len(b):
        return b[:, :2].copy(), "rboxes"
    b = target.get("polys")
    if b is not None and len(b):
        return b.reshape(-1, 4, 2).mean(1), "polys"
    return np.zeros((0, 2), np.float32), None


def _translate_boxes(target, dx, dy, mask=None):
    """Shift every box key by (dx, dy); with `mask`, keep only its rows of
    the non-ignore keys, labels and difficult (reference :329)."""
    for key in _BOX_KEYS:
        b = target.get(key)
        if b is None or getattr(b, "ndim", 0) != 2 or len(b) == 0:
            continue
        b = b.copy()
        if mask is not None and not key.endswith("_ignore"):
            b = b[mask]
        if "rboxes" in key:
            b[:, 0] += dx
            b[:, 1] += dy
        else:
            b[:, 0::2] += dx
            b[:, 1::2] += dy
        target[key] = b
    if mask is not None:
        for key in ("labels", "difficult"):
            v = target.get(key)
            if v is not None and len(v) == len(mask):
                target[key] = v[mask]


@TRANSFORMS.register_module()
class MinIoURandomCrop:
    """The SSD crop (reference :353): draw a mode from (1, *min_ious, 0);
    1 keeps the image, otherwise up to 50 tries for a patch whose IoU with
    every box reaches the mode and that holds a box centre, then keep the
    boxes whose centres lie inside, clip the horizontal boxes to the patch
    and move everything into its frame. Draws from `rng` in the
    reference's order, so one seed gives one crop in both packages."""

    def __init__(self, min_ious=(0.1, 0.3, 0.5, 0.7, 0.9), min_crop_size=0.3,
                 bbox_clip_border=True):
        self.sample_mode = (1, *min_ious, 0)
        self.min_crop_size = min_crop_size
        self.bbox_clip_border = bbox_clip_border

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        h, w = image.shape[:2]
        centers, _ = _box_centers(target or {})
        while True:
            mode = self.sample_mode[int(rng.integers(len(self.sample_mode)))]
            if mode == 1:
                return image, target
            for _ in range(50):
                new_w = rng.uniform(self.min_crop_size * w, w)
                new_h = rng.uniform(self.min_crop_size * h, h)
                if new_h / new_w < 0.5 or new_h / new_w > 2:
                    continue
                left = rng.uniform(0, w - new_w)
                top = rng.uniform(0, h - new_h)
                patch = np.array([int(left), int(top), int(left + new_w), int(top + new_h)],
                                 np.float32)
                if patch[2] == patch[0] or patch[3] == patch[1]:
                    continue
                mask = None
                if len(centers):
                    hb = target.get("hboxes")
                    if hb is None or not len(hb):
                        hb = target.get("bboxes")
                    if hb is not None and len(hb) and _hbb_iou_np(patch, hb).min() < mode:
                        continue
                    mask = ((centers[:, 0] > patch[0]) & (centers[:, 1] > patch[1])
                            & (centers[:, 0] < patch[2]) & (centers[:, 1] < patch[3]))
                    if not mask.any():
                        continue
                crop = np.ascontiguousarray(
                    image[int(patch[1]):int(patch[3]), int(patch[0]):int(patch[2])])
                if target is not None:
                    if self.bbox_clip_border:
                        for key in ("hboxes", "bboxes"):
                            b = target.get(key)
                            if b is None or not len(b):
                                continue
                            b = b.copy()
                            b[:, 0::2] = np.clip(b[:, 0::2], patch[0], patch[2])
                            b[:, 1::2] = np.clip(b[:, 1::2], patch[1], patch[3])
                            target[key] = b
                    _translate_boxes(target, -patch[0], -patch[1], mask=mask)
                    target["img_size"] = (crop.shape[1], crop.shape[0])
                return crop, target


@TRANSFORMS.register_module()
class Expand:
    """Paste the image into a canvas filled with `mean`, `ratio` times its
    size, with probability `prob` (the SSD zoom-out, reference :427)."""

    def __init__(self, mean=(0, 0, 0), ratio_range=(1, 4), prob=0.5):
        self.mean = np.asarray(mean, np.float32)
        self.min_ratio, self.max_ratio = ratio_range
        self.prob = prob

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        if rng.random() > self.prob:
            return image, target
        h, w = image.shape[:2]
        ratio = rng.uniform(self.min_ratio, self.max_ratio)
        nw, nh = int(w * ratio), int(h * ratio)
        left = int(rng.uniform(0, nw - w))
        top = int(rng.uniform(0, nh - h))
        canvas = np.empty((nh, nw, image.shape[2]), image.dtype)
        canvas[...] = self.mean
        canvas[top:top + h, left:left + w] = image
        if target is not None:
            _translate_boxes(target, left, top)
            target["img_size"] = (nw, nh)
        return canvas, target


HSV_SHIFT = 12  # OpenCV's fixed point in RGB2HSV_b


def _div_table(numerator):
    """OpenCV's `saturate_cast<int>(numerator / i)` for i = 1..255, 0 at 0."""
    table = np.zeros(256, np.int64)
    table[1:] = np.rint(numerator / np.arange(1, 256, dtype=np.float64))
    return table


_SDIV = _div_table(255 << HSV_SHIFT)
_HDIV180 = _div_table((180 << HSV_SHIFT) / 6.0)
# cv2's HSV2RGB_b takes a row's pixels 32 at a time in vector code (fused
# multiply-adds, truncation) and the rest one at a time (rounding)
HSV2RGB_VECTOR_PIXELS = 32
# the sextant table of OpenCV's HSV2RGB: which of (v, p, q, t) each of
# b, g, r takes
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv_u8(rgb):
    """`cv2.cvtColor(rgb, COLOR_RGB2HSV)` of uint8 (..., 3): OpenCV's
    integer arithmetic with its division tables, hue 0..179."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    s = (diff * _SDIV[v] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV180[diff] + (1 << (HSV_SHIFT - 1))) >> HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv):
    """`cv2.cvtColor(hsv, COLOR_HSV2RGB)` of uint8 (H, W, 3), hue 0..179,
    as cv2 5.0 computes it on an AVX2 host: float32 h * (6 / 180),
    s / 255, v / 255 (as products with the float32 reciprocals), the
    sextant's p = v (1 - s), q = v (1 - s f), t = v (1 - s (1 - f)), with
    1 - s f and 1 - s (1 - f) fused multiply-adds, times 255. Each row's
    first multiple of 32 pixels runs OpenCV's vector code, which truncates;
    the others run its scalar code, which rounds to nearest."""
    if hsv.ndim != 3 or (hsv[..., 0] >= 180).any():
        raise ValueError("hsv_to_rgb_u8 takes (H, W, 3) uint8 with hue 0..179")
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    f = h - sector
    one = f32(1)

    def fma_one(a, b):  # one - a * b rounded once; exact: a * b fits a double
        return (1.0 - a.astype(np.float64) * b.astype(np.float64)).astype(f32)

    vector = np.arange(hsv.shape[1]) < hsv.shape[1] // HSV2RGB_VECTOR_PIXELS * HSV2RGB_VECTOR_PIXELS
    tab = np.stack([v, v * (one - s), v * fma_one(s, f), v * fma_one(s, one - f)], -1)
    bgr = np.take_along_axis(tab, _SECTORS[sector.astype(np.int64)], -1)
    bgr = np.where((s == 0)[..., None], v[..., None], bgr) * f32(255)
    bgr = np.where(vector[:, None], np.floor(bgr), np.rint(bgr))
    return np.ascontiguousarray(np.clip(bgr, 0, 255).astype(np.uint8)[..., ::-1])


@TRANSFORMS.register_module()
class PhotoMetricDistortion:
    """The SSD photometric distortion (reference :455): a brightness
    delta, a contrast scale before or after, and a saturation scale and a
    hue shift in OpenCV's uint8 HSV, each with probability 0.5, drawn from
    `rng` in the reference's order. The reference's truncations to uint8
    before and after the HSV round trip are kept. Returns float32 0..255."""

    def __init__(self, brightness_delta=32, contrast_range=(0.5, 1.5),
                 saturation_range=(0.5, 1.5), hue_delta=18):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta

    def __call__(self, image, target=None, rng=None):
        rng = rng or np.random.default_rng()
        img = image.astype(np.float32)
        if rng.random() < 0.5:
            img = img + rng.uniform(-self.brightness_delta, self.brightness_delta)
        contrast_first = rng.random() < 0.5

        def contrast(img):
            if rng.random() < 0.5:
                img = img * rng.uniform(*self.contrast_range)
            return img

        if contrast_first:
            img = contrast(img)
        do_sat = rng.random() < 0.5
        do_hue = rng.random() < 0.5
        if do_sat or do_hue:
            hsv = rgb_to_hsv_u8(np.clip(img, 0, 255).astype(np.uint8)).astype(np.float32)
            if do_sat:
                hsv[..., 1] *= rng.uniform(*self.saturation_range)
            if do_hue:
                hsv[..., 0] = (hsv[..., 0]
                               + rng.uniform(-self.hue_delta, self.hue_delta) / 2) % 180
            hsv[..., 1:] = np.clip(hsv[..., 1:], 0, 255)
            img = hsv_to_rgb_u8(hsv.astype(np.uint8)).astype(np.float32)
        if not contrast_first:
            img = contrast(img)
        return np.clip(img, 0, 255), target


@TRANSFORMS.register_module()
class Normalize:
    def __init__(self, mean, std, to_bgr=True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self._inv_std = (1.0 / self.std).astype(np.float32)
        self.to_bgr = to_bgr

    def __call__(self, image, target=None, rng=None):
        image = image.astype(np.float32)
        if self.to_bgr:
            image = np.ascontiguousarray(image[..., ::-1])
        np.subtract(image, self.mean, out=image)
        np.multiply(image, self._inv_std, out=image)
        if target is not None:
            target["img_norm_cfg"] = dict(
                mean=self.mean.tolist(), std=self.std.tolist(), to_bgr=self.to_bgr
            )
        return image, target
