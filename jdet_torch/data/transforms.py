"""Host-side per-sample transforms (numpy) for the DOTA RetinaNet configs.

Port of `jdet_tpu/data/transforms.py`: the box helpers
(`norm_angle_np`, `rbox_to_poly_np`, `poly_to_rbox_np`, :32-61),
`Compose` :71, `Resize`/`RotatedResize` :95-157,
`RotatedRandomFlip`/`RandomFlip` :160-221, `RandomRotateAug` :224, `Pad`
:280 and `Normalize` :507, registered in `TRANSFORMS` under the same
names. A transform maps (image, target, rng) to (image, target), where
target holds rboxes/polys/hboxes (and their *_ignore) numpy arrays and
meta keys, and rng is a `np.random.Generator`.

`Resize` does not call cv2: `resize_bilinear` is its bilinear resize with
half-pixel centres and no antialiasing, as `cv2.resize(INTER_LINEAR)`.
cv2 computes uint8 images in fixed point; this one computes in float32
and rounds, so a pixel may differ from cv2's by at most one grey level.
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


def _bilinear_taps(n_out, n_in):
    """Source index pairs and weights of each output coordinate:
    half-pixel centres, clamped at the borders (cv2's INTER_LINEAR)."""
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0, n_in - 1)
    i0 = np.floor(src).astype(np.int64)
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (src - i0).astype(np.float32)


def resize_bilinear(image, size):
    """Resize an (H, W, C) image to size=(w, h) bilinearly; uint8 images
    are rounded to nearest, within one grey level of cv2's fixed point."""
    nw, nh = size
    h, w = image.shape[:2]
    if (nw, nh) == (w, h):
        return image.copy()
    x0, x1, fx = _bilinear_taps(nw, w)
    y0, y1, fy = _bilinear_taps(nh, h)
    img = image.astype(np.float32)
    rows = img[y0] * (1 - fy)[:, None, None] + img[y1] * fy[:, None, None]
    out = rows[:, x0] * (1 - fx)[None, :, None] + rows[:, x1] * fx[None, :, None]
    if image.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


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
        resized = resize_bilinear(image, (nw, nh))
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
