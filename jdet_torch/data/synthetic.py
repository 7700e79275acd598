"""Synthetic DOTA data: a tiled tree (PNG tiles of filled rotated
rectangles and a `labels.pkl` in the reference's record format), and raw
scenes with DOTA labelTxt files for the tiler.

No DOTA data ships with the repository, so `chip_smoke.py` and the tests
drive the data pipeline on images drawn here from a seed with numpy and
written with the port's PNG writer; the tiles' row filter cycles through
all five from tile to tile.
"""
from __future__ import annotations

import os
import pickle

import numpy as np

from ..config.constants import get_classes_by_name
from .image_io import imwrite
from .transforms import rbox_to_poly_np


def fill_rbox(img, rbox, color):
    """Paint the pixels whose centres lie inside rbox (cx, cy, w, h, theta)."""
    cx, cy, w, h, t = (float(v) for v in rbox)
    poly = rbox_to_poly_np(np.asarray([rbox], np.float32))[0]
    H, W = img.shape[:2]
    x0, x1 = max(int(poly[0::2].min()), 0), min(int(np.ceil(poly[0::2].max())) + 1, W)
    y0, y1 = max(int(poly[1::2].min()), 0), min(int(np.ceil(poly[1::2].max())) + 1, H)
    if x0 >= x1 or y0 >= y1:
        return
    dy, dx = np.mgrid[y0:y1, x0:x1]
    dx, dy = dx - cx, dy - cy
    c, s = np.cos(t), np.sin(t)
    inside = (np.abs(dx * c + dy * s) <= w / 2) & (np.abs(-dx * s + dy * c) <= h / 2)
    img[y0:y1, x0:x1][inside] = color


def make_synthetic_dota(root, n_images=16, size=1024, n_obj=(24, 64), n_classes=15,
                        seed=0):
    """Write root/images/tile_XXXX.png and root/labels.pkl; returns
    (images_dir, labels.pkl path). Each tile holds n_obj[0]..n_obj[1]
    rectangles with w >= h and theta in [-pi/4, 3pi/4), the form the
    reference's tiling gives, over dark noise; labels are 1-based."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    scale = size / 1024
    infos = []
    for i in range(n_images):
        img = rng.integers(0, 40, (size, size, 3), dtype=np.uint8)
        n = int(rng.integers(n_obj[0], n_obj[1] + 1))
        w = rng.uniform(24, 160, n) * scale
        h = np.minimum(rng.uniform(12, 80, n) * scale, w)
        rboxes = np.stack([
            rng.uniform(0.1, 0.9, n) * size, rng.uniform(0.1, 0.9, n) * size, w, h,
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
        labels = rng.integers(1, n_classes + 1, n).astype(np.int32)
        for rb in rboxes:
            fill_rbox(img, rb, rng.integers(120, 256, 3))
        name = f"tile_{i:04d}.png"
        imwrite(os.path.join(img_dir, name), img, filter_type=i % 5)
        infos.append({
            "filename": name, "width": size, "height": size,
            "ann": {"bboxes": rboxes, "labels": labels,
                    "bboxes_ignore": np.zeros((0, 5), np.float32),
                    "labels_ignore": np.zeros((0,), np.int32)},
        })
    ann = os.path.join(root, "labels.pkl")
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return img_dir, ann


def make_synthetic_raw_dota(root, sizes=((2000, 1500), (2100, 900)),
                            corner_only=(False, True), seed=0):
    """Write root/images/scene_XXXX.png (RGB, Sub-filtered) and
    root/labelTxt/scene_XXXX.txt, DOTA's raw layout, one scene per (w, h)
    of `sizes`; returns (images dir, labelTxt dir). Each scene holds 40-80
    rectangles. Each label file starts with DOTA's two header lines, then
    has one line per rectangle: its four corners, a DOTA class name and a
    difficult flag (0, 1 or 2). A scene whose `corner_only` is True keeps
    its objects in its top-left 700 x 400 pixels, so that the tiler sees
    windows with no object."""
    rng = np.random.default_rng(seed)
    classes = get_classes_by_name("DOTA")
    img_dir = os.path.join(root, "images")
    label_dir = os.path.join(root, "labelTxt")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    for i, ((w, h), corner) in enumerate(zip(sizes, corner_only)):
        img = rng.integers(0, 40, (h, w, 3), dtype=np.uint8)
        n = int(rng.integers(40, 81))
        span = (700, 400) if corner else (w, h)
        bw = rng.uniform(24, 200, n)
        rboxes = np.stack([
            rng.uniform(0, span[0], n), rng.uniform(0, span[1], n), bw,
            np.minimum(rng.uniform(12, 100, n), bw),
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
        lines = ["imagesource:GoogleEarth", "gsd:0.146343590398"]
        for rb, poly in zip(rboxes, rbox_to_poly_np(rboxes)):
            fill_rbox(img, rb, rng.integers(120, 256, 3))
            diff = int(rng.choice(3, p=(0.8, 0.15, 0.05)))
            coords = " ".join(f"{v:.1f}" for v in poly)
            lines.append(f"{coords} {classes[int(rng.integers(len(classes)))]} {diff}")
        name = f"scene_{i:04d}"
        imwrite(os.path.join(img_dir, name + ".png"), img, filter_type=1)
        with open(os.path.join(label_dir, name + ".txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return img_dir, label_dir
