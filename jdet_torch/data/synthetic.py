"""Synthetic DOTA data: a tiled tree (PNG tiles of filled rotated
rectangles and a `labels.pkl` in the reference's record format), and raw
scenes with DOTA labelTxt files for the tiler; and source trees of the
SSDD / SSDD+, FAIR, COCO and YOLO formats around given JPEG or TIFF
files.

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


def _random_quads(rng, w, h, n):
    """n (x1, y1, ..., x4, y4) rotated rectangles inside a w x h image and
    their enclosing (xmin, ymin, xmax, ymax)."""
    side = min(w, h)
    rboxes = np.stack([rng.uniform(0.2 * w, 0.8 * w, n), rng.uniform(0.2 * h, 0.8 * h, n),
                       rng.uniform(0.08, 0.3, n) * side, rng.uniform(0.04, 0.15, n) * side,
                       rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
    quads = np.round(rbox_to_poly_np(rboxes).astype(np.float64), 1)
    quads[:, 0::2] = np.clip(quads[:, 0::2], 0, w - 1)
    quads[:, 1::2] = np.clip(quads[:, 1::2], 0, h - 1)
    hboxes = np.stack([quads[:, 0::2].min(1), quads[:, 1::2].min(1),
                       quads[:, 0::2].max(1), quads[:, 1::2].max(1)], 1)
    return quads, hboxes


def _image_size(path):
    from .image_io import imread

    h, w = imread(path).shape[:2]
    return w, h


def make_ssdd_tree(root, jpegs, seed=0, n_obj=(1, 6)):
    """An SSDD / SSDD+ source tree: root/images/<i>.jpg (copies of the given
    JPEG files) and root/labels/<i>.xml, each object with a `bndbox` and a
    `rotated_bndbox` (x1..y4), difficult 0 or 1. Returns (images, labels)."""
    import shutil

    rng = np.random.default_rng(seed)
    img_dir, ann_dir = os.path.join(root, "images"), os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for i, src in enumerate(jpegs):
        name = f"{i + 1:06d}"
        shutil.copyfile(src, os.path.join(img_dir, name + ".jpg"))
        w, h = _image_size(src)
        quads, hboxes = _random_quads(rng, w, h, int(rng.integers(*n_obj)))
        objs = []
        for q, b in zip(quads, hboxes):
            rot = "".join(f"<{k}>{v}</{k}>" for k, v in zip(
                ("x1", "y1", "x2", "y2", "x3", "y3", "x4", "y4"), q))
            box = "".join(f"<{k}>{v}</{k}>" for k, v in zip(
                ("xmin", "ymin", "xmax", "ymax"), b))
            objs.append(f"<object><name>ship</name><difficult>{int(rng.random() < 0.2)}"
                        f"</difficult><bndbox>{box}</bndbox><rotated_bndbox>{rot}"
                        "</rotated_bndbox></object>")
        with open(os.path.join(ann_dir, name + ".xml"), "w") as f:
            f.write(f"<annotation><filename>{name}.jpg</filename>{''.join(objs)}</annotation>\n")
    return img_dir, ann_dir


def make_fair_tree(root, tiffs, dataset_type="FAIR1M_1_5", seed=0, n_obj=(2, 9)):
    """A FAIR source tree: root/images/<i>.tif (copies of the given TIFF
    files) and root/labelXml/<i>.xml in FAIR's format (class names with
    spaces, 5 points per object, the first repeated)."""
    import shutil

    rng = np.random.default_rng(seed)
    classes = [c.replace("_", " ") for c in get_classes_by_name(dataset_type)]
    img_dir, ann_dir = os.path.join(root, "images"), os.path.join(root, "labelXml")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(ann_dir, exist_ok=True)
    for i, src in enumerate(tiffs):
        shutil.copyfile(src, os.path.join(img_dir, f"{i + 1}.tif"))
        w, h = _image_size(src)
        quads, _ = _random_quads(rng, w, h, int(rng.integers(*n_obj)))
        objs = []
        for q in quads:
            pts = [f"{q[2 * k]:.6f},{q[2 * k + 1]:.6f}" for k in (0, 1, 2, 3, 0)]
            objs.append("<object><possibleresult><name>"
                        f"{classes[int(rng.integers(len(classes)))]}</name></possibleresult>"
                        "<points>" + "".join(f"<point>{p}</point>" for p in pts)
                        + "</points></object>")
        with open(os.path.join(ann_dir, f"{i + 1}.xml"), "w") as f:
            f.write(f"<annotation><objects>{''.join(objs)}</objects></annotation>\n")
    return img_dir, ann_dir


def make_coco_tree(root, images, n_classes=80, seed=0, n_obj=(1, 12)):
    """A COCO-style tree: root/images/<i><ext> (copies of the given image
    files) and root/instances.json with `n_classes` categories on ids
    sparse in 1..90 as COCO's are, xywh boxes and a few crowd
    annotations. Returns (images_dir, annotations_file)."""
    import json
    import shutil

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    os.makedirs(img_dir, exist_ok=True)
    cat_ids = np.sort(rng.choice(np.arange(1, 91), n_classes, replace=False))
    coco = {"images": [], "annotations": [],
            "categories": [{"id": int(c), "name": f"class_{c}"} for c in cat_ids]}
    for i, src in enumerate(images):
        name = f"{i:012d}{os.path.splitext(src)[1]}"
        shutil.copyfile(src, os.path.join(img_dir, name))
        w, h = _image_size(src)
        coco["images"].append({"id": i + 1, "file_name": name, "width": w, "height": h})
        _, hboxes = _random_quads(rng, w, h, int(rng.integers(*n_obj)))
        for b in hboxes:
            coco["annotations"].append({
                "id": len(coco["annotations"]) + 1, "image_id": i + 1,
                "category_id": int(rng.choice(cat_ids)),
                "bbox": [float(b[0]), float(b[1]), float(b[2] - b[0]), float(b[3] - b[1])],
                "area": float((b[2] - b[0]) * (b[3] - b[1])),
                "iscrowd": int(rng.random() < 0.05)})
    ann = os.path.join(root, "instances.json")
    with open(ann, "w") as f:
        json.dump(coco, f)
    return img_dir, ann


def make_yolo_tree(root, images, n_classes=80, seed=0, n_obj=(1, 12)):
    """A YOLO-format tree: root/images/<i><ext> (copies of the given image
    files) and root/labels/<i>.txt, one "cls cx cy w h" line per object
    (0-based class, centre and size normalized by the image's size); every
    fifth image's txt is empty. Returns (images_dir, labels_dir)."""
    import shutil

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "images")
    lab_dir = os.path.join(root, "labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    for i, src in enumerate(images):
        name = f"{i:06d}"
        shutil.copyfile(src, os.path.join(img_dir, name + os.path.splitext(src)[1]))
        w, h = _image_size(src)
        n = int(rng.integers(*n_obj))
        _, hb = _random_quads(rng, w, h, 0 if i % 5 == 4 else n)
        cls = rng.integers(0, n_classes, len(hb))
        with open(os.path.join(lab_dir, name + ".txt"), "w") as f:
            for c, b in zip(cls, hb):
                f.write(f"{c} {(b[0] + b[2]) / 2 / w:.6f} {(b[1] + b[3]) / 2 / h:.6f} "
                        f"{(b[2] - b[0]) / w:.6f} {(b[3] - b[1]) / h:.6f}\n")
    return img_dir, lab_dir
