"""Detection drawing: oriented boxes and labels on images.

Port of `jdet_tpu/utils/visualization.py` (`draw_polys` :16,
`visualize_results` :41, `draw_bboxes` :70, `_color_val` :148,
`visualize_gt` :162) on the port's numpy rasterizer (`utils/draw.py`,
which reproduces cv2's `polylines` and `putText` pixel for pixel) and
PNG codec (`data/image_io.py`): the GPU machine has neither cv2 nor PIL.

The colours land as the reference's do. `draw_polys` draws on the BGR
flip of the image with the palette's tuple as it is and flips back, so a
saved pixel holds the palette colour reversed; `draw_bboxes` draws on the
RGB array, so its colours land as given. Images are read and written as
RGB (`image_io.imread`/`imwrite`); the reference's `cv2.imread` /
`cv2.imwrite` pair round-trips the same pixels. Where the reference's
`cv2.imread` returns None (a `.npy` tile), the image is skipped.
"""
from __future__ import annotations

import os

import numpy as np

from ..config.constants import class_palette
from ..data.image_io import imread, imwrite
from .draw import polylines, put_text


def _read_rgb(path):
    """The RGB pixels of an image file, or None where the reference's
    `cv2.imread` reads none (a missing file, a `.npy` array)."""
    if not os.path.isfile(path) or path.lower().endswith(".npy"):
        return None
    return imread(path)


def draw_polys(image, polys, scores=None, labels=None, class_names=None,
               score_thr=0.3, thickness=2):
    """(H, W, 3) RGB image, (n, 8) polygons -> the annotated RGB image:
    each polygon at or above `score_thr` in its class's palette colour,
    with "name score" where class names are given."""
    img = np.ascontiguousarray(image[..., ::-1].astype(np.uint8))  # RGB -> BGR
    n_cls = len(class_names) if class_names else int(
        labels.max() + 1 if labels is not None and len(labels) else 1)
    palette = class_palette(max(n_cls, 1))
    for i, poly in enumerate(np.asarray(polys).reshape(-1, 4, 2)):
        s = float(scores[i]) if scores is not None else 1.0
        if s < score_thr:
            continue
        c = int(labels[i]) if labels is not None else 0
        color = tuple(int(x) for x in palette[c % len(palette)])
        pts = poly.astype(np.int32)
        polylines(img, pts, True, color, thickness)
        if class_names:
            put_text(img, f"{class_names[c]} {s:.2f}", tuple(pts[0]), 0.5, color)
    return img[..., ::-1]


def visualize_results(results, class_names, images_dir, save_dir, score_thr=0.3):
    """results: [(det dict, meta)]. Writes each image with its valid
    detections drawn to `save_dir`, under its own file name."""
    os.makedirs(save_dir, exist_ok=True)
    for det, meta in results:
        img = _read_rgb(os.path.join(images_dir, meta["filename"]))
        if img is None:
            continue
        valid = np.asarray(det.get("valid", np.ones(len(det["polys"]), bool)))
        out = draw_polys(img, np.asarray(det["polys"])[valid], np.asarray(det["scores"])[valid],
                         np.asarray(det["labels"])[valid], class_names, score_thr)
        imwrite(os.path.join(save_dir, os.path.basename(meta["filename"])),
                np.ascontiguousarray(out))
    return save_dir


def draw_bboxes(img, bboxes, labels=None, scores=None, class_names=None, score_thr=0.0,
                colors="random", thickness=1, with_text=True, out_file=None):
    """Boxes of width 4 (x1, y1, x2, y2), 5 (cx, cy, w, h, theta) or 8
    (polygons) on an RGB array or an image path, the best scores drawn
    last, each in its class's colour ('random' for the palette, one
    colour, or a list), with "cls|score" text; optionally written to
    `out_file`. Returns the annotated RGB array."""
    from ..data.transforms import rbox_to_poly_np

    if isinstance(img, str):
        img = imread(img)
    img = np.ascontiguousarray(np.asarray(img).astype(np.uint8))
    bboxes = np.asarray(bboxes, np.float32).reshape(
        -1, bboxes.shape[-1] if np.ndim(bboxes) > 1 else len(bboxes))
    n = bboxes.shape[0]
    labels = (np.zeros(n, np.int32) if labels is None
              else np.asarray(labels, np.int32).reshape(-1))
    if scores is not None:
        scores = np.asarray(scores, np.float32).reshape(-1)
        keep = scores >= score_thr
        bboxes, labels, scores = bboxes[keep], labels[keep], scores[keep]
        order = np.argsort(scores)  # ascending: the best drawn last
        bboxes, labels, scores = bboxes[order], labels[order], scores[order]
    if bboxes.shape[0] == 0:
        if out_file is not None:
            imwrite(out_file, img)
        return img

    k = bboxes.shape[1]
    if k == 4:
        x1, y1, x2, y2 = bboxes.T
        polys = np.stack([x1, y1, x2, y1, x2, y2, x1, y2], -1)
    elif k == 5:
        polys = rbox_to_poly_np(bboxes)
    elif k == 8:
        polys = bboxes
    else:
        raise ValueError(f"bboxes must be (N, 4|5|8), got width {k}")

    n_cls = int(labels.max()) + 1 if len(labels) else 1
    if isinstance(colors, str) and colors == "random":
        palette = class_palette(n_cls)
    else:
        one = _color_val(colors)
        palette = one if isinstance(one, list) else [one] * n_cls
    for i, poly in enumerate(polys.reshape(-1, 4, 2)):
        c = int(labels[i])
        color = tuple(int(x) for x in np.asarray(palette[c % len(palette)]))
        pts = np.round(poly).astype(np.int32)
        polylines(img, pts, True, color, thickness)
        if with_text:
            txt = f"cls: {c}" if class_names is None else str(class_names[c])
            if scores is not None:
                txt += f"|{scores[i]:.02f}"
            put_text(img, txt, tuple(pts[0]), 0.4, color)
    if out_file is not None:
        imwrite(out_file, img)
    return img


def _color_val(colors):
    """'green' / (r, g, b) / a list of either -> RGB tuple(s)."""
    named = {"green": (0, 255, 0), "red": (255, 0, 0), "blue": (0, 0, 255),
             "yellow": (255, 255, 0), "cyan": (0, 255, 255),
             "magenta": (255, 0, 255), "white": (255, 255, 255),
             "black": (0, 0, 0)}
    if isinstance(colors, str):
        return named[colors]
    if isinstance(colors, (list, tuple)) and len(colors) and isinstance(
            colors[0], (list, tuple, str, np.ndarray)):
        return [_color_val(c) for c in colors]
    return tuple(int(c) for c in colors)


def visualize_gt(dataset, save_dir, limit=None, colors="random", thickness=2):
    """Draw a dataset's ground-truth boxes (its parsed annotations, 1-based
    labels) to `save_dir`. Returns the list of written files."""
    os.makedirs(save_dir, exist_ok=True)
    names = getattr(dataset, "CLASSES", None)
    written = []
    for info in dataset.img_infos[:limit]:
        img = _read_rgb(os.path.join(dataset.images_dir, info["filename"]))
        if img is None:
            continue
        ann = info["ann"]
        out = draw_bboxes(img, np.asarray(ann["bboxes"], np.float32),
                          labels=np.asarray(ann["labels"], np.int32) - 1,
                          class_names=names, colors=colors, thickness=thickness)
        f = os.path.join(save_dir, os.path.basename(info["filename"]))
        imwrite(f, out)
        written.append(f)
    return written
