"""Whole-image result merging: the test-time inverse of tiling.

Copy of `jdet_tpu/data/devkits/result_merge.py` (`parse_tile_name` :26,
`tile_to_original` :35, `merge_results` :42, `write_dota_submission`
:89), itself a mirror of the reference merge pipeline
(`python/jdet/data/devkits/result_merge.py`, `data_merge.py`): tile names
`name__rate__left___up` are parsed back (result_merge.py:227-235), polys
translated to original coordinates and divided by the rate
(poly2origpoly:199), then per-image per-class polygon NMS with an hbb
prefilter (py_cpu_nms_poly_fast:69-130) merges duplicate detections from
overlapping tiles; results are written as DOTA submission txts and
optionally zipped (data_merge.py:56-104).
"""
from __future__ import annotations

import os
import re
import zipfile
from collections import defaultdict

import numpy as np

from .polygon import nms_poly_np

_TILE_RE = re.compile(r"^(.*?)__([\d.]+)__(\d+)___(\d+)$")


def parse_tile_name(name):
    """'P0001__1.0__512___0' -> ('P0001', 1.0, 512, 0); plain names map to
    themselves with no offset."""
    m = _TILE_RE.match(name)
    if not m:
        return name, 1.0, 0, 0
    return m.group(1), float(m.group(2)), int(m.group(3)), int(m.group(4))


def tile_to_original(polys, rate, left, up):
    out = polys.astype(np.float64).copy()
    out[:, 0::2] += left
    out[:, 1::2] += up
    return out / rate


def merge_results(results, classes, iou_thr=0.1, per_class_thr=None):
    """Merge per-tile detections into per-original-image detections.

    Args:
      results: list of (det, meta) — det with numpy polys/scores/labels/
        valid; meta with 'filename' of the tile.
      iou_thr: merge-NMS polygon IoU threshold (or dict per class name).

    Returns {orig_name: {class_name: (m, 9) [poly8 + score]}}.
    """
    per_image = defaultdict(lambda: defaultdict(list))
    for det, meta in results:
        tile = os.path.splitext(os.path.basename(meta["filename"]))[0]
        orig, rate, left, up = parse_tile_name(tile)
        polys = np.asarray(det["polys"]).reshape(-1, 8)
        scores = np.asarray(det["scores"]).reshape(-1)
        labels = np.asarray(det["labels"]).reshape(-1)
        valid = np.asarray(
            det.get("valid", np.ones(len(polys), bool))
        ).reshape(-1)
        if not valid.any():
            continue
        polys = tile_to_original(polys[valid], rate, left, up)
        scores = scores[valid]
        labels = labels[valid]
        for c, cname in enumerate(classes):
            m = labels == c
            if m.any():
                per_image[orig][cname].append(
                    np.concatenate([polys[m], scores[m, None]], 1)
                )

    merged = {}
    for orig, per_cls in per_image.items():
        merged[orig] = {}
        for cname, chunks in per_cls.items():
            dets = np.concatenate(chunks, 0)
            thr = (
                per_class_thr.get(cname, iou_thr)
                if isinstance(per_class_thr, dict)
                else iou_thr
            )
            keep = nms_poly_np(dets[:, :8], dets[:, 8], thr)
            merged[orig][cname] = dets[keep]
    return merged


def write_dota_submission(merged, classes, out_dir, task="Task1",
                          zip_path=None):
    """Per-class submission txts `img score x0 y0 ... y3`
    (data_merge.py:29-48) + optional zip."""
    os.makedirs(out_dir, exist_ok=True)
    files = []
    for cname in classes:
        path = os.path.join(out_dir, f"{task}_{cname}.txt")
        with open(path, "w") as f:
            for orig, per_cls in sorted(merged.items()):
                for row in per_cls.get(cname, []):
                    coords = " ".join(f"{x:.2f}" for x in row[:8])
                    f.write(f"{orig} {row[8]:.4f} {coords}\n")
        files.append(path)
    if zip_path:
        with zipfile.ZipFile(zip_path, "w", zipfile.ZIP_DEFLATED) as z:
            for p in files:
                z.write(p, os.path.basename(p))
    return files
