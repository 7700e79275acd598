"""VOC-style AP evaluation over polygon detections.

Copy of `jdet_tpu/data/devkits/voc_eval.py` (`voc_ap` :16,
`voc_eval_dota` :32), itself a mirror of the reference evaluator
(`python/jdet/data/devkits/voc_eval.py`): 11-point ('07) or
all-points ('12) AP (voc_eval.py:39-70); `voc_eval_dota` greedy-matches
score-sorted detections to GT polys at an IoU threshold with difficult
exclusion (voc_eval.py:236+), using exact polygon IoU.
"""
from __future__ import annotations

import numpy as np

from .polygon import poly_iou


def voc_ap(rec, prec, use_07_metric=False):
    """AP from PR points (voc_eval.py:39-70)."""
    if use_07_metric:
        ap = 0.0
        for t in np.arange(0.0, 1.1, 0.1):
            p = np.max(prec[rec >= t]) if np.sum(rec >= t) > 0 else 0.0
            ap += p / 11.0
        return ap
    mrec = np.concatenate(([0.0], rec, [1.0]))
    mpre = np.concatenate(([0.0], prec, [0.0]))
    for i in range(mpre.size - 1, 0, -1):
        mpre[i - 1] = np.maximum(mpre[i - 1], mpre[i])
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def voc_eval_dota(
    dets_by_image,
    gts_by_image,
    ovthresh=0.5,
    use_07_metric=True,
):
    """Per-class AP.

    Args:
      dets_by_image: {img_id: (n, 9) [8 poly coords + score]}
      gts_by_image:  {img_id: {"polys": (m, 8), "difficult": (m,) bool}}

    Returns (recall, precision, ap).
    """
    class_recs = {}
    npos = 0
    for img_id, g in gts_by_image.items():
        polys = np.asarray(g.get("polys", np.zeros((0, 8))), np.float64).reshape(-1, 8)
        difficult = np.asarray(
            g.get("difficult", np.zeros(len(polys), bool)), bool
        )
        det_flag = np.zeros(len(polys), bool)
        npos += int((~difficult).sum())
        class_recs[img_id] = {
            "polys": polys,
            "difficult": difficult,
            "det": det_flag,
        }

    image_ids, confidence, boxes = [], [], []
    for img_id, d in dets_by_image.items():
        d = np.asarray(d, np.float64).reshape(-1, 9)
        for row in d:
            image_ids.append(img_id)
            confidence.append(row[8])
            boxes.append(row[:8])
    if not image_ids:
        return np.zeros(0), np.zeros(0), 0.0
    confidence = np.asarray(confidence)
    boxes = np.asarray(boxes)

    order = np.argsort(-confidence)
    image_ids = [image_ids[i] for i in order]
    boxes = boxes[order]

    nd = len(image_ids)
    tp = np.zeros(nd)
    fp = np.zeros(nd)
    for d in range(nd):
        rec = class_recs.get(image_ids[d])
        bb = boxes[d]
        ovmax = -np.inf
        jmax = -1
        if rec is not None and len(rec["polys"]):
            overlaps = poly_iou(bb[None], rec["polys"])[0]
            jmax = int(overlaps.argmax())
            ovmax = overlaps[jmax]
        if ovmax > ovthresh:
            if not rec["difficult"][jmax]:
                if not rec["det"][jmax]:
                    tp[d] = 1
                    rec["det"][jmax] = True
                else:
                    fp[d] = 1
        else:
            fp[d] = 1

    fp = np.cumsum(fp)
    tp = np.cumsum(tp)
    recall = tp / max(npos, 1)
    precision = tp / np.maximum(tp + fp, np.finfo(np.float64).eps)
    ap = voc_ap(recall, precision, use_07_metric)
    return recall, precision, ap
