"""COCO: the dataset of horizontal boxes and its COCO-protocol evaluator.

Port of `jdet_tpu/data/coco.py`: `COCODataset` :23 reads an instances
JSON (`annotations_file`): the categories sorted by id give the classes
and `cat2label` (1-based labels), crowd annotations are skipped, each
xywh box becomes a zero-angle rbox (cx, cy, w, h, 0) so that the rotated
pipeline applies, and images without gts are dropped unless
`filter_empty_gt=False`. `evaluate` :63 and `coco_map` :153 compute
pycocotools' protocol in numpy (AP@[.5:.95] with 101-point
interpolation, AP50, AP75, AP by area, AR@1/10/100), matching each image
greedily per IoU threshold as `_match_img` :118 does.

The committed `configs/ssd300_coco.py` passes `anno_file=`, which the
reference hands on to `CustomDataset.__init__` and so raises a TypeError
there. The port refuses the key by name; both packages run the config
with `dataset.<split>.annotations_file` set instead.
"""
from __future__ import annotations

import json

import numpy as np

from ..utils.registry import DATASETS
from .custom import CustomDataset


@DATASETS.register_module()
class COCODataset(CustomDataset):
    def __init__(self, annotations_file=None, **kw):
        if "anno_file" in kw:
            raise TypeError(
                "COCODataset: 'anno_file' is not an argument (the reference's "
                "CustomDataset.__init__ raises on it too); set annotations_file= to the "
                "instances JSON instead")
        super().__init__(annotations_file=None, **kw)
        self.coco = None
        if annotations_file:
            with open(annotations_file) as f:
                self.coco = json.load(f)
            cats = sorted(self.coco["categories"], key=lambda c: c["id"])
            self.CLASSES = [c["name"] for c in cats]
            self.cat2label = {c["id"]: i + 1 for i, c in enumerate(cats)}
            anns_by_img = {}
            for a in self.coco["annotations"]:
                anns_by_img.setdefault(a["image_id"], []).append(a)
            infos = []
            for img in self.coco["images"]:
                boxes, labels = [], []
                for a in anns_by_img.get(img["id"], []):
                    if a.get("iscrowd", 0):
                        continue
                    x, y, w, h = a["bbox"]
                    boxes.append([x + w / 2, y + h / 2, w, h, 0.0])
                    labels.append(self.cat2label[a["category_id"]])
                if kw.get("filter_empty_gt", True) and not boxes:
                    continue
                infos.append({
                    "filename": img["file_name"],
                    "width": img["width"],
                    "height": img["height"],
                    "ann": {
                        "bboxes": np.asarray(boxes, np.float32).reshape(-1, 5),
                        "labels": np.asarray(labels, np.int64),
                        "bboxes_ignore": np.zeros((0, 5), np.float32),
                    },
                })
            self.img_infos = infos

    def evaluate(self, results, work_dir=None, epoch=None, **kw):
        """COCO-protocol mAP over the horizontal boxes of (det, meta)
        results; keys `eval/coco_mAP`, `eval/coco_mAP50`, ..."""
        dets, gts = {}, {}
        for det, meta in results:
            img_id = meta["img_id"]
            polys = np.asarray(det["polys"]).reshape(-1, 8)
            xs, ys = polys[:, 0::2], polys[:, 1::2]
            hbb = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], 1)
            valid = np.asarray(det.get("valid", np.ones(len(hbb), bool)))
            dets[img_id] = (hbb[valid], np.asarray(det["scores"])[valid],
                            np.asarray(det["labels"])[valid])
            gp = np.asarray(meta.get("polys", np.zeros((0, 8)))).reshape(-1, 8)
            gxs, gys = gp[:, 0::2], gp[:, 1::2]
            ghbb = (np.stack([gxs.min(1), gys.min(1), gxs.max(1), gys.max(1)], 1)
                    if len(gp) else np.zeros((0, 4)))
            gts[img_id] = (ghbb, np.asarray(meta.get("labels", np.zeros(0))))
        ap = coco_map(dets, gts, len(self.CLASSES))
        return {
            "eval/coco_mAP": ap["mAP"],
            "eval/coco_mAP50": ap["mAP50"],
            "eval/coco_mAP75": ap["mAP75"],
            "eval/coco_mAP_small": ap["mAP_small"],
            "eval/coco_mAP_medium": ap["mAP_medium"],
            "eval/coco_mAP_large": ap["mAP_large"],
            "eval/coco_AR@1": ap["AR@1"],
            "eval/coco_AR@10": ap["AR@10"],
            "eval/coco_AR@100": ap["AR@100"],
        }


def _hbb_iou(a, b):
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    union = aa[:, None] + ab[None] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


_AREA_RNGS = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}


def _match_img(iou, gt_ig, det_areas, thrs, rng, max_det):
    """pycocotools COCOeval.evaluateImg matching (cocoeval.py): greedy per
    IoU threshold with ignore semantics — ignored gts (outside the area
    range) absorb matches without counting; unmatched dets outside the
    range are ignored too."""
    nd = min(iou.shape[0], max_det)
    ng = iou.shape[1]
    T = len(thrs)
    order = np.argsort(gt_ig, kind="stable")  # non-ignored gts first
    dtm = np.full((T, nd), -1, np.int64)
    dt_ig = np.zeros((T, nd), bool)
    gtm = np.full((T, ng), -1, np.int64)
    for t, thr in enumerate(thrs):
        for d in range(nd):
            best = min(thr, 1 - 1e-10)
            m = -1
            for g in order:
                if gtm[t, g] >= 0:
                    continue
                if m > -1 and not gt_ig[m] and gt_ig[g]:
                    break  # only ignored gts remain: keep the real match
                if iou[d, g] < best:
                    continue
                best = iou[d, g]
                m = g
            if m == -1:
                continue
            dtm[t, d] = m
            dt_ig[t, d] = gt_ig[m]
            gtm[t, m] = d
        out_rng = (det_areas[:nd] < rng[0]) | (det_areas[:nd] > rng[1])
        dt_ig[t] |= (dtm[t] == -1) & out_rng
    return dtm, dt_ig


def coco_map(dets, gts, num_classes, max_dets=(1, 10, 100)):
    """The full COCO protocol in numpy: AP@[.5:.95], AP50, AP75, AP by
    area (small/medium/large), AR@1/10/100.

    dets: {img: (hbb (n,4), scores (n,), labels 0-based (n,))}
    gts:  {img: (hbb (m,4), labels 1-based (m,))}
    """
    thrs = np.arange(0.5, 1.0, 0.05)
    recall_pts = np.linspace(0, 1, 101)
    T = len(thrs)
    max_det = max(max_dets)
    area_names = list(_AREA_RNGS)
    # ap[area][t, c]; ar[k][t, c] for maxDets k (area 'all')
    ap = {a: np.full((T, num_classes), np.nan) for a in area_names}
    ar = {k: np.full((T, num_classes), np.nan) for k in max_dets}

    empty = (np.zeros((0, 4)), np.zeros(0), np.zeros(0))
    for c in range(num_classes):
        # gather this class's per-image dets/gts once
        per_img = []
        for img, (ghbb, glab) in gts.items():
            gt_c = ghbb[glab == c + 1]
            dh, ds, dl = dets.get(img, empty)
            m = dl == c
            dh_c, ds_c = dh[m], ds[m]
            o = np.argsort(-ds_c, kind="stable")[:max_det]
            dh_c, ds_c = dh_c[o], ds_c[o]
            iou = (
                _hbb_iou(dh_c, gt_c)
                if len(gt_c) and len(dh_c)
                else np.zeros((len(dh_c), len(gt_c)))
            )
            g_areas = (gt_c[:, 2] - gt_c[:, 0]) * (gt_c[:, 3] - gt_c[:, 1])
            d_areas = (dh_c[:, 2] - dh_c[:, 0]) * (dh_c[:, 3] - dh_c[:, 1])
            per_img.append((iou, ds_c, g_areas, d_areas))

        for a in area_names:
            rng = _AREA_RNGS[a]
            scores, matched, ignored = [], [], []
            npos = 0
            for iou, ds_c, g_areas, d_areas in per_img:
                gt_ig = (g_areas < rng[0]) | (g_areas > rng[1])
                npos += int((~gt_ig).sum())
                if len(ds_c) == 0:
                    continue
                dtm, dt_ig = _match_img(iou, gt_ig, d_areas, thrs, rng,
                                        max_det)
                nd = dtm.shape[1]
                scores.append(ds_c[:nd])
                matched.append(dtm >= 0)
                ignored.append(dt_ig)
            if npos == 0:
                continue
            if not scores:
                ap[a][:, c] = 0.0
                if a == "all":
                    for k in max_dets:
                        ar[k][:, c] = 0.0
                continue
            ss = np.concatenate(scores)
            mm = np.concatenate(matched, 1)  # (T, ND)
            ii = np.concatenate(ignored, 1)
            order = np.argsort(-ss, kind="mergesort")
            mm, ii = mm[:, order], ii[:, order]
            tps = mm & ~ii
            fps = ~mm & ~ii
            tp = np.cumsum(tps, 1).astype(np.float64)
            fp = np.cumsum(fps, 1).astype(np.float64)
            rec = tp / npos
            prec = tp / np.maximum(tp + fp, np.spacing(1))
            for t in range(T):
                p = prec[t][::-1]
                p = np.maximum.accumulate(p)[::-1]
                inds = np.searchsorted(rec[t], recall_pts, side="left")
                q = np.zeros(len(recall_pts))
                valid = inds < len(p)
                q[valid] = p[inds[valid]]
                ap[a][t, c] = q.mean()
            if a == "all":
                # AR@k: max recall with at most k dets/img — recompute the
                # cumulative on the per-image-truncated det stream
                for k in max_dets:
                    # truncate each image's dets to k before pooling
                    sk, mk, ik = [], [], []
                    for iou, ds_c, g_areas, d_areas in per_img:
                        gt_ig = (g_areas < rng[0]) | (g_areas > rng[1])
                        if len(ds_c) == 0:
                            continue
                        dtm_k, dt_ig_k = _match_img(
                            iou, gt_ig, d_areas, thrs, rng, k
                        )
                        nd = dtm_k.shape[1]
                        sk.append(ds_c[:nd])
                        mk.append(dtm_k >= 0)
                        ik.append(dt_ig_k)
                    if not sk:
                        continue
                    mm_k = np.concatenate(mk, 1)
                    ii_k = np.concatenate(ik, 1)
                    tp_k = (mm_k & ~ii_k).sum(1).astype(np.float64)
                    ar[k][:, c] = tp_k / npos

    def _mean(x):
        return float(np.nanmean(x)) if not np.all(np.isnan(x)) else 0.0

    return {
        "mAP": _mean(ap["all"]),
        "mAP50": _mean(ap["all"][0]),
        "mAP75": _mean(ap["all"][5]),
        "mAP_small": _mean(ap["small"]),
        "mAP_medium": _mean(ap["medium"]),
        "mAP_large": _mean(ap["large"]),
        "AR@1": _mean(ar[max_dets[0]]) if len(max_dets) > 0 else 0.0,
        "AR@10": _mean(ar[max_dets[1]]) if len(max_dets) > 1 else 0.0,
        "AR@100": _mean(ar[max_dets[2]]) if len(max_dets) > 2 else 0.0,
    }
