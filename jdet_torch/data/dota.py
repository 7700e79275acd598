"""DOTA datasets: class tables, balanced resampling, VOC-mAP evaluation,
submission writing.

Port of `jdet_tpu/data/dota.py`: `DOTADataset` :46 with
`_balance_category` :59, `evaluate` :72 (keys `eval/<i>_<class>_AP` and
`eval/0_meanAP`) and `save_submission` :121 (`Task1_<class>.txt`);
`FAIRDataset`, `FAIR1M_1_5_Dataset` and `SSDDDataset` (:145-170); and
`ImageDataset` :173, the gt-less folder dataset of `test`; and
`DOTAWSOODDataset` :195, H2RBox's weakly supervised view.
"""
from __future__ import annotations

import os

import numpy as np

from ..config.constants import (
    DOTA1_CLASSES,
    DOTA1_5_CLASSES,
    DOTA2_CLASSES,
    FAIR_CLASSES,
    FAIR1M_1_5_CLASSES,
    SSDD_CLASSES,
    get_classes_by_name,
)
from ..utils.registry import DATASETS
from .custom import CustomDataset
from .transforms import rbox_to_poly_np
from .devkits.voc_eval import voc_eval_dota

# balance-category repeat table (reference dota.py:43-54): rare classes are
# oversampled by these factors when balance_category=True
BALANCE_CATEGORY_REPEATS = {
    "storage-tank": 2,
    "baseball-diamond": 2,
    "ground-track-field": 3,
    "swimming-pool": 2,
    "soccer-ball-field": 3,
    "roundabout": 3,
    "tennis-court": 2,
    "basketball-court": 3,
    "helicopter": 3,
    "container-crane": 3,
}


@DATASETS.register_module()
class DOTADataset(CustomDataset):
    def __init__(self, version="1", balance_category=False, **kw):
        if str(version) in ("1", "1.0"):
            classes = DOTA1_CLASSES
        elif str(version) in ("1_5", "1.5"):
            classes = DOTA1_5_CLASSES
        else:
            classes = DOTA2_CLASSES
        super().__init__(classes=classes, **kw)
        self.version = str(version)
        if balance_category:
            self.img_infos = self._balance_category(self.img_infos)

    def _balance_category(self, infos):
        """Oversample images containing rare categories (dota.py:43-62)."""
        out = []
        for info in infos:
            labels = np.asarray(info.get("ann", {}).get("labels", []))
            repeat = 1
            for li in np.unique(labels):
                name = self.CLASSES[int(li) - 1]
                repeat = max(repeat, BALANCE_CATEGORY_REPEATS.get(name, 1))
            out.extend([info] * repeat)
        return out

    # ------------------------------------------------------------------
    def evaluate(self, results, work_dir=None, epoch=None, ovthresh=0.5,
                 use_07_metric=True, logger=None, **kw):
        """VOC-mAP over polygon detections (dota.py:85-139).

        results: list of (det, meta) where det has numpy polys (n, 8),
        scores (n,), labels (n,) 0-based-fg, and meta carries the GT
        ("polys", "labels", "polys_ignore").
        """
        dets_per_class = {c: {} for c in range(len(self.CLASSES))}
        gts_per_class = {c: {} for c in range(len(self.CLASSES))}
        for det, meta in results:
            img_id = meta["img_id"]
            polys = np.asarray(det["polys"]).reshape(-1, 8)
            scores = np.asarray(det["scores"]).reshape(-1)
            labels = np.asarray(det["labels"]).reshape(-1)
            valid = np.asarray(det.get("valid", np.ones(len(polys), bool))).reshape(-1)
            for c in range(len(self.CLASSES)):
                m = valid & (labels == c)
                dets_per_class[c][img_id] = np.concatenate(
                    [polys[m], scores[m, None]], 1
                )
            gt_polys = np.asarray(meta.get("polys", np.zeros((0, 8)))).reshape(-1, 8)
            gt_labels = np.asarray(meta.get("labels", np.zeros(0))).reshape(-1)
            ig = np.asarray(meta.get("polys_ignore", np.zeros((0, 8)))).reshape(-1, 8)
            for c in range(len(self.CLASSES)):
                sel = gt_labels == (c + 1)
                polys_c = gt_polys[sel]
                difficult = np.zeros(len(polys_c), bool)
                if len(ig):
                    polys_c = np.concatenate([polys_c, ig], 0)
                    difficult = np.concatenate(
                        [difficult, np.ones(len(ig), bool)], 0
                    )
                gts_per_class[c][img_id] = {
                    "polys": polys_c,
                    "difficult": difficult,
                }

        aps = {}
        for c, name in enumerate(self.CLASSES):
            _, _, ap = voc_eval_dota(
                dets_per_class[c], gts_per_class[c],
                ovthresh=ovthresh, use_07_metric=use_07_metric,
            )
            aps[f"eval/{c + 1}_{name}_AP"] = ap
        aps["eval/0_meanAP"] = float(np.mean(list(aps.values()))) if aps else 0.0
        return aps

    # ------------------------------------------------------------------
    def save_submission(self, results, save_dir):
        """Write DOTA per-class txt submission files (dota.py:64-83):
        Task1_<class>.txt lines `img_name score x0 y0 ... y3`."""
        os.makedirs(save_dir, exist_ok=True)
        lines = {c: [] for c in self.CLASSES}
        for det, meta in results:
            name = os.path.splitext(os.path.basename(meta["filename"]))[0]
            polys = np.asarray(det["polys"]).reshape(-1, 8)
            scores = np.asarray(det["scores"]).reshape(-1)
            labels = np.asarray(det["labels"]).reshape(-1)
            valid = np.asarray(det.get("valid", np.ones(len(polys), bool))).reshape(-1)
            for p, s, l, v in zip(polys, scores, labels, valid):
                if not v:
                    continue
                cname = self.CLASSES[int(l)]
                coords = " ".join(f"{x:.2f}" for x in p)
                lines[cname].append(f"{name} {s:.4f} {coords}")
        for cname, ls in lines.items():
            with open(os.path.join(save_dir, f"Task1_{cname}.txt"), "w") as f:
                f.write("\n".join(ls))
        return save_dir


@DATASETS.register_module()
class FAIRDataset(DOTADataset):
    """FAIR1M variant (reference data/fair.py:10)."""

    def __init__(self, **kw):
        kw.pop("version", None)
        CustomDataset.__init__(self, classes=FAIR_CLASSES, **kw)
        self.version = "fair"


@DATASETS.register_module()
class FAIR1M_1_5_Dataset(DOTADataset):
    def __init__(self, **kw):
        kw.pop("version", None)
        CustomDataset.__init__(self, classes=FAIR1M_1_5_CLASSES, **kw)
        self.version = "fair1m_1_5"


@DATASETS.register_module()
class SSDDDataset(DOTADataset):
    """SSDD+ variant (reference data/ssdd_plus.py:6)."""

    def __init__(self, **kw):
        kw.pop("version", None)
        CustomDataset.__init__(self, classes=SSDD_CLASSES, **kw)
        self.version = "ssdd+"


@DATASETS.register_module()
class ImageDataset(CustomDataset):
    """GT-less folder dataset for test/vis (reference data/image.py:15)."""

    def __init__(self, images_dir="", dataset_type="DOTA", images=None, **kw):
        kw.setdefault("filter_empty_gt", False)
        super().__init__(
            annotations_file=None, images_dir=images_dir,
            classes=get_classes_by_name(dataset_type), **kw
        )
        exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif")
        if images is not None:
            files = images
        else:
            files = sorted(
                f for f in os.listdir(images_dir) if f.lower().endswith(exts)
            )
        self.img_infos = [{"filename": f, "ann": {}} for f in files]


@DATASETS.register_module()
class DOTAWSOODDataset(DOTADataset):
    """H2RBox's weakly supervised DOTA: each sample's rboxes are replaced
    by their circumscribed horizontal rectangles at angle 0, after the
    transforms, so that the model never sees a gt angle."""

    def load_sample(self, idx, rng=None):
        img, target = super().load_sample(idx, rng)
        rb = target["rboxes"]
        if len(rb):
            polys = rbox_to_poly_np(rb)
            x1, y1 = polys[:, 0::2].min(1), polys[:, 1::2].min(1)
            x2, y2 = polys[:, 0::2].max(1), polys[:, 1::2].max(1)
            target["rboxes"] = np.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1,
                                         np.zeros_like(x1)], 1).astype(np.float32)
        return img, target
