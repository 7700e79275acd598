"""Port of `jdet_tpu/models/boxes/sampler.py::pseudo_sample` (:14)."""
from __future__ import annotations


def pseudo_sample(assign):
    """PseudoSampler: all positives, all negatives, as masks."""
    gt_inds = assign["gt_inds"]
    return {
        "pos_mask": gt_inds > 0,
        "neg_mask": gt_inds == 0,
        "gt_inds": gt_inds,
    }
