"""Anchor targets — assign, sample, encode, weight — in fixed shapes.

Port of `jdet_tpu/models/boxes/anchor_target.py` (`anchor_target_single`
:37, `anchor_target_batch` :148): the rotated branch on the max-IoU or the
ATSS assigner (:79-90), the horizontal one (the RPN's, :91-95), the
pseudo and the random sampler (:98-105), the deltas of either branch
(`rbox2delta` or `hbox2delta`, :124) or with `reg_decoded_bbox`
(:121-122) the matched gts themselves (the gaussian and IoU losses
regress on them). The reference vmaps the
single-image function over the batch, over the anchors too where they
are per image (:163-176, S2ANet's refined anchors); here
`anchor_target_single` takes any leading batch dimensions, on shared
(n, d) or per-image (B, n, d) anchors, so `anchor_target_batch` calls it
once and the assigner's kernel runs once for all images.
"""
from __future__ import annotations

import torch

from ...ops.box_convert import hbox2delta, rbox2delta
from .assigner import atss_assign_rotated, max_iou_assign_hbb, max_iou_assign_rotated
from .sampler import pseudo_sample, random_sample


def anchor_inside_flags_rotated(anchors, valid_flags, img_shape, allowed_border):
    """The reference's `anchor_inside_flags_rotated` (:21): with
    allowed_border >= 0, valid anchors (..., n, 5) whose centres lie within
    `allowed_border` of the (h, w) image; otherwise valid_flags. (Every
    head of the reference passes no img_shape, so there the border never
    removes an anchor.)"""
    if allowed_border < 0:
        return valid_flags
    h, w = img_shape
    return (valid_flags
            & (anchors[..., 0] >= -allowed_border) & (anchors[..., 1] >= -allowed_border)
            & (anchors[..., 0] < w + allowed_border) & (anchors[..., 1] < h + allowed_border))


def anchor_target_single(
    anchors,
    valid_flags,
    gt_bboxes,
    gt_mask,
    gt_labels,
    *,
    target_means=(0.0,) * 5,
    target_stds=(1.0,) * 5,
    assigner_cfg=None,
    sampler_cfg=None,
    pos_weight=-1,
    rotated=True,
    reg_decoded_bbox=False,
    iou_chunk=512,
    rand=None,
    generator=None,
):
    """Targets for gt_bboxes (..., k, d) padded, gt_mask (..., k) bool and
    gt_labels (..., k) 1-based, against shared anchors (n, d) or per-image
    anchors (B, n, d) with (B, k, d) gts, and valid_flags (n,) bool, one
    for every image, or (B, n), one per image; d = 5 rotated, 4 horizontal
    (`rotated=False`, shared anchors). Invalid anchors are excluded before
    assignment: they can neither be argmax targets nor receive low-quality
    gt claims.
    `sampler_cfg` of type "random" draws through `random_sample`, from
    `rand` or `generator`.

    Returns a dict of (..., n) labels / label_weights / pos_mask /
    neg_mask / gt_inds and (..., n, d) bbox_targets / bbox_weights.
    """
    assigner_cfg = dict(assigner_cfg or {})
    sampler_cfg = dict(sampler_cfg or {})
    assigner_type = assigner_cfg.pop("type", "max_iou")
    if assigner_type not in ("max_iou", "atss"):
        raise NotImplementedError(f"assigner {assigner_type!r} is not ported")
    if assigner_type == "atss":
        if not rotated or anchors.dim() != 2:
            raise NotImplementedError("the ATSS assigner takes shared rotated anchors")
        assign = atss_assign_rotated(
            anchors, gt_bboxes, gt_mask, gt_labels,
            anchor_mask=valid_flags, iou_chunk=iou_chunk, **assigner_cfg
        )
    elif rotated:
        assign = max_iou_assign_rotated(
            anchors, gt_bboxes, gt_mask, gt_labels,
            anchor_mask=valid_flags, iou_chunk=iou_chunk, **assigner_cfg
        )
    else:
        assign = max_iou_assign_hbb(anchors, gt_bboxes, gt_mask, gt_labels,
                                    anchor_mask=valid_flags, **assigner_cfg)
    gt_inds = assign["gt_inds"]
    sampler_type = sampler_cfg.pop("type", "pseudo")
    if sampler_type == "random":
        sample = random_sample(assign, sampler_cfg["num"], sampler_cfg["pos_fraction"],
                               sampler_cfg.get("neg_pos_ub", -1), rand=rand,
                               generator=generator)
    elif sampler_type == "pseudo":
        sample = pseudo_sample(assign)
    else:
        raise NotImplementedError(f"sampler {sampler_type!r} is not ported")
    pos_mask = sample["pos_mask"]
    neg_mask = sample["neg_mask"]

    k, d = gt_bboxes.shape[-2:]
    safe_gt = (gt_inds - 1).clamp(0, k - 1)
    matched_gt = torch.gather(
        gt_bboxes, -2, safe_gt[..., None].expand(*safe_gt.shape, d)
    )
    if reg_decoded_bbox:
        bbox_targets = torch.where(pos_mask[..., None], matched_gt, 0.0)
    else:
        encode = rbox2delta if rotated else hbox2delta
        deltas = encode(anchors, matched_gt, target_means, target_stds)
        bbox_targets = torch.where(pos_mask[..., None], deltas, 0.0)
    bbox_weights = pos_mask[..., None].to(bbox_targets.dtype).expand_as(
        bbox_targets
    )

    labels = torch.where(pos_mask, assign["labels"], 0)
    pw = 1.0 if pos_weight <= 0 else pos_weight
    label_weights = torch.where(
        pos_mask, pw, torch.where(neg_mask, 1.0, 0.0)
    )
    return {
        "labels": labels,
        "label_weights": label_weights,
        "bbox_targets": bbox_targets,
        "bbox_weights": bbox_weights,
        "pos_mask": pos_mask,
        "neg_mask": neg_mask,
        "gt_inds": gt_inds,
    }


def anchor_target_batch(anchors, valid_flags, gt_bboxes, gt_mask, gt_labels, **kw):
    """Targets for a batch: gt_* are (B, k, ...) per image, anchors shared
    (n, d) or per image (B, n, d), valid_flags (n,) shared. Also returns
    num_total_pos / num_total_neg, each the sum over images of
    max(per-image count, 1)."""
    out = anchor_target_single(
        anchors, valid_flags, gt_bboxes, gt_mask, gt_labels, **kw
    )
    num_total_pos = out["pos_mask"].sum(dim=-1).clamp(min=1).sum()
    num_total_neg = out["neg_mask"].sum(dim=-1).clamp(min=1).sum()
    return out, num_total_pos, num_total_neg
