"""Rotated NMS with fixed-size outputs.

Port of `jdet_tpu/ops/nms_rotated.py` (`_greedy_sweep` :29, `nms_rotated`
:55, `ml_nms_rotated` :81, `multiclass_nms_rotated` :98). Outputs keep the reference's fixed
`max_per_img` budget with a validity mask; invalid slots hold zero boxes,
score 0 and label -1. The reference's vmap over classes (and over images)
is a batch dimension written out.

`multiclass_nms_rotated`'s per-class self-IoU runs on the rect IoU kernel
for a CUDA tensor (one launch for all images and classes) and on the
plain differentiable path for a CPU tensor, as the reference runs it. On
the CPU only the pairs the greedy sweep reads are evaluated
(`_plain_suppression`): of (B, C, 512, 512) pairs a few percent touch.
"""
from __future__ import annotations

import torch

from .box_iou_rotated import box_iou_rotated, box_iou_rotated_aligned
from .rotated_iou_kernel import box_iou_rotated_rect
from .topk import stable_topk

PAIR_CHUNK = 65536  # pairs of the CPU suppression matrix evaluated at once


def _greedy_sweep(overlap, valid):
    """Greedy NMS keep-mask from a boolean suppression matrix.

    overlap: (..., n, n) bool — overlap[j, i] True if box j (higher score)
    suppresses box i; only the strict upper triangle (j < i) is used.
    valid: (..., n) bool — slots eligible for keeping at all.

    Solves keep[i] = valid[i] & ~any_{j<i}(overlap[j, i] & keep[j]) by
    fixpoint iteration: after r rounds the first r slots are final, so it
    ends on the exact greedy result, in as many rounds as the longest
    suppression chain.
    """
    n = overlap.shape[-1]
    tri = torch.ones(n, n, dtype=torch.bool, device=overlap.device).triu(1)
    m = overlap & tri & valid[..., :, None] & valid[..., None, :]
    keep = valid
    while True:
        suppressed = (m & keep[..., :, None]).any(dim=-2)
        new = valid & ~suppressed
        if torch.equal(new, keep):
            return keep
        keep = new


def _plain_suppression(b, valid, thr):
    """`box_iou_rotated(b, b) > thr` for (..., K, 5) boxes on the pairs
    `_greedy_sweep` reads: j < i, both valid, and their circumscribed
    circles meeting (with a margin); every other pair is False, as a pair
    that does not touch has IoU 0."""
    k = b.shape[-2]
    r = 0.5 * torch.sqrt(b[..., 2] ** 2 + b[..., 3] ** 2)
    d2 = ((b[..., :, None, :2] - b[..., None, :, :2]) ** 2).sum(-1)
    near = d2 <= ((r[..., :, None] + r[..., None, :]) * (1 + 1e-4) + 1e-3) ** 2
    tri = torch.ones(k, k, dtype=torch.bool, device=b.device).triu(1)
    pairs = (near & tri & valid[..., :, None] & valid[..., None, :]).nonzero(as_tuple=True)
    *lead, j, i = pairs
    over = torch.zeros(b.shape[:-1] + (k,), dtype=torch.bool, device=b.device)
    hit = []
    # in chunks whose temporaries stay in cache
    for s in range(0, j.numel(), PAIR_CHUNK):
        sl = slice(s, s + PAIR_CHUNK)
        hit.append(box_iou_rotated_aligned(b[(*(x[sl] for x in lead), j[sl])],
                                           b[(*(x[sl] for x in lead), i[sl])]) > thr)
    if hit:
        over[pairs] = torch.cat(hit)
    return over


def nms_rotated(boxes, scores, iou_threshold, valid=None):
    """Greedy rotated NMS over (n, 5) boxes.

    Returns (order, keep): indices into `boxes` in descending score order,
    and the keep mask aligned with `order`."""
    n = boxes.shape[0]
    if valid is None:
        valid = torch.ones(n, dtype=torch.bool, device=boxes.device)
    s = torch.where(valid, scores, float("-inf"))
    order = torch.argsort(-s, stable=True)
    b = boxes[order]
    iou = box_iou_rotated(b, b)
    keep = _greedy_sweep(iou > iou_threshold, valid[order])
    return order, keep


def ml_nms_rotated(boxes, scores, labels, iou_threshold, valid=None):
    """Label-aware rotated NMS over (n, 5) boxes: only boxes of one label
    suppress each other. The reference's coordinate-offset trick: each
    label's boxes are shifted along x by label * span, span exceeding the
    valid boxes' extent, so boxes of different labels never touch. Returns
    `nms_rotated`'s (order, keep); its IoU goes to K1's matrix kernel on
    the card from `KERNEL_MIN_PAIRS` pairs on."""
    if valid is None:
        valid = torch.ones(boxes.shape[0], dtype=torch.bool, device=boxes.device)
    span = (torch.where(valid, boxes[:, 0].abs() + boxes[:, 2], 0.0).amax()
            + torch.where(valid, boxes[:, 1].abs() + boxes[:, 3], 0.0).amax() + 1.0)
    shifted = boxes.clone()
    shifted[:, 0] = boxes[:, 0] + labels.to(boxes.dtype) * span
    return nms_rotated(shifted, scores, iou_threshold, valid)


def multiclass_nms_rotated(
    multi_bboxes,
    multi_scores,
    score_thr,
    nms_iou_thr,
    max_per_img,
    score_factors=None,
    class_cap=512,
):
    """Score-filter -> per-class NMS -> global top-k, fixed output size.

    multi_bboxes (B, n, 5) rboxes, or (B, n, C * 5), one box per class
    (the reference's class-specific layout, :144-149); multi_scores
    (B, n, C) class scores (no background column); `score_factors` (B, n), where given, multiplies
    each candidate's scores first (FCOS's centerness). Classes never
    suppress each other, so each class NMS-es its top `class_cap`
    candidates independently.

    Returns a dict of boxes (B, max_per_img, 5), scores (B, max_per_img),
    labels (B, max_per_img) int64 (-1 where invalid) and valid.
    """
    B, n, num_classes = multi_scores.shape
    if score_factors is not None:
        multi_scores = multi_scores * score_factors[..., None]
    K = min(n, class_cap)

    valid = multi_scores > score_thr
    sT = torch.where(valid, multi_scores, float("-inf")).transpose(1, 2)
    # stable sorts: equal scores keep the lower index first, as
    # `jax.lax.top_k` orders them, on either device (`torch.topk` breaks
    # ties one way on the CPU and another on the card, and the order
    # decides which of two tied boxes suppresses the other)
    top_s, top_i = stable_topk(sT, K)  # (B, C, K), sorted desc
    if multi_bboxes.shape[-1] == 5:
        per_class = multi_bboxes[:, None].expand(B, num_classes, n, 5)
    else:
        per_class = multi_bboxes.reshape(B, n, num_classes, 5).transpose(1, 2)
    b = torch.gather(per_class, 2, top_i[..., None].expand(B, num_classes, K, 5))  # (B, C, K, 5)
    v = torch.isfinite(top_s)

    if b.is_cuda:
        flat = b.reshape(B * num_classes, K, 5).float().contiguous()
        over = box_iou_rotated_rect(flat, flat).reshape(B, num_classes, K, K) > nms_iou_thr
    else:
        over = _plain_suppression(b, v, nms_iou_thr)  # (B, C, K, K)
    keep = _greedy_sweep(over, v)

    flat_s = torch.where(keep, top_s, float("-inf")).reshape(B, -1)
    m = min(max_per_img, flat_s.shape[1])
    sel_s, sel = stable_topk(flat_s, m)
    valid_out = torch.isfinite(sel_s)
    boxes = torch.gather(
        b.reshape(B, -1, 5), 1, sel[..., None].expand(B, m, 5)
    )
    out = {
        "boxes": multi_bboxes.new_zeros(B, max_per_img, 5),
        "scores": multi_scores.new_zeros(B, max_per_img),
        "labels": sel.new_full((B, max_per_img), -1),
        "valid": valid_out.new_zeros(B, max_per_img),
    }
    out["boxes"][:, :m] = torch.where(valid_out[..., None], boxes, 0.0)
    out["scores"][:, :m] = torch.where(valid_out, sel_s, 0.0)
    out["labels"][:, :m] = torch.where(valid_out, sel // K, -1)
    out["valid"][:, :m] = valid_out
    return out
