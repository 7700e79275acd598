"""Max-IoU assignment in masked, fixed-shape form.

Port of the rotated branch of `jdet_tpu/models/boxes/assigner.py`
(`assign_wrt_overlaps` :45, `max_iou_assign_rotated` :135). Every
function takes a leading batch dimension (the reference's vmap over
images, written out), so the IoU kernel is launched once for the batch.

Per anchor the outputs are:
  gt_inds:      -1 ignore, 0 negative, i+1 positive for gt i
  max_overlaps: float
  labels:       0 background, 1-based class for positives
Padding gt rows never match: their IoU rows are masked to -inf.

`max_iou_assign_rotated` is the wrapper of the fused CUDA assigner
(`ops/rotated_iou_kernel.py::launch_max_iou_assign_rect`), which never
writes the IoU matrix: every CUDA call launches it. Its plain version,
for CPU tensors, is the composition here, `assign_wrt_overlaps` on
`box_iou_rotated`'s matrix; it lives here and not in `ops/`, because
`ops/` does not depend on `models/`.
"""
from __future__ import annotations

import torch

from ...ops.box_iou_rotated import box_iou_rotated
from ...ops.rotated_iou_kernel import launch_max_iou_assign_rect, park_masked_boxes


def assign_wrt_overlaps(
    overlaps,
    gt_mask,
    gt_labels,
    pos_iou_thr=0.5,
    neg_iou_thr=0.4,
    min_pos_iou=0.0,
    anchor_mask=None,
):
    """Masked MaxIoU assignment from a (..., k, n) overlap matrix.

      1. default -1 (ignore)
      2. max_overlap < neg_iou_thr -> 0 (negative)
      3. max_overlap >= pos_iou_thr -> argmax gt + 1
      4. low-quality match: each gt claims every anchor at its max IoU if
         that max >= min_pos_iou (later gts override earlier ones).

    gt_mask (..., k) bool marks real gt rows, gt_labels (..., k) their
    1-based classes; anchor_mask (n,) bool marks anchors eligible at all
    (in every image).
    """
    k = overlaps.shape[-2]
    ov = torch.where(gt_mask[..., :, None], overlaps, float("-inf"))
    if anchor_mask is not None:
        ov = torch.where(anchor_mask, ov, float("-inf"))

    max_overlaps, argmax_overlaps = ov.max(dim=-2)
    # with zero real gts, every anchor is negative
    any_gt = gt_mask.any(dim=-1, keepdim=True)
    max_overlaps = torch.where(any_gt, max_overlaps, 0.0)

    neg = (max_overlaps >= 0) & (max_overlaps < neg_iou_thr)
    assigned = torch.where(neg, 0, -1)
    pos = max_overlaps >= pos_iou_thr
    assigned = torch.where(pos, argmax_overlaps + 1, assigned)

    gt_max = ov.amax(dim=-1)  # (..., k)
    eligible = gt_mask & (gt_max >= min_pos_iou) & torch.isfinite(gt_max)
    hits = (ov == gt_max[..., None]) & eligible[..., None]
    # the reference loops gts in order and later gts override: the largest
    # gt index claiming each anchor wins
    gt_index = torch.arange(k, device=ov.device)[:, None]
    claim = torch.where(hits, gt_index, -1).amax(dim=-2)
    assigned = torch.where(claim >= 0, claim + 1, assigned)

    if anchor_mask is not None:
        assigned = torch.where(anchor_mask, assigned, -1)

    safe = (assigned - 1).clamp(0, k - 1)
    picked = torch.gather(gt_labels.long(), -1, safe)
    labels = torch.where(assigned > 0, picked, 0)
    return {
        "gt_inds": assigned,
        "max_overlaps": max_overlaps,
        "labels": labels,
    }


def max_iou_assign_rotated(
    anchors,
    gt_bboxes,
    gt_mask,
    gt_labels,
    pos_iou_thr=0.5,
    neg_iou_thr=0.4,
    min_pos_iou=0.0,
    anchor_mask=None,
    iou_chunk=512,
):
    """Rotated MaxIoU assignment. anchors (n, 5) shared, or (B, n, 5) per
    image with (B, k, 5) gts (the reference's vmap over images and anchors,
    `anchor_target.py:163-176`); gt_bboxes (k, 5) or (B, k, 5) padded;
    gt_mask and gt_labels of gt_bboxes' leading shape, bool and integer;
    anchor_mask (n,) bool or None, one for every image. Returns
    `assign_wrt_overlaps`' dict.

    A CUDA tensor launches the fused kernel (one launch for the batch) or
    raises; a CPU tensor is assigned on `box_iou_rotated`'s matrix, which
    broadcasts over per-image anchors, `iou_chunk` gt rows at a time (the
    plain version)."""
    if gt_bboxes.is_cuda:
        return launch_max_iou_assign_rect(
            gt_bboxes.contiguous(), gt_mask, gt_labels,
            anchors.contiguous(), anchor_mask, pos_iou_thr,
            neg_iou_thr, min_pos_iou,
        )
    overlaps = box_iou_rotated(
        park_masked_boxes(gt_bboxes, gt_mask), anchors, chunk=iou_chunk
    )
    return assign_wrt_overlaps(
        overlaps, gt_mask, gt_labels, pos_iou_thr, neg_iou_thr,
        min_pos_iou, anchor_mask,
    )
