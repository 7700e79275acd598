"""Horizontal-box NMS in fixed shapes.

Port of `jdet_tpu/ops/nms.py` (`hbb_iou_matrix` :14, `nms` :25) on the
rotated NMS's `_greedy_sweep`, over any leading batch dimensions, so that
one sweep (one host sync per fixpoint round) serves a whole batch of
independent problems: the RPN runs every image and every level at once.
"""
from __future__ import annotations

import torch

from .nms_rotated import _greedy_sweep


def hbb_iou_matrix(b1, b2):
    """IoU of (x1, y1, x2, y2) boxes, (..., n, 4) against (..., m, 4) ->
    (..., n, m), in the reference's float operations and their order, one
    coordinate at a time (no (..., n, m, 2) intermediate)."""
    a = b1[..., :, None, :]
    b = b2[..., None, :, :]
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    iw = (torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0])).clamp(min=0)
    ih = (torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1])).clamp(min=0)
    inter = iw * ih
    union = area1[..., :, None] + area2[..., None, :] - inter
    return torch.where(union > 1e-9, inter / union.clamp(min=1e-9), 0.0)


def nms(boxes, scores, iou_threshold, valid=None, max_pairs=1 << 26):
    """Greedy hbb NMS over boxes (..., n, 4) and scores (..., n), each
    leading index a problem of its own. Returns (order, keep): indices in
    descending score order (ties to the lower index) and the keep mask
    aligned with `order`. The suppression matrix is built at most
    `max_pairs` pairs at a time over the leading index."""
    n = boxes.shape[-2]
    if valid is None:
        valid = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    s = torch.where(valid, scores, float("-inf"))
    order = torch.sort(s, dim=-1, descending=True, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*order.shape, 4))
    v = torch.gather(valid, -1, order)
    lead = b.shape[:-2]
    flat = b.reshape(-1, n, 4)
    step = max(1, max_pairs // max(n * n, 1))
    over = torch.cat([hbb_iou_matrix(flat[i:i + step], flat[i:i + step]) > iou_threshold
                      for i in range(0, flat.shape[0], step)]) if flat.shape[0] else \
        flat.new_zeros(0, n, n, dtype=torch.bool)
    keep = _greedy_sweep(over.reshape(*lead, n, n), v)
    return order, keep
