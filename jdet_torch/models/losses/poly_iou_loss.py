"""Polygon IoU losses (PolyIoULoss / PolyGIoULoss).

Port of `jdet_tpu/models/losses/poly_iou_loss.py` (`poly_overlap_aligned`
:55, `poly_iou_loss` :74, `poly_giou_loss` :83): the predicted quad's
ring clipped by the target quad's four half-planes (`ops/convex.py`),
the IoU clipped below at `eps`, the GIoU's enclosing area the hull of
both quads' 8 points. Inputs are rboxes (n, 5) or polys (n, 8).

With a `weight`, only the pairs of nonzero weight are evaluated: the
others add 0 to the loss and to its gradient, as they do in the
reference, which evaluates every pair (RetinaNet's 4 x 196,416 anchors
for a few hundred positives).
"""
from __future__ import annotations

import torch

from ...ops.box_convert import rbox_to_poly
from ...ops.convex import _quad_ccw, hull_area, hull_quad_intersection_area, poly_area
from .basic import _sum_over


def _as_poly(b):
    if b.shape[-1] == 5:
        return rbox_to_poly(b)
    assert b.shape[-1] == 8, b.shape
    return b


def poly_overlap_aligned(pred, target, eps=1e-6):
    """(iou, union, enclosing area) of aligned quad pairs; pred and target
    (n, 5) rboxes or (n, 8) polys."""
    p8, t8 = _as_poly(pred), _as_poly(target)
    n = p8.shape[0]
    pts = p8.reshape(n, 4, 2)
    quad = _quad_ccw(t8.reshape(n, 4, 2))
    inter = hull_quad_intersection_area(pts, quad)
    union = poly_area(p8) + poly_area(t8) - inter + eps
    iou = torch.maximum(inter / union, union.new_tensor(eps))
    return iou, union, hull_area(torch.cat([pts, quad], -2))


def _weighted(per_pair, pred, target, weight, reduction, avg_factor):
    """`per_pair(pred, target)` reduced as the reference's `_reduce`, on
    the pairs of nonzero weight only when a weight is given."""
    n = pred.shape[0]
    if weight is None:
        loss = per_pair(pred, target)
    else:
        if weight.dim() > 1:
            weight = weight.reshape(n, -1).mean(-1)
        idx = weight.nonzero()[:, 0]
        part = per_pair(pred[idx], target[idx]) * weight[idx]
        loss = part if reduction != "none" else pred.new_zeros(n).index_put((idx,), part)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return _sum_over(loss, max(n, 1) if avg_factor is None else avg_factor)


def poly_iou_loss(pred, target, weight=None, linear=False, eps=1e-6, reduction="mean",
                  avg_factor=None):
    """-log(IoU), or 1 - IoU if `linear`, over aligned polygon pairs."""
    def per_pair(p, t):
        iou = poly_overlap_aligned(p, t, eps)[0]
        return 1 - iou if linear else -torch.log(iou)

    return _weighted(per_pair, pred, target, weight, reduction, avg_factor)


def poly_giou_loss(pred, target, weight=None, eps=1e-6, reduction="mean", avg_factor=None):
    """1 - GIoU over aligned polygon pairs."""
    def per_pair(p, t):
        iou, union, enclose = poly_overlap_aligned(p, t, eps)
        return 1 - (iou - (enclose - union) / torch.maximum(enclose, enclose.new_tensor(eps)))

    return _weighted(per_pair, pred, target, weight, reduction, avg_factor)
