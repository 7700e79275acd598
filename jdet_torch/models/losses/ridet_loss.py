"""RIDet's representation-invariant loss.

Port of `jdet_tpu/models/losses/ridet_loss.py` (`ridet_loss` :47): a
center metric (the smooth-L1 distance of the centers over the target's
squared diagonal, scaled by its aspect ratio) plus a geometry metric that
takes the cheaper of the two equivalent orderings of an rbox, (w, h,
theta) and (h, w, theta + pi/2), each scored by a rotation term and an
axis-free (w, h) IoU term. The minimum is elementwise, so the loss has no
matching loop; `torch.minimum` splits the gradient at an exact tie as
`jnp.minimum` does.

Negatives carry zero targets: their aspect ratio becomes 1 / eps and the
diagonal eps, so their terms are very large but finite, and their weight
0 takes them out of the loss and its gradient.
"""
from __future__ import annotations

import math

import torch


def _smooth_l1(diff, beta=1.0):
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _rotation_mapping(inp, tgt, eps=1e-6):
    """The width ratio folded to at most 1, times |cos(d theta)|."""
    ratios_w = (inp[:, 0] / (tgt[:, 0] + eps)).abs()
    ratios_w = torch.where(ratios_w > 1, 1 / (ratios_w + eps), ratios_w)
    dtheta = inp[:, 2] - tgt[:, 2]
    return 1 / (1 + eps + ratios_w * torch.cos(dtheta).abs()) - 0.5


def _wh_iou(inp, tgt, eps=1e-6):
    """-log of the axis-free (w, h) IoU plus the GIoU gap."""
    inter = torch.minimum(inp[:, 0], tgt[:, 0]) * torch.minimum(inp[:, 1], tgt[:, 1])
    union = inp[:, 0] * inp[:, 1] + tgt[:, 0] * tgt[:, 1] - inter
    areac = torch.maximum(inp[:, 0], tgt[:, 0]) * torch.maximum(inp[:, 1], tgt[:, 1])
    return -torch.log(inter / (union + eps) + eps) + (areac - union) / (areac + eps)


def _shape_mapping(inp, tgt):
    return torch.minimum(_wh_iou(inp[:, [1, 0]], tgt[:, :2]), _wh_iou(inp[:, [0, 1]], tgt[:, :2]))


def _hungarian_shape(inp, tgt):
    """The cheaper of the two equivalent (w, h, theta) orderings."""
    tgt_plus = torch.cat([tgt[:, [1, 0]], (tgt[:, 2] + math.pi * 0.5)[:, None]], -1)
    a = 10 * _rotation_mapping(inp, tgt_plus) + 0.1 * _shape_mapping(inp, tgt_plus)
    b = 10 * _rotation_mapping(inp, tgt) + 0.1 * _shape_mapping(inp, tgt)
    return torch.minimum(a, b)


def ridet_loss(pred, target, weight=None, beta=1.0, reduction="mean", avg_factor=None,
               eps=1e-6):
    """pred, target: (n, 5) rboxes; weight (n,) or (n, ...), averaged to
    (n,). Reduction as the reference's: "none", "sum", or the sum over
    `avg_factor` (at least 1; n by default)."""
    box_ratio = target[:, 2] / (target[:, 3] + eps)
    box_ratio = torch.where(box_ratio > 1, box_ratio, 1 / (box_ratio + eps))
    center_dist = _smooth_l1(pred[:, :2] - target[:, :2], beta).sum(-1)
    diagonal = target[:, 2] ** 2 + target[:, 3] ** 2
    center_metric = box_ratio * 0.25 * center_dist / (diagonal + eps)
    loss = center_metric + _hungarian_shape(pred[:, 2:], target[:, 2:])
    if weight is not None:
        if weight.dim() != 1:
            weight = weight.reshape(weight.shape[0], -1).mean(-1)
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1)
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss.sum() / avg.clamp(min=1.0)
