"""Rotated IoU loss.

Port of `jdet_tpu/models/losses/iou_loss.py::rotated_iou_loss` (:14) on
the exact, differentiable aligned IoU (`ops/box_iou_rotated.py`).
"""
from __future__ import annotations

import torch

from ...ops.box_iou_rotated import box_iou_rotated_aligned
from .basic import _sum_over


def rotated_iou_loss(pred, target, weight=None, mode="log", eps=1e-6, reduction="mean",
                     avg_factor=None):
    ious = box_iou_rotated_aligned(pred, target).clamp(min=eps)
    if mode == "linear":
        loss = 1 - ious
    elif mode == "square":
        loss = 1 - ious ** 2
    elif mode == "log":
        loss = -torch.log(ious)
    else:
        raise ValueError(mode)
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1)
    return _sum_over(loss, avg_factor)
