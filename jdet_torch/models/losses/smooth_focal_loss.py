"""Smooth focal loss, CSL's angle-classification loss.

Port of `jdet_tpu/models/losses/smooth_focal_loss.py::smooth_focal_loss`
(:16): focal-weighted BCE against soft targets (the CSL coder's smoothed
circular labels).
"""
from __future__ import annotations

import torch

from .basic import _bce_with_logits, _sum_over


def smooth_focal_loss(pred, target, weight=None, gamma=2.0, alpha=0.25, reduction="mean",
                      avg_factor=None):
    p = torch.sigmoid(pred)
    target = target.to(pred.dtype)
    pt = (1 - p) * target + p * (1 - target)
    focal_weight = (alpha * target + (1 - alpha) * (1 - target)) * pt ** gamma
    loss = _bce_with_logits(pred, target) * focal_weight
    if weight is not None:
        if weight.dim() < loss.dim():
            weight = weight[..., None]
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return loss.sum() / loss.numel() if avg_factor is None else _sum_over(loss, avg_factor)
