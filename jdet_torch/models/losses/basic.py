"""Weighted detection losses with avg_factor-style reduction.

Port of `jdet_tpu/models/losses/basic.py` (`weight_reduce_loss` :16,
`_bce_with_logits` :32, `sigmoid_focal_loss` :44, `smooth_l1_loss` :82, `l1_loss` :91,
`cross_entropy_loss` :97, `binary_cross_entropy_loss` :116). Labels are
integers, 0 = background, 1..C = foreground; sigmoid logits have C
channels, so class c maps to channel c-1. The softmax cross entropy takes
its labels as they index the logits (`label_offset` shifts them).
"""
from __future__ import annotations

import torch


def weight_reduce_loss(loss, weight=None, reduction="mean", avg_factor=None):
    """Apply elementwise weight then reduce; avg_factor overrides the mean
    denominator."""
    if weight is not None:
        if weight.dim() < loss.dim():
            weight = weight[..., None]
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        return loss.mean()
    return _sum_over(loss, avg_factor)


def _sum_over(loss, avg_factor):
    """loss.sum() / max(avg_factor, 1)."""
    avg = torch.as_tensor(avg_factor, dtype=loss.dtype, device=loss.device)
    return loss.sum() / avg.clamp(min=1.0)


def _bce_with_logits(logits, targets):
    """Numerically-stable BCE with logits."""
    max_val = (-logits).clamp(min=0)
    return (
        (1 - targets) * logits
        + max_val
        + torch.log(
            (torch.exp(-max_val) + torch.exp(-logits - max_val)).clamp(min=1e-10)
        )
    )


def sigmoid_focal_loss(
    logits,
    labels,
    weight=None,
    gamma=2.0,
    alpha=0.25,
    avg_factor=None,
    reduction="mean",
):
    """Sigmoid focal loss with 1-based labels. logits (..., C); labels
    (...,) int with 0 = background; per-anchor `weight` multiplies the BCE
    before the focal modulation."""
    c = logits.shape[-1]
    classes = torch.arange(1, c + 1, dtype=labels.dtype, device=labels.device)
    targets = (classes == labels[..., None]).to(logits.dtype)
    ce = _bce_with_logits(logits, targets)
    if weight is not None:
        ce = ce * weight[..., None]
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = ce * (1 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1 - alpha) * (1 - targets)
        loss = alpha_t * loss
    if reduction == "mean":
        if avg_factor is None:
            return loss.sum() / loss.numel()
        return _sum_over(loss, avg_factor)
    if reduction == "sum":
        return loss.sum()
    return loss


def smooth_l1_loss(
    pred, target, weight=None, beta=1.0, avg_factor=None, reduction="mean"
):
    """SmoothL1: 0.5 d^2 / beta below beta, d - beta/2 above."""
    diff = (pred - target).abs()
    loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta)
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def l1_loss(pred, target, weight=None, avg_factor=None, reduction="mean"):
    """|pred - target|, weighted and reduced."""
    return weight_reduce_loss((pred - target).abs(), weight, reduction, avg_factor)


def cross_entropy_loss(logits, labels, weight=None, avg_factor=None, reduction="mean",
                       label_offset=0):
    """Softmax cross entropy over the last axis of logits; labels (...,)
    int index it after adding `label_offset`."""
    logp = torch.log_softmax(logits, dim=-1)
    lbl = (labels + label_offset).long()
    loss = -torch.gather(logp, -1, lbl[..., None])[..., 0]
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def binary_cross_entropy_loss(logits, targets, weight=None, avg_factor=None,
                              reduction="mean"):
    """Elementwise BCE with logits against targets (bool or float)."""
    loss = _bce_with_logits(logits, targets.to(logits.dtype))
    return weight_reduce_loss(loss, weight, reduction, avg_factor)


def accuracy(logits, labels):
    """The share of rows whose argmax is their label."""
    return (logits.argmax(-1) == labels).float().mean()
