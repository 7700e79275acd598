"""RSDet's modulated loss, the distillation losses and the symmetric KLD
variants.

Port of `jdet_tpu/models/losses/misc_losses.py` (`rsdet_loss` :17,
`knowledge_distillation_kl_div_loss` :64, `im_loss` :81, `jd_loss` :95,
`kld_symmax_loss` :110, `kld_symmin_loss` :122).
"""
from __future__ import annotations

import torch

from .basic import _sum_over
from .gaussian_dist_loss import _postprocess, _reduce, kld_loss


def _mean(loss, avg_factor):
    """loss.sum() over its element count, or over max(avg_factor, 1)."""
    return loss.sum() / loss.numel() if avg_factor is None else _sum_over(loss, avg_factor)


def rsdet_loss(preds, targets, anchors, weight=None, sigma=3.0, reduction="mean",
               avg_factor=None):
    """Modulated 5-parameter loss: the smaller of the smooth-L1 and of
    the L1 of the representation with w and h swapped (a log-ratio
    correction) and the angle a quarter turn off."""
    s2 = sigma ** 2
    diff = (preds - targets).abs()
    loss1 = torch.where(diff < 1.0 / s2, 0.5 * s2 * diff ** 2, diff - 0.5 / s2).sum(-1)

    logr = torch.log(anchors[..., 2].clamp(min=1e-6)) - torch.log(anchors[..., 3].clamp(min=1e-6))
    l2 = torch.stack([
        preds[..., 0] - targets[..., 0],
        preds[..., 1] - targets[..., 1],
        preds[..., 2] - targets[..., 3] - logr,
        preds[..., 3] - targets[..., 2] + logr,
        (preds[..., 4] - targets[..., 4]).abs() - 0.5,
    ], -1)
    loss = torch.minimum(loss1, l2.abs().sum(-1))
    if weight is not None:
        if weight.dim() > loss.dim():
            weight = weight.mean(-1)
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1)
    return _sum_over(loss, avg_factor)


def knowledge_distillation_kl_div_loss(pred, soft_label, T=10.0, weight=None, avg_factor=None,
                                       reduction="mean"):
    """KL(softmax(soft_label / T) || softmax(pred / T)) * T^2 per row."""
    target = torch.softmax(soft_label / T, -1)
    logp = torch.log_softmax(pred / T, -1)
    logq = torch.log_softmax(soft_label / T, -1)
    kd = (target * (logq - logp)).sum(-1) * T * T
    if weight is not None:
        kd = kd * weight
    if reduction == "none":
        return kd
    if reduction == "sum":
        return kd.sum()
    return _mean(kd, avg_factor)


def im_loss(x, soft_target, weight=None, avg_factor=None, reduction="mean"):
    """Feature-imitation MSE against a teacher feature, which takes no
    gradient."""
    loss = (x - soft_target.detach()) ** 2
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    return _mean(loss, avg_factor)


def _kld_both_ways(pred, target, alpha, sqrt):
    kw = dict(fun="none", tau=0.0, alpha=alpha, sqrt=sqrt, reduction="none")
    return kld_loss(pred, target, **kw), kld_loss(target, pred, **kw)


def jd_loss(pred, target, weight=None, fun="log1p", tau=1.0, alpha=1.0, sqrt=True,
            reduction="mean", avg_factor=None):
    """Symmetrized (Jeffreys) KLD."""
    a, b = _kld_both_ways(pred, target, alpha, False)
    jd = 0.5 * (a + b)
    if sqrt:
        jd = torch.sqrt(jd.clamp(min=1e-7))
    return _reduce(_postprocess(jd, fun, tau), weight, reduction, avg_factor)


def kld_symmax_loss(pred, target, weight=None, fun="log1p", tau=1.0, alpha=1.0, sqrt=True,
                    reduction="mean", avg_factor=None):
    """max(KL(p, t), KL(t, p))."""
    a, b = _kld_both_ways(pred, target, alpha, sqrt)
    return _reduce(_postprocess(torch.maximum(a, b), fun, tau), weight, reduction, avg_factor)


def kld_symmin_loss(pred, target, weight=None, fun="log1p", tau=1.0, alpha=1.0, sqrt=True,
                    reduction="mean", avg_factor=None):
    """min(KL(p, t), KL(t, p))."""
    a, b = _kld_both_ways(pred, target, alpha, sqrt)
    return _reduce(_postprocess(torch.minimum(a, b), fun, tau), weight, reduction, avg_factor)
