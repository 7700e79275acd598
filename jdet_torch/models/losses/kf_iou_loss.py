"""KFIoU loss: the overlap of two boxes as the Kalman product of their
Gaussians.

Port of `jdet_tpu/models/losses/kf_iou_loss.py::kf_iou_loss` (:17). The
fused Gaussian Sigma = Sigma_p - Sigma_p (Sigma_p + Sigma_t)^-1 Sigma_p,
written out on 2x2 components; volumes V = 4 sqrt(det Sigma) give
KFIoU = V / (V_p + V_t - V + eps). The centers take a smooth-L1 on the
encoded (delta) xy; the shapes come from the decoded boxes.
"""
from __future__ import annotations

import torch

from .basic import _sum_over
from .gaussian_dist_loss import xy_wh_r_to_gaussian


def kf_iou_loss(pred, target, pred_decode=None, targets_decode=None, weight=None, fun=None,
                beta=1.0 / 9.0, eps=1e-6, reduction="mean", avg_factor=None):
    xy_p = pred[..., :2]
    xy_t = target[..., :2]
    _, (ap, bp, cp) = xy_wh_r_to_gaussian(pred_decode)
    _, (at, bt, ct) = xy_wh_r_to_gaussian(targets_decode)

    diff = (xy_p - xy_t).abs()
    xy_loss = torch.where(diff < beta, 0.5 * diff * diff / beta, diff - 0.5 * beta).sum(-1)

    det_p = ap * cp - bp * bp
    det_t = at * ct - bt * bt
    vb_p = 4 * torch.sqrt(det_p.clamp(min=0))
    vb_t = 4 * torch.sqrt(det_t.clamp(min=0))

    # K = Sigma_p (Sigma_p + Sigma_t)^-1, the inverse [[sc, -sb], [-sb, sa]] / det_s
    sa = ap + at
    sb = bp + bt
    sc = cp + ct
    det_s = (sa * sc - sb * sb).clamp(min=1e-12)
    k11 = (ap * sc - bp * sb) / det_s
    k12 = (-ap * sb + bp * sa) / det_s
    k21 = (bp * sc - cp * sb) / det_s
    k22 = (-bp * sb + cp * sa) / det_s
    # Sigma = Sigma_p - K Sigma_p
    fa = ap - (k11 * ap + k12 * bp)
    fb = bp - (k11 * bp + k12 * cp)
    fc = cp - (k21 * bp + k22 * cp)
    det_f = fa * fc - fb * fb
    vb = torch.nan_to_num(4 * torch.sqrt(det_f.clamp(min=0)))
    kfiou = vb / (vb_p + vb_t - vb + eps)

    if fun == "ln":
        kf = -torch.log(kfiou + eps)
    elif fun == "exp":
        kf = torch.exp(1 - kfiou) - 1
    else:
        kf = 1 - kfiou

    loss = (xy_loss + kf).clamp(min=0)
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1)
    return _sum_over(loss, avg_factor)
