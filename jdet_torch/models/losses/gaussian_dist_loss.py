"""Gaussian-distribution box losses: GWD, KLD, BCD.

Port of `jdet_tpu/models/losses/gaussian_dist_loss.py` (`xy_wh_r_to_gaussian`
:24, `_postprocess` :43, `_reduce` :55, `gwd_loss` :67, `kld_loss` :109,
`bcd_loss` :153, `gaussian_dist_loss` :186). An rbox is the 2-D Gaussian
N(xy, R diag(w/2, h/2)^2 R^T); the distance between two such Gaussians,
normalized by `fun` ("log1p", "sqrt" or "none") and `tau`
(1 - 1 / (tau + d) for tau >= 1), is the regression loss. The 2x2
algebra is written out on the (a, b; b, c) components, as the reference
does.

`kld_loss(compat_ref=True)` divides the inverse of Sigma_p by det(Sigma_p)
once more, the reference's quirk that its published KLD numbers were
trained with; the default is the KL divergence itself.
"""
from __future__ import annotations

import torch

from .basic import _sum_over


def xy_wh_r_to_gaussian(rboxes):
    """(..., 5) rbox -> (xy (..., 2), (a, b, c)), the components of
    sigma = [[a, b], [b, c]] = R diag(w/2, h/2)^2 R^T."""
    xy = rboxes[..., :2]
    w = rboxes[..., 2].clamp(1e-7, 1e7) * 0.5
    h = rboxes[..., 3].clamp(1e-7, 1e7) * 0.5
    r = rboxes[..., 4]
    cos = torch.cos(r)
    sin = torch.sin(r)
    a = cos * cos * w * w + sin * sin * h * h
    b = sin * cos * (w * w - h * h)
    c = sin * sin * w * w + cos * cos * h * h
    return xy, (a, b, c)


def _postprocess(distance, fun="log1p", tau=1.0):
    if fun == "log1p":
        distance = torch.log1p(distance)
    elif fun == "sqrt":
        distance = torch.sqrt(distance.clamp(min=1e-7))
    elif fun != "none":
        raise ValueError(fun)
    if tau >= 1.0:
        return 1 - 1 / (tau + distance)
    return distance


def _reduce(loss, weight, reduction, avg_factor):
    if weight is not None:
        loss = loss * weight
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    if avg_factor is None:
        avg_factor = max(loss.shape[0], 1) if loss.dim() else 1
    return _sum_over(loss, avg_factor)


def gwd_loss(pred, target, weight=None, fun="log1p", tau=1.0, alpha=1.0, normalize=True,
             reduction="mean", avg_factor=None):
    """Gaussian Wasserstein distance loss, with
    Tr(Z^1/2) = sqrt(Tr(Z) + 2 sqrt(det Z)) for the 2x2 PSD Z."""
    xy_p, (ap, bp, cp) = xy_wh_r_to_gaussian(pred)
    xy_t, (at, bt, ct) = xy_wh_r_to_gaussian(target)

    xy_distance = ((xy_p - xy_t) ** 2).sum(-1)
    whr = ap + cp + at + ct
    tr_pt = ap * at + 2 * bp * bt + cp * ct  # Tr(Sigma_p Sigma_t)
    det_p = ap * cp - bp * bp
    det_t = at * ct - bt * bt
    det_sqrt = torch.sqrt((det_p * det_t).clamp(min=0))
    whr = whr - 2 * torch.sqrt((tr_pt + 2 * det_sqrt).clamp(min=1e-7))
    distance = torch.sqrt((xy_distance + alpha * alpha * whr).clamp(min=1e-7))
    if normalize:
        scale = 2 * torch.sqrt(torch.sqrt(det_sqrt.clamp(min=1e-7)).clamp(min=1e-7)).clamp(
            min=1e-7)
        distance = distance / scale
    return _reduce(_postprocess(distance, fun, tau), weight, reduction, avg_factor)


def kld_loss(pred, target, weight=None, fun="log1p", tau=1.0, alpha=1.0, sqrt=True,
             reduction="mean", avg_factor=None, compat_ref=False):
    """KL divergence of the target's Gaussian from the prediction's."""
    xy_p, (ap, bp, cp) = xy_wh_r_to_gaussian(pred)
    xy_t, (at, bt, ct) = xy_wh_r_to_gaussian(target)

    det_p = (ap * cp - bp * bp).clamp(min=1e-7)
    det_t = (at * ct - bt * bt).clamp(min=1e-7)
    # inverse of Sigma_p: [[cp, -bp], [-bp, ap]] / det_p
    inv_scale = det_p * det_p if compat_ref else det_p
    ia = cp / inv_scale
    ib = -bp / inv_scale
    ic = ap / inv_scale

    dx = xy_p[..., 0] - xy_t[..., 0]
    dy = xy_p[..., 1] - xy_t[..., 1]
    xy_distance = 0.5 * (ia * dx * dx + 2 * ib * dx * dy + ic * dy * dy)

    whr_distance = 0.5 * (ia * at + 2 * ib * bt + ic * ct)
    whr_distance = whr_distance + 0.5 * (torch.log(det_p) - torch.log(det_t))
    whr_distance = whr_distance - 1
    distance = xy_distance / (alpha * alpha) + whr_distance
    if sqrt:
        distance = torch.sqrt(distance.clamp(min=1e-7))
    return _reduce(_postprocess(distance, fun, tau), weight, reduction, avg_factor)


def bcd_loss(pred, target, weight=None, fun="log1p", tau=1.0, sqrt=True, reduction="mean",
             avg_factor=None):
    """Bhattacharyya distance loss."""
    xy_p, (ap, bp, cp) = xy_wh_r_to_gaussian(pred)
    xy_t, (at, bt, ct) = xy_wh_r_to_gaussian(target)

    am = 0.5 * (ap + at)
    bm = 0.5 * (bp + bt)
    cm = 0.5 * (cp + ct)
    det_m = (am * cm - bm * bm).clamp(min=1e-7)
    det_p = (ap * cp - bp * bp).clamp(min=1e-7)
    det_t = (at * ct - bt * bt).clamp(min=1e-7)

    dx = xy_p[..., 0] - xy_t[..., 0]
    dy = xy_p[..., 1] - xy_t[..., 1]
    # (1/8) d^T Sigma_m^-1 d
    xy_distance = 0.125 * (cm * dx * dx - 2 * bm * dx * dy + am * dy * dy) / det_m
    whr_distance = 0.5 * torch.log(det_m / torch.sqrt(det_p * det_t))
    distance = xy_distance + whr_distance
    if sqrt:
        distance = torch.sqrt(distance.clamp(min=1e-7))
    return _reduce(_postprocess(distance, fun, tau), weight, reduction, avg_factor)


_GD_FUNCS = {"gwd": gwd_loss, "kld": kld_loss, "bcd": bcd_loss}


def gaussian_dist_loss(pred, target, loss_type="gwd", **kw):
    """GDLoss's dispatch by `loss_type`."""
    return _GD_FUNCS[loss_type](pred, target, **kw)
