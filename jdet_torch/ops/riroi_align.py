"""Rotation-invariant RoI align (ReDet).

Port of `jdet_tpu/ops/riroi_align.py` (`_orientation_shift` :20,
`riroi_align` :54, `riroi_align_multilevel` :71): the rotated RoI align
of `ops/roi_align_rotated.py`, then a circular shift of each RoI's
orientation channels by its angle, interpolating linearly between the
two nearest of the 8 discrete orientations, so that an object's
features are the same in its own frame whatever its rotation.

Features are NCHW with fields * 8 channels, orientation fastest; the
aligned output is (B, R, P, P, fields * 8). The shift follows the
reference's arithmetic: theta / 45 degrees split into floor and
fraction (a floor and a floor-mod, since theta is negative for some
boxes), per-RoI weights of the 8 rolls rounded to the features' dtype,
and the 8 weighted rolls summed in order in that dtype.
"""
from __future__ import annotations

import math

import torch

from .roi_align_rotated import roi_align_rotated, roi_align_rotated_multilevel

N_ORIENT = 8


def _orientation_shift(out, rois, n_orientation=N_ORIENT):
    """out (B, R, P, P, C), C = F * n_orientation; rois (B, R, 5). Channel
    j of a field becomes (1 - frac) x[(j + lo) % n] + frac x[(j + hi) % n]
    for theta = (lo + frac) * 2 pi / n, hi = lo + 1."""
    B, R, P, _, C = out.shape
    x = out.reshape(B, R, P, P, C // n_orientation, n_orientation)
    t = rois[..., 4] / (2 * math.pi / n_orientation)
    i0 = torch.floor(t)
    frac = t - i0
    lo = torch.remainder(i0, n_orientation).long()
    hi = torch.remainder(i0 + 1, n_orientation).long()
    s = torch.arange(n_orientation, device=out.device)
    w = ((1 - frac)[..., None] * (s == lo[..., None])
         + frac[..., None] * (s == hi[..., None])).to(out.dtype)  # (B, R, n)
    acc = None
    for k in range(n_orientation):
        # shift k: x[..., (j + k) % n] == roll(x, -k)
        term = w[:, :, k, None, None, None, None] * torch.roll(x, -k, dims=-1)
        acc = term if acc is None else acc + term
    return acc.reshape(B, R, P, P, C)


def riroi_align(feat, rois, out_size=7, spatial_scale=1.0, sampling_ratio=2,
                n_orientation=N_ORIENT, valid=None):
    """One level: feat (B, F * n, H, W), rois (B, R, 5) -> (B, R, P, P,
    F * n)."""
    out = roi_align_rotated(feat, rois, out_size, spatial_scale, sampling_ratio, valid)
    return _orientation_shift(out, rois, n_orientation)


def riroi_align_multilevel(feats, rois, lvl, strides, out_size=7, sampling_ratio=2,
                           n_orientation=N_ORIENT, valid=None):
    """Level-routed: each RoI aligned on its level `lvl` (B, R) only, then
    shifted."""
    out = roi_align_rotated_multilevel(feats, rois, lvl, strides, out_size, sampling_ratio,
                                       valid)
    return _orientation_shift(out, rois, n_orientation)
