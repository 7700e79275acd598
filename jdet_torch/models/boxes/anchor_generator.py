"""Anchor generation, built on the target device.

Port of `AnchorGeneratorRotated` in
`jdet_tpu/models/boxes/anchor_generator.py` (:27, `_gen_base_anchors`
:69, `grid_anchors` :103): base_size x scales x ratios x angles, anchors
(cx, cy, w, h, theta) centred at 0.5*(base-1) plus the grid shifts, in
(H, W, A) order; of `AnchorGeneratorYangXue` (:157, the widths rounded
on a small grid first); of `multi_level_grid_anchors` (:325); and of
`AnchorGeneratorHBB` (:235), the RPN's horizontal (x1, y1, x2, y2)
anchors.
"""
from __future__ import annotations

import numpy as np
import torch


class AnchorGeneratorRotated:
    """w = base*scale/sqrt(ratio), h = base*scale*sqrt(ratio)."""

    def __init__(
        self,
        base_size,
        scales=None,
        ratios=(1.0,),
        angles=(0.0,),
        octave_base_scale=None,
        scales_per_octave=None,
        ctr=None,
    ):
        self.base_size = base_size
        self.ratios = np.asarray(ratios, np.float32)
        self.angles = np.asarray(angles, np.float32)
        self.ctr = ctr
        if scales is not None:
            self.scales = np.asarray(scales, np.float32)
        elif octave_base_scale is not None and scales_per_octave is not None:
            self.scales = np.asarray(
                [
                    octave_base_scale * 2 ** (i / scales_per_octave)
                    for i in range(scales_per_octave)
                ],
                np.float32,
            )
        else:
            raise ValueError("need scales or octave scales")
        self.base_anchors = self._gen_base_anchors()
        # base anchors per device, copied once: a host-to-device copy in
        # every forward would synchronize the train step with the host
        self._base_on = {}

    @property
    def num_base_anchors(self):
        return self.base_anchors.shape[0]

    def _gen_base_anchors(self):
        w = h = float(self.base_size)
        if self.ctr is None:
            x_ctr = 0.5 * (w - 1)
            y_ctr = 0.5 * (h - 1)
        else:
            x_ctr, y_ctr = self.ctr
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ones = np.ones_like(self.angles)[None, None, :]
        ws = (w * w_ratios[:, None, None] * self.scales[None, :, None]
              * ones).reshape(-1)
        hs = (h * h_ratios[:, None, None] * self.scales[None, :, None]
              * ones).reshape(-1)
        angles = np.tile(self.angles, len(self.scales) * len(self.ratios))
        return np.stack(
            [np.full_like(ws, x_ctr), np.full_like(ws, y_ctr), ws, hs, angles],
            axis=-1,
        ).astype(np.float32)

    def grid_anchors(self, featmap_size, stride, device="cuda"):
        """(H*W*A, 5) float32 anchors for a feature map, on `device`."""
        feat_h, feat_w = featmap_size
        device = torch.device(device)
        sx = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
        sy = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
        shifts = torch.zeros(feat_h, feat_w, 5, device=device)
        shifts[..., 0] = sx[None, :]
        shifts[..., 1] = sy[:, None]
        base = self._base_on.get(device)
        if base is None:
            base = self._base_on[device] = torch.as_tensor(self.base_anchors, device=device)
        return (shifts.reshape(-1, 1, 5) + base[None]).reshape(-1, 5)


class AnchorGeneratorYangXue(AnchorGeneratorRotated):
    """The yangxue/rotation-detection anchors (the reference's
    `AnchorGeneratorYangXue`, :157): widths rounded on a `yx_base_size`
    grid first, round(w_ratio * yx_base_size), heights round(ws * ratio),
    both then scaled to the true base size; centres at center_offset *
    (yx_base_size - 1). (cx, cy, w, h, theta) like the others."""

    def __init__(self, base_size, yx_base_size=4.0, center_offset=0.5, **kw):
        self.yx_base_size = float(yx_base_size)
        self.center_offset = center_offset
        super().__init__(base_size, **kw)

    def _gen_base_anchors(self):
        yx = self.yx_base_size
        ctr = self.center_offset * (yx - 1)
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws0 = np.round(w_ratios * yx)
        hs0 = np.round(ws0 * self.ratios)
        scale = float(self.base_size) / yx
        ones = np.ones_like(self.angles)[None, None, :]
        ws = (ws0[:, None, None] * scale * self.scales[None, :, None] * ones).reshape(-1)
        hs = (hs0[:, None, None] * scale * self.scales[None, :, None] * ones).reshape(-1)
        angles = np.tile(self.angles, len(self.scales) * len(self.ratios))
        return np.stack(
            [np.full_like(ws, ctr), np.full_like(ws, ctr), ws, hs, angles], axis=-1,
        ).astype(np.float32)


def multi_level_grid_anchors(generators, featmap_sizes, strides, device="cuda"):
    """Every level's rotated anchors, concatenated: (sum_l H_l W_l A, 5)."""
    return torch.cat([gen.grid_anchors(tuple(fs), stride, device=device)
                      for gen, fs, stride in zip(generators, featmap_sizes, strides)], 0)


class AnchorGeneratorRotatedS2ANet(AnchorGeneratorRotated):
    """One square, zero-angle anchor per location for S2ANet's FAM: side
    base_size * scale (4 * stride in the configs), centred at
    0.5 * (base_size - 1). Port of `AnchorGeneratorRotatedS2ANet`
    (`anchor_generator.py:206`)."""

    def _gen_base_anchors(self):
        w = h = float(self.base_size)
        h_ratios = np.sqrt(self.ratios)
        w_ratios = 1.0 / h_ratios
        ws = (w * self.scales[:, None] * w_ratios[None, :]).reshape(-1)
        hs = (h * self.scales[:, None] * h_ratios[None, :]).reshape(-1)
        return np.stack(
            [np.full_like(ws, 0.5 * (w - 1)), np.full_like(ws, 0.5 * (h - 1)), ws, hs,
             np.zeros_like(ws)],
            axis=-1,
        ).astype(np.float32)


class AnchorGeneratorHBB:
    """mmdet-style horizontal anchors (x1, y1, x2, y2) per level: base
    size = the level's stride, w = base * scale / sqrt(ratio), h = base *
    scale * sqrt(ratio), ratios outer and scales inner, centred at
    center_offset * base plus the grid shifts, in (H, W, A) order."""

    def __init__(self, strides, ratios, scales, center_offset=0.0):
        self.strides = tuple(strides)
        self.ratios = np.asarray(ratios, np.float32)
        self.scales = np.asarray(scales, np.float32)
        self.base_anchors = []
        for base in self.strides:
            w = h = float(base)
            h_ratios = np.sqrt(self.ratios)
            w_ratios = 1 / h_ratios
            ws = (w * w_ratios[:, None] * self.scales[None, :]).reshape(-1)
            hs = (h * h_ratios[:, None] * self.scales[None, :]).reshape(-1)
            x_ctr, y_ctr = center_offset * w, center_offset * h
            self.base_anchors.append(np.stack(
                [x_ctr - 0.5 * ws, y_ctr - 0.5 * hs, x_ctr + 0.5 * ws, y_ctr + 0.5 * hs],
                axis=-1).astype(np.float32))
        self._base_on = {}

    @property
    def num_base_anchors(self):
        return self.base_anchors[0].shape[0]

    def grid_anchors(self, featmap_size, level, device="cuda"):
        """(H*W*A, 4) float32 anchors of `level`, on `device`."""
        feat_h, feat_w = featmap_size
        device = torch.device(device)
        stride = self.strides[level]
        sx = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
        sy = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
        sxg = sx[None, :].expand(feat_h, feat_w)
        syg = sy[:, None].expand(feat_h, feat_w)
        shifts = torch.stack([sxg, syg, sxg, syg], -1).reshape(-1, 1, 4)
        base = self._base_on.get((device, level))
        if base is None:
            base = self._base_on[(device, level)] = torch.as_tensor(
                self.base_anchors[level], device=device)
        return (shifts + base[None]).reshape(-1, 4)
