"""Oriented Response Networks: Active Rotating Filters and
rotation-invariant pooling, NCHW.

Port of `jdet_tpu/ops/orn.py` (`_KERNEL_INDICES` :26,
`arf_gather_indices` :43, `rotate_arf` :68, `ExpandedWeight` :94,
`ORConv2d` :101, `rotation_invariant_pooling` :155,
`rotation_invariant_encoding` :167). The ARF expansion is a static
gather: the reference's forward scatter table, inverted once in numpy
into a permutation, drives one `index_select`, whose autograd backward is
the scatter-add of the ARF backward.

Channel layout as in the reference: out channel o * nRot + k (rotation
fastest), in channel i * nOrient + orient; the expanded weight is OIHW
(O * nRot, I * nOrient, k, k), the reference's HWIO transposed.
`rotation_invariant_pooling` views the channels as (out, nRot).

`CachedExpansion` is the expanded-weight cache that `ORConv2d` and the
C8 convs of `models/equivariant/econv.py` share (the reference's
`ExpandedWeight` buffers, filled by `cache_expanded_weights`).

`ORConv2d` rounds its expanded weight to its input's dtype and returns
float32, as the reference does (:140-152). In S2ANet its input is the
deformable conv's float32 output, so it runs in float32 under the bf16
policy as well.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# 3x3 spatial rotation index tables (1-based over the 3x3 grid) per 45deg
# step, and the trivial 1x1 table
_KERNEL_INDICES = {
    1: {a: (1,) for a in (0, 45, 90, 135, 180, 225, 270, 315)},
    3: {
        0: (1, 2, 3, 4, 5, 6, 7, 8, 9),
        45: (2, 3, 6, 1, 5, 9, 4, 7, 8),
        90: (3, 6, 9, 2, 5, 8, 1, 4, 7),
        135: (6, 9, 8, 3, 5, 7, 2, 1, 4),
        180: (9, 8, 7, 6, 5, 4, 3, 2, 1),
        225: (8, 7, 4, 9, 5, 1, 6, 3, 2),
        270: (7, 4, 1, 8, 5, 2, 9, 6, 3),
        315: (4, 1, 2, 7, 5, 3, 8, 9, 6),
    },
}


def arf_gather_indices(n_orientation, n_rotation, kernel_size):
    """Static inverse LUT (nRot, nEntry): src[k_rot, dst_entry] with
    entries flattened as orient * kH * kW + spatial."""
    kk = kernel_size * kernel_size
    delta_orientation = 360 / n_orientation
    delta_rotation = 360 / n_rotation
    src = np.zeros((n_rotation, n_orientation * kk), np.int64)
    for i in range(n_orientation):
        for j in range(kk):
            for k in range(n_rotation):
                angle = int(delta_rotation * k)
                layer = (i + math.floor(angle / delta_orientation)) % n_orientation
                dst = layer * kk + _KERNEL_INDICES[kernel_size][angle][j] - 1
                src[k, dst] = i * kk + j
    return src


def rotate_arf(weight, src_indices):
    """Expand (O, I, nOrient, k, k) -> OIHW (O * nRot, I * nOrient, k, k)
    by one `index_select` of the weight's entries per rotation."""
    O, I, n_or, kh, kw = weight.shape
    n_rot = src_indices.shape[0]
    ent = weight.reshape(O * I, n_or * kh * kw).t()  # (nEntry, O*I)
    rot = ent.index_select(0, src_indices.reshape(-1))
    rot = rot.reshape(n_rot, n_or, kh, kw, O, I)
    # -> (O, nRot, I, nOr, kh, kw)
    return rot.permute(4, 0, 5, 1, 2, 3).reshape(O * n_rot, I * n_or, kh, kw)


class CachedExpansion(nn.Module):
    """A module whose conv weight is an expansion (`_expand()`) of its
    `weight`, with a cache of it: `fill_cache` keeps the expansion in the
    non-persistent buffer `wexp` and `expanded_weight` returns it until
    `drop_cache`. The cache records the weight's version: reading it after
    the weight changed, or where the weight's gradient is wanted, raises."""

    def _init_cache(self):
        self.register_buffer("wexp", torch.zeros(0), persistent=False)
        self.cache_on = False
        self._wexp_version = None

    def fill_cache(self):
        with torch.no_grad():
            self.wexp = self._expand()
        self._wexp_version = self.weight._version
        self.cache_on = True

    def drop_cache(self):
        self.wexp = self.weight.new_zeros(0)
        self._wexp_version = None
        self.cache_on = False

    def expanded_weight(self):
        if not self.cache_on:
            return self._expand()
        if self.weight._version != self._wexp_version:
            raise RuntimeError(f"{type(self).__name__}: the expansion cache is stale "
                               "(the weight changed after it was filled)")
        if self.weight.requires_grad and torch.is_grad_enabled():
            raise RuntimeError(f"{type(self).__name__}: the expansion cache would cut the "
                               "weight's gradient; drop it before training")
        return self.wexp


class ORConv2d(CachedExpansion):
    """Oriented-response conv, stride 1 and "same" padding (S2ANet's):
    weight (O, I, nOrient, k, k) drawn from N(0, 2/n), n = I * nOrient * k
    * k; bias (O * nRot,) zero."""

    def __init__(self, in_channels, out_channels, kernel_size=3, arf_config=(1, 8), *,
                 generator=None):
        super().__init__()
        self.n_orientation, self.n_rotation = arf_config
        if in_channels % self.n_orientation:
            raise ValueError(f"in_channels {in_channels} is not a multiple of "
                             f"nOrientation {self.n_orientation}")
        self.padding = kernel_size // 2
        i_base = in_channels // self.n_orientation
        n = i_base * self.n_orientation * kernel_size * kernel_size
        self.weight = nn.Parameter(
            torch.empty(out_channels, i_base, self.n_orientation, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels * self.n_rotation))
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / n), generator=generator)
        self.register_buffer(
            "src_indices",
            torch.from_numpy(arf_gather_indices(self.n_orientation, self.n_rotation,
                                                kernel_size)),
            persistent=False)
        self._init_cache()

    def _expand(self):
        return rotate_arf(self.weight, self.src_indices)

    def forward(self, x):
        # the weight rounded to the input's dtype, the products summed in
        # float32 (the reference's preferred_element_type)
        w = self.expanded_weight().to(x.dtype).float()
        return F.conv2d(x.float(), w, None, 1, self.padding) + self.bias[:, None, None]


def rotation_invariant_pooling(x, n_orientation=8):
    """Max over the orientations of ARF-expanded channels: (B, C, H, W)
    -> (B, C / nOrient, H, W), channels viewed as (out, nRot)."""
    B, C, H, W = x.shape
    return x.reshape(B, C // n_orientation, n_orientation, H, W).amax(2)


def rotation_invariant_encoding(x, n_orientation=8):
    """Align each sample to its main direction: x (B, F * nOrient), the
    orientation of largest summed |x| over the F fields (the first on a
    tie) rotated to the front of every field. Returns (aligned (B, C),
    main direction (B,))."""
    B, C = x.shape
    xo = x.reshape(B, C // n_orientation, n_orientation)
    # argmax returns the first of tied maxima, as jnp.argmax does
    main = xo.abs().sum(1).argmax(-1)
    idx = torch.arange(n_orientation, device=x.device)
    shift = (idx[None] + main[:, None]) % n_orientation
    aligned = torch.gather(xo, 2, shift[:, None, :].expand_as(xo))
    return aligned.reshape(B, C), main
