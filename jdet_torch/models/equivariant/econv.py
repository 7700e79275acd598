"""Cyclic-group (C8) equivariant convolutions on regular fields, NCHW.

Port of `jdet_tpu/models/equivariant/econv.py` (`rotation_interp_matrix`
:53, `_rot_mats_cached` :83, `lifting_expand` :93, `REConv2d` :107,
`REConv2dLift` :174, `cache_expanded_weights` :209, `InnerBatchNorm`
:238). A regular field carries 8 orientation channels: channel f * 8 + r
of a (B, fields * 8, H, W) tensor is orientation r of field f. Each
filter is stored once; its 8 rotated, orientation-shifted copies are
built by a static linear map, and the layer is one ordinary convolution
(cuDNN) with the expanded weight, OIHW with out channel o * 8 + r and in
channel i * 8 + s.

- `REConv2d` (regular -> regular): 1x1 and 3x3 filters rotate exactly by
  45-degree steps through the ARF gather of `ops/orn.py`; other sizes
  through the bilinear rotation operators, then a roll of the input
  orientations by r.
- `REConv2dLift` (trivial -> regular, the stem): 8 rotated copies of
  each filter through the bilinear operators.
- Both pad k // 2 on every side (not flax's SAME): a 7x7/s2 conv pads
  (3, 3).
- `InnerBatchNorm`: statistics and affine parameters shared by the 8
  orientations of a field, kept in a `BatchNorm2d` child named `bn`.

The compute dtype is the one in force when a module is built
(`models/nn.py`), as for every layer of the port (the reference's C8
convs read the global policy when they are traced, which its Runner and
bench.py set for the whole run), with the reference's own arithmetic: the input is cast
to it, the expansion runs in float32 and is rounded to it, the conv
returns it, and a bias is added in it; `InnerBatchNorm` on running
statistics builds its per-field scale and shift in float32, repeats them
8 times, rounds them to the input's dtype and computes x * scale + shift
in that dtype.

`cache_expanded_weights` keeps each expansion in a non-persistent buffer
(`wexp`, `ops/orn.py::CachedExpansion`) that the forward reads instead of
expanding: a cache that the weight has moved past, or one that would cut
the weight's gradient, raises instead of being read.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...ops.orn import CachedExpansion, ORConv2d, arf_gather_indices, rotate_arf
from ..layers import BatchNorm2d
from ..nn import compute_dtype

N_ORIENT = 8


def rotation_interp_matrix(k, angle):
    """(k*k, k*k) bilinear operator rotating a k x k filter BY `angle`:
    rotated[p] = sum_q M[p, q] original[q], sampling the original at the
    position rotated by -angle about the centre."""
    c = (k - 1) / 2.0
    cos, sin = math.cos(angle), math.sin(angle)
    M = np.zeros((k * k, k * k), np.float32)
    for py in range(k):
        for px in range(k):
            x = px - c
            y = py - c
            sx = cos * x + sin * y + c
            sy = -sin * x + cos * y + c
            x0, y0 = math.floor(sx), math.floor(sy)
            fx, fy = sx - x0, sy - y0
            for dy, wy in ((0, 1 - fy), (1, fy)):
                for dx, wx in ((0, 1 - fx), (1, fx)):
                    qx, qy = x0 + dx, y0 + dy
                    if 0 <= qx < k and 0 <= qy < k and wy * wx > 0:
                        M[py * k + px, qy * k + qx] += wy * wx
    return M


@functools.lru_cache(maxsize=16)
def _rot_mats_cached(k):
    """(8, k*k, k*k) rotation operators by r * 45 degrees."""
    return np.stack([rotation_interp_matrix(k, r * 2 * math.pi / N_ORIENT)
                     for r in range(N_ORIENT)])


def lifting_expand(weight, rot_mats):
    """(O, I, k, k) -> OIHW (O * 8, I, k, k): the 8 rotated copies of each
    filter, out channel o * 8 + r."""
    O, I, k, _ = weight.shape
    flat = weight.reshape(O, I, k * k)
    w = torch.stack([flat @ rot_mats[r].T for r in range(N_ORIENT)], 1)
    return w.reshape(O * N_ORIENT, I, k, k)


def general_expand(weight, rot_mats):
    """(O, I, 8, k, k) -> OIHW (O * 8, I * 8, k, k) for any k: orientation
    r is the filter rotated by r * 45 degrees with its input orientations
    rolled by r."""
    O, I, n_or, k, _ = weight.shape
    w = weight.reshape(O, I, n_or, k * k)
    outs = [torch.roll(w @ rot_mats[r].T, r, dims=2) for r in range(N_ORIENT)]
    return torch.stack(outs, 1).reshape(O * N_ORIENT, I * n_or, k, k)


class REConv2d(CachedExpansion):
    """Regular -> regular C8 group conv. in_fields and out_fields count
    fields (the tensors carry fields * 8 channels). weight (O, I, 8, k,
    k) from N(0, 2 / (I * 8 * k * k)); bias (O * 8,) zero, if any."""

    def __init__(self, in_fields, out_fields, kernel_size=3, stride=1, padding=None,
                 bias=False, *, generator=None):
        super().__init__()
        k = kernel_size
        self.kernel_size = k
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.empty(out_fields, in_fields, N_ORIENT, k, k))
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / (in_fields * N_ORIENT * k * k)),
                            generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_fields * N_ORIENT)) if bias else None
        self._use_lut = k in (1, 3)
        if self._use_lut:
            table = torch.from_numpy(arf_gather_indices(N_ORIENT, N_ORIENT, k))
            self.register_buffer("src_indices", table, persistent=False)
        else:
            self.register_buffer("rot_mats", torch.from_numpy(_rot_mats_cached(k)),
                                 persistent=False)
        self._init_cache()

    def _expand(self):
        if self._use_lut:
            return rotate_arf(self.weight, self.src_indices)
        return general_expand(self.weight, self.rot_mats)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        out = F.conv2d(x, self.expanded_weight().to(x.dtype), None, self.stride, self.padding)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)[:, None, None]
        return out


class REConv2dLift(CachedExpansion):
    """Trivial -> regular lifting conv (the ReResNet stem): in_channels
    plain channels to out_fields regular fields. weight (O, I, k, k) from
    N(0, 2 / (I * k * k)), no bias."""

    def __init__(self, in_channels, out_fields, kernel_size=7, stride=2, padding=None, *,
                 generator=None):
        super().__init__()
        k = kernel_size
        self.stride = stride
        self.padding = k // 2 if padding is None else padding
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.empty(out_fields, in_channels, k, k))
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, math.sqrt(2.0 / (in_channels * k * k)),
                            generator=generator)
        self.register_buffer("rot_mats", torch.from_numpy(_rot_mats_cached(k)),
                             persistent=False)
        self._init_cache()

    def _expand(self):
        return lifting_expand(self.weight, self.rot_mats)

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        return F.conv2d(x, self.expanded_weight().to(x.dtype), None, self.stride,
                        self.padding)


_CACHED = (REConv2d, REConv2dLift, ORConv2d)


def cache_expanded_weights(model, enable=True):
    """Fill (enable) or drop the expansion cache of every `REConv2d`,
    `REConv2dLift` and `ORConv2d` in `model`, from the weights as they
    are now. Returns the number of modules touched."""
    n = 0
    for m in model.modules():
        if isinstance(m, _CACHED):
            m.fill_cache() if enable else m.drop_cache()
            n += 1
    return n


def cache_frozen_expansions(model):
    """The train-time cache (the reference Runner's `_build_train_step`):
    drop every cache, then fill those of the backbone's frozen stem and
    layer1..layer{frozen_stages}, whose weights never change. Returns the
    number of modules filled."""
    cache_expanded_weights(model, enable=False)
    bb = getattr(model, "backbone", None)
    fs = getattr(bb, "frozen_stages", -1)
    if bb is None or fs is None or fs < 0:
        return 0
    return sum(cache_expanded_weights(getattr(bb, name))
               for name in ["conv1", "bn1"] + [f"layer{i}" for i in range(1, fs + 1)]
               if hasattr(bb, name))


class InnerBatchNorm(nn.Module):
    """BatchNorm over regular fields: one mean, variance, scale and bias
    per field, shared by its 8 orientation channels. Training mode takes
    the batch statistics in float32 (E[x^2] - E[x]^2, clamped at 0) and
    moves the running ones by momentum 0.9, as flax does; eval mode uses
    the running ones."""

    def __init__(self, fields):
        super().__init__()
        self.fields = fields
        self.bn = BatchNorm2d(fields)

    def forward(self, x):
        bn = self.bn
        if self.training:
            xf = x.float()
            f = self.fields
            mean_f = xf.mean((0, 2, 3)).reshape(f, N_ORIENT).mean(-1)
            mean2_f = (xf * xf).mean((0, 2, 3)).reshape(f, N_ORIENT).mean(-1)
            var_f = (mean2_f - mean_f * mean_f).clamp(min=0.0)
            with torch.no_grad():
                m = 1.0 - bn.momentum
                bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean_f)
                bn.running_var.copy_(m * bn.running_var + (1 - m) * var_f)
        else:
            mean_f, var_f = bn.running_mean, bn.running_var
        inv = torch.rsqrt(var_f + bn.eps) * bn.weight
        shift = -mean_f * inv + bn.bias
        inv = inv.repeat_interleave(N_ORIENT).to(x.dtype)[:, None, None]
        shift = shift.repeat_interleave(N_ORIENT).to(x.dtype)[:, None, None]
        return x * inv + shift
