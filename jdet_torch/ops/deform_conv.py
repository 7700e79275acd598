"""Deformable convolution (v1, and v2 with a mask) and bilinear sampling,
NCHW, in plain PyTorch.

Port of `jdet_tpu/ops/deform_conv.py` (`bilinear_sample_nhwc` :24, as
R3Det's feature refinement and H2RBox's image rotation call it;
`deform_conv2d` :115 with its bias, stride, padding, dilation and DCNv2
mask; `DeformConv` :202, as AlignConv uses it at stride 1, padding 1,
no bias; `DCNv2` :232). Offsets are a (dy, dx) pair per output pixel and
kernel tap. Each tap samples the input bilinearly at its moved position,
zero outside (-1, H) x (-1, W) with every out-of-image corner zero; the
samples are contracted with the weight in one product per image,
(Cout, C * k * k) x (C * k * k, H * W), summed in float32.

The reference's corner-packed row table, its 8-aligned row pitch
(`_pitch8`) and `ops/gather.py` are TPU layout workarounds and are not
ported. The sampling is `F.grid_sample(mode="bilinear",
padding_mode="zeros", align_corners=False)` on the pixel coordinates
mapped to [-1, 1], which has exactly these border semantics; its
backward is the scatter-add of the reference's gather. The samples come
out as (B, C, k * k, H * W), so that the product needs no transpose,
and the (B, S, 4, C) corner intermediate is never formed.

Under the bf16 policy the reference samples bf16 features, casts the
weight to their dtype and accumulates and returns float32 (:180-187).
Here the sampling runs in float32 on the bf16 values and its result is
rounded to bf16, and the product of the bf16 samples and the bf16 weight
runs in float32 (the products of two bf16 values are exact in float32),
so the output is float32 in both policies.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..models.layers import Conv2d


def _grid(sy, sx, h, w):
    """Pixel coordinates -> `F.grid_sample`'s [-1, 1] grid
    (align_corners=False), x first."""
    return torch.stack([(2 * sx + 1) / w - 1, (2 * sy + 1) / h - 1], -1)


def deform_conv2d(x, offsets, weight, bias=None, stride=1, padding=1, dilation=1, mask=None):
    """x (B, C, H, W); offsets (B, Ho, Wo, k * k, 2) as (dy, dx), taps in
    row-major (ky, kx) order; weight (Cout, C, k, k); bias (Cout,) or
    None; mask (B, Ho, Wo, k * k), DCNv2's modulation of each tap's
    sample, or None. Tap (ky, kx) of output (i, j) samples at
    (i * stride - padding + ky * dilation + dy, j * stride - padding +
    kx * dilation + dx). Returns (B, Cout, Ho, Wo) float32."""
    B, C, H, W = x.shape
    cout, _, k, _ = weight.shape
    kk = k * k
    Ho = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    f32 = dict(dtype=torch.float32, device=x.device)
    # the sampling position of tap t = ky * k + kx at output (i, j)
    tap = torch.arange(k, **f32) * dilation
    tap_y, tap_x = tap.repeat_interleave(k), tap.repeat(k)
    oy = torch.arange(Ho, **f32) * stride - padding
    ox = torch.arange(Wo, **f32) * stride - padding
    off = offsets.float().permute(0, 3, 4, 1, 2)  # (B, kk, 2, Ho, Wo)
    sy = (oy[:, None] + tap_y[:, None, None]) + off[:, :, 0]
    sx = (ox[None, :] + tap_x[:, None, None]) + off[:, :, 1]
    grid = _grid(sy, sx, H, W)
    cols = F.grid_sample(x.float(), grid.reshape(B, kk, Ho * Wo, 2), mode="bilinear",
                         padding_mode="zeros", align_corners=False)
    if mask is not None:
        cols = cols * mask.float().permute(0, 3, 1, 2).reshape(B, 1, kk, Ho * Wo)
    w2 = weight.to(x.dtype)
    if x.dtype != torch.float32:
        # the reference's samples and weight in the features' dtype
        cols = cols.to(x.dtype).float()
        w2 = w2.float()
    out = torch.matmul(w2.reshape(cout, C * kk), cols.reshape(B, C * kk, Ho * Wo))
    out = out.reshape(B, cout, Ho, Wo)
    return out if bias is None else out + bias.float()[:, None, None]


def bilinear_sample(x, sy, sx):
    """Sample x (B, C, H, W) at the pixel coordinates sy, sx (B, ...) of
    each image; returns (B, C, ...) in x's dtype. A sample is zero outside
    (-1, H) x (-1, W), and each corner outside the image counts zero, as
    in the reference's corner table (`corner_weights_and_rows` :61-85).
    Under the bf16 policy the reference forms the corner weights and sums
    the corners in bf16 (:73-74); here the sampling runs in float32 on the
    bf16 values and rounds once."""
    b, c, h, w = x.shape
    rest = sy.shape[1:]
    grid = _grid(sy.float(), sx.float(), h, w).reshape(b, 1, -1, 2)
    out = F.grid_sample(x.float(), grid, mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(b, c, *rest).to(x.dtype)


class DeformConv(nn.Module):
    """DCN v1 with offsets from the caller (S2ANet's AlignConv) or a
    companion conv: weight (Cout, C, k, k) drawn from N(0, 0.01^2), a zero
    bias with `use_bias`."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1,
                 dilation=1, use_bias=False, *, generator=None):
        super().__init__()
        self.stride, self.padding, self.dilation = stride, padding, dilation
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if use_bias else None
        with torch.no_grad():
            nn.init.normal_(self.weight, 0.0, 0.01, generator=generator)

    def forward(self, x, offsets, mask=None):
        return deform_conv2d(x, offsets, self.weight, self.bias, self.stride, self.padding,
                             self.dilation, mask)


class DCNv2(nn.Module):
    """Modulated deformable conv (the reference's `DCNv2`, :232-279): a
    companion conv `conv_offset` (zero weight and bias, explicit symmetric
    padding) predicts 3 k^2 channels, split into the taps' dy, dx and mask
    logits; the mask is their sigmoid."""

    def __init__(self, in_channels, out_channels, kernel_size=3, stride=1, padding=1,
                 dilation=1, *, generator=None):
        super().__init__()
        k = kernel_size
        self.k = k
        self.deform = DeformConv(in_channels, out_channels, k, stride, padding, dilation,
                                 use_bias=True, generator=generator)
        self.conv_offset = Conv2d(in_channels, 3 * k * k, k, stride,
                                  kernel_init=lambda w, g: w.zero_(), padding=padding,
                                  generator=generator)

    def forward(self, x):
        out = self.conv_offset(x).permute(0, 2, 3, 1)  # (B, Ho, Wo, 3 k^2)
        k2 = self.k * self.k
        offsets = torch.stack([out[..., :k2], out[..., k2:2 * k2]], -1)
        mask = torch.sigmoid(out[..., 2 * k2:])
        return self.deform(x, offsets, mask)
