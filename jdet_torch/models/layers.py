"""Shared NN building bricks, NCHW.

Port of `jdet_tpu/models/layers.py` (`bias_init_with_prob` :20,
`normal_init` :26, `ConvModule` :30 with norm None or 'bn', `max_pool`
:101, `resize_nearest` :112) plus the `Conv2d`, `BatchNorm2d` and
`Linear` that stand in for flax's `nnx.Conv`, `nnx.BatchNorm` and
`nnx.Linear` (`jdet_tpu/models/nn.py` :53-58).

All three bind the compute dtype of `models/nn.py` when they are built and
follow flax's arithmetic under it (flax 0.12, `promote_dtype` of every
operand to the layer's dtype): the conv casts its input, its float32
weight and its bias to that dtype, convolves, and adds the bias as an
operation of its own in that dtype (a bias fused into the conv rounds
once where flax rounds twice); the BN with running statistics casts the
input and its four float32 vectors to that dtype and normalizes step by
step in it. `ConvModule`, `max_pool` and `resize_nearest` keep their
input's dtype.

Flax's SAME padding is asymmetric under stride 2 (3x3/s2 on an even size
pads (0, 1), 7x7/s2 on 1024 pads (2, 3)), while torch's `padding=k//2` is
symmetric; `same_pads` computes flax's pads from the input size, and an
asymmetric pad goes through `F.pad` before an unpadded conv or pool.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .nn import compute_dtype


def bias_init_with_prob(prior_prob):
    """Focal-loss style classification bias init."""
    return float(-math.log((1 - prior_prob) / prior_prob))


def normal_init(std=0.01):
    """Initializer (tensor, generator) drawing from N(0, std^2)."""
    def init(w, generator):
        return nn.init.normal_(w, 0.0, std, generator=generator)

    return init


def xavier_uniform_init(w, generator):
    """Flax's `xavier_uniform`: U(-a, a), a = sqrt(6 / (fan_in + fan_out))."""
    return nn.init.xavier_uniform_(w, generator=generator)


def lecun_normal_init(w, generator):
    """Flax's default conv kernel init: truncated normal, variance
    1/fan_in."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                 generator=generator)


def same_pads(size, kernel, stride, dilation=1):
    """(lo, hi) padding of flax/XLA 'SAME' along one spatial axis."""
    out = -(-size // stride)
    eff = (kernel - 1) * dilation + 1
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv2d(nn.Module):
    """NCHW conv with flax 'SAME' padding; weight OIHW, float32; computes
    in the compute dtype bound when it is built."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size,
        stride=1,
        bias=True,
        kernel_init=lecun_normal_init,
        bias_value=0.0,
        *,
        generator=None,
    ):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(
            torch.empty(out_channels, in_channels, kernel_size, kernel_size)
        )
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        with torch.no_grad():
            kernel_init(self.weight, generator)
            if self.bias is not None:
                self.bias.fill_(bias_value)

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x, weight = x.to(self.dtype), weight.to(self.dtype)
        ph = same_pads(x.shape[-2], self.kernel_size, self.stride)
        pw = same_pads(x.shape[-1], self.kernel_size, self.stride)
        if ph[0] == ph[1] and pw[0] == pw[1]:
            y = F.conv2d(x, weight, None, self.stride, padding=(ph[0], pw[0]))
        else:
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
            y = F.conv2d(x, weight, None, self.stride)
        if bias is None:
            return y
        return y + bias.to(y.dtype)[:, None, None]


class Linear(nn.Module):
    """y = x W^T + b over the last axis; weight (O, I) and bias float32;
    computes in the compute dtype bound when it is built, with the bias
    added after the product, in that dtype, as flax adds it."""

    def __init__(self, in_features, out_features, kernel_init=lecun_normal_init, *,
                 generator=None):
        super().__init__()
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        with torch.no_grad():
            kernel_init(self.weight, generator)

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x, weight, bias = x.to(self.dtype), weight.to(self.dtype), bias.to(self.dtype)
        return F.linear(x, weight) + bias


class BatchNorm2d(nn.BatchNorm2d):
    """BN with flax's epsilon (1e-5) and momentum 0.9 (torch's 0.1);
    float32 parameters and statistics, computing in the compute dtype
    bound when it is built. Under a compute dtype, training mode takes
    the batch statistics in float32 and rounds the output, as flax does;
    the main path's BNs all run on their running statistics."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.dtype = compute_dtype()

    def forward(self, x):
        d = self.dtype
        if d is None:
            return super().forward(x)
        if self.training:
            # flax's `_compute_stats` (float32, E[x^2] - E[x]^2) and its
            # running averages, which keep the biased variance
            x = x.float()
            mean = x.mean((0, 2, 3))
            var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            scale = torch.rsqrt(var + self.eps) * self.weight.to(d)
            y = (x - mean[:, None, None]) * scale[:, None, None]
            return (y + self.bias.to(d)[:, None, None]).to(d)
        mean, var, scale, bias = (t.to(d)[:, None, None] for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        return (x.to(d) - mean) * (torch.rsqrt(var + self.eps) * scale) + bias


class ConvModule(nn.Module):
    """conv -> norm -> act. norm in {None, 'bn'}; act in {None, 'relu'}."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size,
        *,
        stride=1,
        norm=None,
        act="relu",
        kernel_init=lecun_normal_init,
        generator=None,
    ):
        super().__init__()
        if norm not in (None, "bn"):
            raise NotImplementedError(f"norm {norm!r} is not ported")
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           bias=norm is None, kernel_init=kernel_init,
                           generator=generator)
        self.norm = BatchNorm2d(out_channels) if norm == "bn" else None
        self.act = act

    def forward(self, x):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        if self.act == "relu":
            x = F.relu(x)
        return x


def max_pool(x, window, stride, padding="SAME"):
    """Max pool with flax's 'SAME' padding (pads with -inf) or 'VALID'."""
    if padding == "VALID":
        return F.max_pool2d(x, window, stride)
    ph = same_pads(x.shape[-2], window, stride)
    pw = same_pads(x.shape[-1], window, stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


def resize_nearest(x, size):
    """Nearest-neighbour resize of NCHW to (H, W) = size with half-pixel
    centres (jax.image.resize's 'nearest'); integer upscales repeat."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")
