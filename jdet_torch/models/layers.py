"""Shared NN building bricks, NCHW.

Port of `jdet_tpu/models/layers.py` (`bias_init_with_prob` :20,
`normal_init` :26, `ConvModule` :30 with norm None or 'bn', `max_pool`
:101, `resize_nearest` :112) plus the `Conv2d`, `BatchNorm2d`, `Linear`
and `LayerNorm2d` that stand in for flax's `nnx.Conv`, `nnx.BatchNorm`,
`nnx.Linear` and `nnx.LayerNorm` (`jdet_tpu/models/nn.py` :53-74), and
`gelu` (`jax.nn.gelu`'s default tanh form) and `sigmoid`.

All four bind the compute dtype of `models/nn.py` when they are built and
follow flax's arithmetic under it (flax 0.12, `promote_dtype` of every
operand to the layer's dtype): the conv casts its input, its float32
weight and its bias to that dtype, convolves, and adds the bias as an
operation of its own in that dtype (a bias fused into the conv rounds
once where flax rounds twice); the BN with running statistics casts the
input and its four float32 vectors to that dtype and normalizes step by
step in it; the LayerNorm casts its input, scale and bias to that dtype,
then takes the statistics and normalizes in float32 and rounds once.
`ConvModule`, `max_pool` and `resize_nearest` keep their input's dtype.
`gelu` and `sigmoid` follow XLA's expansion under a lower dtype, each
step rounded to it.

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
    """NCHW conv, weight OIHW (O, I / groups, kh, kw), float32; computes in
    the compute dtype bound when it is built. `kernel_size` is an int or
    (kh, kw). Padding is flax's 'SAME' unless `padding` gives flax's
    explicit symmetric pads, an int or (ph, pw); `groups` is flax's
    `feature_group_count` (depthwise: groups = channels)."""

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
        padding=None,
        dilation=1,
        groups=1,
        generator=None,
    ):
        super().__init__()
        kh, kw = (kernel_size, kernel_size) if isinstance(kernel_size, int) else kernel_size
        self.kernel_size = (kh, kw)
        self.stride = stride
        self.padding = (padding, padding) if isinstance(padding, int) else padding
        self.dilation = dilation
        self.groups = groups
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, kh, kw))
        self.bias = nn.Parameter(torch.empty(out_channels)) if bias else None
        with torch.no_grad():
            kernel_init(self.weight, generator)
            if self.bias is not None:
                self.bias.fill_(bias_value)

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x, weight = x.to(self.dtype), weight.to(self.dtype)
        conv = dict(stride=self.stride, dilation=self.dilation, groups=self.groups)
        if self.padding is not None:
            y = F.conv2d(x, weight, None, padding=self.padding, **conv)
        else:
            (kh, kw), d = self.kernel_size, self.dilation
            ph = same_pads(x.shape[-2], kh, self.stride, d)
            pw = same_pads(x.shape[-1], kw, self.stride, d)
            if ph[0] == ph[1] and pw[0] == pw[1]:
                y = F.conv2d(x, weight, None, padding=(ph[0], pw[0]), **conv)
            else:
                x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
                y = F.conv2d(x, weight, None, **conv)
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
    bound when it is built. Training mode takes the batch statistics in
    float32 as flax does (E[x^2] - E[x]^2, clamped at 0) and moves the
    running ones towards them, biased variance included (torch's own
    keeps the unbiased one), rounding the output to the compute dtype;
    the main path's BNs all run on their running statistics."""

    def __init__(self, channels):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.dtype = compute_dtype()

    def forward(self, x):
        d = self.dtype
        if self.training:
            # flax's `_compute_stats` and its running averages
            y = x.float()
            mean = y.mean((0, 2, 3))
            var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self.running_mean.lerp_(mean, self.momentum)
                self.running_var.lerp_(var, self.momentum)
            weight, bias = self.weight, self.bias
            if d is not None:
                weight, bias = weight.to(d), bias.to(d)
            scale = torch.rsqrt(var + self.eps) * weight
            y = (y - mean[:, None, None]) * scale[:, None, None] + bias[:, None, None]
            return y if d is None else y.to(d)
        if d is None:
            return super().forward(x)
        mean, var, scale, bias = (t.to(d)[:, None, None] for t in (
            self.running_mean, self.running_var, self.weight, self.bias))
        # rsqrt of the bf16 (var + eps) in float32, rounded once, as XLA
        # computes it (torch's CPU kernel rounds 1/sqrt twice on the short
        # per-channel vectors it does not vectorize)
        inv = torch.rsqrt((var + self.eps).float()).to(d)
        return (x.to(d) - mean) * (inv * scale) + bias


class LayerNorm2d(nn.Module):
    """flax's `nnx.LayerNorm` over the channels of an NCHW tensor: epsilon
    1e-6 (flax's default; torch's is 1e-5), float32 scale and bias.
    Statistics in float32 as flax's `use_fast_variance` takes them,
    E[x^2] - E[x]^2 clamped at 0; then (x - mean) * (rsqrt(var + eps) *
    scale) + bias in float32, rounded once to the compute dtype bound when
    it is built (into which input, scale and bias are cast first)."""

    def __init__(self, channels, eps=1e-6):
        super().__init__()
        self.eps = eps
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x, weight, bias = x.to(self.dtype), weight.to(self.dtype), bias.to(self.dtype)
        y = x.float()
        mean = y.mean(1, keepdim=True)
        var = ((y * y).mean(1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * weight.float()[:, None, None]
        y = (y - mean) * mul + bias.float()[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


def _rounded(value, dtype):
    """`value` rounded to `dtype`, as a Python float."""
    return float(torch.tensor(value, dtype=torch.float32).to(dtype))


def gelu(x):
    """`jax.nn.gelu` as the reference calls it: its default
    `approximate=True`, the tanh form (torch's default is the erf form).
    In float32 at once; in a lower dtype (the bf16 policy) step by step in
    that dtype with its constants rounded to it, as XLA computes it: x * (0.5
    * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * (x * x * x)))))."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    c = _rounded(0.044715, x.dtype)
    s = _rounded(math.sqrt(2.0 / math.pi), x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(s * (x + c * (x * x * x)))))


def sigmoid(x):
    """`jax.nn.sigmoid`: in float32 at once; in a lower dtype as XLA
    expands it, 1 / (1 + exp(-x)) with each step rounded to that dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1.0 / (1.0 + torch.exp(-x))


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
