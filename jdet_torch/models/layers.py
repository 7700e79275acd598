"""Shared NN building bricks, NCHW.

Port of `jdet_tpu/models/layers.py` (`bias_init_with_prob` :20,
`normal_init` :26, `ConvModule` :30 with norm None, 'bn' or 'gn',
`Scale` :91, `max_pool` :101, `resize_nearest` :112) plus the `Conv2d`,
`BatchNorm2d`, `Linear`, `LayerNorm2d` and `GroupNorm` that stand in for
flax's `nnx.Conv`, `nnx.BatchNorm`, `nnx.Linear`, `nnx.LayerNorm` and
`nnx.GroupNorm` (`jdet_tpu/models/nn.py` :53-74), and `gelu`
(`jax.nn.gelu`'s default tanh form) and `sigmoid`.

All five bind the compute dtype of `models/nn.py` when they are built and
follow flax's arithmetic under it (flax 0.12, `promote_dtype` of every
operand to the layer's dtype): the conv casts its input, its float32
weight and its bias to that dtype, convolves, and adds the bias as an
operation of its own in that dtype (a bias fused into the conv rounds
once where flax rounds twice); the BN with running statistics casts the
input and its four float32 vectors to that dtype and normalizes step by
step in it; the LayerNorm and the GroupNorm cast their input, scale and bias to that
dtype, then take the statistics and normalize in float32 (float64 under
a float64 policy: flax promotes to at least float32) and round once.
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
    1/fan_in, within 2 standard deviations of the untruncated normal.
    Drawn by the inverse CDF (one uniform draw and `erfinv`): PyTorch's
    `trunc_normal_` resamples until every value lies inside, which took a
    ResNet-18 build ~1 s on one CPU thread."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    edge = math.erf(-2.0 / math.sqrt(2.0))  # 2 Phi(-2) - 1
    with torch.no_grad():
        w.uniform_(edge, -edge, generator=generator)
        return w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std)


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


def _stats_dtype(dtype):
    """The dtype flax's norms take statistics in: at least float32."""
    return torch.promote_types(dtype, torch.float32)


def at_least_float32(x):
    """`x` cast to float32, as the reference casts a head's outputs, or
    kept in its dtype where that is wider (a float64 policy's)."""
    return x.to(_stats_dtype(x.dtype))


class BatchNorm2d(nn.BatchNorm2d):
    """BN with flax's epsilon (1e-5) and momentum 0.9 (torch's 0.1) by
    default; float32 parameters and statistics, computing in the compute
    dtype bound when it is built. Training mode takes the batch statistics
    in float32 as flax does (E[x^2] - E[x]^2, clamped at 0) and moves the
    running ones towards them, biased variance included (torch's own
    keeps the unbiased one), rounding the output to the compute dtype;
    the main path's BNs all run on their running statistics.

    `flax_momentum` m (YOLO's 0.97) updates the running statistics in
    flax's own form, m * running + (1 - m) * batch; without it they move
    by `lerp_` with torch's momentum 0.1, as every other model's do."""

    def __init__(self, channels, eps=1e-5, flax_momentum=None):
        super().__init__(channels, eps=eps, momentum=0.1)
        self.flax_momentum = flax_momentum
        self.dtype = compute_dtype()

    def _update_running(self, mean, var):
        m = self.flax_momentum
        for running, batch in ((self.running_mean, mean), (self.running_var, var)):
            if m is None:
                running.lerp_(batch, self.momentum)
            else:
                running.copy_(running * m + batch * (1.0 - m))

    def forward(self, x):
        d = self.dtype
        if self.training:
            # flax's `_compute_stats` and its running averages
            y = x.to(_stats_dtype(x.dtype))
            mean = y.mean((0, 2, 3))
            var = ((y * y).mean((0, 2, 3)) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                self._update_running(mean, var)
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
        inv = torch.rsqrt((var + self.eps).to(_stats_dtype(d))).to(d)
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
        st = _stats_dtype(x.dtype)
        y = x.to(st)
        mean = y.mean(1, keepdim=True)
        var = ((y * y).mean(1, keepdim=True) - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + self.eps) * weight.to(st)[:, None, None]
        y = (y - mean) * mul + bias.to(st)[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


class GroupNorm(nn.Module):
    """flax 0.12's `nnx.GroupNorm` on an NCHW tensor: `num_groups` groups
    of channels (32 by default), epsilon 1e-6 (torch's `nn.GroupNorm` takes
    1e-5), float32 `weight` and `bias` (flax's `scale` and `bias`). Under
    a compute dtype flax casts the input, scale and bias to it; its
    statistics are taken in float32 from a bf16 or float32 input
    (`_compute_stats` promotes to at least float32) as `use_fast_variance`
    takes them, E[x^2] - E[x]^2 clamped at 0 over each image's group (its
    channels and all positions); `_normalize` then computes (x - mean) * (rsqrt(var +
    eps) * scale) + bias in float32, since the float32 statistics promote
    the bf16 operands, and rounds once to the compute dtype bound when the
    layer is built."""

    def __init__(self, channels, num_groups=32, eps=1e-6):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels do not split into {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.dtype = compute_dtype()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        weight, bias = self.weight, self.bias
        if self.dtype is not None:
            x, weight, bias = x.to(self.dtype), weight.to(self.dtype), bias.to(self.dtype)
        b, c, h, w = x.shape
        st = _stats_dtype(x.dtype)
        y = x.to(st).reshape(b, self.num_groups, -1)
        mean = y.mean(-1, keepdim=True)
        var = ((y * y).mean(-1, keepdim=True) - mean * mean).clamp(min=0.0)
        mean = mean.expand(-1, -1, c // self.num_groups).reshape(b, c, 1, 1)
        var = var.expand(-1, -1, c // self.num_groups).reshape(b, c, 1, 1)
        mul = torch.rsqrt(var + self.eps) * weight.to(st)[:, None, None]
        y = (x.to(st) - mean) * mul + bias.to(st)[:, None, None]
        return y if self.dtype is None else y.to(self.dtype)


class Scale(nn.Module):
    """A learnable scalar multiplier (FCOS's per-level scale): a 0-d
    float32 `scale`. As in JAX, a bf16 input times the float32 scalar is
    float32 (torch would keep bf16 for a 0-d operand)."""

    def __init__(self, scale=1.0):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(float(scale)))

    def forward(self, x):
        return x.to(torch.promote_types(x.dtype, self.scale.dtype)) * self.scale


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
    """conv -> norm -> act. norm in {None, 'bn', 'gn'} (the conv has a
    bias only without a norm); act in {None, 'relu'}."""

    def __init__(
        self,
        in_channels,
        out_channels,
        kernel_size,
        *,
        stride=1,
        norm=None,
        num_groups=32,
        act="relu",
        kernel_init=lecun_normal_init,
        generator=None,
    ):
        super().__init__()
        if norm not in (None, "bn", "gn"):
            raise NotImplementedError(f"norm {norm!r} is not ported")
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           bias=norm is None, kernel_init=kernel_init,
                           generator=generator)
        self.norm = (BatchNorm2d(out_channels) if norm == "bn"
                     else GroupNorm(out_channels, num_groups) if norm == "gn" else None)
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


def _linear_weights(n_in, n_out, scale, translation, device):
    """(n_in, n_out) weights of `jax.image.scale_and_translate`'s
    antialiased linear kernel on one axis: output o samples the input at
    (o + 0.5 - translation) / scale - 0.5 with a triangle kernel widened by
    1 / scale when downsampling, its weights normalised to sum 1, and zero
    where the sample lies outside [-0.5, n_in - 0.5]."""
    inv = 1.0 / scale
    kscale = max(inv, 1.0)
    f = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv \
        - translation * inv - 0.5
    x = (f[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs()
    w = (1.0 - x / kscale).clamp(min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, 1.0), 0.0)
    return torch.where(((f >= -0.5) & (f <= n_in - 0.5))[None, :], w, 0.0)


def resize_bilinear(x, size, align_corners=False):
    """Linear resize of NCHW to (H, W) = size as the reference's
    `resize_bilinear` (`jax.image.resize` 'linear', antialiased when
    downsampling); with align_corners its scale is (out - 1) / (in - 1) on
    each axis and its translation 0, as the reference passes them to
    `jax.image.scale_and_translate`. Computed in float32."""
    h, w = x.shape[-2:]
    oh, ow = size
    if align_corners:
        sh, sw = (oh - 1) / max(h - 1, 1), (ow - 1) / max(w - 1, 1)
    else:
        sh, sw = oh / h, ow / w
    wy = _linear_weights(h, oh, sh, 0.0, x.device)
    wx = _linear_weights(w, ow, sw, 0.0, x.device)
    y = torch.einsum("...hw,hH->...Hw", x.float(), wy)
    return torch.einsum("...Hw,wW->...HW", y, wx).to(x.dtype)


def resize_nearest(x, size):
    """Nearest-neighbour resize of NCHW to (H, W) = size with half-pixel
    centres (jax.image.resize's 'nearest'); integer upscales repeat."""
    if tuple(x.shape[-2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")
