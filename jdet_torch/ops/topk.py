"""Top-k in the reference's tie order.

`jax.lax.top_k` returns equal values lower index first. `torch.topk`
does not promise an order among ties, and breaks them one way on the CPU
and another on the card, so which of two tied candidates survives a cut
would depend on the device. `stable_topk` gives the order of a stable
descending sort cut to k: ties keep the lower index first on either
device. Every cut whose tie order decides a result takes it: the heads'
per-level `nms_pre` cut and the multiclass NMS's per-class and final
ones.

For float32 and narrower floats it runs `torch.topk` on a key without
ties: the value's bits, mapped so that integer order is float order, in
the high 32 bits of an int64 and the reversed index in the low 32. A
top-k of (B, N) selects without sorting all N, where a stable sort would
(RetinaNet's level 0 at 1024²: N = 147,456 per image for a cut of 1000).
"""
from __future__ import annotations

import torch

_FLOATS = (torch.float32, torch.float16, torch.bfloat16)


def _tie_free_key(x):
    """int64 keys of a float tensor's last axis: descending key order is
    descending value, ties lower index first (-0.0 counts as +0.0)."""
    bits = (x.float() + 0.0).contiguous().view(torch.int32)
    # negative floats: flip the magnitude bits, so that int order = float order
    ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    n = x.shape[-1]
    rev = torch.arange(n - 1, -1, -1, dtype=torch.int64, device=x.device)
    return ordered.to(torch.int64) * (1 << 32) + rev


def stable_topk(x, k):
    """(values, indices) of the k largest along the last axis, descending,
    ties to the lower index."""
    k = min(k, x.shape[-1])
    if x.dtype in _FLOATS and x.shape[-1] < 2**31:
        _, i = torch.topk(_tie_free_key(x), k, dim=-1)
        return torch.gather(x, -1, i), i
    s, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return s[..., :k], i[..., :k]
