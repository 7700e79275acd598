"""The compute dtype of the layers (mixed precision).

Port of `jdet_tpu/models/nn.py`. Parameters stay float32; conv and norm
layers compute in the policy's dtype (`torch.bfloat16`, or None for
float32), which each layer reads once, when it is built. So the scope
only has to cover building the model: a model built inside
`compute_dtype_scope(torch.bfloat16)` keeps its policy after the scope
exits. The head casts its outputs back to float32 where the losses and
the decoding start; the anchors, the assigner, the codecs, the losses
and the NMS run in float32.
"""
from __future__ import annotations

import contextlib

_COMPUTE_DTYPE = None  # None: float32


def set_compute_dtype(dtype):
    """Set the compute dtype of layers built from now on; returns the
    previous value, so that a caller can restore it."""
    global _COMPUTE_DTYPE
    prev = _COMPUTE_DTYPE
    _COMPUTE_DTYPE = dtype
    return prev


def compute_dtype():
    return _COMPUTE_DTYPE


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    """Set the compute dtype for the layers built inside the scope, and
    restore the previous one on exit."""
    prev = set_compute_dtype(dtype)
    try:
        yield
    finally:
        set_compute_dtype(prev)
