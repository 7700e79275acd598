"""Numerical-parity debugging helpers, on the port's state-dict names.

Port of `jdet_tpu/utils/check_diff.py` (`dump_state`, `check_diff`,
`compare_data`; the reference's `utils/check_diff.py:6-45`): dump a
model's state to a pickle of {name: numpy array}, compare a model with
such a dump tensor by tensor, and compare two nested results, printing
the largest absolute differences.
"""
from __future__ import annotations

import pickle

import numpy as np
import torch


def _state_numpy(model):
    return {k: v.detach().cpu().numpy() for k, v in model.state_dict().items()}


def dump_state(model, path):
    """Pickle `model`'s state dict as {name: numpy array} to `path`."""
    with open(path, "wb") as f:
        pickle.dump(_state_numpy(model), f)
    return path


def check_diff(model, ref_path, atol=1e-5, top=20):
    """Compare `model`'s state with a pickled {name: array} dump: prints
    the `top` largest max |diff| (names the dump lacks, or whose shapes
    differ, first) and returns the rows [(name, max |diff| or None,
    note)] that differ by more than `atol` or have a note."""
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    rows = []
    for k, v in _state_numpy(model).items():
        if k not in ref:
            rows.append((k, None, "missing in reference"))
            continue
        r = np.asarray(ref[k])
        if r.shape != v.shape:
            rows.append((k, None, f"shape {v.shape} vs {r.shape}"))
            continue
        rows.append((k, float(np.abs(v.astype(np.float64) - r).max()) if v.size else 0.0, ""))
    rows.sort(key=lambda x: -(x[1] if x[1] is not None else np.inf))
    for k, d, note in rows[:top]:
        print(f"{k}: max|diff|={d} {note}")
    return [(k, d, note) for k, d, note in rows if note or (d or 0) > atol]


def compare_data(a, b, atol=1e-5, prefix=""):
    """Max |a - b| of two nested dicts / lists / arrays or tensors, in
    the same nesting; prints each leaf above `atol` with its path."""
    if isinstance(a, dict):
        return {k: compare_data(a[k], b[k], atol, f"{prefix}.{k}") for k in a}
    if isinstance(a, (list, tuple)):
        return [compare_data(x, y, atol, f"{prefix}[{i}]") for i, (x, y) in enumerate(zip(a, b))]

    def arr(x):
        return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

    d = float(np.abs(arr(a).astype(np.float64) - arr(b)).max())
    if d > atol:
        print(f"{prefix}: max|diff| = {d}")
    return d
