"""General helpers.

Copy of `jdet_tpu/utils/general.py` (`parse_losses` :27,
`check_interval` :42, `build_file` :49, `search_ckpt` :56,
`list_images` :69, `set_random_seed` :82), which mirror the reference's
`utils/general.py` (:67, :117, :105, :158, :147, :82).
"""
from __future__ import annotations

import functools
import glob
import os
import random
import re

import numpy as np
import torch


def multi_apply(func, *args, **kwargs):
    """func over the zipped lists of `args`, its result tuples transposed
    into lists (the reference's `multi_apply`)."""
    pfunc = functools.partial(func, **kwargs) if kwargs else func
    return tuple(map(list, zip(*map(pfunc, *args))))


def to_numpy(tree):
    """Tensors of a nested dict / list / tuple -> numpy arrays, on the
    host (the reference's `to_numpy`)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def parse_losses(losses):
    """Sum every entry whose key contains 'loss' (general.py:67-80).
    List-valued entries are summed elementwise first. Returns
    (total, log_vars) with log_vars["total_loss"] = total."""
    total = 0.0
    log_vars = {}
    for k, v in losses.items():
        if isinstance(v, (list, tuple)):
            v = sum(v)
        log_vars[k] = v
        if "loss" in k:
            total = total + v
    log_vars["total_loss"] = total
    return total, log_vars


def check_interval(step, interval):
    """True every `interval` steps (general.py:117)."""
    if interval is None or interval <= 0:
        return False
    return step % interval == 0


def build_file(work_dir, prefix):
    """work_dir/prefix path with directories created (general.py:105)."""
    path = os.path.join(work_dir, prefix)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def search_ckpt(work_dir):
    """Newest checkpoint by epoch number in work_dir/checkpoints
    (general.py:158-163)."""
    files = glob.glob(os.path.join(work_dir, "checkpoints", "ckpt_*.pkl"))
    if not files:
        return None

    def epoch_of(f):
        m = re.search(r"ckpt_(\d+)", os.path.basename(f))
        return int(m.group(1)) if m else -1

    return max(files, key=epoch_of)


def list_images(path):
    exts = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")
    if os.path.isfile(path):
        return [path]
    out = []
    for root, _, names in os.walk(path):
        out.extend(
            os.path.join(root, n) for n in names if n.lower().endswith(exts)
        )
    return sorted(out)


def set_random_seed(seed):
    """Seed Python's, numpy's and torch's global generators."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
