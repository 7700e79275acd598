"""General helpers.

Copy of `jdet_tpu/utils/general.py` (`parse_losses` :27,
`check_interval` :42), which mirror the reference's `utils/general.py`
(:67, :117).
"""
from __future__ import annotations


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
