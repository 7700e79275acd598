"""LR schedules: a warmup prefix wrapping a step/cosine/exp/poly/inv decay.

Port of `jdet_tpu/optim/lr_scheduler.py` (`_warmup_factor` :20,
`build_lr_schedule` :35). A schedule is a plain function from the count
of updates already made to the learning rate, in Python floats. Decays
are expressed in steps; epoch milestones are converted with
`steps_per_epoch`, as in the reference.
"""
from __future__ import annotations

import math

_DECAYS = ("StepLR", "CosineAnnealingLR", "ExpLR", "PolyLR", "InvLR")
_WARMUPS = (None, "constant", "linear", "exp")


def _warmup_factor(step, warmup, warmup_iters, warmup_ratio):
    if warmup is None or step >= warmup_iters:
        return 1.0
    alpha = min(max(step / max(warmup_iters, 1), 0.0), 1.0)
    if warmup == "constant":
        return warmup_ratio
    if warmup == "linear":
        return warmup_ratio + (1 - warmup_ratio) * alpha
    return warmup_ratio ** (1 - alpha)


def build_lr_schedule(
    base_lr,
    *,
    scheduler_type="StepLR",
    milestones=(),
    gamma=0.1,
    steps_per_epoch=1,
    max_steps=None,
    warmup=None,
    warmup_iters=500,
    warmup_ratio=1.0 / 3,
    min_lr=0.0,
    power=1.0,
):
    """Return fn(step) -> lr.

    scheduler_type in {StepLR, CosineAnnealingLR, ExpLR, PolyLR, InvLR}
    (the reference's lr_scheduler.py:73,197,258,277,287; a `*Group` name
    takes the same decay, and `WarmUpLR` is StepLR without milestones).
    warmup in {None, constant, linear, exp} over `warmup_iters` steps,
    starting at `warmup_ratio`. `milestones` are epochs."""
    scheduler_type = scheduler_type.replace("Group", "")
    if scheduler_type == "WarmUpLR":
        scheduler_type = "StepLR"  # warmup-only: no decay
    if scheduler_type not in _DECAYS:
        raise ValueError(f"unknown scheduler_type {scheduler_type!r}")
    if warmup not in _WARMUPS:
        raise ValueError(f"unknown warmup {warmup!r}")
    ms_steps = [int(m * steps_per_epoch) for m in milestones]
    span = max(max_steps or 1, 1)

    def schedule(step):
        if scheduler_type == "StepLR":
            decay = gamma ** sum(step >= m for m in ms_steps)
        elif scheduler_type == "CosineAnnealingLR":
            t = min(max(step / span, 0.0), 1.0)
            decay = (min_lr / base_lr) + (1 - min_lr / base_lr) * 0.5 * (
                1 + math.cos(math.pi * t)
            )
        elif scheduler_type == "ExpLR":
            decay = gamma ** (step / steps_per_epoch)
        elif scheduler_type == "PolyLR":
            t = min(max(step / span, 0.0), 1.0)
            decay = (1 - t) ** power + min_lr / base_lr
        else:  # InvLR
            decay = (1 + gamma * step) ** (-power)
        return base_lr * decay * _warmup_factor(
            step, warmup, warmup_iters, warmup_ratio
        )

    return schedule


def build_group_lr_schedules(base_lr, groups, **common):
    """Per-parameter-group schedules (the reference's
    `build_group_lr_schedules`, :88; JDet's `WarmUpLRGroup` /
    `CosineAnnealingLRGroup`): each group is a dict of overrides of the
    base schedule's keywords, with a `pattern` glob over parameter names
    (default "*"), an `lr_mult` on the base lr and, in place of a
    `warmup_ratio`, an absolute `warmup_init_lr`. Returns [(pattern,
    fn(step) -> lr), ...] for `build_optimizer(group_schedules=...)`."""
    out = []
    for g in groups:
        g = dict(g)
        pattern = g.pop("pattern", "*")
        lr_mult = g.pop("lr_mult", 1.0)
        if "warmup_init_lr" in g:
            g["warmup_ratio"] = g.pop("warmup_init_lr") / (base_lr * lr_mult)
        out.append((pattern, build_lr_schedule(base_lr * lr_mult, **{**common, **g})))
    return out
