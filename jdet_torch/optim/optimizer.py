"""SGD in the form of the reference's optax chain.

Port of `jdet_tpu/optim/optimizer.py` for SGD (`frozen_stages_predicate`
:37, `build_optimizer` :59, `param_groups` lr multipliers :106, the
teacher mask :121). The reference chains

    clip_by_global_norm(max_norm) -> add_decayed_weights(wd)
        -> sgd(lr_schedule, momentum) -> per-parameter multipliers

and `Optimizer.step` does the same in that order:

- the clip is written out as optax computes it: the norm is taken over
  every gradient and, when it is >= max_norm, each gradient becomes
  (g / norm) * max_norm, with no epsilon (`clip_grad_norm_` adds 1e-6);
- `torch.optim.SGD(weight_decay=wd)` adds wd * p to the clipped gradient
  before its momentum, which is `add_decayed_weights` before optax's
  trace, and its buffer starts at the first gradient as the trace starts
  from zeros;
- the schedule is read at the count of updates already made (optax's
  `scale_by_schedule`), so the first update uses lr_schedule(0);
- a multiplier scales its group's lr, which scales the update. A
  parameter whose multiplier is 0 (frozen stages, teachers) is left out
  of SGD; the frozen stages also take no gradient (the backbone sets
  `requires_grad_(False)`, the reference stops the gradient), so they add
  nothing to the clip's norm in either package.

Adam, AdamW and per-group schedules are not ported yet.
"""
from __future__ import annotations

import fnmatch
import math

import torch


def frozen_stages_predicate(frozen_stages):
    """True = trainable. The stem and layer1..layer{frozen_stages} of the
    backbone are excluded from updates (ResNet._freeze_stages)."""
    frozen_names = ["conv1", "bn1", "conv1a", "conv1b", "conv1c",
                    "bn1a", "bn1b", "bn1c"]
    frozen_layers = [f"layer{i}" for i in range(1, frozen_stages + 1)]

    def pred(path, param):
        parts = path.split(".")
        if "backbone" in parts:
            i = parts.index("backbone")
            nxt = parts[i + 1] if len(parts) > i + 1 else ""
            if frozen_stages >= 0 and nxt in frozen_names:
                return False
            if nxt in frozen_layers:
                return False
        return True

    return pred


def clip_by_global_norm_(grads, max_norm):
    """Scale `grads` in place by max_norm / norm when their global 2-norm
    is >= max_norm (optax.clip_by_global_norm). Returns the norm, a
    0-dim tensor on the gradients' device; nothing is read to the host."""
    norm = torch.nn.utils.get_total_norm(grads)
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class Optimizer:
    """Clip, weight decay, momentum SGD at the scheduled lr, per-parameter
    multipliers: one `step()` per update, after `backward()`."""

    def __init__(self, params, groups, lr_schedule, momentum, weight_decay, max_norm):
        # every trainable parameter: its gradient enters the clip's norm
        self.params = params
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.count = 0
        self.sgd = torch.optim.SGD(
            groups, lr=lr_schedule(0), momentum=momentum, weight_decay=weight_decay
        )

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_norm is not None and grads:
            clip_by_global_norm_(grads, self.max_norm)
        lr = self.lr_schedule(self.count)
        for group in self.sgd.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.sgd.step()
        self.count += 1


def build_optimizer(
    model,
    *,
    opt_type="SGD",
    lr_schedule,
    momentum=0.9,
    weight_decay=0.0001,
    grad_clip=None,
    frozen_stages=None,
    param_groups=None,
):
    """Build the `Optimizer` over `model`'s trainable parameters.

    grad_clip: None, a max norm, or dict(max_norm=...). param_groups: list
    of dicts {"pattern": glob over parameter names, "lr_mult": float}; the
    multipliers of every matching group multiply."""
    if opt_type.upper() != "SGD":
        raise NotImplementedError(f"optimizer {opt_type!r} is not ported")
    max_norm = None
    if grad_clip is not None:
        max_norm = grad_clip.get("max_norm", 10.0) if isinstance(grad_clip, dict) else grad_clip

    mult_fns = []
    if param_groups:
        def group_mult(path, param):
            mult = 1.0
            for g in param_groups:
                if fnmatch.fnmatch(path, g.get("pattern", "*")):
                    mult *= g.get("lr_mult", 1.0)
            return mult

        mult_fns.append(group_mult)
    if frozen_stages is not None and frozen_stages >= 0:
        pred = frozen_stages_predicate(frozen_stages)
        mult_fns.append(lambda path, param: 1.0 if pred(path, param) else 0.0)
    # distillation teachers are always frozen (KD single-stage detector)
    mult_fns.append(lambda path, param: 0.0 if "teacher" in path.split(".") else 1.0)

    params, by_mult = [], {}
    for name, p in model.named_parameters():
        if not p.requires_grad:
            continue
        params.append(p)
        mult = float(math.prod(f(name, p) for f in mult_fns))
        if mult != 0.0:
            by_mult.setdefault(mult, []).append(p)
    groups = [{"params": ps, "lr_mult": m} for m, ps in by_mult.items()]
    return Optimizer(params, groups, lr_schedule, momentum, weight_decay, max_norm)
