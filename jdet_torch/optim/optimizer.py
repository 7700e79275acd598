"""SGD, Adam and AdamW in the form of the reference's optax chains.

Port of `jdet_tpu/optim/optimizer.py` (`frozen_stages_predicate` :37,
`build_optimizer` :59 with SGD :84, Adam :89 and AdamW :91,
`param_groups` lr multipliers :106, the teacher mask :121). For SGD the
reference chains

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

For AdamW the chain is clip -> `optax.adamw(lr_schedule, b1, b2, eps,
weight_decay)` -> multipliers: Adam's moments of the clipped gradient,
bias-corrected by the count of Adam's own updates, u = m^ / (sqrt(v^) +
eps), plus wd * p for every parameter (no mask), times -lr, times the
parameter's multiplier. `OptaxAdam` computes that update as optax does.
`torch.optim.AdamW` with a group lr of lr * mult is the same formula, but
it takes the bias corrections 1 - b^t in float64, where optax takes them
in float32, where 1 - 0.999 rounds 1.3e-5 off its value, which moves the
first updates by ~7e-6 of themselves (`OptaxAdam` meets the reference's
within 1e-6, `tests/test_torch_pretrained.py`). Adam is the
same without the decay: the reference's `optax.adam` ignores
`weight_decay`, and so does the port. Parameters of multiplier 0 are left
out, as for SGD; the reference keeps moments for them that it never
applies.

Per-group schedules are not ported yet.
"""
from __future__ import annotations

import fnmatch
import math

import numpy as np
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


class OptaxAdam(torch.optim.Optimizer):
    """`optax.adamw` (`optax.adam` with weight_decay 0) in optax's float32
    arithmetic, on float32 parameters; the state keeps torch's names
    (`exp_avg` = optax's mu, `exp_avg_sq` = nu, `step` = Adam's count).
    Per parameter, at step t:

        m = (1 - b1) g + b1 m;  v = (1 - b2) g^2 + b2 v
        u = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps) + wd p
        p = p + (-lr) u

    with 1 - b^t computed in float32, as optax's `bias_correction` does.
    A group's lr carries its multiplier, applied to the update as the
    reference's multiplier transform does (the decay term included)."""

    def __init__(self, params, lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            ps = [p for p in group["params"] if p.grad is not None]
            if not ps:
                continue
            b1, b2 = group["betas"]
            for p in ps:
                if not self.state[p]:
                    self.state[p] = {"exp_avg": torch.zeros_like(p),
                                     "exp_avg_sq": torch.zeros_like(p),
                                     "step": torch.zeros((), dtype=torch.float32)}
            states = [self.state[p] for p in ps]
            grads = [p.grad for p in ps]
            mu = [st["exp_avg"] for st in states]
            nu = [st["exp_avg_sq"] for st in states]
            torch._foreach_mul_(mu, b1)
            torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
            torch._foreach_mul_(nu, b2)
            torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
            for st in states:
                st["step"] += 1
            steps = torch.stack([st["step"] for st in states])
            if (steps != steps[0]).any():
                # optax keeps one count for every parameter
                raise RuntimeError("OptaxAdam: a group's parameters are at different steps")
            t = steps[0]
            one = torch.ones((), dtype=torch.float32)
            bc1 = float(one - torch.tensor(b1, dtype=torch.float32) ** t)
            bc2 = float(one - torch.tensor(b2, dtype=torch.float32) ** t)
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, group["eps"])
            upd = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            if group["weight_decay"]:
                torch._foreach_add_(upd, torch._foreach_mul(ps, group["weight_decay"]))
            torch._foreach_mul_(upd, -group["lr"])
            torch._foreach_add_(ps, upd)


class Optimizer:
    """Clip, then the torch optimizer `inner` (SGD with weight decay and
    momentum, or `OptaxAdam`) at the scheduled lr times each group's
    multiplier: one `step()` per update, after `backward()`. `count` is
    the number of updates made, at which the schedule is read."""

    # what each kind keeps per parameter, by torch's state names
    STATE_KEYS = {"sgd": ("momentum_buffer",), "adam": ("exp_avg", "exp_avg_sq", "step"),
                  "adamw": ("exp_avg", "exp_avg_sq", "step")}

    def __init__(self, params, kind, inner, lr_schedule, max_norm):
        # every trainable parameter: its gradient enters the clip's norm
        self.params = params
        self.kind = kind
        self.inner = inner
        self.lr_schedule = lr_schedule
        self.max_norm = max_norm
        self.count = 0

    @property
    def sgd(self):
        """The inner `torch.optim.SGD` (an SGD optimizer only)."""
        if self.kind != "sgd":
            raise AttributeError(f"a {self.kind} optimizer has no SGD")
        return self.inner

    def updated(self):
        """The parameters that `step` updates (multiplier not 0)."""
        return [p for g in self.inner.param_groups for p in g["params"]]

    def state_by_name(self, model):
        """{parameter name: {state name: CPU tensor}} of each parameter of
        `model` that has optimizer state yet."""
        out = {}
        for name, p in model.named_parameters():
            st = self.inner.state.get(p)
            if st:
                out[name] = {k: st[k].detach().cpu().clone() for k in self.STATE_KEYS[self.kind]
                             if st.get(k) is not None}
        return out

    def load_state_by_name(self, model, state):
        """Set the state of each parameter that `step` updates from
        `state` ({parameter name: {state name: array}}); parameters that
        `state` lacks keep theirs."""
        updated = set(self.updated())
        for name, p in model.named_parameters():
            if p in updated and name in state:
                self.inner.state[p] = {k: torch.as_tensor(np.asarray(v)).to(
                    p.device if k != "step" else "cpu", torch.float32).clone()
                    for k, v in state[name].items()}

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        grads = [p.grad for p in self.params if p.grad is not None]
        if self.max_norm is not None and grads:
            clip_by_global_norm_(grads, self.max_norm)
        lr = self.lr_schedule(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr * group["lr_mult"]
        self.inner.step()
        self.count += 1


def build_optimizer(
    model,
    *,
    opt_type="SGD",
    lr_schedule,
    momentum=0.9,
    weight_decay=0.0001,
    betas=(0.9, 0.999),
    eps=1e-8,
    grad_clip=None,
    frozen_stages=None,
    param_groups=None,
):
    """Build the `Optimizer` over `model`'s trainable parameters.

    opt_type: "SGD", "Adam" or "AdamW" (any case). grad_clip: None, a max
    norm, or dict(max_norm=...). param_groups: list of dicts {"pattern":
    glob over parameter names, "lr_mult": float}; the multipliers of every
    matching group multiply."""
    kind = opt_type.lower()
    if kind not in Optimizer.STATE_KEYS:
        raise ValueError(f"optimizer {opt_type!r}: SGD, Adam or AdamW")
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
    lr = lr_schedule(0)
    if kind == "sgd":
        inner = torch.optim.SGD(groups, lr=lr, momentum=momentum, weight_decay=weight_decay)
    else:
        inner = OptaxAdam(groups, lr=lr, betas=betas, eps=eps,
                          weight_decay=weight_decay if kind == "adamw" else 0.0)
    return Optimizer(params, kind, inner, lr_schedule, max_norm)
