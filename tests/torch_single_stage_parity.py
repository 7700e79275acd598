"""What the parity tests of R3Det, Rotated FCOS and H2RBox share
(tests/test_torch_r3det.py, test_torch_fcos.py, test_torch_h2rbox.py).

Each file builds one narrow reference model (ResNet-18, FPN and towers of
32-64 channels, 128², B=2), carries its weights into the port strictly
through `params_from_jax`, and runs the reference once per precision:
`reference_f32` compiles one function that returns the eval-mode head
outputs, `predict` on them, the train-mode head outputs (what `loss`
sees), the head's targets on them, and one train step (the losses, then
the optimizer's update), and calls it for 2 steps; `reference_bf16`
compiles the bf16 model's head outputs and losses. The step's losses are
the head's loss forward on the train-mode outputs, which the port's head
is held to (rtol 1e-5) on those same outputs. The tolerances:
- `predict` on the reference's head outputs: the same valid slots and
  labels, scores atol 1e-6, boxes atol 1e-4;
- 2 train steps: each parameter within 1e-4 of its tensor's largest
  value, and the losses of each step rtol 1e-4 (the model's convolutions
  sum in another order);
- the gradients of the first step (what an Adam step divides by their
  own size; `reference_f32` returns them): per tensor, the largest
  error within 1e-3 of the largest gradient and the error's norm within
  5e-4 of the gradient's (`GRAD_LIMITS`, as `chip_smoke.py` holds the
  card's);
- bf16: the port's distance to the reference's bf16 result, a root mean
  square, over the reference's own bf16 - f32 gap: each head output,
  pooled over the levels and at each level of at least 100 values,
  within the gap, and the losses, pooled, within 0.25 of it, as
  tests/test_torch_s2anet.py holds them (`assert_within_gap`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.layers import bias_init_with_prob
from jdet_tpu.models.pretrained import assign_flat, flat_paths
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_normalizer
from test_torch_pretrained import _abstract
from test_torch_retina_variants import UNFUSED_OPTIONS
from test_torch_train_step import MEAN, SCHED, STD

BF16 = torch.bfloat16
GRAD_LIMITS = {"grad": 1e-3, "grad_rms": 5e-4}
HEAD_GAP, LOSS_GAP, MIN_VALUES = 1.0, 0.25, 100
SGD_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)


def t(a):
    return torch.from_numpy(np.array(a))


def numpy_params(module):
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}


def make_batch(seed, B=2, size=128, K=8, real=3, num_classes=15):
    """uint8 images and padded targets (gt_bboxes (B, K, 5), 1-based
    gt_labels, gt_mask) from a numpy seed."""
    rng = np.random.RandomState(seed)
    u8 = (rng.rand(B, size, size, 3) * 255).astype(np.uint8)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real] = np.stack([
            rng.uniform(30, 100, real), rng.uniform(30, 100, real),
            rng.uniform(16, 60, real), rng.uniform(8, 30, real),
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, real)], 1)
        labels[b, :real] = rng.randint(1, num_classes + 1, real)
    return u8, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def weights_for(module, cls_paths, seed=1):
    """A value for every leaf of the reference `module` from a seed: conv
    kernels of the backbone and neck with variance 1/fan_in, the head's
    with std 0.01 (its init), but the class convs at `cls_paths` with std
    0.3 and the focal prior bias, so that `predict`'s scores do not tie;
    norm scales and variances in [0.5, 1.5), other leaves N(0, 0.1), the
    head's biases 0."""
    rng = np.random.RandomState(seed)
    _, flat = flat_paths(module)
    out = {}
    for path, var in flat.items():
        shape = tuple(var.get_value().shape)
        prefix, leaf = path.rsplit(".", 1)
        head = path.startswith("bbox_head.")
        if leaf == "kernel":
            std = (0.3 if prefix in cls_paths else 0.01) if head else (
                1.0 / np.sqrt(np.prod(shape[:-1])))
            v = rng.normal(0.0, std, shape)
        elif leaf == "bias" and head and not prefix.endswith(".norm"):
            v = np.full(shape, bias_init_with_prob(0.01) if prefix in cls_paths else 0.0)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        else:
            v = rng.normal(0.0, 0.1, shape)
        out[path] = np.asarray(v, np.float32)
    return out


def jax_model(cfg, cls_paths, weights=None, dtype=None):
    """The reference model built abstract (`nnx.eval_shape`: an eager or
    jitted flax build takes seconds) under the compute dtype `dtype` and
    filled with `weights` (`weights_for`'s when None): (model, weights)."""
    with j_compute_dtype_scope(dtype):
        jm = _abstract(lambda rngs: j_build_detector(cfg, rngs=rngs, load_pretrained=False))
    weights = weights_for(jm, cls_paths) if weights is None else weights
    assign_flat(jm, weights, strict=True)
    return jm, weights


def port(cfg, weights, dtype=None):
    """The port of `cfg` on the CPU with the reference's weights, loaded
    strictly."""
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(cfg, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def trainable(flat, model):
    """The port's names and values of the reference's parameters."""
    return {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in flat.items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale", "weight")}, model).items()}


def fast_jit(fn, *args):
    """fn(*args) compiled with XLA's fusion passes off (as
    tests/test_torch_retina_variants.py's `unfused_jit`): each primitive
    computes as eager JAX computes it, and H2RBox's train step (two
    backbone passes, the rotated view's gathers) compiles in ~25 s
    instead of ~60 s."""
    return compile_unfused(fn, *args)(*args)


def compile_unfused(fn, *args):
    """`fast_jit`'s compiled fn, to call again."""
    return jax.jit(fn).lower(*args).compile(compiler_options=UNFUSED_OPTIONS)


def reference_f32(jmodel, tmodel, u8, targets, opt_kw, lr=0.01, steps=2, loss_kw=None,
                  extra=None):
    """The reference's float32 run, one function compiled once and called
    for each of `steps` train steps: the eval-mode and the train-mode
    head outputs (the backbone's BNs on their statistics either way),
    `predict` (score_thr 0) on the eval ones, `extra(model, outs_train,
    jt)` (a head's targets or another loss on those outputs), then the
    losses and the optimizer's update. The first call's outputs and
    gradients (under the port's names) are kept. `loss_kw` goes to the
    model's `loss`."""
    images = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    loss_kw = loss_kw or {}
    jmodel.bbox_head.test_cfg = dict(jmodel.bbox_head.test_cfg, score_thr=0.0)
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(lr, **SCHED), **opt_kw)
    graphdef, state = nnx.split((jmodel, jopt))

    def run(state):
        m, opt = nnx.merge(graphdef, state)
        feats = m.extract_feat(images)
        outs = m.bbox_head(feats)
        outs_train = m.bbox_head(feats, train=True)
        first = dict(outs=outs, predict=m.bbox_head.predict(outs), outs_train=outs_train,
                     extra=extra(m, outs_train, jt) if extra else {})
        (_, log_vars), grads = nnx.value_and_grad(
            lambda m: j_parse_losses(m.loss(images, jt, **loss_kw)), has_aux=True)(m)
        opt.update(m, grads)
        return first, log_vars, grads, nnx.state((m, opt))

    compiled = compile_unfused(run, state)
    out = {"losses": []}
    for it in range(steps):
        first, log_vars, grads, state = compiled(state)
        if it == 0:
            out.update(jax.tree.map(np.asarray, first))
            out["grads"] = trainable({".".join(str(p) for p in path): np.asarray(
                v.get_value() if hasattr(v, "get_value") else v)
                for path, v in grads.flat_state()}, tmodel)
        out["losses"].append({k: float(v) for k, v in log_vars.items()})
    nnx.update((jmodel, jopt), state)
    out["params"] = trainable(numpy_params(jmodel), tmodel)
    return out


def reference_bf16(jmodel, u8, targets, loss_fn=None):
    """The bf16 reference's eval-mode head outputs (as float32) and its
    losses, jitted once. By default the losses are the head's on its
    train-mode outputs as returned, rounded to bf16
    (`optimization_barrier`), as the loss specifies: under jit XLA would
    keep the fused output convs' sums in float32
    (tests/test_torch_s2anet.py). `loss_fn(m, images, jt)` replaces
    that."""
    images = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    graphdef, state = nnx.split(jmodel)

    def run(state):
        m = nnx.merge(graphdef, state)
        outs = m.bbox_head(m.extract_feat(images))
        if loss_fn is None:
            outs_train = m.bbox_head(m.extract_feat(images, train=True), train=True)
            losses = m.bbox_head.loss(jax.lax.optimization_barrier(outs_train), jt)
        else:
            losses = loss_fn(m, images, jt)
        return outs, j_parse_losses(losses)[1]

    outs, log_vars = fast_jit(run, state)
    return {"outs": jax.tree.map(lambda a: np.asarray(a, np.float32), outs),
            "losses": {k: float(v) for k, v in log_vars.items()}}


def port_steps(tmodel_factory, u8, targets, opt_kw, lr=0.01, steps=2):
    """`steps` train steps of a fresh port through `build_train_step`:
    (model, start parameters, log_vars of each step)."""
    model = tmodel_factory()
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(lr, **SCHED), **opt_kw)
    step = build_train_step(model, opt, preprocess=make_device_normalizer(MEAN, STD))
    tt = {k: t(v) for k, v in targets.items()}
    return model, start, [step(t(u8), tt, it) for it in range(steps)]


def assert_steps_match(model, start, log_vars, want, moved_names=()):
    """The losses of each step rtol 1e-4; each parameter after the steps
    within 1e-4 of its tensor's largest value; `moved_names` moved; the
    frozen parameters untouched."""
    for it, (lv, wl) in enumerate(zip(log_vars, want["losses"])):
        for k, w in wl.items():
            np.testing.assert_allclose(lv[k].item(), w, rtol=1e-4, err_msg=f"step {it} {k}")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) <= set(want["params"])
    for n in got:
        w = want["params"][n]
        tol = 1e-4 * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[n], w, rtol=0, atol=tol, err_msg=f"param {n}")
    for n in moved_names:
        assert not np.array_equal(got[n], start[n].numpy()), n
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert torch.equal(p.detach(), start[n]), n


def assert_grads_match(model, want):
    """Each trainable tensor's `.grad` of `model` against the reference's
    first-step gradients `want`, to `GRAD_LIMITS`."""
    got = {n: p.grad.numpy() for n, p in model.named_parameters() if p.requires_grad}
    assert len(got) > 50 and set(got) <= set(want)
    for n, g in got.items():
        w = want[n].astype(np.float64)
        err = np.abs(g - w)
        for what, e, scale in (("grad", err.max(), np.abs(w).max()),
                               ("grad_rms", np.linalg.norm(err), np.linalg.norm(w))):
            assert e <= GRAD_LIMITS[what] * scale, (
                f"{n}: {what} error {e:.3e} over {scale:.3e} > {GRAD_LIMITS[what]}")


def assert_predict_matches(got, want):
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["polys"][v], want["polys"][v], rtol=0, atol=1e-4)


def rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def assert_within_gap(got_outs, bf16, f32, got_losses):
    """The port's bf16 head outputs (lists of numpy arrays per level, in
    the reference's layout) and losses against the reference's bf16 ones,
    each distance a root mean square over the reference's own bf16 - f32
    gap: each output pooled over the levels within HEAD_GAP; each output
    at each level that holds at least MIN_VALUES values within HEAD_GAP
    too; the losses, pooled, within LOSS_GAP. Below MIN_VALUES a root mean
    square moves by tens of percent between equally good roundings: at
    128², B=2 the top levels hold 2 to 40 values per output (FCOS's level
    4 read 1.0 to 2.0 of gaps as large, relative to the outputs, as level
    0's, where it read 0.62). Returns the level-outputs held pooled only,
    with their counts."""
    pooled = {}
    fracs, small = {}, {}
    for lvl, (g_lvl, b_lvl, f_lvl) in enumerate(zip(got_outs, bf16["outs"], f32["outs"])):
        for i, (g, b, f) in enumerate(zip(*(jax.tree.leaves(x) for x in (g_lvl, b_lvl, f_lvl)))):
            for k, a in enumerate((g, b, f)):
                pooled.setdefault(i, ([], [], []))[k].append(np.ravel(a))
            name = f"level {lvl} output {i}"
            if np.size(b) < MIN_VALUES:
                small[name] = int(np.size(b))
            elif rms(b - f) > 0:
                fracs[name] = rms(g - b) / rms(b - f)
    for i, (g, b, f) in pooled.items():
        g, b, f = (np.concatenate(a) for a in (g, b, f))
        if rms(b - f) > 0:
            fracs[f"output {i} over the levels"] = rms(g - b) / rms(b - f)
    worst = max(fracs, key=fracs.get)
    assert fracs[worst] <= HEAD_GAP, (f"{worst} at {fracs[worst]:.3f} of the gap: {fracs}; "
                                      f"below {MIN_VALUES} values, pooled only: {small}")
    keys = sorted(got_losses)
    assert keys == sorted(bf16["losses"])
    got, b, f = (np.array([d[k] for k in keys]) for d in (
        got_losses, bf16["losses"], f32["losses"][0]))
    frac = rms(got - b) / rms(b - f)
    assert frac <= LOSS_GAP, f"losses at {frac:.3f} of the gap: {got} {b} {f}"
    return small
