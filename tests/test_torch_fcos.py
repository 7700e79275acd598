"""Rotated FCOS (its box ops, GroupNorm and Scale, the head, the detector)
in jdet_torch against jdet_tpu, on the CPU.

- `regular_theta`, `regular_obb`, `mintheta_obb` and `distance2obb` on
  random boxes, squares (w == h) and angles on the period's edges: atol
  1e-5;
- `GroupNorm` against flax's `nnx.GroupNorm` (32 groups, epsilon 1e-6):
  float32 within 1e-5 of the output's largest value, and under the bf16
  policy the reference's bf16 output to one bf16 ulp (the statistics in
  float32 on both sides, one rounding at the end); `Scale` exactly, a
  bf16 input giving float32;
- the model (ResNet-18, FPN 64, two GroupNorm tower convs, 128², B=2;
  tests/torch_single_stage_parity.py) on a batch whose points lie clear
  (1e-3 px) of every gt's sides and of the regress ranges' bounds: the
  targets (labels and positives exactly, box targets atol 1e-4) and the
  head's loss forward on the reference's own head outputs rtol 1e-5 (the
  losses of the reference's first step, compiled with XLA's fusion off),
  `predict` on them, 2 train steps and the bf16 model (the helper
  module's tolerances);
- `params_from_jax` strict on the model (the GroupNorms' scale and bias,
  the 0-d `Scale`s), and `configs/fcos_obb_r50_fpn_1x_dota.py` at full
  width.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models import nn as jnn
from jdet_tpu.models.layers import Scale as JScale
from jdet_tpu.ops import box_convert as jbc
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import params_from_jax
from jdet_torch.models.layers import GroupNorm, Scale
from jdet_torch.ops import box_convert as tbc
from jdet_torch.parallel import make_device_normalizer
from torch_single_stage_parity import (BF16, MEAN, SGD_KW, STD, assert_predict_matches,
                                       assert_steps_match, assert_within_gap, jax_model,
                                       make_batch, port, port_steps, reference_bf16,
                                       reference_f32, t)

CFG = dict(
    type="FCOS",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=64, num_outs=5, start_level=1,
              add_extra_convs="on_output", relu_before_extra_convs=True),
    bbox_head=dict(type="FCOSHead", num_classes=5, in_channels=64, feat_channels=64,
                   stacked_convs=2, test_cfg=dict(max_per_img=32)),
)
CLS = ("bbox_head.conv_cls",)
STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the ops ---------------------------------------------------------------------------

def _boxes(rng, n):
    b = np.stack([rng.uniform(0, 256, n), rng.uniform(0, 256, n), rng.uniform(4, 80, n),
                  rng.uniform(4, 80, n), rng.uniform(-2 * np.pi, 2 * np.pi, n)], 1)
    b[:8, 3] = b[:8, 2]  # squares
    b[8:16, 4] = np.float32([-np.pi / 2, np.pi / 2, 0.0, np.pi, -np.pi, np.pi / 4,
                             -np.pi / 4, 3 * np.pi / 4])
    return b.astype(np.float32)


@pytest.mark.parametrize("fn", ["regular_theta", "regular_obb", "mintheta_obb",
                                "distance2obb"])
def test_box_convert_matches(fn):
    rng = np.random.RandomState(0)
    boxes = _boxes(rng, 64)
    if fn == "regular_theta":
        args = (boxes[:, 4],)
    elif fn == "distance2obb":
        pts = rng.uniform(0, 256, (64, 2)).astype(np.float32)
        dist = np.concatenate([rng.uniform(0, 60, (64, 4)), boxes[:, 4:]], 1)
        dist[:4, :4] = 10.0  # w == h
        args = (pts, dist.astype(np.float32))
    else:
        args = (boxes,)
    want = np.asarray(getattr(jbc, fn)(*(jnp.asarray(a) for a in args)))
    got = getattr(tbc, fn)(*(t(a) for a in args)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("norm", ["GroupNorm", "LayerNorm2d", "BatchNorm2d"])
def test_norms_keep_float64_under_a_float64_policy(norm):
    # flax promotes the statistics to at least float32: a float64 policy
    # keeps them in float64 (`chip_smoke.py`'s float64 gradients need it)
    from jdet_torch.models import layers

    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.normal(0.5, 2.0, (2, 64, 5, 7)))
    with tnn.compute_dtype_scope(torch.float64):
        mod = getattr(layers, norm)(64)
    mod.eval()
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 64)))
        mod.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, 64)))
        got = mod(x)
    xd = x.numpy()
    w, b = (v.detach().double().numpy()[:, None, None] for v in (mod.weight, mod.bias))
    if norm == "BatchNorm2d":
        mean, var = (v.double().numpy()[:, None, None] for v in (mod.running_mean,
                                                                  mod.running_var))
    else:
        axes = (1,) if norm == "LayerNorm2d" else (2, 3, 4)
        y = xd.reshape(2, 32, 2, 5, 7) if norm == "GroupNorm" else xd
        mean = y.mean(axes, keepdims=True)
        var = (y * y).mean(axes, keepdims=True) - mean * mean
        if norm == "GroupNorm":
            mean, var = (np.repeat(v, 2, 1).reshape(2, 64, 1, 1) for v in (mean, var))
    want = (xd - mean) / np.sqrt(var + mod.eps) * w + b
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_group_norm_and_scale_match(dtype):
    rng = np.random.RandomState(1)
    C = 64
    x = (rng.normal(0.5, 2.0, (2, 9, 11, C))).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bf16" else None
    with jnn.compute_dtype_scope(jd):
        jgn = jnn.GroupNorm(C, num_groups=32, rngs=nnx.Rngs(0))
    scale, bias = rng.uniform(0.5, 1.5, C), rng.normal(0, 0.1, C)
    jgn.scale.set_value(jnp.asarray(scale, jnp.float32))
    jgn.bias.set_value(jnp.asarray(bias, jnp.float32))
    with tnn.compute_dtype_scope(BF16 if jd else None):
        gn = GroupNorm(C)
    with torch.no_grad():
        gn.weight.copy_(t(np.float32(scale)))
        gn.bias.copy_(t(np.float32(bias)))
    xin = x.astype(jnp.bfloat16) if jd else x
    want = np.asarray(nnx.jit(lambda m, x: m(x))(jgn, jnp.asarray(xin)), np.float32)
    got = gn(torch.from_numpy(np.asarray(xin, np.float32)).to(BF16 if jd else torch.float32)
             .permute(0, 3, 1, 2))
    assert got.dtype == (BF16 if jd else torch.float32)
    got = got.float().permute(0, 2, 3, 1).detach().numpy()
    if jd:
        # one bf16 ulp of the value at most
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
        assert (np.abs(got - want) <= ulp).all()
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    js = JScale(1.0)
    js.scale.set_value(jnp.float32(0.75))
    sc = Scale(1.0)
    sc.load_state_dict(params_from_jax({"scale": np.float32(0.75)}, sc))
    y = rng.normal(0, 3, (2, 4, 5, 5)).astype(np.float32)
    yin = y.astype(jnp.bfloat16) if jd else y
    want = np.asarray(js(jnp.asarray(yin)))
    got = sc(torch.from_numpy(np.asarray(yin, np.float32)).to(BF16 if jd else torch.float32))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got.detach().numpy(), want)


# the model -------------------------------------------------------------------------

def point_margin(head, targets, size=128, weak=False):
    """The smallest distance (px) from a point to a gt's side and from a
    gt's largest side distance to a regress range's bound; `weak` takes
    the gts' circumscribed boxes (H2RBox's)."""
    points, rr, _ = head._point_table([(size // s, size // s) for s in head.strides], "cpu")
    margin = math.inf
    for gt, m in zip(targets["gt_bboxes"], targets["gt_mask"]):
        gt = t(gt[m])
        if weak:
            gt = tbc.hbox_to_rbox(tbc.rbox_to_hbox(gt))
        cx, cy, w, h, a = tbc.mintheta_obb(gt).double().unbind(-1)
        ox, oy = points[:, 0].double() - cx[:, None], points[:, 1].double() - cy[:, None]
        dx = torch.cos(a)[:, None] * ox + torch.sin(a)[:, None] * oy
        dy = -torch.sin(a)[:, None] * ox + torch.cos(a)[:, None] * oy
        ltrb = torch.stack([w[:, None] / 2 + dx, h[:, None] / 2 + dy,
                            w[:, None] / 2 - dx, h[:, None] / 2 - dy], -1)
        margin = min(margin, ltrb.amin(-1).abs().min().item(),
                     (ltrb.amax(-1)[..., None] - rr.double()).abs().min().item())
    return margin


def tie_free_batch(head, num_classes, weak=False):
    for seed in range(1, 40):
        u8, targets = make_batch(seed, num_classes=num_classes)
        if point_margin(head, targets, weak=weak) > 1e-3:
            return u8, targets
    raise AssertionError("no tie-free batch")


def _targets(head, m, outs, jt):
    """The reference's point targets (its `_target_single` over the
    batch) at the port `head`'s points for the outputs' sizes."""
    pts = head._point_table([o[0].shape[1:3] for o in outs], "cpu")
    return jax.vmap(functools.partial(m.bbox_head._target_single,
                                      *(jnp.asarray(p.numpy()) for p in pts)))(
        jt["gt_bboxes"], jt["gt_mask"], jt["gt_labels"])


@functools.cache
def _ref():
    jmodel, weights = jax_model(CFG, CLS)
    tmodel = port(CFG, weights)
    u8, targets = tie_free_batch(tmodel.bbox_head, 5)
    f32 = reference_f32(jmodel, tmodel, u8, targets, SGD_KW,
                        extra=functools.partial(_targets, tmodel.bbox_head))
    bf16 = reference_bf16(jax_model(CFG, CLS, weights, jnp.bfloat16)[0], u8, targets)
    return weights, tmodel, u8, targets, f32, bf16


def to_port(outs, eval_mode=False):
    """The reference's NHWC outputs (cls, distances, theta, centerness) as
    the port's head takes them: NCHW, the eval-mode distances back in
    strides (the strides are powers of two: exact)."""
    return [tuple(t(o).permute(0, 3, 1, 2).contiguous() / (s if i == 1 and eval_mode else 1)
                  for i, o in enumerate(lvl)) for lvl, s in zip(outs, STRIDES)]


def to_ref(outs):
    """The port's outputs in the reference's eval-mode layout."""
    return [[(o.permute(0, 2, 3, 1) * (s if i == 1 else 1)).detach().float().numpy()
             for i, o in enumerate(lvl)] for lvl, s in zip(outs, STRIDES)]


def test_targets_and_head_loss_match_on_the_reference_outputs():
    _, tmodel, _, targets, f32, _ = _ref()
    head = tmodel.bbox_head
    outs = f32["outs_train"]
    pts = head._point_table([o[0].shape[1:3] for o in outs], "cpu")
    labels, bbox_targets, pos = f32["extra"]
    got = head._targets(*pts, t(targets["gt_bboxes"]), t(targets["gt_mask"]),
                        t(targets["gt_labels"]))
    assert int(pos.sum()) > 20
    np.testing.assert_array_equal(got[0].numpy(), labels)
    np.testing.assert_array_equal(got[2].numpy(), pos)
    np.testing.assert_allclose(got[1].numpy()[pos], bbox_targets[pos], rtol=0, atol=1e-4)
    # the reference's first step took these losses of these outputs
    got = head.loss(to_port(outs), {k: t(v) for k, v in targets.items()})
    assert set(got) == {"loss_cls", "loss_bbox", "loss_centerness"}
    for k, v in got.items():
        want = f32["losses"][0][k]
        assert want > 0, k
        np.testing.assert_allclose(v.item(), want, rtol=1e-5, err_msg=k)


def test_head_outputs_and_predict_match():
    _, tmodel, u8, _, f32, _ = _ref()
    with torch.no_grad():
        got = tmodel.bbox_head(tmodel.extract_feat(make_device_normalizer(MEAN, STD)(t(u8))))
    for g, w in zip(to_ref(got), f32["outs"]):
        for i, (gi, wi) in enumerate(zip(g, w)):
            np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-4 * max(1.0, np.abs(wi).max()),
                                       err_msg=f"output {i}")
    head = tmodel.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    got = {k: v.numpy() for k, v in head.predict(to_port(f32["outs"], eval_mode=True)).items()}
    head.test_cfg = dict(head.test_cfg, score_thr=0.05)
    assert got["boxes"].shape == (2, 32, 5)
    assert_predict_matches(got, f32["predict"])


def test_two_train_steps_match():
    weights, _, u8, targets, f32, _ = _ref()
    model, start, log_vars = port_steps(lambda: port(CFG, weights), u8, targets, SGD_KW)
    assert_steps_match(model, start, log_vars, f32, moved_names=(
        "bbox_head.cls_convs.1.norm.weight", "bbox_head.scales.2.scale",
        "bbox_head.scale_t.scale", "bbox_head.conv_centerness.weight"))


def test_bf16_model_within_the_reference_gap():
    weights, _, u8, targets, f32, bf16 = _ref()
    model = port(CFG, weights, BF16)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(t(u8))
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    assert [o.dtype for o in outs[0]] == [BF16, torch.float32, torch.float32, BF16]
    model.train()
    losses = model.loss(images, {k: t(v) for k, v in targets.items()})
    losses = {k: v.item() for k, v in losses.items()}
    losses["total_loss"] = sum(losses.values())
    assert_within_gap(to_ref(outs), bf16, f32, losses)


def test_params_from_jax_is_strict_on_the_model():
    weights, tmodel, _, _, _, _ = _ref()
    sd = params_from_jax(weights, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    assert sd["bbox_head.scales.4.scale"].shape == ()
    assert "bbox_head.reg_convs.1.norm.weight" in sd
    assert not any(k.startswith("bbox_head") and "num_batches_tracked" in k for k in sd)


def test_config_builds_at_full_width():
    cfg = load_cfg_file("configs/fcos_obb_r50_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "FCOS" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(head.cls_convs) == len(head.reg_convs) == 4
    assert head.num_classes == 15 and head.cls_convs[0].norm.num_groups == 32
    assert head.cls_convs[0].conv.bias is None and len(head.scales) == 5
    assert head.conv_cls.weight.shape == (15, 256, 3, 3) and head.norm_on_bbox
