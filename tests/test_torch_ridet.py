"""RIDet's loss, S2ANet's RIDet config and ResNet-101 in jdet_torch against
jdet_tpu, on the CPU.

- `ridet_loss` and its gradient with respect to the predictions, rtol
  1e-5 (atol 1e-6 on the gradient), on positives near their targets,
  zero-target negatives of weight 0 (whose terms reach ~1e12 and must
  leave no inf or NaN in the loss or its gradient, in float32 and on
  bf16-rounded predictions), and exact ties of both minimums (a square
  prediction; a square target with the prediction at pi/4, where both
  orderings score the same bits), where `torch.minimum` and `jnp.minimum`
  both split the gradient;
- the RIDet branch of `S2ANetHead.loss` and of `RotatedRetinaHead`'s, on
  the reference heads' own outputs (narrow heads on random feature
  maps): the losses rtol 1e-5 and their gradients with respect to the
  outputs rtol 1e-4, atol 1e-6 (the reference's loss compiled with
  fusion off, `unfused_jit`);
- the S2ANet RIDet model (ResNet-18, FPN 32, one tower conv, 128², B=2,
  on a batch without near ties in either assignment): 2 train steps
  (warmup lr, clip 35), each parameter within 1e-3 of its tensor's
  largest value, as tests/test_torch_s2anet.py holds one;
- ResNet-101 (stage 3's 23 blocks): a forward at 64² within 1e-5 of each
  stage output's largest value, its leaves through `params_from_jax`, and
  a torchvision file imported alike by both packages;
- `s2anet_r50_fpn_1x_dota_ridet.py` and `s2anet_r101_fpn_1x_dota.py`
  built from their files.
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import jdet_tpu.models.heads  # noqa: F401  (registers the reference's heads)
from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.losses import ridet_loss as j_ridet_loss
from jdet_tpu.models.pretrained import assign_flat as j_assign_flat
from jdet_tpu.models.pretrained import backbone_to_flat as j_backbone_to_flat
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_tpu.utils.registry import HEADS as JHEADS
from jdet_torch.config import load_cfg_file
from jdet_torch.models import pretrained
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.losses import ridet_loss
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_normalizer
from jdet_torch.utils.registry import HEADS, LOSSES, build_from_cfg
from test_torch_pretrained import (_assert_same_state, _backbones, _source_sd,
                                   _torchvision_name)
from test_torch_retina_heads import _head_batch, _to_torch_outs
from test_torch_retina_variants import _boxes, unfused_jit
from test_torch_s2anet import _batch as _s2anet_batch
from test_torch_train_step import MEAN, SCHED, STD, _assert_close_per_tensor

RIDET = dict(type="ridet", beta=1.0, loss_weight=1.0)
ODM_RIDET_CFG = dict(
    fam_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
                 allowed_border=-1, pos_weight=-1),
    odm_cfg=dict(assigner=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
                 allowed_border=-1, pos_weight=-1, reg_decoded_bbox=True),
)
S2A_HEAD = dict(type="S2ANetHead", num_classes=16, in_channels=32, feat_channels=32,
                stacked_convs=1, loss_odm_bbox=RIDET, train_cfg=ODM_RIDET_CFG)
S2A_CFG = dict(
    type="S2ANet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=32, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(S2A_HEAD, test_cfg=dict(nms_pre=256, max_per_img=32)),
)
RETINA_HEAD = dict(type="RotatedRetinaHead", num_classes=16, in_channels=32, feat_channels=32,
                   stacked_convs=1, loss_bbox=RIDET)
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


# the loss -------------------------------------------------------------------------

def _ridet_inputs(n=60, seed=0):
    """pred, target, weight: a third zero-target negatives of weight 0, the
    rest positives near their targets; row 20 a square prediction (the
    inner minimum ties), row 21 a square target with the prediction at
    pi/4 against its angle 0 (the outer minimum ties)."""
    rng = np.random.RandomState(seed)
    target = _boxes(rng, n)
    pred = target.copy()
    pred[:, :2] += rng.normal(0, 4, (n, 2))
    pred[:, 2:4] *= np.exp(rng.normal(0, 0.2, (n, 2)))
    pred[:, 4] += rng.normal(0, 0.2, n)
    weight = np.ones(n, np.float32)
    third = n // 3
    target[:third] = 0.0
    weight[:third] = 0.0
    pred[20, 3] = pred[20, 2]
    target[21, 2:] = (30.0, 30.0, 0.0)
    pred[21, 4] = np.float32(math.pi / 4)
    return pred.astype(np.float32), target, weight


def _j_loss_and_grad(pred, target, weight, **kw):
    # jitted: eager JAX compiles each of the loss's ~100 primitives apart
    return jax.jit(jax.value_and_grad(lambda p: j_ridet_loss(p, target, weight=weight, **kw)))(
        pred)


@pytest.mark.parametrize("bf16_pred", [False, True], ids=["f32", "bf16_rounded"])
def test_ridet_loss_and_gradient_match(bf16_pred):
    pred, target, weight = _ridet_inputs()
    if bf16_pred:
        pred = pred.astype(jnp.bfloat16).astype(np.float32)
    want, want_g = _j_loss_and_grad(jnp.asarray(pred), jnp.asarray(target), jnp.asarray(weight),
                                    avg_factor=jnp.float32(7.0))
    p = _t(pred).requires_grad_(True)
    got = ridet_loss(p, _t(target), weight=_t(weight), avg_factor=torch.tensor(7.0))
    got.backward()
    assert torch.isfinite(got) and torch.isfinite(p.grad).all()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)
    # the negatives: huge finite terms, no gradient through weight 0
    per_row = ridet_loss(_t(pred), _t(target), reduction="none")
    assert torch.isfinite(per_row).all() and per_row[:20].min() > 1e6
    assert (p.grad[:20] == 0).all()


def test_ridet_loss_splits_the_gradient_at_exact_ties():
    """Both minimums tie exactly on rows 20 and 21 in both packages; the
    gradient there equals the reference's, which takes half of each
    branch's."""
    pred, target, weight = _ridet_inputs()
    p = _t(pred).requires_grad_(True)
    # the modules (the packages bind `ridet_loss` to the function)
    tl = importlib.import_module("jdet_torch.models.losses.ridet_loss")
    jl = importlib.import_module("jdet_tpu.models.losses.ridet_loss")
    wh_a = tl._wh_iou(p[20:21, [3, 2]], _t(target[20:21, 2:4]))
    wh_b = tl._wh_iou(p[20:21, [2, 3]], _t(target[20:21, 2:4]))
    assert torch.equal(wh_a, wh_b)
    tp = _t(target[21:22, 2:])
    tplus = torch.cat([tp[:, [1, 0]], (tp[:, 2] + math.pi * 0.5)[:, None]], -1)
    a = 10 * tl._rotation_mapping(p[21:22, 2:], tplus) + 0.1 * tl._shape_mapping(p[21:22, 2:], tplus)
    b = 10 * tl._rotation_mapping(p[21:22, 2:], tp) + 0.1 * tl._shape_mapping(p[21:22, 2:], tp)
    assert torch.equal(a, b)
    jt = jnp.asarray(target[21:22, 2:])
    ja = 10 * jl._rotation_mapping(jnp.asarray(pred[21:22, 2:]), jnp.concatenate(
        [jt[:, [1, 0]], (jt[:, 2] + math.pi * 0.5)[:, None]], -1))
    jb = 10 * jl._rotation_mapping(jnp.asarray(pred[21:22, 2:]), jt)
    assert np.array_equal(np.asarray(ja), np.asarray(jb))
    for rows in ((20, 21), (21, 22)):
        sl = slice(*rows)
        want_g = _j_loss_and_grad(jnp.asarray(pred[sl]), jnp.asarray(target[sl]),
                                  jnp.asarray(weight[sl]))[1]
        q = _t(pred[sl]).requires_grad_(True)
        ridet_loss(q, _t(target[sl]), weight=_t(weight[sl])).backward()
        np.testing.assert_allclose(q.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
        assert q.grad[0, 2:4].abs().sum() > 0


def test_ridet_loss_reductions_and_registry():
    pred, target, weight = _ridet_inputs()
    w2 = np.repeat(weight[:, None], 5, 1)
    for kw in (dict(reduction="none"), dict(reduction="sum"), dict()):
        want = np.asarray(j_ridet_loss(jnp.asarray(pred), jnp.asarray(target),
                                       weight=jnp.asarray(w2), **kw))
        got = ridet_loss(_t(pred), _t(target), weight=_t(w2), **kw).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5)
    fn = build_from_cfg(dict(type="RIDetLoss", beta=0.5), LOSSES)
    np.testing.assert_allclose(fn(_t(pred), _t(target), weight=_t(weight)).item(),
                               float(j_ridet_loss(jnp.asarray(pred), jnp.asarray(target),
                                                  weight=jnp.asarray(weight), beta=0.5)),
                               rtol=1e-5)


# the heads on the reference's outputs -------------------------------------------------

@functools.cache
def _head_pair(kind):
    cfg = dict(S2A_HEAD if kind == "s2anet" else RETINA_HEAD)
    head_cls = JHEADS.get(cfg.pop("type"))
    jhead = nnx.jit(lambda: head_cls(rngs=nnx.Rngs(1), **cfg))()
    thead = build_from_cfg(dict(S2A_HEAD if kind == "s2anet" else RETINA_HEAD), HEADS,
                           generator=torch.Generator().manual_seed(0))
    _, flat = flat_paths(jhead)
    load_from_jax(thead, {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
                          for k, v in flat.items()})
    forward = nnx.jit(lambda h, f: h(f))
    for seed in range(21, 60):
        feats, targets = _head_batch(seed)
        jouts = forward(jhead, [jnp.asarray(f) for f in feats])
        if kind == "retina" or _s2anet_margin(thead, jouts, targets) > 1e-5:
            return jhead, thead, jouts, targets
    raise AssertionError("no tie-free batch")


def _s2anet_margin(thead, jouts, targets):
    """The assignments' smallest margin (tests/test_torch_s2anet.py's
    `_margin`) on the init anchors (FAM) and the refined ones (ODM): the
    low-quality match compares IoUs for exact equality."""
    from test_torch_s2anet import _margin

    sizes = [o[0].shape[1:3] for o in jouts]
    init = thead._flat_init_anchors(sizes, "cpu")
    refine = torch.cat([_t(o[2]).reshape(2, -1, 5) for o in jouts], 1)
    gts, mask = targets["gt_bboxes"], targets["gt_mask"]
    return min(_margin(thead, gts, mask, init.expand(2, -1, -1)),
               _margin(thead, gts, mask, refine))


def _touts(kind, jouts):
    """The reference's NHWC outputs as the port's head takes them: NCHW,
    but S2ANet's refined anchors, (B, H, W, 5) in both."""
    if kind == "retina":
        return _to_torch_outs(jouts, requires_grad=True)
    return [tuple((_t(o) if i == 2 else _t(o).permute(0, 3, 1, 2).contiguous())
                  .requires_grad_(i != 2) for i, o in enumerate(lvl)) for lvl in jouts]


@pytest.mark.parametrize("kind", ["s2anet", "retina"])
def test_head_ridet_losses_and_gradients_match(kind):
    jhead, thead, jouts, targets = _head_pair(kind)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    graphdef, state = nnx.split(jhead)

    def total_and_grad(state, o):
        def total(o):
            losses = nnx.merge(graphdef, state).loss(o, jt)
            return sum(losses.values()), losses
        return jax.value_and_grad(total, has_aux=True)(o)

    (_, want), want_grads = unfused_jit(total_and_grad, state, jouts)
    touts = _touts(kind, jouts)
    got = thead.loss(touts, {k: _t(v) for k, v in targets.items()})
    if kind == "retina":
        got = got[0] if isinstance(got, tuple) else got
    assert set(got) == set(want)
    bbox = "loss_odm_bbox" if kind == "s2anet" else "loss_bbox"
    assert float(want[bbox]) > 0
    for k in want:
        assert np.isfinite(float(want[k])), k
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-5, err_msg=k)
    sum(got.values()).backward()
    for jl, tl in zip(want_grads, touts):
        for i, (j, t) in enumerate(zip(jl, tl)):
            if not t.requires_grad:
                continue
            g = t.grad.permute(0, 2, 3, 1) if t.dim() == 4 else t.grad
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-4, atol=1e-6)


# the S2ANet RIDet model -------------------------------------------------------------

def test_s2anet_ridet_two_train_steps_match():
    from test_torch_retinanet import _randomize_bn

    jmodel = nnx.jit(lambda: j_build_detector(S2A_CFG, seed=0))()
    _randomize_bn(jmodel, seed=1)
    _, flat = flat_paths(jmodel)
    weights = {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
               for k, v in flat.items()}
    model = build_detector(S2A_CFG, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    u8, targets = _s2anet_batch(model)
    images = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    @nnx.jit
    def step(m, opt):
        (_, log_vars), grads = nnx.value_and_grad(
            lambda m: j_parse_losses(m.loss(images, jt)), has_aux=True)(m)
        opt.update(m, grads)
        return log_vars

    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
    want_lv = [step(jmodel, jopt) for _ in range(2)]
    _, flat = flat_paths(jmodel)
    want = {k: v.numpy() for k, v in params_from_jax(
        {k: np.asarray(v.get_value()) for k, v in flat.items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale", "weight")}, model).items()}

    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    tstep = build_train_step(model, opt, preprocess=make_device_normalizer(MEAN, STD))
    tt = {k: _t(v) for k, v in targets.items()}
    for it in range(2):
        lv = tstep(_t(u8), tt, it)
        assert "loss_odm_bbox" in lv and float(want_lv[it]["loss_odm_bbox"]) > 0
        for k, v in want_lv[it].items():
            np.testing.assert_allclose(lv[k].item(), float(v), rtol=1e-3, err_msg=f"{it} {k}")
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _assert_close_per_tensor(got, {n: want[n] for n in got}, "param")
    for n in ("bbox_head.odm_reg.weight", "bbox_head.align_conv.deform_conv.weight"):
        assert not np.array_equal(got[n], start[n].numpy()), n


# ResNet-101 ---------------------------------------------------------------------------

def test_resnet101_forward_matches():
    jm, tm = _backbones("resnet", depth=101)
    assert len(tm.layer3) == 23
    rng = np.random.RandomState(5)
    _, flat = flat_paths(jm)
    values = {}
    for path, var in flat.items():
        shape, leaf = var.get_value().shape, path.rsplit(".", 1)[1]
        if leaf == "kernel":
            v = rng.normal(0, math.sqrt(1.0 / np.prod(shape[:-1])), shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.0, shape)
        else:
            v = rng.normal(0, 0.1, shape)
        values[path] = v.astype(np.float32)
        var.set_value(jnp.asarray(values[path]))
    load_from_jax(tm, values)
    x = rng.rand(1, 64, 64, 3).astype(np.float32)
    want = nnx.jit(lambda m, x: m(x, False))(jm, jnp.asarray(x))
    tm.eval()
    with torch.no_grad():
        got = tm(_t(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


def test_resnet101_torchvision_import_equals_the_reference():
    jm, tm = _backbones("resnet", depth=101)
    sd = _source_sd(tm, _torchvision_name, seed=6)
    assert "layer3.22.conv3.weight" in sd
    _, missing, unexpected = j_assign_flat(jm, j_backbone_to_flat(jm, sd), strict=True)
    assert not missing and not unexpected
    _, missing, unexpected = pretrained.assign_state(tm, pretrained.backbone_to_flat(tm, sd),
                                                     strict=True)
    assert not missing and not unexpected
    _assert_same_state(jm, tm)


@pytest.mark.parametrize("name", ["s2anet_r50_fpn_1x_dota_ridet.py",
                                  "s2anet_r101_fpn_1x_dota.py"])
def test_s2anet_configs_build_from_their_files(name):
    cfg = load_cfg_file(f"configs/{name}")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "S2ANet" and model.neck.out_channels == 256
    if "ridet" in name:
        assert model.backbone.depth == 50 and head.num_classes == 16
        assert head.loss_cfgs["odm_bbox"]["type"] == "ridet"
        assert head.train_cfg["odm_cfg"]["reg_decoded_bbox"] is True
        assert "reg_decoded_bbox" not in head.train_cfg["fam_cfg"]
        assert cfg["optimizer"]["lr"] == 0.0025
    else:
        assert model.backbone.depth == 101 and len(model.backbone.layer3) == 23
        assert head.loss_cfgs["odm_bbox"].get("type", "smooth_l1") == "smooth_l1"
        assert cfg["model"]["backbone"]["pretrained"] == "data/pretrained/resnet101.ckpt"
