"""R3Det (the FRM, the refine stage, the detector) in jdet_torch against
jdet_tpu, on the CPU.

- `bilinear_sample` against `bilinear_sample_nhwc` on samples inside the
  image, on its border and outside it (corners in and out of range), and
  `FeatureRefineModule` with points=1 and points=5: atol 1e-5;
- the model (ResNet-18, FPN 32, one RetinaNet tower conv, the refine
  towers, 128², B=2; tests/torch_single_stage_parity.py) on a batch
  without near ties in the stage-1 assignment (shared anchors) or the
  refine stage's (each image's refined boxes): the refine stage's targets
  exactly (labels and weights) and atol 1e-5 (box targets), the head's
  loss forward on the reference's own head outputs rtol 1e-5 (the losses
  of the reference's first step, compiled with XLA's fusion off),
  `predict` on them, 2 train steps and the bf16 model (the helper
  module's tolerances);
- `params_from_jax` strict on the model, the FRM and the refine towers
  among its leaves, and `configs/r3det_r50_fpn_1x_dota.py` at full width.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.boxes.anchor_target import anchor_target_batch as j_anchor_target_batch
from jdet_tpu.ops.deform_conv import bilinear_sample_nhwc as j_bilinear_sample_nhwc
from jdet_tpu.ops.roi_ops_extra import FeatureRefineModule as JFeatureRefineModule
from jdet_torch.config import load_cfg_file
from jdet_torch.models.boxes.anchor_target import anchor_target_batch
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.ops.box_iou_rotated import box_iou_rotated
from jdet_torch.ops.deform_conv import bilinear_sample
from jdet_torch.ops.roi_ops_extra import FeatureRefineModule
from jdet_torch.parallel import make_device_normalizer
from torch_single_stage_parity import (BF16, MEAN, SGD_KW, STD, assert_predict_matches,
                                       assert_steps_match, assert_within_gap, jax_model,
                                       make_batch, numpy_params, port, port_steps,
                                       reference_bf16, reference_f32, t)

CFG = dict(
    type="R3Det",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=32, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(type="R3DetHead", num_classes=6, in_channels=32, feat_channels=32,
                   stacked_convs=1, test_cfg=dict(nms_pre=256, max_per_img=32)),
)
CLS = ("bbox_head.retina_cls", "bbox_head.refine_cls")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the ops ---------------------------------------------------------------------------

def _sample_points(rng, B, H, W, n):
    """Sample positions: random inside, on the border, and just outside
    (within a pixel, where one corner still lands in the image) and far
    outside."""
    sy = rng.uniform(-0.5, H - 0.5, (B, n))
    sx = rng.uniform(-0.5, W - 0.5, (B, n))
    edge = np.array([-1.0, -0.999, -0.5, 0.0, H - 1.0, H - 0.5, H - 0.001, H, H + 0.5, -3.0])
    sy[:, :len(edge)] = edge
    sx[:, len(edge):2 * len(edge)] = edge * W / H
    return sy.astype(np.float32), sx.astype(np.float32)


def test_bilinear_sample_matches_inside_and_outside_the_image():
    rng = np.random.RandomState(0)
    B, H, W, C = 2, 7, 9, 5
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    sy, sx = _sample_points(rng, B, H, W, 60)
    want = np.asarray(j_bilinear_sample_nhwc(jnp.asarray(x), jnp.asarray(sy), jnp.asarray(sx)))
    got = bilinear_sample(t(x).permute(0, 3, 1, 2), t(sy), t(sx))
    assert got.shape == (B, C, 60)
    np.testing.assert_allclose(got.permute(0, 2, 1).numpy(), want, rtol=0, atol=1e-5)
    outside = (sy <= -1) | (sy >= H) | (sx <= -1) | (sx >= W)
    assert outside.any() and (want[outside] == 0).all()


@pytest.mark.parametrize("points", [1, 5])
def test_feature_refine_module_matches(points):
    rng = np.random.RandomState(points)
    C, strides, B = 8, (8, 16), 2
    jfrm = JFeatureRefineModule(C, strides, points=points, rngs=nnx.Rngs(3))
    frm = FeatureRefineModule(C, strides, points=points)
    load_from_jax(frm, numpy_params(jfrm))
    feats, boxes = [], []
    for s in strides:
        h = 64 // s
        feats.append(rng.normal(0, 1, (B, h, h, C)).astype(np.float32))
        boxes.append(np.concatenate([
            rng.uniform(-8, 72, (B, h, h, 2)), rng.uniform(4, 40, (B, h, h, 2)),
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, h, h, 1))], -1).astype(np.float32))
    want = nnx.jit(lambda m, f, b: m(f, b))(jfrm, [jnp.asarray(f) for f in feats],
                                            [jnp.asarray(b) for b in boxes])
    got = frm([t(f).permute(0, 3, 1, 2) for f in feats], [t(b) for b in boxes])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)


# the model -------------------------------------------------------------------------

def _margin(gts, mask, anchors, pos_thr, neg_thr):
    """The smallest gap between a gt's best IoU and its second best, and
    between an anchor's best IoU and either threshold, over (B, N, 5)
    anchors: the low-quality match compares IoUs for exact equality."""
    margin = np.inf
    for b in range(len(gts)):
        iou = box_iou_rotated(t(gts[b][mask[b]]), anchors[b]).double()
        top2 = iou.topk(2, dim=1).values
        best = iou.max(0).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item(),
                     (best - pos_thr).abs().min().item(), (best - neg_thr).abs().min().item())
    return margin


def _tie_free_batch(tmodel):
    head = tmodel.bbox_head
    sizes = [(128 // s, 128 // s) for s in head.anchor_strides]
    anchors = head._flat_anchors(sizes, "cpu")
    for seed in range(1, 40):
        u8, targets = make_batch(seed, num_classes=5)
        with torch.no_grad():
            tmodel.train()
            outs = head(tmodel.extract_feat(make_device_normalizer(MEAN, STD)(t(u8))))
            tmodel.eval()
        refined = torch.cat([o[2].reshape(2, -1, 5) for o in outs], 1)
        gts, mask = targets["gt_bboxes"], targets["gt_mask"]
        if min(_margin(gts, mask, anchors.expand(2, -1, -1), 0.5, 0.4),
               _margin(gts, mask, refined, 0.6, 0.5)) > 1e-5:
            return u8, targets
    raise AssertionError("no tie-free batch")


def _refine_targets(m, outs, jt):
    """The reference's refine-stage targets on its own refined boxes."""
    refined = jnp.concatenate([o[2].reshape(o[2].shape[0], -1, 5) for o in outs], 1)
    tg, _, _ = j_anchor_target_batch(
        refined, jnp.ones(refined.shape[1], bool), jt["gt_bboxes"], jt["gt_mask"],
        jt["gt_labels"], assigner_cfg=m.bbox_head.refine_train_cfg["assigner"], rotated=True)
    return tg


@functools.cache
def _ref():
    jmodel, weights = jax_model(CFG, CLS)
    tmodel = port(CFG, weights)
    u8, targets = _tie_free_batch(tmodel)
    f32 = reference_f32(jmodel, tmodel, u8, targets, SGD_KW, extra=_refine_targets)
    bf16 = reference_bf16(jax_model(CFG, CLS, weights, jnp.bfloat16)[0], u8, targets)
    return weights, tmodel, u8, targets, f32, bf16


def _to_port(outs, requires_grad=False):
    """The reference's NHWC outputs [((cls, reg), (cls, reg), refined)]
    as the port's head takes them: the outputs NCHW, the refined boxes
    (B, H, W, 5) in both."""
    def nchw(a):
        return t(a).permute(0, 3, 1, 2).contiguous().requires_grad_(requires_grad)
    return [(tuple(nchw(a) for a in s1), tuple(nchw(a) for a in s2), t(rb))
            for s1, s2, rb in outs]


def _to_ref(outs):
    return [[(o.permute(0, 2, 3, 1) if o.dim() == 4 and i < 4 else o).detach().float().numpy()
             for i, o in enumerate((s1[0], s1[1], s2[0], s2[1], rb))] for s1, s2, rb in outs]


def test_refine_targets_and_head_loss_match_on_the_reference_outputs():
    _, tmodel, _, targets, f32, _ = _ref()
    outs = f32["outs_train"]
    refined = np.concatenate([o[2].reshape(2, -1, 5) for o in outs], 1)
    got, _, _ = anchor_target_batch(
        t(refined), torch.ones(refined.shape[1], dtype=torch.bool), t(targets["gt_bboxes"]),
        t(targets["gt_mask"]), t(targets["gt_labels"]),
        assigner_cfg=dict(tmodel.bbox_head.refine_train_cfg["assigner"]))
    want = f32["extra"]
    assert int((want["labels"] > 0).sum()) > 0
    for k in ("labels", "label_weights", "bbox_weights"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["bbox_targets"].numpy(), want["bbox_targets"], rtol=0,
                               atol=1e-5)
    # the reference's first step took these losses of these outputs
    got = tmodel.bbox_head.loss(_to_port(outs), {k: t(v) for k, v in targets.items()})
    assert set(got) == {"loss_init_cls", "loss_init_bbox", "loss_refine_cls",
                        "loss_refine_bbox"}
    for k, v in got.items():
        want = f32["losses"][0][k]
        assert want > 0, k
        np.testing.assert_allclose(v.item(), want, rtol=1e-5, err_msg=k)


def test_head_outputs_and_predict_match():
    _, tmodel, u8, _, f32, _ = _ref()
    with torch.no_grad():
        got = tmodel.bbox_head(tmodel.extract_feat(make_device_normalizer(MEAN, STD)(t(u8))))
    for g, w in zip(_to_ref(got), f32["outs"]):
        for i, (gi, wi) in enumerate(zip(g, jax.tree.leaves(w))):
            atol = 1e-4 * (max(1.0, np.abs(wi).max()) if i == 4 else 1.0)
            np.testing.assert_allclose(gi, wi, rtol=0, atol=atol, err_msg=f"output {i}")
    head = tmodel.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    got = {k: v.numpy() for k, v in head.predict(_to_port(f32["outs"])).items()}
    head.test_cfg = dict(head.test_cfg, score_thr=0.05)
    assert got["boxes"].shape == (2, 32, 5)
    assert_predict_matches(got, f32["predict"])


def test_two_train_steps_match():
    weights, _, u8, targets, f32, _ = _ref()
    model, start, log_vars = port_steps(lambda: port(CFG, weights), u8, targets, SGD_KW)
    assert_steps_match(model, start, log_vars, f32, moved_names=(
        "bbox_head.frm.conv_5_1.weight", "bbox_head.refine_reg_convs.1.conv.weight",
        "bbox_head.refine_cls.bias", "bbox_head.retina_cls.weight"))


def test_bf16_model_within_the_reference_gap():
    weights, _, u8, targets, f32, bf16 = _ref()
    model = port(CFG, weights, BF16)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(t(u8))
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    assert outs[0][1][0].dtype == BF16 and outs[0][2].dtype == torch.float32
    model.train()
    losses = model.loss(images, {k: t(v) for k, v in targets.items()})
    assert all(v.dtype == torch.float32 for v in losses.values())
    losses = {k: v.item() for k, v in losses.items()}
    losses["total_loss"] = sum(losses.values())
    assert_within_gap(_to_ref(outs), bf16, f32, losses)


def test_params_from_jax_is_strict_on_the_model():
    weights, tmodel, _, _, _, _ = _ref()
    sd = params_from_jax(weights, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    for k in ("bbox_head.frm.conv_1_5.weight", "bbox_head.frm.conv_1_1.bias",
              "bbox_head.refine_cls_convs.1.conv.weight", "bbox_head.refine_reg.bias"):
        assert k in sd, k


def test_config_builds_at_full_width():
    cfg = load_cfg_file("configs/r3det_r50_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "R3Det" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(head.cls_convs) == 4
    assert head.num_classes == 16 and head.num_anchors == 9
    assert len(head.refine_cls_convs) == len(head.refine_reg_convs) == 2
    assert head.refine_train_cfg["assigner"]["pos_iou_thr"] == 0.6
    assert head.refine_cls.weight.shape == (15, 256, 1, 1) and head.frm.points == 1
    assert cfg["optimizer"]["lr"] == 0.0025
