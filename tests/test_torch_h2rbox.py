"""H2RBox (its ops, the head, the detector and the weakly supervised DOTA
dataset) in jdet_torch against jdet_tpu, on the CPU.

- `obb2xyxy` (atol 1e-5 and one float32 ulp) and `hbb_iou_loss` (rtol
  1e-6), `rotate_image`
  (atol 1e-4 on normalized images: the sample positions round alike,
  `grid_sample`'s mapping to [-1, 1] and back moves them by ~1e-5 px),
  `rotate_rboxes`, and `_aug_index_map` exactly at four angles;
- the model (ResNet-18, FPN 64, two GroupNorm tower convs, 128², B=2,
  tests/torch_single_stage_parity.py) on a batch
  whose points lie clear of the weak (circumscribed) gts' sides and the
  regress ranges' bounds. Both packages get the same rotation: the
  reference draws theta from its key, and the port is handed that value
  (the two generators' streams differ). The head's `loss_with_aug` on
  the reference's own head outputs rtol 1e-5 (compiled with XLA's fusion
  off, with its first step); `predict` with `rect_classes`; the
  gradients of the loss from one state, which the config's AdamW
  consumes (the helper module's `GRAD_LIMITS`; an AdamW step itself
  divides each gradient by its own size, so a gradient near 0 takes a
  full step of either sign and no per-element tolerance holds on it:
  tests/test_torch_pretrained.py holds `OptaxAdam` against optax, and
  `chip_smoke.py` the card's gradients against the CPU's); 2 train steps
  with SGD; the bf16 model (the helper module's tolerances); the
  detector's branch for
  a head without `loss_with_aug` (FCOS's, the dense angle consistency)
  rtol 1e-4 (convolutions sum in another order);
- `DOTAWSOODDataset` against the reference's on a synthetic tree;
- `params_from_jax` strict on the model, and
  `configs/h2rbox_r50_fpn_1x_dota.py` at full width with AdamW.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

import jdet_tpu.data.dota as jdota
import jdet_tpu.models.detectors.h2rbox as jh2
from jdet_tpu.models.heads import h2rbox_head as jhh
from jdet_torch.config import load_cfg_file
from jdet_torch.data.dota import DOTAWSOODDataset
from jdet_torch.data.synthetic import make_synthetic_dota
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import params_from_jax
from jdet_torch.models.detectors import h2rbox as th2
from jdet_torch.models.heads import h2rbox_head as thh
from jdet_torch.parallel import make_device_normalizer
from jdet_torch.utils.general import parse_losses
from test_torch_fcos import STRIDES, tie_free_batch, to_port, to_ref
from test_torch_pretrained import _abstract
from torch_single_stage_parity import (BF16, MEAN, SGD_KW, STD, assert_grads_match,
                                       assert_predict_matches, assert_steps_match,
                                       assert_within_gap, fast_jit, jax_model, port,
                                       port_steps, reference_bf16, reference_f32, t)

CFG = dict(
    type="H2RBox",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=64, num_outs=5, start_level=1,
              add_extra_convs="on_output", relu_before_extra_convs=True),
    bbox_head=dict(type="H2RBoxHead", num_classes=5, in_channels=64, feat_channels=64,
                   stacked_convs=2, rotation_agnostic_classes=[1, 3], rect_classes=[0, 1, 2],
                   test_cfg=dict(max_per_img=32)),
)
CLS = ("bbox_head.conv_cls",)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def _theta():
    """The reference's rotation for `loss(key=None)`: its first split of
    PRNGKey(0), uniform in [0.25 pi, 0.75 pi) (a Python float, drawn once
    outside any trace)."""
    k1, _ = jax.random.split(jax.random.PRNGKey(0))
    return float(jax.random.uniform(k1, (), minval=0.25 * jnp.pi, maxval=0.75 * jnp.pi))


# the ops ---------------------------------------------------------------------------

def test_obb2xyxy_and_hbb_iou_loss_match():
    rng = np.random.RandomState(0)
    boxes = np.stack([rng.uniform(0, 256, 40), rng.uniform(0, 256, 40), rng.uniform(4, 80, 40),
                      rng.uniform(4, 80, 40), rng.uniform(-np.pi, np.pi, 40)], 1)
    boxes = boxes.astype(np.float32)
    want = np.asarray(jhh.obb2xyxy(jnp.asarray(boxes)))
    np.testing.assert_allclose(thh.obb2xyxy(t(boxes)).numpy(), want, rtol=1.2e-7, atol=1e-5)
    pred = want + rng.normal(0, 5, want.shape).astype(np.float32)
    pred[:5] = pred[:5, [2, 3, 0, 1]]  # inverted: zero area, no overlap
    w = rng.uniform(0, 1, 40).astype(np.float32)
    for kw in (dict(), dict(weight=w, avg_factor=np.float32(3.5)),
               dict(weight=w, avg_factor=np.float32(1e-8))):
        ref = float(jhh.hbb_iou_loss(jnp.asarray(pred), jnp.asarray(want),
                                     **{k: jnp.asarray(v) for k, v in kw.items()}))
        got = thh.hbb_iou_loss(t(pred), t(want), **{k: t(v) for k, v in kw.items()}).item()
        np.testing.assert_allclose(got, ref, rtol=1e-6)


def test_rotate_image_and_rboxes_match():
    rng = np.random.RandomState(1)
    images = rng.normal(0, 1, (2, 40, 56, 3)).astype(np.float32)
    theta = np.float32(_theta())
    want = np.asarray(jh2.rotate_image(jnp.asarray(images), jnp.float32(theta)))
    got = th2.rotate_image(t(images), torch.tensor(theta)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (want == 0).any()  # corners rotated in from outside
    boxes = np.stack([rng.uniform(0, 56, 20), rng.uniform(0, 40, 20), rng.uniform(4, 30, 20),
                      rng.uniform(4, 30, 20), rng.uniform(-np.pi, np.pi, 20)], 1)
    boxes = boxes.astype(np.float32)
    want = np.asarray(jh2.rotate_rboxes(jnp.asarray(boxes), jnp.float32(theta), 56, 40))
    got = th2.rotate_rboxes(t(boxes), torch.tensor(theta), 56, 40).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("rot", [0.25 * math.pi, 0.5 * math.pi, 1.1, 2.3])
def test_aug_index_map_matches(rot):
    # abstract: the index map reads no parameter
    jhead = _abstract(lambda rngs: jhh.H2RBoxHead(num_classes=5, in_channels=32,
                                                  feat_channels=32, stacked_convs=1, rngs=rngs))
    head = thh.H2RBoxHead(num_classes=5, in_channels=32, feat_channels=32, stacked_convs=1)
    sizes = [(256 // s, 256 // s) for s in STRIDES]
    want = jhead._aug_index_map(sizes, jnp.float32(rot), (127.5, 127.5))
    got = head._aug_index_map(sizes, torch.tensor(rot, dtype=torch.float32), (127.5, 127.5),
                              "cpu")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].sum() > 0 and (got[1].all() or rot != 0.5 * math.pi)


# the model -------------------------------------------------------------------------

def _loss_with_aug(m, outs, jt):
    """The reference head's `loss_with_aug` on its own outputs, the
    rotated view's taken as the same outputs' distances and angles, on
    the weak targets at the reference's rotation."""
    weak = dict(jt, gt_bboxes=jh2.hbox_to_rbox(jh2.rbox_to_hbox(jt["gt_bboxes"])))
    return m.bbox_head.loss_with_aug(outs, [(o[1], o[2]) for o in outs],
                                     jnp.float32(_theta()), weak)


@functools.cache
def _ref():
    jmodel, weights = jax_model(CFG, CLS)
    tmodel = port(CFG, weights)
    u8, targets = tie_free_batch(tmodel.bbox_head, 5, weak=True)
    _theta()
    f32 = reference_f32(jmodel, tmodel, u8, targets, SGD_KW, extra=_loss_with_aug)
    bf16 = reference_bf16(jax_model(CFG, CLS, weights, jnp.bfloat16)[0], u8, targets,
                          loss_fn=lambda m, images, jt: m.loss(images, jt))
    return weights, tmodel, u8, targets, f32, bf16


def _port_loss(model):
    """The port's `loss` with the reference's rotation."""
    theta = _theta()
    return lambda images, targets, generator=None: type(model).loss(
        model, images, targets, theta=theta)


def test_loss_with_aug_matches_on_the_reference_outputs():
    _, tmodel, _, targets, f32, _ = _ref()
    tt = {k: t(v) for k, v in targets.items()}
    tt["gt_bboxes"] = th2.hbox_to_rbox(th2.rbox_to_hbox(tt["gt_bboxes"]))
    touts = to_port(f32["outs_train"])
    got = tmodel.bbox_head.loss_with_aug(touts, [(o[1], o[2]) for o in touts],
                                         torch.tensor(np.float32(_theta())), tt)
    assert set(got) == set(f32["extra"]) == {"loss_cls", "loss_bbox", "loss_centerness",
                                             "loss_bbox_aug"}
    for k, w in f32["extra"].items():
        assert float(w) > 0, k
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-5, err_msg=k)


def test_predict_with_rect_classes_matches():
    _, tmodel, _, _, f32, _ = _ref()
    head = tmodel.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    got = {k: v.numpy() for k, v in head.predict(to_port(f32["outs"], eval_mode=True)).items()}
    head.test_cfg = dict(head.test_cfg, score_thr=0.05)
    want = f32["predict"]
    rect = want["valid"] & (want["labels"] <= 2)
    assert rect.sum() > 0 and (want["boxes"][rect][:, 4] == 0).all()
    assert_predict_matches(got, want)


def test_two_train_steps_match():
    weights, _, u8, targets, f32, _ = _ref()

    def factory():
        model = port(CFG, weights)
        model.loss = _port_loss(model)
        return model

    model, start, log_vars = port_steps(factory, u8, targets, SGD_KW)
    assert "loss_bbox_aug" in log_vars[0]
    assert_steps_match(model, start, log_vars, f32, moved_names=(
        "bbox_head.reg_convs.1.norm.weight", "bbox_head.scales.0.scale",
        "bbox_head.conv_theta.weight", "backbone.layer2.0.conv1.weight"))


def test_gradients_from_one_state_match():
    weights, _, u8, targets, f32, _ = _ref()
    model = port(CFG, weights)
    model.train()
    images = make_device_normalizer(MEAN, STD)(t(u8))
    losses = _port_loss(model)(images, {k: t(v) for k, v in targets.items()})
    parse_losses(losses)[0].backward()
    assert_grads_match(model, f32["grads"])


def test_bf16_model_within_the_reference_gap():
    weights, _, u8, targets, f32, bf16 = _ref()
    model = port(CFG, weights, BF16)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(t(u8))
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    model.train()
    losses = _port_loss(model)(images, {k: t(v) for k, v in targets.items()})
    losses = {k: v.item() for k, v in losses.items()}
    losses["total_loss"] = sum(losses.values())
    assert_within_gap(to_ref(outs), bf16, f32, losses)


def test_fallback_branch_without_loss_with_aug_matches():
    """H2RBox with FCOS's head (the same parameters): the head's losses on
    the weak targets and the dense angle consistency `loss_ss`."""
    weights, _, u8, targets, _, _ = _ref()
    cfg = dict(CFG, bbox_head={k: v for k, v in CFG["bbox_head"].items()
                               if k not in ("rotation_agnostic_classes", "rect_classes")})
    cfg["bbox_head"]["type"] = "FCOSHead"
    jmodel, _ = jax_model(cfg, CLS, weights)
    images = make_device_normalizer(MEAN, STD)(t(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    graphdef, state = nnx.split(jmodel)
    want = fast_jit(lambda s, x: nnx.merge(graphdef, s).loss(x, jt), state,
                    jnp.asarray(images.numpy()))
    model = port(cfg, weights)
    assert not hasattr(model.bbox_head, "loss_with_aug")
    got = _port_loss(model)(images, {k: t(v) for k, v in targets.items()})
    assert set(got) == set(want) and "loss_ss" in got
    for k, w in want.items():
        assert float(w) > 0, k
        np.testing.assert_allclose(got[k].item(), float(w), rtol=1e-4, err_msg=k)


def test_dota_wsood_dataset_matches(tmp_path):
    img_dir, ann = make_synthetic_dota(str(tmp_path), n_images=3, size=128, n_obj=(2, 5),
                                       seed=4)
    kw = dict(annotations_file=ann, images_dir=img_dir, image_size=(128, 128), max_gt=8,
              transforms=[dict(type="RotatedResize", min_size=128, max_size=128)],
              batch_size=1, shuffle=False, image_dtype="uint8", num_workers=0)
    mine, ref = DOTAWSOODDataset(**kw), jdota.DOTAWSOODDataset(**kw)
    for i in range(3):
        (_, got), (_, want) = mine.load_sample(i), ref.load_sample(i)
        assert len(got["rboxes"]) >= 2 and (got["rboxes"][:, 4] == 0).all()
        np.testing.assert_allclose(got["rboxes"], want["rboxes"], rtol=0, atol=1e-4)
        np.testing.assert_array_equal(got["labels"], want["labels"])


def test_params_from_jax_is_strict_on_the_model():
    weights, tmodel, _, _, _, _ = _ref()
    assert set(params_from_jax(weights, tmodel)) == set(tmodel.state_dict())


def test_config_builds_at_full_width_with_adamw():
    cfg = load_cfg_file("configs/h2rbox_r50_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "H2RBox" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(head.reg_convs) == 4
    assert head.num_classes == 15 and head.cls_convs[0].norm.num_groups == 32
    assert head.rotation_agnostic_classes == (1, 9, 11) and head.rect_classes == (9, 11)
    assert model.rot_range == (0.25, 0.75) and model.ss_loss_weight == 0.4
    assert cfg["optimizer"]["type"] == "AdamW" and cfg["optimizer"]["weight_decay"] == 0.05
