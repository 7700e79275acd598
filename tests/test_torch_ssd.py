"""SSD300-VGG16 (`configs/ssd300_coco.py`) and COCO against jdet_tpu, on
the CPU.

- `L2Norm`, `SSDVGG` at a small input (odd sizes, so that flax's 'SAME'
  pools pad (0, 1)), `SSDNeck` and `SSDHead` at narrow widths on the
  feature sizes of a 300² input: outputs within 1e-5 of the largest value
  (relative), the head's loss within 1e-5 relative and its `predict`
  equal (valid slots, labels, scores atol 1e-6, boxes within 1e-5 of the
  largest coordinate);
- `ssd_anchors` equal (8,732 at 300²);
- the horizontal `anchor_target_batch` (`rotated=False`, `hbox2delta`)
  equal in labels, weights and targets;
- the whole SSD at 300², B=1, float32, with the reference's weights: the
  losses within 1e-5 relative, the gradients within 1e-4 of each tensor's
  largest (those of conv1_1 to conv5_3 in float64, see `POOLED_BLOCKS`),
  `predict` equal as above. Its class convs are drawn at 1.5 / sqrt(fan_in)
  so that hundreds of candidates per image pass the config's `score_thr`
  of 0.02; the convs that a ReLU follows are rescaled so that no
  pre-activation lies near the kink (`calibrate_relu_convs`), and the
  batch is checked to have a margin at the hard-negative cut (the
  reference and the port sum the convolutions in another order, ~1e-6
  apart, so two negatives' losses within that margin could swap ranks);
- `COCODataset` and its `evaluate` equal on a COCO-style JSON;
- the committed config's `anno_file` refused by both packages.

The reference compiles once per function with XLA's fusion off
(`torch_single_stage_parity.fast_jit`; the whole detector's with LLVM's
optimizer on, which runs it ~8 s faster).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.config import load_cfg_file as j_load_cfg_file
from jdet_tpu.data.coco import COCODataset as JCOCODataset
from jdet_tpu.models.backbones.ssd_vgg import L2Norm as JL2Norm
from jdet_tpu.models.backbones.ssd_vgg import SSDNeck as JSSDNeck
from jdet_tpu.models.backbones.ssd_vgg import SSDVGG as JSSDVGG
from jdet_tpu.models.boxes.anchor_target import anchor_target_batch as j_anchor_target_batch
from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.heads.ssd_head import SSDHead as JSSDHead
from jdet_tpu.models.pretrained import assign_flat, flat_paths
from jdet_torch.config import load_cfg_file
from jdet_torch.data.coco import COCODataset
from jdet_torch.models.backbones.ssd_vgg import L2Norm, SSDNeck, SSDVGG
from jdet_torch.models.boxes.anchor_target import anchor_target_batch
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models import nn as tnn
from jdet_torch.models.heads.ssd_head import SSDHead, ssd_anchors
from jdet_torch.models.layers import Conv2d
from jdet_torch.ops.box_convert import rbox_to_hbox
from make_codec_fixtures import OUT as FIXTURES
from test_torch_pretrained import _abstract
from torch_single_stage_parity import fast_jit

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "ssd300_coco.py")
FEATS_300 = (38, 19, 10, 5, 3, 1)
BATCH_SEED = 0  # a batch with a margin at the hard-negative cut (see `_neg_margin`)
# The convs before VGG's five max pools (conv1_1 to conv5_3), whose
# float32 gradients at 300² are held in float64 instead
# (test_ssdvgg_matches_the_reference): of the ~1.5 million pooling windows
# with a positive maximum, a few hold two values within 1e-6 of each
# other, the two packages' float32 sums disagree on which is larger, and
# the pool sends the gradient to different elements (conv1_1's gradient
# read 3.7e-3 and conv5_3's 1.0e-3 of their largest value off the
# reference's; fc6 and every tensor after it agreed within 1e-6)
POOLED_BLOCKS = tuple(f"backbone.blocks.{i}." for i in range(5))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def nchw(a):
    return t(np.asarray(a).transpose(0, 3, 1, 2))


def nhwc(x):
    return x.detach().permute(0, 2, 3, 1).numpy()


def close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(np.abs(want).max(), 1e-30))


def assert_predict_matches(got, want):
    """The same valid slots and labels, scores within 1e-6, boxes and
    polygons within 1e-5 of the largest coordinate (SSD's boxes come from
    the deltas of twenty float32 convolutions, exp-scaled up to 300 px)."""
    v = np.asarray(want["valid"])
    assert v.sum() > 0
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], np.asarray(want["labels"])[v])
    np.testing.assert_allclose(got["scores"][v], np.asarray(want["scores"])[v], rtol=0, atol=1e-6)
    for k in ("boxes", "polys"):
        close(got[k][v], np.asarray(want[k])[v])


def ssd_weights(module, seed=1):
    """Every leaf of the reference `module` from a seed: convs He-scaled
    (std sqrt(2 / fan_in)), the head's class convs at 1.5 / sqrt(fan_in)
    and its box convs at 0.2 / sqrt(fan_in), biases N(0, 0.05) (the head's
    0), L2Norm's scale in [10, 30)."""
    rng = np.random.RandomState(seed)
    _, flat = flat_paths(module)
    out = {}
    for path, var in flat.items():
        shape = tuple(var.get_value().shape)
        name = path.split("bbox_head.")[-1]
        if path.endswith("kernel"):
            fan_in = np.prod(shape[:-1])
            gain = 1.5 if name.startswith("cls_convs") else 0.2 if name.startswith(
                "reg_convs") else np.sqrt(2.0)
            v = rng.normal(0.0, gain / np.sqrt(fan_in), shape)
        elif path.endswith("l2norm.weight") or path == "weight":
            v = rng.uniform(10, 30, shape)
        elif name.startswith(("cls_convs", "reg_convs")):
            v = np.zeros(shape)
        else:
            v = rng.normal(0.0, 0.05, shape)
        out[path] = np.asarray(v, np.float32)
    return out


def ssd_batch(seed, B=1, size=300, K=8, real=5, num_classes=80):
    """Normalized float images (as the config's Normalize leaves them) and
    zero-angle gts (gt_bboxes (B, K, 5), 1-based labels, mask)."""
    rng = np.random.RandomState(seed)
    images = rng.normal(0, 50, (B, size, size, 3)).astype(np.float32)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real, 0] = rng.uniform(60, 240, real)
        gt[b, :real, 1] = rng.uniform(60, 240, real)
        gt[b, :real, 2] = rng.uniform(20, 180, real)
        gt[b, :real, 3] = rng.uniform(20, 180, real)
        labels[b, :real] = rng.randint(1, num_classes + 1, real)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def _jax(module_fn, seed=1):
    """An abstract reference module filled with `ssd_weights`."""
    jm = _abstract(module_fn)
    weights = ssd_weights(jm, seed)
    assign_flat(jm, weights, strict=True)
    return jm, weights


# the parts -------------------------------------------------------------------------------

def test_l2norm_matches_the_reference():
    rng = np.random.RandomState(0)
    x = (rng.randn(2, 5, 7, 16) * rng.uniform(0, 3, (1, 5, 7, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0  # the eps inside the root keeps a zero vector at 0
    jm = JL2Norm(16)
    w = rng.uniform(10, 30, 16).astype(np.float32)
    jm.weight.set_value(jnp.asarray(w))
    tm = L2Norm(16)
    load_from_jax(tm, {"weight": w})
    got = nhwc(tm(nchw(x)))
    close(got, np.asarray(jm(jnp.asarray(x))))
    assert (got[0, 0, 0] == 0).all()


def test_ssdvgg_matches_the_reference():
    """The outputs in float32, and every gradient of a fixed linear
    function of them under both packages' float64 policy (see
    `POOLED_BLOCKS`), at 45x37: the 'SAME' pools pad (0, 1) on each odd
    size (45 -> 23 -> 12, 37 -> 19 -> 10)."""
    jm, weights = _jax(lambda rngs: JSSDVGG(rngs=rngs))
    tm = SSDVGG()
    load_from_jax(tm, weights)
    rng = np.random.RandomState(1)
    x = rng.normal(0, 50, (1, 45, 37, 3)).astype(np.float32)
    want = fast_jit(lambda a: jm(a), jnp.asarray(x))
    got = tm(nchw(x))
    assert [tuple(g.shape[-2:]) for g in got] == [(6, 5), (3, 3)]
    for g, w in zip(got, want):
        close(nhwc(g), w)

    x = rng.normal(0, 50, (1, 45, 37, 3))
    probes = [rng.normal(0, 1, (1, 6, 5, 512)), rng.normal(0, 1, (1, 3, 3, 1024))]
    with jax.enable_x64(True):
        with j_compute_dtype_scope(jnp.float64):
            jm64 = _abstract(lambda rngs: JSSDVGG(rngs=rngs))
        assign_flat(jm64, weights, strict=True)
        graphdef, state = nnx.split(jm64)

        def probe(state, x):
            return nnx.grad(lambda m: sum((o * p).sum() for o, p in zip(m(x), probes)))(
                nnx.merge(graphdef, state))

        grads = jax.jit(probe)(state, jnp.asarray(x))
        flat = {".".join(str(p) for p in path): np.asarray(v.get_value()) for path, v in
                grads.flat_state()}
    with tnn.compute_dtype_scope(torch.float64):
        tm64 = SSDVGG()
    load_from_jax(tm64, weights)
    outs = tm64(nchw(x).double())
    sum((o * nchw(p)).sum() for o, p in zip(outs, probes)).backward()
    params = dict(tm64.named_parameters())
    for name, g in params_from_jax(flat, tm64).items():
        close(params[name].grad.numpy(), g.numpy(), rel=1e-4)


def test_ssd_neck_and_head_match_the_reference():
    neck_kw = dict(in_channels=(16, 32), extra_channels=(16, 8, 8, 8))
    jneck, wneck = _jax(lambda rngs: JSSDNeck(**neck_kw, rngs=rngs))
    tneck = SSDNeck(**neck_kw)
    load_from_jax(tneck, wneck)
    rng = np.random.RandomState(2)
    inputs = [rng.normal(0, 1, (2, s, s, c)).astype(np.float32)
              for s, c in zip(FEATS_300[:2], neck_kw["in_channels"])]
    head_kw = dict(num_classes=5, in_channels=(16, 32, 16, 8, 8, 8),
                   test_cfg=dict(score_thr=0.02, nms_pre=1000, max_per_img=200))
    jhead, whead = _jax(lambda rngs: JSSDHead(**head_kw, rngs=rngs))
    thead = SSDHead(**head_kw)
    load_from_jax(thead, whead)
    _, targets = ssd_batch(3, B=2, num_classes=5)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def ref(inputs):  # one compile: the neck, then the head on its outputs
        feats = jneck(inputs)
        outs = jhead(feats)
        return feats, outs, jhead.loss(outs, jt), jhead.predict(outs)

    want_feats, want_outs, want_loss, want_det = fast_jit(
        ref, tuple(jnp.asarray(i) for i in inputs))
    got_feats = tneck(tuple(nchw(i) for i in inputs))
    assert [g.shape[-1] for g in got_feats] == list(FEATS_300)
    for g, w in zip(got_feats, want_feats):
        close(nhwc(g), w)
    got_outs = thead(tuple(torch.from_numpy(np.asarray(w).transpose(0, 3, 1, 2).copy())
                           for w in want_feats))
    for (gc, gr), (wc, wr) in zip(got_outs, want_outs):
        close(nhwc(gc), wc)
        close(nhwc(gr), wr)
    # the loss and predict on the reference's outputs
    outs = [(nchw(wc), nchw(wr)) for wc, wr in want_outs]
    got_loss = thead.loss(outs, {k: t(v) for k, v in targets.items()})
    for k, v in want_loss.items():
        np.testing.assert_allclose(float(got_loss[k]), float(v), rtol=1e-5, err_msg=k)
    det = {k: v.numpy() for k, v in thead.predict(outs).items()}
    assert det["valid"].sum() >= 100
    assert_predict_matches(det, jax.tree.map(np.asarray, want_det))


def test_ssd_anchors_match_the_reference():
    cfg = {k: v for k, v in load_cfg_file(CONFIG)["model"]["bbox_head"].items() if k != "type"}
    jhead = _abstract(lambda rngs: JSSDHead(**cfg, rngs=rngs))
    thead = SSDHead(**cfg)
    want = jhead._anchors([(s, s) for s in FEATS_300])
    got = thead.anchors([(s, s) for s in FEATS_300], "cpu").numpy()
    assert got.shape == (8732, 4)
    np.testing.assert_array_equal(got, want)
    from jdet_tpu.models.heads.ssd_head import ssd_anchors as j_ssd_anchors

    np.testing.assert_array_equal(ssd_anchors((5, 7), 64, 162, 213, (2, 3)),
                                  j_ssd_anchors((5, 7), 64, 162, 213, (2, 3)))


def test_horizontal_anchor_targets_match_the_reference():
    anchors = SSDHead().anchors([(s, s) for s in FEATS_300], "cpu")
    _, targets = ssd_batch(4, B=3, K=10, real=7)
    gt_h = np.concatenate([targets["gt_bboxes"][..., :2] - targets["gt_bboxes"][..., 2:4] / 2,
                           targets["gt_bboxes"][..., :2] + targets["gt_bboxes"][..., 2:4] / 2], -1)
    kw = dict(target_means=(0.0,) * 4, target_stds=(0.1, 0.1, 0.2, 0.2),
              assigner_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0),
              rotated=False)
    valid = np.ones(len(anchors), bool)
    want, want_pos, want_neg = fast_jit(
        lambda a, g, m, lab: j_anchor_target_batch(a, jnp.asarray(valid), g, m, lab, **kw),
        jnp.asarray(anchors.numpy()), jnp.asarray(gt_h), jnp.asarray(targets["gt_mask"]),
        jnp.asarray(targets["gt_labels"]))
    got, got_pos, got_neg = anchor_target_batch(
        anchors, t(valid), t(gt_h), t(targets["gt_mask"]), t(targets["gt_labels"]), **kw)
    assert int(got_pos) == int(want_pos) and int(got_neg) == int(want_neg)
    assert int(want_pos) > 3 * 7
    for k in ("labels", "label_weights", "pos_mask", "neg_mask", "gt_inds", "bbox_weights"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_allclose(got["bbox_targets"].numpy(), np.asarray(want["bbox_targets"]),
                               rtol=0, atol=1e-6)


# the whole detector ----------------------------------------------------------------------

def calibrate_relu_convs(model, images, seed=2, shift=4.0):
    """Rescale every conv that a ReLU follows (the backbone's and the
    neck's), in one forward pass on `images`, so that each of its output
    channels has unit standard deviation and a mean of +-`shift` (the sign
    drawn from a seed): the weight divided per channel by the channel's
    standard deviation, the bias set to the mean's target. No
    pre-activation then lies near the ReLU's kink. In float32 the
    reference and the port sum the convolutions in another order, ~1e-6
    of the sum apart; with plain random weights a few of the ~5 million
    pre-activations of a 300² forward lie that near zero, where the ReLU
    passes a gradient in one package and not in the other (one such
    element moved fc6's weight gradient by 1.1e-2 of its largest value,
    against a float64 run). Returns the number of convs rescaled."""
    rng = np.random.RandomState(seed)
    convs = [m for name, m in model.named_modules()
             if name.startswith(("backbone.blocks", "backbone.fc", "neck.extra"))
             and isinstance(m, Conv2d)]

    def hook(module, inputs, out):
        pre = out - module.bias[:, None, None]
        flat = pre.transpose(0, 1).reshape(out.shape[1], -1)
        mean, std = flat.mean(1), flat.std(1, unbiased=False)
        scale = 1.0 / torch.where(std > 0, std, mean.abs() + 1.0)
        sign = torch.from_numpy(rng.choice([-1.0, 1.0], len(std)).astype(np.float32))
        module.weight.mul_(scale[:, None, None, None])
        module.bias.copy_(sign * shift - mean * scale)
        return pre * scale[:, None, None] + module.bias[:, None, None]

    handles = [c.register_forward_hook(hook) for c in convs]
    with torch.no_grad():
        model.extract_feat(images)
    for h in handles:
        h.remove()
    return len(convs)


def _ssd_models(images):
    """The reference SSD (abstract) and the port's with the same weights:
    `ssd_weights`, then the ReLU-followed convs rescaled on `images`
    (`calibrate_relu_convs`)."""
    cfg = load_cfg_file(CONFIG)["model"]
    jm = _abstract(lambda rngs: j_build_detector(
        j_load_cfg_file(CONFIG)["model"], rngs=rngs, load_pretrained=False))
    weights = ssd_weights(jm)
    tm = build_detector(cfg, device="cpu", load_pretrained=False)
    load_from_jax(tm, weights)
    assert calibrate_relu_convs(tm, t(images)) == 13 + 2 + 8
    state = tm.state_dict()
    for path in weights:
        prefix, leaf = path.rsplit(".", 1)
        if prefix.startswith(("backbone.blocks", "backbone.fc", "neck.extra")):
            w = state[f"{prefix}.{'weight' if leaf == 'kernel' else leaf}"].numpy()
            weights[path] = np.ascontiguousarray(w.transpose(2, 3, 1, 0) if w.ndim == 4 else w)
    assign_flat(jm, weights, strict=True)
    return jm, tm


def _neg_margin(model, images, targets):
    """The relative gap between the last negative the hard-negative cut
    keeps and the first it drops, per image (the port's losses)."""
    head = model.bbox_head
    with torch.no_grad():
        cls, _, anchors = head._flatten(head(model.extract_feat(images)))
        tgt, _, _ = anchor_target_batch(
            anchors, torch.ones(len(anchors), dtype=torch.bool),
            rbox_to_hbox(targets["gt_bboxes"]), targets["gt_mask"], targets["gt_labels"],
            target_means=head.target_means, target_stds=head.target_stds,
            assigner_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.0),
            rotated=False)
        lbl = torch.where(tgt["labels"] > 0, tgt["labels"] - 1, head.num_classes).long()
        ce = -torch.gather(torch.log_softmax(cls, -1), -1, lbl[..., None])[..., 0]
    gaps = []
    for b in range(ce.shape[0]):
        neg = torch.sort(ce[b][tgt["neg_mask"][b]], descending=True).values
        k = head.neg_pos_ratio * max(int(tgt["pos_mask"][b].sum()), 1)
        gaps.append(float((neg[k - 1] - neg[k]) / neg[k - 1]))
    return min(gaps)


def test_ssd300_matches_the_reference():
    images, targets = ssd_batch(BATCH_SEED)
    tt = {k: t(v) for k, v in targets.items()}
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    jm, tm = _ssd_models(images)
    assert _neg_margin(tm, t(images), tt) > 1e-4
    graphdef, state = nnx.split(jm)

    def total(m, x):
        parts = m.loss(x, jt)
        return sum(parts.values()), parts

    def ref(state, x):
        m = nnx.merge(graphdef, state)
        (_, parts), grads = nnx.value_and_grad(total, has_aux=True)(m, x)
        return parts, grads, m.predict(x)

    # fusion off as `fast_jit`, but LLVM's optimizer on: VGG's float32
    # forward and backward at 300² run ~8 s faster than at -O0
    x = jnp.asarray(images)
    want_loss, want_grads, want_det = jax.jit(ref).lower(state, x).compile(
        compiler_options={"xla_disable_hlo_passes": "fusion"})(state, x)
    got_loss = tm.loss(t(images), tt)
    for k, v in want_loss.items():
        np.testing.assert_allclose(got_loss[k].item(), float(v), rtol=1e-5, err_msg=k)
    sum(got_loss.values()).backward()
    flat = {".".join(str(p) for p in path): np.asarray(
        v.get_value() if hasattr(v, "get_value") else v) for path, v in want_grads.flat_state()}
    want_g = params_from_jax(flat, tm)
    params = dict(tm.named_parameters())
    assert set(want_g) == set(params)
    for name, g in want_g.items():
        if name.startswith(POOLED_BLOCKS):
            continue  # held in float64 by test_ssdvgg_matches_the_reference
        if np.abs(g.numpy()).max() > 0:
            close(params[name].grad.numpy(), g.numpy(), rel=1e-4)
        else:  # the top levels' convs: no anchor of theirs was kept
            assert not params[name].grad.numpy().any(), name
    with torch.no_grad():
        det = {k: v.numpy() for k, v in tm.predict(t(images)).items()}
    assert det["valid"].sum() >= 100
    assert_predict_matches(det, jax.tree.map(np.asarray, want_det))


# COCO --------------------------------------------------------------------------------------

def test_coco_dataset_and_evaluate_match_the_reference(tmp_path):
    from jdet_torch.data.synthetic import make_coco_tree

    jpegs = [os.path.join(FIXTURES, n) for n in ("baseline_420_640x480.jpg",
                                                 "progressive_422_333x217.jpg",
                                                 "restart_440_301x203.jpg")]
    img_dir, ann = make_coco_tree(str(tmp_path / "coco"), jpegs, seed=3)
    kw = dict(annotations_file=ann, images_dir=img_dir, image_size=(300, 300))
    got, want = COCODataset(**kw), JCOCODataset(**kw)
    assert got.CLASSES == want.CLASSES and len(got.CLASSES) == 80
    assert got.cat2label == want.cat2label
    assert len(got) == len(want) == 3
    for a, b in zip(got.img_infos, want.img_infos):
        assert a.keys() == b.keys() and a["filename"] == b["filename"]
        for k, v in b["ann"].items():
            np.testing.assert_array_equal(a["ann"][k], v, err_msg=k)
    # detections near the gts, some off, from a seed
    rng = np.random.RandomState(5)
    results = []
    for i in range(len(got)):
        _, meta = got.load_sample(i, np.random.default_rng(0))
        polys = meta["polys"]
        n = len(polys)
        det_polys = np.concatenate([polys + rng.normal(0, 3, polys.shape),
                                    rng.uniform(0, 300, (4, 8))]).astype(np.float32)
        labels = np.concatenate([meta["labels"] - 1, rng.randint(0, 80, 4)])
        labels[rng.rand(len(labels)) < 0.2] = rng.randint(0, 80)
        results.append(({"polys": det_polys, "scores": rng.rand(n + 4).astype(np.float32),
                         "labels": labels, "valid": np.ones(n + 4, bool)},
                        {"img_id": i, "polys": polys, "labels": meta["labels"]}))
    a, b = got.evaluate(results), want.evaluate(results)
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-12, err_msg=k)
    assert b["eval/coco_mAP50"] > 0


def test_the_committed_anno_file_is_refused_by_both(tmp_path):
    ann = tmp_path / "instances.json"
    ann.write_text(json.dumps({"images": [], "annotations": [], "categories": []}))
    cfg = load_cfg_file(CONFIG)["dataset"]["train"]
    kw = {k: v for k, v in cfg.items() if k != "type"}
    kw["anno_file"] = str(ann)
    with pytest.raises(TypeError, match="anno_file"):
        JCOCODataset(**kw)
    with pytest.raises(TypeError, match="anno_file.*annotations_file"):
        COCODataset(**kw)
