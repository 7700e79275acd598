"""jdet_torch anchors, anchor targets and losses against jdet_tpu.

Anchors must be equal. Assignments (labels, gt_inds) must be equal except
on anchors whose IoU lies within 1e-5 of a threshold (0.4 / 0.5) or of
its gt's maximum without being that maximum: there the two frameworks'
last-ulp differences may decide differently. bbox_targets match to atol
1e-5, the losses to rtol 1e-5."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jdet_tpu.models.boxes.anchor_generator import AnchorGeneratorRotated as JGen
from jdet_tpu.models.boxes.anchor_generator import AnchorGeneratorRotatedS2ANet as JS2AGen
from jdet_tpu.models.boxes.anchor_target import anchor_target_batch as j_targets
from jdet_tpu.models.losses import sigmoid_focal_loss as j_focal
from jdet_tpu.models.losses import smooth_l1_loss as j_smooth_l1
from jdet_tpu.ops.box_iou_rotated import box_iou_rotated as j_iou
from jdet_tpu.ops.pallas_iou import park_masked_boxes as j_park
from jdet_torch.models.boxes import (AnchorGeneratorRotated, AnchorGeneratorRotatedS2ANet,
                                     anchor_target_batch)
from jdet_torch.utils.edge_cases import refined_anchors
from jdet_torch.models.losses import sigmoid_focal_loss, smooth_l1_loss
from test_retinanet_e2e import synthetic_batch
from test_torch_retina_variants import unfused_jit

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's thread pool made the plain versions'
    many small ops tens of times slower here than one thread (77 s against
    0.34 s for four of the early-out cases of test_torch_iou_kernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


STRIDES = (8, 16, 32, 64, 128)
GEN_KW = dict(octave_base_scale=4, scales_per_octave=3, ratios=(1.0, 0.5, 2.0))
TARGET_KW = dict(
    target_means=(0.0,) * 5,
    target_stds=(1.0,) * 5,
    assigner_cfg=dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0),
    pos_weight=-1,
)


@pytest.mark.parametrize("sizes", [((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)),
                                   ((5, 7), (3, 4), (2, 2), (1, 1), (1, 1))])
def test_anchors_equal_reference(sizes):
    for s, fs in zip(STRIDES, sizes):
        got = AnchorGeneratorRotated(s, **GEN_KW).grid_anchors(fs, s, device="cpu")
        want = np.asarray(JGen(s, **GEN_KW).grid_anchors(fs, s))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("sizes", [((16, 16), (8, 8), (4, 4), (2, 2), (1, 1)),
                                   ((5, 7), (3, 4), (2, 2), (1, 1), (1, 1))])
def test_s2anet_anchors_equal_reference(sizes):
    for s, fs in zip(STRIDES, sizes):
        got = AnchorGeneratorRotatedS2ANet(s, scales=(4,)).grid_anchors(fs, s, device="cpu")
        want = np.asarray(JS2AGen(s, (4,), (1.0,)).grid_anchors(fs, s))
        np.testing.assert_array_equal(got.numpy(), want)
    assert got.shape == (fs[0] * fs[1], 5) and (got[:, 2] == 4 * s).all()


def _anchors_128():
    sizes = [(128 // s, 128 // s) for s in STRIDES]
    return np.concatenate([
        np.asarray(JGen(s, **GEN_KW).grid_anchors(fs, s))
        for s, fs in zip(STRIDES, sizes)
    ])


@pytest.fixture(scope="module")
def targets():
    _, t = synthetic_batch()
    t = {k: np.array(v) for k, v in t.items()}
    anchors = _anchors_128()
    valid = np.ones(len(anchors), bool)
    want, want_pos, want_neg = _j_targets(anchors, valid, t)
    got, got_pos, got_neg = anchor_target_batch(
        torch.from_numpy(anchors), torch.from_numpy(valid),
        torch.from_numpy(t["gt_bboxes"]), torch.from_numpy(t["gt_mask"]),
        torch.from_numpy(t["gt_labels"]), **TARGET_KW,
    )
    want = {k: np.array(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    return t, anchors, want, (int(want_pos), int(want_neg)), got, (int(got_pos), int(got_neg))


def _j_targets(anchors, valid, t):
    """The reference's targets, compiled once with XLA's fusion off (each
    primitive as eager JAX computes it; eagerly, JAX compiles each of the
    assigner's primitives apart)."""
    return unfused_jit(lambda *a: j_targets(*a, rotated=True, **TARGET_KW),
                       *(jnp.asarray(x) for x in (anchors, valid, t["gt_bboxes"],
                                                  t["gt_mask"], t["gt_labels"])))


def _j_overlaps(gts, mask, anchors):
    """The reference's IoU of the parked gts against the anchors, compiled
    as `_j_targets` is."""
    return np.asarray(unfused_jit(lambda g, m, a: j_iou(j_park(g, m), a, impl="xla"),
                                  jnp.asarray(gts), jnp.asarray(mask), jnp.asarray(anchors)))


def _decisive(t, anchors):
    """(B, N) mask of anchors whose assignment no last-ulp IoU difference
    can change."""
    out = []
    for b in range(len(t["gt_bboxes"])):
        ov = _j_overlaps(t["gt_bboxes"][b], t["gt_mask"][b], anchors)
        ov = ov[t["gt_mask"][b]]  # real gts only
        near_thr = np.zeros(ov.shape[1], bool)
        for thr in (0.4, 0.5):
            near_thr |= (np.abs(ov - thr) < 1e-5).any(0)
        gt_max = ov.max(1, keepdims=True)
        near_max = ((np.abs(ov - gt_max) < 1e-5) & (ov != gt_max)).any(0)
        out.append(~near_thr & ~near_max)
    return np.stack(out)


def test_anchor_target_assignment_matches(targets):
    t, anchors, want, want_n, got, got_n = targets
    ok = _decisive(t, anchors)
    assert ok.mean() > 0.99
    for k in ("labels", "gt_inds", "pos_mask", "neg_mask"):
        np.testing.assert_array_equal(got[k][ok], want[k][ok], err_msg=k)
    np.testing.assert_array_equal(got["label_weights"][ok], want["label_weights"][ok])
    assert want["pos_mask"].sum() > 0
    if ok.all():
        assert got_n == want_n


def test_anchor_target_bbox_targets_match(targets):
    t, anchors, want, _, got, _ = targets
    ok = _decisive(t, anchors)
    np.testing.assert_allclose(got["bbox_targets"][ok], want["bbox_targets"][ok], atol=1e-5)
    np.testing.assert_array_equal(got["bbox_weights"][ok], want["bbox_weights"][ok])


def test_losses_match(targets):
    _, _, want, (num_pos, _), _, _ = targets
    rng = np.random.RandomState(0)
    B, N = want["labels"].shape
    logits = rng.normal(-3.0, 2.0, (B, N, 15)).astype(np.float32)
    preds = rng.normal(0.0, 0.5, (B, N, 5)).astype(np.float32)
    avg = float(max(num_pos, 1))
    got_cls = sigmoid_focal_loss(
        torch.from_numpy(logits), torch.from_numpy(want["labels"]).long(),
        weight=torch.from_numpy(want["label_weights"]), avg_factor=avg)
    want_cls = j_focal(jnp.asarray(logits), jnp.asarray(want["labels"]),
                       weight=jnp.asarray(want["label_weights"]), avg_factor=avg)
    np.testing.assert_allclose(float(got_cls), float(want_cls), rtol=1e-5)
    got_reg = smooth_l1_loss(
        torch.from_numpy(preds), torch.from_numpy(want["bbox_targets"]),
        weight=torch.from_numpy(want["bbox_weights"]), beta=1.0 / 9.0, avg_factor=avg)
    want_reg = j_smooth_l1(jnp.asarray(preds), jnp.asarray(want["bbox_targets"]),
                           weight=jnp.asarray(want["bbox_weights"]), beta=1.0 / 9.0,
                           avg_factor=avg)
    np.testing.assert_allclose(float(got_reg), float(want_reg), rtol=1e-5)
    assert float(got_cls) > 0 and float(got_reg) > 0


def test_anchor_target_per_image_anchors_matches():
    """The per-image branch (S2ANet's ODM on its refined anchors,
    `anchor_target.py:163-176`): one set of refined anchors per image over
    the 128² S2ANet init anchors, against the reference's vmap over images
    and anchors, at the tolerances above."""
    _, t = synthetic_batch()
    t = {k: np.array(v) for k, v in t.items()}
    init = np.concatenate([
        np.asarray(JS2AGen(s, (4,), (1.0,)).grid_anchors((128 // s, 128 // s), s))
        for s in STRIDES])
    anchors = np.stack([refined_anchors(init, seed=b, extreme=2) for b in range(2)])
    valid = np.ones(anchors.shape[1], bool)
    want, want_pos, want_neg = _j_targets(anchors, valid, t)
    got, got_pos, got_neg = anchor_target_batch(
        torch.from_numpy(anchors), torch.from_numpy(valid),
        torch.from_numpy(t["gt_bboxes"]), torch.from_numpy(t["gt_mask"]),
        torch.from_numpy(t["gt_labels"]), **TARGET_KW)
    got = {k: v.numpy() for k, v in got.items()}
    ok = np.concatenate([_decisive({k: v[b:b + 1] for k, v in t.items()}, anchors[b])
                         for b in range(2)])
    assert ok.mean() > 0.99
    for k in ("labels", "gt_inds", "pos_mask", "neg_mask", "label_weights",
              "bbox_weights"):
        np.testing.assert_array_equal(got[k][ok], np.asarray(want[k])[ok], err_msg=k)
    np.testing.assert_allclose(got["bbox_targets"][ok], np.asarray(want["bbox_targets"])[ok],
                               atol=1e-5)
    assert got["pos_mask"].sum() > 0
    if ok.all():
        assert (int(got_pos), int(got_neg)) == (int(want_pos), int(want_neg))
