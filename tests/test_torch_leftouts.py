"""The reference's last single-card modules in jdet_torch against jdet_tpu,
on the CPU, op by op (Res2Net and its RetinaNet: tests/test_torch_res2net.py):

- anchors: `AnchorGeneratorYangXue` and `multi_level_grid_anchors`
  exactly (rtol 1e-6 on the scaled widths), `anchor_inside_flags_rotated`
  exactly, the RetinaNet head's `anchor_generator_cfg`;
- the assigner: `gt_max_assign_all=False` (the first-claim rule) and
  `ignore_iof_thr` with ignore regions, on the edge cases and on random
  sets, rotated, horizontal and `fake_rbb`: gt_inds and labels exactly,
  max_overlaps atol 2e-4 (the IoU's tolerance) with -inf alike; the card's
  form of the ignore regions (`fold_ignore` into the anchor mask, then
  `unfold_ignore`) on the plain version, against the reference alike;
  R3Det's refine stage with `allowed_border` 0;
- `multiclass_nms_rotated` on (B, n, C * 5) class-specific boxes and
  `ml_nms_rotated`: keep and order exactly, boxes atol 1e-5;
- `OrientedHead(reg_class_agnostic=False)`: loss rtol 1e-5 on the same
  sampled RoIs, `predict` boxes and scores atol 1e-4 on the same slots;
- `deform_conv2d` with bias, stride, padding, dilation and mask,
  `DeformConv`, `DCNv2`: forward atol 1e-5, gradients atol 1e-4;
- `psroi_align`, `roi_pool`, `roi_align`, `dcn_v2_pooling` (also against
  the numpy CUDA oracle of tests/test_dcn_orn.py), `DCNPooling`: atol 1e-5;
- `build_group_lr_schedules` and `build_optimizer(group_schedules=...)`
  (rtol 1e-5 on the lrs, which the reference computes in float32; the
  parameters after 2 SGD steps within 1e-6 of their largest);
- YAML configs and `print_cfg`, `check_diff`, and the small helpers
  under the reference's names.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_torch.models.boxes.anchor_generator import (AnchorGeneratorRotated,
                                                      AnchorGeneratorYangXue,
                                                      multi_level_grid_anchors)
from jdet_torch.models.boxes.anchor_target import anchor_inside_flags_rotated, anchor_target_batch
from jdet_torch.models.boxes.assigner import (assign_wrt_overlaps, fold_ignore, hbb_iof,
                                              ignore_anchors, max_iou_assign_hbb,
                                              max_iou_assign_rotated, unfold_ignore)
from jdet_torch.ops import box_iou_rotated, park_masked_boxes
from jdet_torch.utils.edge_cases import (ASSIGN_CASES, assign_edge_case,
                                         per_image_assign_edge_case)

THR = dict(pos_iou_thr=0.5, neg_iou_thr=0.4, min_pos_iou=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def rboxes(rng, n, lo=20, hi=100, wh=(8, 60)):
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(*wh, n), rng.uniform(wh[0] / 2, wh[1] / 2, n),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)


def assert_assign_equal(got, want, atol=2e-4):
    for k in ("gt_inds", "labels"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    mo, wmo = np.asarray(got["max_overlaps"]), np.asarray(want["max_overlaps"])
    np.testing.assert_array_equal(np.isfinite(mo), np.isfinite(wmo))
    fin = np.isfinite(wmo)
    np.testing.assert_allclose(mo[fin], wmo[fin], rtol=0, atol=atol)


# anchors ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(base_size=8, octave_base_scale=4, scales_per_octave=3, ratios=(1.0, 0.5, 2.0)),
    dict(base_size=32, scales=(1.0, 2.0), ratios=(0.25, 1.0, 3.0), angles=(0.0, 0.5),
         yx_base_size=8.0, center_offset=0.0),
])
def test_yangxue_anchors_match(kw):
    from jdet_tpu.models.boxes.anchor_generator import (
        AnchorGeneratorYangXue as JYangXue, multi_level_grid_anchors as j_multi_level)

    got, want = AnchorGeneratorYangXue(**kw), JYangXue(**kw)
    np.testing.assert_allclose(got.base_anchors, want.base_anchors, rtol=1e-6, atol=0)
    sizes, strides = [(5, 7), (3, 4)], [8, 16]
    gens = [AnchorGeneratorYangXue(**kw), AnchorGeneratorRotated(8, scales=(2.0,))]
    from jdet_tpu.models.boxes.anchor_generator import AnchorGeneratorRotated as JRotated
    jgens = [JYangXue(**kw), JRotated(8, scales=(2.0,))]
    np.testing.assert_allclose(multi_level_grid_anchors(gens, sizes, strides, "cpu").numpy(),
                               np.asarray(j_multi_level(jgens, sizes, strides)),
                               rtol=1e-6, atol=1e-5)


def test_retina_head_takes_the_yangxue_anchors():
    from jdet_torch.models.heads.rotated_retina_head import RotatedRetinaHead

    head = RotatedRetinaHead(4, 8, feat_channels=8, stacked_convs=1,
                             anchor_generator_cfg=dict(type="AnchorGeneratorYangXue",
                                                       yx_base_size=4.0))
    plain = RotatedRetinaHead(4, 8, feat_channels=8, stacked_convs=1)
    assert isinstance(head.anchor_generators[0], AnchorGeneratorYangXue)
    assert type(plain.anchor_generators[0]) is AnchorGeneratorRotated
    from jdet_tpu.models.boxes.anchor_generator import AnchorGeneratorYangXue as JYangXue

    for g, s in zip(head.anchor_generators, head.anchor_strides):
        want = JYangXue(s, octave_base_scale=4, scales_per_octave=3, ratios=(1.0, 0.5, 2.0))
        np.testing.assert_allclose(g.base_anchors, want.base_anchors, rtol=1e-6)
    assert head.num_anchors == plain.num_anchors == 9
    assert not np.allclose(head.anchor_generators[0].base_anchors,
                           plain.anchor_generators[0].base_anchors)


@pytest.mark.parametrize("border", [-1, 0, 4])
def test_anchor_inside_flags_match(border):
    from jdet_tpu.models.boxes.anchor_target import anchor_inside_flags_rotated as j_inside

    rng = np.random.RandomState(border + 2)
    anchors = rboxes(rng, 300, lo=-10, hi=74)
    valid = rng.rand(300) < 0.9
    want = np.asarray(j_inside(jnp.asarray(anchors), jnp.asarray(valid), (64, 48), border))
    got = anchor_inside_flags_rotated(t(anchors), t(valid), (64, 48), border)
    np.testing.assert_array_equal(got.numpy(), want)
    # per-image anchors (B, n, 5) with shared flags, as R3Det's refine stage
    two = np.stack([anchors, anchors[::-1].copy()])
    got2 = anchor_inside_flags_rotated(t(two), t(valid), (64, 48), border)
    np.testing.assert_array_equal(torch.broadcast_to(got2, (2, 300))[0].numpy(), want)


def test_r3det_refine_stage_takes_allowed_border():
    """The reference passes no img_shape to the refine stage's targets
    (r3det_head.py:139-150), so allowed_border 0 keeps every refined box:
    the port builds the head (it raised before), and the targets on each
    image's refined boxes, every box inside, with the head's shared flags
    or with per-image ones, equal the reference's with allowed_border 0."""
    from jdet_tpu.models.boxes.anchor_target import anchor_target_batch as j_targets
    from jdet_torch.models.heads.r3det_head import R3DetHead

    head = R3DetHead(4, 8, feat_channels=8, stacked_convs=1,
                     refine_train_cfg=dict(allowed_border=0))
    assert head.refine_train_cfg["allowed_border"] == 0
    rng = np.random.RandomState(5)
    refined = np.stack([rboxes(rng, 200, lo=-20, hi=90) for _ in range(2)])
    gts = np.stack([rboxes(rng, 6) for _ in range(2)])
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 1, 0, 0, 0]], bool)
    labels = rng.randint(1, 4, (2, 6))
    assigner = dict(pos_iou_thr=0.6, neg_iou_thr=0.5, min_pos_iou=0.0)
    ones = np.ones(200, bool)
    want, _, _ = jax.jit(lambda *a: j_targets(*a, assigner_cfg=assigner, allowed_border=0,
                                              rotated=True))(
        *map(jnp.asarray, (refined, ones, gts, mask, labels)))
    for flags in (np.ones((2, 200), bool), ones):
        got, _, _ = anchor_target_batch(t(refined), t(flags), t(gts), t(mask), t(labels),
                                        assigner_cfg=dict(assigner))
        for k in ("labels", "label_weights", "gt_inds"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        np.testing.assert_allclose(got["bbox_targets"].numpy(), np.asarray(want["bbox_targets"]),
                                   rtol=0, atol=1e-5)


# the assigner ------------------------------------------------------------------------

def _ref_assign(anchors, gts, mask, labels, am=None, hbb=False, **kw):
    """jdet_tpu's assigner image by image, on shared or per-image anchors
    (and per-image anchor masks and ignore regions)."""
    from jdet_tpu.models.boxes import assigner as ja

    fn = ja.max_iou_assign_hbb if hbb else ja.max_iou_assign_rotated
    ign = {k: kw.pop(k) for k in ("gt_bboxes_ignore", "gt_ignore_mask") if k in kw}
    out = []
    for b in range(len(gts)):
        def per(x):
            return None if x is None else jnp.asarray(x if x.ndim == (2 if x.dtype != bool
                                                                      else 1) else x[b])
        extra = {k: jnp.asarray(v[b]) for k, v in ign.items()}
        out.append(fn(per(anchors), jnp.asarray(gts[b]), jnp.asarray(mask[b]),
                      gt_labels=jnp.asarray(labels[b]), anchor_mask=per(am), **extra, **kw))
    return {k: np.stack([np.asarray(o[k]) for o in out]) for k in out[0]}


@pytest.mark.parametrize("form", ["shared", "per_image"])
@pytest.mark.parametrize("case", ASSIGN_CASES)
def test_first_claim_matches_reference_on_edge_cases(case, form):
    make = assign_edge_case if form == "shared" else per_image_assign_edge_case
    gts, mask, labels, anchors, am, _ = make(case)
    kw = dict(THR, gt_max_assign_all=False)
    got = max_iou_assign_rotated(t(anchors), t(gts), t(mask), t(labels),
                                 anchor_mask=None if am is None else t(am), **kw)
    assert_assign_equal(got, _ref_assign(anchors, gts, mask, labels, am, **kw))
    # each eligible gt claims at most one anchor beyond the thresholds'
    full = max_iou_assign_rotated(t(anchors), t(gts), t(mask), t(labels),
                                  anchor_mask=None if am is None else t(am), **THR)
    assert ((got["gt_inds"] > 0).sum() <= (full["gt_inds"] > 0).sum())


def _ignore_case(name, seed=3, B=2, K=8, M=3, N=500):
    """Shared anchors on a grid, B images of K gt slots and M ignore-region
    slots: `name` shapes image 0 (image 1 random). N stays within the
    reference IoF's chunk (512 rows): above it eager JAX compiles the
    chunks' `lax.map` anew at every call."""
    rng = np.random.RandomState(seed)
    g = np.stack(np.meshgrid(np.arange(4, 128, 10), np.arange(4, 128, 10)), -1).reshape(-1, 2)
    anchors = np.concatenate([np.repeat(g, 4, 0)[:N], np.tile(
        [[16, 8, 0.0], [16, 16, 0.3], [24, 12, -0.5], [10, 20, 1.2]], (len(g), 1))[:N]], 1)
    anchors = anchors.astype(np.float32)
    gts = np.stack([rboxes(rng, K, 20, 110) for _ in range(B)])
    mask = np.zeros((B, K), bool)
    mask[:, :4] = True
    labels = rng.randint(1, 5, (B, K))
    ign = np.stack([rboxes(rng, M, 20, 110, wh=(20, 60)) for _ in range(B)])
    imask = np.zeros((B, M), bool)
    imask[:, :2] = True
    am = rng.rand(N) < 0.95
    if name == "every_anchor_ignored":
        ign[0, 0] = [64, 64, 400, 400, 0.0]
    elif name == "every_anchor_masked":
        am = np.zeros(N, bool)
    elif name == "no_real_gt":
        mask[0] = False
    elif name == "no_real_ignore_box":
        imask[0] = False
    return anchors, gts, mask, labels, am, ign, imask


IGNORE_CASES = ("random", "every_anchor_ignored", "every_anchor_masked", "no_real_gt",
                "no_real_ignore_box")


@pytest.mark.parametrize("all_claims", [True, False])
@pytest.mark.parametrize("case", IGNORE_CASES)
def test_ignore_regions_match_reference(case, all_claims):
    """Rotated, horizontal and fake_rbb, against the reference image by
    image; and the card's form (the ignored anchors folded into the anchor
    mask, max_overlaps set afterwards) on the plain version, alike."""
    anchors, gts, mask, labels, am, ign, imask = _ignore_case(case)
    kw = dict(THR, gt_max_assign_all=all_claims, ignore_iof_thr=0.5)
    ig = dict(gt_bboxes_ignore=ign, gt_ignore_mask=imask)
    tig = {k: t(v) for k, v in ig.items()}
    want = _ref_assign(anchors, gts, mask, labels, am, **ig, **kw)
    got = max_iou_assign_rotated(t(anchors), t(gts), t(mask), t(labels), anchor_mask=t(am),
                                 **tig, **kw)
    assert_assign_equal(got, want)
    ignored = ignore_anchors(box_iou_rotated(t(anchors), tig["gt_bboxes_ignore"], mode="iof"),
                             tig["gt_ignore_mask"], 0.5)
    assert (got["gt_inds"][ignored] == -1).all()
    if case == "every_anchor_ignored":
        assert ignored[0].all() and (got["gt_inds"][0] == -1).all()
    elif case in ("random", "no_real_gt"):
        assert ignored.any() and (~ignored).any()
    # the card's form, on the plain version
    ov = box_iou_rotated(park_masked_boxes(t(gts), t(mask)), t(anchors))
    folded = assign_wrt_overlaps(ov, t(mask), t(labels), anchor_mask=fold_ignore(t(am), ignored),
                                 gt_max_assign_all=all_claims, **THR)
    assert_assign_equal(unfold_ignore(folded, ignored, t(mask)), want)
    # fake_rbb: the hbb IoU, the rotated IoF
    want = _ref_assign(anchors, gts, mask, labels, am, iou_calculator="fake_rbb", **ig, **kw)
    got = max_iou_assign_rotated(t(anchors), t(gts), t(mask), t(labels), anchor_mask=t(am),
                                 iou_calculator="fake_rbb", **tig, **kw)
    assert_assign_equal(got, want, atol=1e-6)
    # horizontal boxes
    from jdet_tpu.ops.box_convert import rbox_to_hbox as j_rbox_to_hbox

    def hbb(x):
        return np.asarray(j_rbox_to_hbox(jnp.asarray(x)))

    hig = dict(gt_bboxes_ignore=hbb(ign), gt_ignore_mask=imask)
    want = _ref_assign(hbb(anchors), hbb(gts), mask, labels, am, hbb=True, **hig, **kw)
    got = max_iou_assign_hbb(t(hbb(anchors)), t(hbb(gts)), t(mask), t(labels),
                             anchor_mask=t(am), **{k: t(v) for k, v in hig.items()}, **kw)
    assert_assign_equal(got, want, atol=1e-6)


def test_hbb_iof_matches_reference():
    from jdet_tpu.models.boxes.assigner import hbb_overlaps as j_hbb_overlaps

    rng = np.random.RandomState(0)
    a = rng.uniform(0, 50, (40, 2))
    a = np.concatenate([a, a + rng.uniform(0, 30, (40, 2))], 1).astype(np.float32)
    b = a[::3] + 3
    np.testing.assert_allclose(hbb_iof(t(a), t(b)).numpy(),
                               np.asarray(j_hbb_overlaps(jnp.asarray(a), jnp.asarray(b), "iof")),
                               rtol=1e-6, atol=1e-7)


# NMS -------------------------------------------------------------------------------

def _clustered(rng, n, C=None):
    """Boxes in a few clusters (so the NMS suppresses), (n, 5) or, with
    C, (n, C * 5): each class's box jittered from the candidate's."""
    centres = rng.uniform(20, 100, (6, 2))
    b = rboxes(rng, n, wh=(20, 40))
    b[:, :2] = centres[rng.randint(0, 6, n)] + rng.normal(0, 4, (n, 2))
    if C is None:
        return b
    per = np.repeat(b[:, None], C, 1) + rng.normal(0, [2, 2, 1, 1, 0.05], (n, C, 5))
    return per.reshape(n, C * 5).astype(np.float32)


def test_multiclass_nms_takes_class_specific_boxes():
    from jdet_tpu.ops.nms_rotated import multiclass_nms_rotated as j_nms
    from jdet_torch.ops import multiclass_nms_rotated

    rng = np.random.RandomState(4)
    B, n, C = 2, 60, 3
    boxes = np.stack([_clustered(rng, n, C) for _ in range(B)])
    scores = rng.uniform(0, 1, (B, n, C)).astype(np.float32)
    got = multiclass_nms_rotated(t(boxes), t(scores), 0.2, 0.3, 150)
    ref = jax.jit(lambda b, s: j_nms(b, s, 0.2, 0.3, 150))
    for b in range(B):
        want = ref(jnp.asarray(boxes[b]), jnp.asarray(scores[b]))
        v = np.asarray(want["valid"])
        assert 5 < v.sum() < 0.8 * n * C
        np.testing.assert_array_equal(got["valid"][b].numpy(), v)
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(want["labels"]))
        np.testing.assert_allclose(got["scores"][b].numpy(), np.asarray(want["scores"]), atol=0)
        np.testing.assert_allclose(got["boxes"][b].numpy(), np.asarray(want["boxes"]), atol=1e-5)


def test_ml_nms_rotated_matches():
    from jdet_tpu.ops.nms_rotated import ml_nms_rotated as j_ml_nms
    from jdet_torch.ops.nms_rotated import ml_nms_rotated

    rng = np.random.RandomState(6)
    boxes = _clustered(rng, 120)
    scores = rng.uniform(0, 1, 120).astype(np.float32)
    labels = rng.randint(0, 4, 120)
    valid = rng.rand(120) < 0.9
    order, keep = ml_nms_rotated(t(boxes), t(scores), t(labels), 0.3, t(valid))
    w_order, w_keep = jax.jit(lambda b, s, lab, v: j_ml_nms(b, s, lab, 0.3, v))(
        *map(jnp.asarray, (boxes, scores, labels, valid)))
    np.testing.assert_array_equal(order.numpy(), np.asarray(w_order))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(w_keep))
    # boxes of different labels never suppress each other
    from jdet_torch.ops.nms_rotated import nms_rotated
    one = nms_rotated(t(boxes), t(scores), 0.3, t(valid))[1]
    assert keep.sum() > one.sum()


# the class-specific R-CNN head -------------------------------------------------------

def _oriented_heads(seed=0):
    from jdet_tpu.models.heads.oriented_head import OrientedHead as JOrientedHead
    from jdet_torch.models.convert import load_from_jax
    from jdet_torch.models.heads.oriented_head import OrientedHead
    from torch_single_stage_parity import numpy_params

    kw = dict(num_classes=4, in_channels=8, fc_out_channels=16, reg_class_agnostic=False,
              train_cfg=dict(sampler=dict(num=16, pos_fraction=0.25)),
              test_cfg=dict(score_thr=0.0, nms_iou_thr=0.3, max_per_img=12))
    jhead = JOrientedHead(**kw, rngs=nnx.Rngs(seed))
    rng = np.random.RandomState(seed)
    for lin, std in ((jhead.fc_cls, 0.3), (jhead.fc_reg, 0.1)):
        lin.kernel.set_value(jnp.asarray(rng.normal(0, std, lin.kernel.get_value().shape),
                                         jnp.float32))
    head = OrientedHead(**kw)
    load_from_jax(head, numpy_params(jhead))
    assert head.fc_reg.weight.shape == (4 * 5, 16)
    return jhead, head


def test_class_specific_oriented_head_matches():
    """The head's loss on the same proposals and sampler draws (the deltas
    of each RoI's label, clipped to C - 1 for background) and `predict`
    (per-class decode, the class-specific NMS)."""
    from test_torch_oriented_rcnn import Replay, sampler_draws

    jhead, head = _oriented_heads()
    rng = np.random.RandomState(1)
    B, K, n = 2, 6, 40
    feats = [rng.normal(0, 1, (B, 64 // s, 64 // s, 8)).astype(np.float32)
             for s in (4, 8, 16, 32)]
    gts = np.stack([rboxes(rng, K, 10, 54, wh=(10, 30)) for _ in range(B)])
    mask = np.zeros((B, K), bool)
    mask[:, :4] = True
    labels = rng.randint(1, 5, (B, K))
    props = np.concatenate([gts + rng.normal(0, [3, 3, 2, 2, 0.1], (B, K, 5)),
                            np.stack([rboxes(rng, n - K, 10, 54, wh=(10, 30))
                                      for _ in range(B)])], 1).astype(np.float32)
    valid = rng.rand(B, n) < 0.9
    key = jax.random.PRNGKey(2)
    jt = {"gt_bboxes": jnp.asarray(gts), "gt_mask": jnp.asarray(mask),
          "gt_labels": jnp.asarray(labels)}
    jprops = {"boxes": jnp.asarray(props), "valid": jnp.asarray(valid)}
    jfeats = [jnp.asarray(f) for f in feats]
    from torch_single_stage_parity import fast_jit

    graphdef, state = nnx.split(jhead)

    def run(state):
        h = nnx.merge(graphdef, state)
        return h.loss(jfeats, jprops, jt, key=key), h.predict(jfeats, jprops)

    want_loss, want_det = fast_jit(run, state)
    tfeats = [t(f).permute(0, 3, 1, 2) for f in feats]
    tprops = {"boxes": t(props), "valid": t(valid)}
    got = head.loss(tfeats, tprops, {k: t(np.asarray(v)) for k, v in jt.items()},
                    rand=Replay(sampler_draws(key, B, K + n)))
    for k, v in want_loss.items():
        assert float(v) > 0, k
        np.testing.assert_allclose(got[k].item(), float(v), rtol=1e-5, err_msg=k)
    det = head.predict(tfeats, tprops)
    v = np.asarray(want_det["valid"])
    assert v.sum() > 4
    np.testing.assert_array_equal(det["valid"].numpy(), v)
    np.testing.assert_array_equal(det["labels"].numpy()[v], np.asarray(want_det["labels"])[v])
    for k in ("scores", "boxes", "polys"):
        np.testing.assert_allclose(det[k].numpy()[v], np.asarray(want_det[k])[v], rtol=0,
                                   atol=1e-4, err_msg=k)


# the deformable convs ----------------------------------------------------------------

@pytest.mark.parametrize("stride,padding,dilation,bias,mask", [
    (1, 1, 1, False, False),  # AlignConv's call
    (2, 2, 2, True, True),
    (2, 0, 1, True, False),
])
def test_deform_conv2d_matches_with_its_arguments(stride, padding, dilation, bias, mask):
    from jdet_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
    from jdet_torch.ops.deform_conv import deform_conv2d

    rng = np.random.RandomState(stride * 10 + padding)
    B, H, W, C, O, k = 2, 11, 9, 3, 4, 3
    Ho = (H + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    Wo = (W + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    x = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    off = rng.normal(0, 2, (B, Ho, Wo, k * k, 2)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, C, O)).astype(np.float32)
    bb = rng.normal(0, 1, O).astype(np.float32) if bias else None
    m = rng.uniform(0, 1, (B, Ho, Wo, k * k)).astype(np.float32) if mask else None
    args = [a for a in (x, off, w, bb, m)]

    def ref(x, off, w, bb, m):
        return j_deform_conv2d(x, off, w, bb, stride, padding, dilation, mask=m)

    jargs = [None if a is None else jnp.asarray(a) for a in args]
    live = [i for i, a in enumerate(args) if a is not None]

    def ref_live(*xs):
        full = list(jargs)
        for i, a in zip(live, xs):
            full[i] = a
        return ref(*full)

    want, vjp = jax.vjp(jax.jit(ref_live), *[jargs[i] for i in live])
    cot = rng.normal(0, 1, want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    tx = [None if a is None else t(a).requires_grad_(True) for a in args]
    got = deform_conv2d(tx[0].permute(0, 3, 1, 2), tx[1], tx[2].permute(3, 2, 0, 1), tx[3],
                        stride, padding, dilation, tx[4])
    assert got.shape == (B, O, Ho, Wo)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    got.permute(0, 2, 3, 1).backward(t(cot))
    for i, g in zip(live, want_grads):
        np.testing.assert_allclose(tx[i].grad.numpy(), np.asarray(g), rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(np.asarray(g)).max()),
                                   err_msg=f"grad {i}")


def test_dcnv2_matches():
    from jdet_tpu.ops.deform_conv import DCNv2 as JDCNv2
    from jdet_torch.models.convert import load_from_jax
    from jdet_torch.ops.deform_conv import DCNv2
    from torch_single_stage_parity import numpy_params

    jm = JDCNv2(3, 5, 3, stride=2, padding=1, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(0)
    # the offset conv starts at zero: draw it so that offsets and mask move
    jm.conv_offset.kernel.set_value(jnp.asarray(
        rng.normal(0, 0.3, jm.conv_offset.kernel.get_value().shape), jnp.float32))
    jm.conv_offset.bias.set_value(jnp.asarray(rng.normal(0, 0.5, 27), jnp.float32))
    jm.deform.bias.set_value(jnp.asarray(rng.normal(0, 1, 5), jnp.float32))
    m = DCNv2(3, 5, 3, stride=2, padding=1)
    assert not m.conv_offset.weight.any() and not m.conv_offset.bias.any()
    load_from_jax(m, numpy_params(jm))
    x = rng.normal(0, 1, (2, 10, 12, 3)).astype(np.float32)

    def loss(jm, x):
        return (jm(x) ** 2).sum(), jm(x)

    (_, want), grads = nnx.jit(nnx.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        jm, jnp.asarray(x))
    tx = t(x).permute(0, 3, 1, 2).requires_grad_(True)
    got = m(tx)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)
    (got ** 2).sum().backward()
    np.testing.assert_allclose(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(grads[1]),
                               rtol=0, atol=1e-4 * np.abs(np.asarray(grads[1])).max())
    gk = np.asarray(grads[0]["conv_offset"]["kernel"].get_value())
    np.testing.assert_allclose(m.conv_offset.weight.grad.permute(2, 3, 1, 0).numpy(), gk,
                               rtol=0, atol=1e-4 * np.abs(gk).max())


# the RoI ops -------------------------------------------------------------------------

def _hbb_rois(rng, B, R, lo=2, hi=60):
    xy = rng.uniform(lo, hi, (B, R, 2))
    wh = rng.uniform(4, 30, (B, R, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_psroi_align_roi_pool_and_roi_align_match():
    from jdet_tpu.ops.roi_align_rotated import roi_align as j_roi_align
    from jdet_tpu.ops.roi_ops_extra import psroi_align as j_psroi_align
    from jdet_tpu.ops.roi_ops_extra import roi_pool as j_roi_pool
    from jdet_torch.ops.roi_align_rotated import roi_align
    from jdet_torch.ops.roi_ops_extra import psroi_align, roi_pool

    rng = np.random.RandomState(0)
    B, H, W, P = 2, 12, 10, 3
    feat = rng.normal(0, 1, (B, H, W, 2 * P * P)).astype(np.float32)
    rois = _hbb_rois(rng, B, 7)
    valid = rng.rand(B, 7) < 0.8
    jf, jr, jv = jnp.asarray(feat), jnp.asarray(rois), jnp.asarray(valid)
    tf, tr, tv = t(feat).permute(0, 3, 1, 2), t(rois), t(valid)
    wants = jax.jit(lambda f, r, v: (j_psroi_align(f, r, P, 0.25, 2, v),
                                     j_roi_pool(f, r, P, 0.25, v),
                                     j_roi_align(f, r, 4, 0.25, 2, v)))(jf, jr, jv)
    for got, want in zip((psroi_align(tf, tr, P, 0.25, 2, tv), roi_pool(tf, tr, P, 0.25, tv),
                          roi_align(tf, tr, 4, 0.25, 2, tv)), wants):
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("group_size,no_trans", [(1, True), (1, False), (2, False)])
def test_dcn_v2_pooling_matches_reference_and_cuda_oracle(group_size, no_trans):
    from jdet_tpu.ops.roi_ops_extra import dcn_v2_pooling as j_pool
    from jdet_torch.ops.roi_ops_extra import dcn_v2_pooling
    from test_dcn_orn import _np_dcn_v2_pooling

    rng = np.random.RandomState(group_size)
    B, H, W, C, P, part = 2, 9, 11, 8, 3, 3
    feat = rng.normal(0, 1, (B, H, W, C)).astype(np.float32)
    R = 6
    xy = rng.uniform(-4, 36, (R, 2))
    rois = np.concatenate([rng.randint(0, B, (R, 1)), xy, xy + rng.uniform(2, 20, (R, 2))],
                          1).astype(np.float32)
    offset = rng.normal(0, 1, (R, 2, part, part)).astype(np.float32)
    kw = dict(spatial_scale=0.25, pooled_size=P, no_trans=no_trans, group_size=group_size,
              part_size=part, sample_per_part=3, trans_std=0.2)
    got = dcn_v2_pooling(t(feat).permute(0, 3, 1, 2), t(rois), t(offset), **kw)
    want = jax.jit(lambda f, r, o: j_pool(f, r, o, **kw))(*map(jnp.asarray, (feat, rois, offset)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    oracle = _np_dcn_v2_pooling(feat.astype(np.float64), rois, offset, 0.25, P, no_trans,
                                group_size, part, 3, 0.2)
    np.testing.assert_allclose(got.numpy(), oracle, rtol=0, atol=1e-5)


def test_dcn_pooling_module_matches():
    from jdet_tpu.ops.roi_ops_extra import DCNPooling as JDCNPooling
    from jdet_torch.models.convert import load_from_jax
    from jdet_torch.ops.roi_ops_extra import DCNPooling
    from torch_single_stage_parity import numpy_params

    kw = dict(spatial_scale=0.5, pooled_size=3, output_dim=4, no_trans=False,
              sample_per_part=2, trans_std=0.1, deform_fc_dim=16)
    jm = JDCNPooling(**kw, rngs=nnx.Rngs(0))
    rng = np.random.RandomState(3)
    # fc3 starts at zero: draw it, so that the offsets and the mask move
    jm.fc3.kernel.set_value(jnp.asarray(rng.normal(0, 0.3, (16, 27)), jnp.float32))
    m = DCNPooling(**kw)
    assert not m.fc3.weight.any()
    load_from_jax(m, numpy_params(jm))
    feat = rng.normal(0, 1, (2, 8, 8, 4)).astype(np.float32)
    rois = np.array([[0, 1, 2, 9, 12], [1, 3, 0, 14, 6], [0, -2, 4, 5, 15]], np.float32)
    want = nnx.jit(lambda m, f, r: m(f, r))(jm, jnp.asarray(feat), jnp.asarray(rois))
    got = m(t(feat).permute(0, 3, 1, 2), t(rois))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)


# per-group schedules -----------------------------------------------------------------

GROUPS = [dict(pattern="backbone.*", lr_mult=0.1, warmup=None),
          dict(pattern="head.*", warmup_init_lr=0.002, gamma=0.5)]
COMMON = dict(scheduler_type="StepLR", milestones=(2, 4), gamma=0.1, steps_per_epoch=3,
              max_steps=20, warmup="linear", warmup_iters=5, warmup_ratio=0.25)


def test_group_lr_schedules_match():
    from jdet_tpu.optim.lr_scheduler import build_group_lr_schedules as j_groups
    from jdet_torch.optim import build_group_lr_schedules

    for kw in (COMMON, dict(COMMON, scheduler_type="CosineAnnealingLRGroup", min_lr=1e-4)):
        got = build_group_lr_schedules(0.02, GROUPS, **kw)
        want = j_groups(0.02, GROUPS, **kw)
        assert [p for p, _ in got] == [p for p, _ in want] == ["backbone.*", "head.*"]
        for (_, g), (_, w) in zip(got, want):
            for step in range(20):
                np.testing.assert_allclose(g(step), float(w(step)), rtol=1e-5, atol=0)


def test_optimizer_applies_the_group_schedules():
    """2 SGD steps (momentum, decay) of a model whose `backbone`, `head`
    and `neck` follow the first group, the second and the base schedule,
    against the reference's optax chain on the same weights."""
    from jdet_tpu.optim.lr_scheduler import build_group_lr_schedules as j_groups
    from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_schedule
    from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
    from jdet_torch.optim import build_group_lr_schedules, build_lr_schedule, build_optimizer

    rng = np.random.RandomState(0)
    names = ("backbone", "head", "neck")
    ws = {n: rng.normal(0, 1, (3, 3)).astype(np.float32) for n in names}

    class J(nnx.Module):
        def __init__(self):
            for n in names:
                setattr(self, n, nnx.Linear(3, 3, use_bias=False, rngs=nnx.Rngs(0)))
                getattr(self, n).kernel.set_value(jnp.asarray(ws[n]))

        def __call__(self, x):
            return self.head(self.neck(self.backbone(x)))

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for n in names:
                lin = torch.nn.Linear(3, 3, bias=False)
                lin.weight.data = t(ws[n].T.copy())
                setattr(self, n, lin)

        def forward(self, x):
            return self.head(self.neck(self.backbone(x)))

    x = rng.normal(0, 1, (4, 3)).astype(np.float32)
    kw = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-3)
    jm = J()
    jopt = j_build_optimizer(jm, lr_schedule=j_schedule(0.05, **COMMON),
                             group_schedules=j_groups(0.05, GROUPS, **COMMON), **kw)
    for _ in range(2):
        grads = nnx.grad(lambda m: (m(jnp.asarray(x)) ** 2).sum())(jm)
        jopt.update(jm, grads)
    m = M()
    opt = build_optimizer(m, lr_schedule=build_lr_schedule(0.05, **COMMON),
                          group_schedules=build_group_lr_schedules(0.05, GROUPS, **COMMON), **kw)
    assert sorted(g["schedule"] for g in opt.inner.param_groups) == [0, 1, 2]
    for _ in range(2):
        opt.zero_grad()
        (m(t(x)) ** 2).sum().backward()
        opt.step()
    for n in names:
        want = np.asarray(getattr(jm, n).kernel.get_value())
        np.testing.assert_allclose(getattr(m, n).weight.detach().numpy().T, want, rtol=0,
                                   atol=1e-7 + 1e-6 * np.abs(want).max(), err_msg=n)
    lrs = opt.group_lrs(1)
    want_lrs = {0: 0.1 * 0.05, 1: float(j_groups(0.05, GROUPS, **COMMON)[1][1](1)),
                2: float(j_schedule(0.05, **COMMON)(1))}
    for g, lr in zip(opt.inner.param_groups, lrs):
        np.testing.assert_allclose(lr, want_lrs[g["schedule"]], rtol=1e-6)


# configs and debugging helpers ---------------------------------------------------------

def test_yaml_configs_and_print_cfg(tmp_path, capsys):
    import jdet_tpu.config.config as jc
    from jdet_torch.config import config as tc

    (tmp_path / "base.py").write_text("model = dict(type='A', depth=50, ratios=(1, 2))\n"
                                      "lr = 0.01\n")
    (tmp_path / "child.yaml").write_text("_base_: base.py\nmodel:\n  depth: 101\n"
                                         "name: yaml_child\nextra: [1, 2]\n")
    (tmp_path / "grand.py").write_text("_base_ = ['child.yaml']\nlr = 0.02\n")
    for f in ("child.yaml", "grand.py"):
        got = tc.load_cfg_file(str(tmp_path / f))
        want = jc.load_cfg_file(str(tmp_path / f))
        assert got == want
    assert got["model"]["depth"] == 101 and got["lr"] == 0.02
    jc.init_cfg(str(tmp_path / "grand.py"))
    tc.init_cfg(str(tmp_path / "grand.py"))
    jc.print_cfg()
    want = capsys.readouterr().out
    tc.print_cfg()
    assert capsys.readouterr().out == want
    jc.init_cfg()
    tc.init_cfg()


def test_yaml_without_pyyaml_names_the_file(tmp_path, monkeypatch):
    import sys

    from jdet_torch.config import load_cfg_file

    path = tmp_path / "c.yaml"
    path.write_text("a: 1\n")
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="c.yaml"):
        load_cfg_file(str(path))


def test_check_diff_and_compare_data(tmp_path, capsys):
    from jdet_tpu.utils.check_diff import compare_data as j_compare_data
    from jdet_torch.utils.check_diff import check_diff, compare_data, dump_state

    model = torch.nn.Sequential(torch.nn.Linear(3, 2), torch.nn.BatchNorm1d(2))
    path = dump_state(model, str(tmp_path / "state.pkl"))
    assert check_diff(model, path) == []
    with torch.no_grad():
        model[0].weight[0, 1] += 0.5
        model[1].bias += 1e-7
    bad = check_diff(model, path, atol=1e-5)
    assert [(k, round(d, 6)) for k, d, _ in bad] == [("0.weight", 0.5)]
    rng = np.random.RandomState(0)
    a = {"x": rng.rand(3), "y": [rng.rand(2), rng.rand(4)]}
    b = {"x": a["x"] + 1e-3, "y": [a["y"][0], a["y"][1] - 2e-6]}
    capsys.readouterr()
    want = j_compare_data(a, b)
    want_out = capsys.readouterr().out
    got = compare_data({"x": t(a["x"]), "y": [t(v) for v in a["y"]]}, b)
    assert capsys.readouterr().out == want_out
    np.testing.assert_allclose(got["x"], want["x"])
    np.testing.assert_allclose(got["y"], want["y"])


def test_small_helpers_match():
    from jdet_tpu.models.layers import resize_bilinear as j_resize_bilinear
    from jdet_tpu.models.losses.basic import accuracy as j_accuracy
    from jdet_tpu.ops import box_convert as jbc
    from jdet_tpu.ops.box_iou_rotated import rotated_intersection_area as j_inter
    from jdet_tpu.utils.general import multi_apply as j_multi_apply
    from jdet_torch.models.layers import resize_bilinear
    from jdet_torch.models.losses import accuracy
    from jdet_torch.ops import box_convert as tbc
    from jdet_torch.ops.box_iou_rotated import rotated_intersection_area
    from jdet_torch.utils.general import multi_apply, to_numpy

    rng = np.random.RandomState(0)
    hb = _hbb_rois(rng, 2, 9)
    rb = rboxes(rng, 12)
    polys = np.asarray(jbc.rbox_to_poly(jnp.asarray(rb)))[:, [2, 3, 4, 5, 6, 7, 0, 1]]
    pts = rng.uniform(0, 50, (7, 2)).astype(np.float32)
    dist = rng.uniform(0, 30, (7, 4)).astype(np.float32)
    cxcy = np.concatenate([hb[0], rng.rand(9, 1).astype(np.float32)], 1)
    for got, want in (
            (tbc.hbox_to_cxcywh(t(hb)), jbc.hbox_to_cxcywh(jnp.asarray(hb))),
            (tbc.cxcywh_to_hbox(t(cxcy)), jbc.cxcywh_to_hbox(jnp.asarray(cxcy))),
            (tbc.get_best_begin_point(t(polys)), jbc.get_best_begin_point(jnp.asarray(polys))),
            (tbc.distance2hbox(t(pts), t(dist), (40, 30)),
             jbc.distance2hbox(jnp.asarray(pts), jnp.asarray(dist), (40, 30))),
            (tbc.distance2hbox(t(pts), t(dist)), jbc.distance2hbox(jnp.asarray(pts),
                                                                   jnp.asarray(dist))),
            (tbc.rbox_to_corners(t(rb)), jbc.rbox_to_corners(jnp.asarray(rb))),
            (rotated_intersection_area(t(rb), t(rb[::-1].copy())),
             j_inter(jnp.asarray(rb), jnp.asarray(rb[::-1].copy())))):
        assert tuple(got.shape) == tuple(np.shape(want))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
    x = rng.normal(0, 1, (2, 6, 7, 3)).astype(np.float32)
    for size, ac in (((11, 13), False), ((3, 4), False), ((4, 3), True)):
        want = np.asarray(j_resize_bilinear(jnp.asarray(x), size, ac))
        got = resize_bilinear(t(x).permute(0, 3, 1, 2), size, ac).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5, err_msg=str(size))
    logits = rng.normal(0, 1, (20, 5)).astype(np.float32)
    lab = rng.randint(0, 5, 20)
    assert accuracy(t(logits), t(lab)).item() == pytest.approx(
        float(j_accuracy(jnp.asarray(logits), jnp.asarray(lab))))

    def f(a, b, c=1):
        return a + c, a * b

    assert multi_apply(f, [1, 2], [3, 4], c=2) == j_multi_apply(f, [1, 2], [3, 4], c=2)
    tree = to_numpy({"a": torch.ones(2), "b": [torch.zeros(1), 3]})
    assert isinstance(tree["a"], np.ndarray) and isinstance(tree["b"][1], np.ndarray)
