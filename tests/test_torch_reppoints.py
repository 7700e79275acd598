"""Rotated RepPoints (the convex ops, both assigners, the head, the
detector) in jdet_torch against jdet_tpu, on the CPU.

Every reference function is compiled once, with XLA's fusion off
(`torch_single_stage_parity.compile_unfused`): eager, the reference's
convex IoU took 15 s for 64 x 8 pairs.

- the ops on `utils/edge_cases.py`'s point sets (degenerate ones first:
  one point nine times, collinear, duplicates, a 3-point hull) and
  quads, and on 256 sets against 16 quads at 1024² scale, where most
  pairs are disjoint: `_prev_next_valid` and the hull's order and mask
  equal; areas rtol 1e-5; the convex IoU within 1e-6 with its zeros
  exactly the reference's; GIoU within 1e-5 and its gradient within
  1e-5 of the largest (`jax.grad`); `min_area_rect` atol 1e-4;
- `convex_assign_init` (1 and 3 candidates, with ties in distance
  between points and between gts): gt_inds, cand_idx, cand_win equal;
  `max_convex_iou_assign` on a batch with a gt that misses every hull
  (which then claims every point of IoU 0) and without near ties
  (`refine_margin` above 1e-5): gt_inds and labels equal, max_overlaps
  within 1e-6;
- the model (ResNet-18, FPN 32, two GroupNorm tower convs, 128², B=2,
  the point convs drawn wide enough that the sets span strides;
  tests/torch_single_stage_parity.py) on a batch whose refine
  assignment has no near ties: the head's three losses on the
  reference's outputs rtol 1e-5, `predict` on them, 2 SGD steps, the bf16 model within the
  reference's gap, `params_from_jax` strict, and
  `configs/rotated_reppoints_r50_fpn_1x_dota.py` at full width.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jdet_tpu.models.boxes import assigner as jassigner
from jdet_tpu.models.pretrained import assign_flat
from jdet_tpu.ops import box_convert as jbc
from jdet_tpu.ops import convex as jcv
from jdet_torch.config import load_cfg_file
from jdet_torch.models.boxes import assigner as tassigner
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import params_from_jax
from jdet_torch.ops import box_convert as tbc
from jdet_torch.ops import convex as tcv
from jdet_torch.parallel import make_device_normalizer
from jdet_torch.utils.edge_cases import gt_quads, point_sets, refine_margin
from torch_single_stage_parity import (BF16, MEAN, SGD_KW, STD, assert_predict_matches,
                                       assert_steps_match, assert_within_gap,
                                       compile_unfused, jax_model, make_batch, port,
                                       port_steps, reference_bf16, reference_f32, t)

CFG = dict(
    type="RotatedRepPoints",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=32, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(type="RotatedRepPointsHead", num_classes=5, in_channels=32,
                   feat_channels=32, point_feat_channels=32, stacked_convs=2,
                   test_cfg=dict(max_per_img=32)),
)
CLS = ("bbox_head.reppoints_cls",)
# the point convs' std: offsets of about a stride, so that the hulls meet the gts
POINT_STD = {"bbox_head.pts_init_conv": 0.1, "bbox_head.pts_init_out": 0.3,
             "bbox_head.pts_refine_conv": 0.1, "bbox_head.pts_refine_out": 0.3}
STRIDES = (8, 16, 32, 64, 128)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the ops ---------------------------------------------------------------------------

def _op_inputs():
    rng = np.random.RandomState(0)
    ps = point_sets(64)
    quads = gt_quads(8)
    rings = rng.rand(64, 13) < 0.4
    rings[0] = False
    rings[1] = False
    rings[1, 5] = True
    wide = rng.rand(16, 144) < 0.1
    wide[0] = False
    # aligned GIoU pairs: sets about their quad's centre, the degenerate ones kept
    gq = quads[rng.randint(0, 8, 64)]
    gps = ps.copy()
    centre = gq.reshape(-1, 4, 2).mean(1, keepdims=True)
    gps[8:] = (centre[8:] + rng.normal(0, 15, (56, 9, 2))).reshape(56, 18)
    gps[6] = gq[6].reshape(4, 2)[[0, 1, 2, 0, 1, 2, 0, 1, 2]].reshape(18)  # on the quad's corners
    # at 1024² scale, most pairs disjoint
    big_ps = point_sets(256, seed=9, lo=0.0, hi=1024.0)
    big_q = gt_quads(16, seed=10, lo=0.0, hi=1024.0, size=(16.0, 300.0))
    return dict(ps=ps, quads=quads, rings=rings, wide=wide, gps=gps, gq=gq,
                gweight=np.arange(1.0, 65.0, dtype=np.float32), big_ps=big_ps, big_q=big_q)


def _reference_ops(x):
    pts = x["ps"].reshape(-1, 9, 2)
    order, mask, _ = jcv.convex_hull_mask(pts)
    order13, mask13, _ = jcv.convex_hull_mask(
        jnp.concatenate([pts[:8], x["quads"].reshape(-1, 4, 2)], 1))

    def giou_sum(p):
        return (jcv.convex_giou(p, x["gq"]) * x["gweight"]).sum()

    return dict(
        pn13=jcv._prev_next_valid(x["rings"]), pn144=jcv._prev_next_valid(x["wide"]),
        order=order, mask=mask, order13=order13, mask13=mask13,
        hull_area=jcv.hull_area(pts),
        inter=jcv.hull_quad_intersection_area(pts[:8], jcv._quad_ccw(x["quads"].reshape(-1, 4, 2))),
        iou=jcv.convex_iou(x["ps"], x["quads"]),
        big_iou=jcv.convex_iou(x["big_ps"], x["big_q"]),
        giou=jcv.convex_giou(x["gps"], x["gq"]), giou_grad=jax.grad(giou_sum)(x["gps"]),
        giou_loss=jcv.convex_giou_loss(x["gps"], x["gq"], weight=x["gweight"], avg_factor=7.0),
        rect=jcv.min_area_rect(pts),
    )


@functools.cache
def _ops():
    x = {k: jnp.asarray(v) for k, v in _op_inputs().items()}
    want = compile_unfused(_reference_ops, x)(x)
    return _op_inputs(), jax.tree.map(np.asarray, want)


def test_prev_next_valid_matches():
    x, want = _ops()
    for key, ring in (("pn13", x["rings"]), ("pn144", x["wide"])):
        for got, w in zip(tcv._prev_next_valid(t(ring)), want[key]):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=key)
    # no valid slot: 0; one valid slot: itself
    assert (want["pn13"][0][0] == 0).all() and (want["pn13"][1][1] == 5).all()


def test_hull_order_and_mask_match():
    x, want = _ops()
    pts = t(x["ps"]).reshape(-1, 9, 2)
    order, mask, _ = tcv.convex_hull_mask(pts)
    np.testing.assert_array_equal(order.numpy(), want["order"])
    np.testing.assert_array_equal(mask.numpy(), want["mask"])
    assert want["mask"][3].sum() == 3 and want["mask"][0].sum() == 9  # the guard keeps 3+
    order, mask, _ = tcv.convex_hull_mask(
        torch.cat([pts[:8], t(x["quads"]).reshape(-1, 4, 2)], 1))
    np.testing.assert_array_equal(order.numpy(), want["order13"])
    np.testing.assert_array_equal(mask.numpy(), want["mask13"])


def test_areas_and_convex_iou_match(monkeypatch):
    x, want = _ops()
    monkeypatch.setattr(tcv, "PAIR_CHUNK", 100)  # several chunks
    pts = t(x["ps"]).reshape(-1, 9, 2)
    np.testing.assert_allclose(tcv.hull_area(pts).numpy(), want["hull_area"], rtol=1e-5,
                               atol=1e-6)
    inter = tcv.hull_quad_intersection_area(pts[:8], tcv._quad_ccw(t(x["quads"]).reshape(-1, 4, 2)))
    np.testing.assert_allclose(inter.numpy(), want["inter"], rtol=1e-5, atol=1e-6)
    for key, ps, q in (("iou", "ps", "quads"), ("big_iou", "big_ps", "big_q")):
        got = tcv.convex_iou(t(x[ps]), t(x[q])).numpy()
        w = want[key]
        np.testing.assert_array_equal(got == 0, w == 0, err_msg=key)
        np.testing.assert_allclose(got, w, rtol=0, atol=1e-6, err_msg=key)
    big = want["big_iou"]
    assert (big > 0).sum() > 50 and (big == 0).sum() > 3000


def test_convex_giou_and_gradient_match():
    x, want = _ops()
    p = t(x["gps"]).requires_grad_()
    giou = tcv.convex_giou(p, t(x["gq"]))
    (giou * t(x["gweight"])).sum().backward()
    np.testing.assert_allclose(giou.detach().numpy(), want["giou"], rtol=0, atol=1e-5)
    g, w = p.grad.numpy(), want["giou_grad"]
    assert np.isfinite(g).all() and np.abs(w).max() > 0.1
    np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    loss = tcv.convex_giou_loss(t(x["gps"]), t(x["gq"]), weight=t(x["gweight"]), avg_factor=7.0)
    np.testing.assert_allclose(loss.item(), want["giou_loss"], rtol=1e-6)


def test_min_area_rect_matches():
    x, want = _ops()
    got = tcv.min_area_rect(t(x["ps"]).reshape(-1, 9, 2)).numpy()
    np.testing.assert_allclose(got, want["rect"], rtol=0, atol=1e-4)


# the assigners ---------------------------------------------------------------------

def _pyramid(size=128):
    centers, lvls = [], []
    for s in STRIDES:
        n = size // s
        ys, xs = np.mgrid[:n, :n].astype(np.float32)
        centers.append(np.stack([xs.ravel() * s + s / 2, ys.ravel() * s + s / 2], -1))
        lvls.append(np.full(n * n, np.log2(s), np.float32))
    return np.concatenate(centers), np.concatenate(lvls)


def _assign_inputs():
    rng = np.random.RandomState(4)
    centers, lvls = _pyramid()
    B, K = 2, 8
    gt = np.zeros((B, K, 5), np.float32)
    gt[:, :6] = np.stack([rng.uniform(10, 118, (B, 6)), rng.uniform(10, 118, (B, 6)),
                          rng.uniform(8, 90, (B, 6)), rng.uniform(8, 60, (B, 6)),
                          rng.uniform(-1.5, 1.5, (B, 6))], -1)
    # a gt centred between two level-0 centres (a tie in distance), and a
    # second gt on it (a tie between gts: the first keeps the point)
    gt[0, 0] = [16.0, 20.0, 24.0, 24.0, 0.0]
    gt[0, 1] = [16.0, 20.0, 24.0, 24.0, 0.0]
    gt[1, 2, 2:4] = [400.0, 300.0]  # clipped to the top level
    mask = np.zeros((B, K), bool)
    mask[:, :6] = True
    mask[1, 4] = False
    labels = rng.randint(1, 6, (B, K))
    # point sets about the centres, a gt far from every hull (it claims
    # every point of IoU 0)
    N = len(centers)
    spread = np.where(lvls[:, None, None] > 3, 10.0, 6.0)
    ps = centers[None, :, None, :] + spread * rng.normal(size=(B, N, 9, 2))
    gt[1, 5] = [300.0, 300.0, 20.0, 10.0, 0.3]
    # the refine assignment without the tied pair
    refine_gt = gt.copy()
    refine_gt[0, 1] = [90.0, 40.0, 50.0, 30.0, 0.7]
    return dict(centers=centers, lvls=lvls, gt=gt, refine_gt=refine_gt, mask=mask,
                labels=labels, ps=ps.reshape(B, N, 18).astype(np.float32))


def _reference_assign(x):
    polys = jbc.rbox_to_poly(x["gt"])
    out = {}
    for pos_num in (1, 3):
        out[f"init{pos_num}"] = jax.vmap(lambda gp, gm: jassigner.convex_assign_init(
            x["centers"], x["lvls"], gp, gm, pos_num=pos_num))(polys, x["mask"])
    refine_polys = jbc.rbox_to_poly(x["refine_gt"])
    out["refine"] = jax.vmap(lambda ps, gp, gm, gl: jassigner.max_convex_iou_assign(
        ps, gp, gm, gl))(x["ps"], refine_polys, x["mask"], x["labels"])
    out["overlaps"] = jax.vmap(lambda ps, gp: jcv.convex_iou(ps, gp).T)(x["ps"], refine_polys)
    out["polys"] = polys
    out["refine_polys"] = refine_polys
    return out


@functools.cache
def _assigned():
    x = {k: jnp.asarray(v) for k, v in _assign_inputs().items()}
    return _assign_inputs(), jax.tree.map(np.asarray, compile_unfused(_reference_assign, x)(x))


@pytest.mark.parametrize("pos_num", [1, 3])
def test_convex_assign_init_matches(pos_num):
    x, want = _assigned()
    got = tassigner.convex_assign_init(t(x["centers"]), t(x["lvls"]), t(want["polys"]),
                                       t(x["mask"]), pos_num=pos_num)
    w = want[f"init{pos_num}"]
    for k in ("gt_inds", "pos_mask", "cand_idx", "cand_win"):
        np.testing.assert_array_equal(got[k].numpy(), w[k], err_msg=k)
    if pos_num == 1:
        # the tied gts: one point, won by the first
        assert w["cand_idx"][0, 0, 0] == w["cand_idx"][0, 1, 0]
        assert w["cand_win"][0, 0, 0] and not w["cand_win"][0, 1, 0]


def test_max_convex_iou_assign_matches(monkeypatch):
    x, want = _assigned()
    monkeypatch.setattr(tcv, "PAIR_CHUNK", 1000)  # several chunks
    ov = want["overlaps"]
    assert refine_margin(ov, x["mask"]) > 1e-5
    # gt 5 of image 1 misses every hull and claims every point of IoU 0
    assert ov[1, 5].max() == 0
    r = want["refine"]
    assert (r["gt_inds"][1] == 6).sum() > 0.8 * ov.shape[-1]
    assert (r["gt_inds"][0] > 0).sum() >= 5 and (r["gt_inds"][0] == 0).any()
    got = tassigner.max_convex_iou_assign(t(x["ps"]), t(want["refine_polys"]), t(x["mask"]),
                                          t(x["labels"]))
    np.testing.assert_array_equal(got["gt_inds"].numpy(), r["gt_inds"])
    np.testing.assert_array_equal(got["labels"].numpy(), r["labels"])
    np.testing.assert_allclose(got["max_overlaps"].numpy(), r["max_overlaps"], rtol=0,
                               atol=1e-6)
    got_ov = tcv.convex_iou_batched(t(x["ps"]), t(want["refine_polys"]), t(x["mask"])).numpy()
    m = x["mask"][..., None]
    np.testing.assert_array_equal((got_ov == 0) & m, (ov == 0) & m)


# the model -------------------------------------------------------------------------

def _widen_points(weights):
    """`weights` with the point convs drawn at `POINT_STD`."""
    weights = dict(weights)
    rng = np.random.RandomState(2)
    for prefix, std in POINT_STD.items():
        k = prefix + ".kernel"
        weights[k] = rng.normal(0.0, std, weights[k].shape).astype(np.float32)
    return weights


def _train_outputs(model, u8):
    with torch.no_grad():
        return model.bbox_head(model.extract_feat(make_device_normalizer(MEAN, STD)(t(u8))))


def _init_sets_and_gts(head, outs, tt):
    """The init point sets (B, A, 18) of `outs`, the gt quads, mask and
    labels: what the refine assignment takes."""
    B = outs[0][0].shape[0]
    pts_list, strides_list = head._points([tuple(o[0].shape[-2:]) for o in outs], "cpu")
    pts = head._decode_points(head._flatten(outs, 1, 18), torch.cat(pts_list),
                              torch.cat(strides_list)).reshape(B, -1, 18)
    return pts, tbc.rbox_to_poly(tt["gt_bboxes"]), tt["gt_mask"], tt["gt_labels"]


def _refine_overlaps(head, outs, targets):
    """The port's convex IoU of the init sets of `outs` with the gts."""
    tt = {k: t(v) for k, v in targets.items()}
    return tcv.convex_iou_batched(*_init_sets_and_gts(head, outs, tt)[:3])


def tie_free_batch(model):
    for seed in range(1, 40):
        u8, targets = make_batch(seed, K=4, num_classes=5)
        ov = _refine_overlaps(model.bbox_head, _train_outputs(model, u8), targets)
        if refine_margin(ov.numpy(), targets["gt_mask"]) > 1e-5:
            return u8, targets
    raise AssertionError("no tie-free batch")


@functools.cache
def _ref():
    jmodel, weights = jax_model(CFG, CLS)
    weights = _widen_points(weights)
    assign_flat(jmodel, weights, strict=True)
    tmodel = port(CFG, weights)
    u8, targets = tie_free_batch(tmodel)
    f32 = reference_f32(jmodel, tmodel, u8, targets, SGD_KW, lr=0.008)
    bf16 = reference_bf16(jax_model(CFG, CLS, weights, jnp.bfloat16)[0], u8, targets)
    return weights, tmodel, u8, targets, f32, bf16


def to_port(outs):
    return [tuple(t(o).permute(0, 3, 1, 2).contiguous() for o in lvl) for lvl in outs]


def to_ref(outs):
    return [[o.permute(0, 2, 3, 1).detach().float().numpy() for o in lvl] for lvl in outs]


def test_head_loss_matches_on_the_reference_outputs():
    _, tmodel, _, targets, f32, _ = _ref()
    head = tmodel.bbox_head
    outs = to_port(f32["outs_train"])
    tt = {k: t(v) for k, v in targets.items()}
    # the batch's refine assignment has positives and no near ties
    ov = _refine_overlaps(head, outs, targets)
    assert refine_margin(ov.numpy(), targets["gt_mask"]) > 1e-5
    refine = tassigner.max_convex_iou_assign(*_init_sets_and_gts(head, outs, tt))
    assert (refine["gt_inds"] > 0).sum() >= 5
    # the reference's first step took these losses of these outputs
    got = head.loss(outs, tt)
    assert set(got) == {"loss_cls", "loss_pts_init", "loss_pts_refine"}
    for k, v in got.items():
        w = f32["losses"][0][k]
        assert w > 0, k
        np.testing.assert_allclose(v.item(), w, rtol=1e-5, err_msg=k)


def test_head_outputs_and_predict_match():
    _, tmodel, u8, _, f32, _ = _ref()
    for g, w in zip(to_ref(_train_outputs(tmodel, u8)), f32["outs"]):
        for i, (gi, wi) in enumerate(zip(g, w)):
            np.testing.assert_allclose(gi, wi, rtol=0, atol=1e-4 * max(1.0, np.abs(wi).max()),
                                       err_msg=f"output {i}")
    head = tmodel.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    got = {k: v.numpy() for k, v in head.predict(to_port(f32["outs"])).items()}
    head.test_cfg = dict(head.test_cfg, score_thr=0.05)
    assert got["boxes"].shape == (2, 32, 5)
    assert_predict_matches(got, f32["predict"])


def test_two_train_steps_match():
    weights, _, u8, targets, f32, _ = _ref()
    model, start, log_vars = port_steps(lambda: port(CFG, weights), u8, targets, SGD_KW,
                                        lr=0.008)
    for lv in log_vars:
        assert all(np.isfinite(v.item()) for v in lv.values())
    assert_steps_match(model, start, log_vars, f32, moved_names=(
        "bbox_head.cls_convs.1.norm.weight", "bbox_head.pts_init_out.weight",
        "bbox_head.pts_refine_out.weight", "bbox_head.reppoints_cls.weight"))


def test_bf16_model_within_the_reference_gap():
    weights, _, u8, targets, f32, bf16 = _ref()
    model = port(CFG, weights, BF16)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(t(u8))
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    assert {o.dtype for o in outs[0]} == {BF16}
    model.train()
    losses = model.loss(images, {k: t(v) for k, v in targets.items()})
    losses = {k: v.item() for k, v in losses.items()}
    losses["total_loss"] = sum(losses.values())
    assert_within_gap(to_ref(outs), bf16, f32, losses)


def test_params_from_jax_is_strict_on_the_model():
    weights, tmodel, _, _, _, _ = _ref()
    sd = params_from_jax(weights, tmodel)
    assert set(sd) == set(tmodel.state_dict())
    for k in ("bbox_head.reg_convs.1.norm.weight", "bbox_head.cls_convs.0.conv.weight",
              "bbox_head.pts_refine_out.bias", "bbox_head.reppoints_cls.bias"):
        assert k in sd, k
    assert "bbox_head.cls_convs.0.conv.bias" not in sd


def test_config_builds_at_full_width():
    cfg = load_cfg_file("configs/rotated_reppoints_r50_fpn_1x_dota.py")
    assert cfg["optimizer"]["lr"] == 0.008
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "RotatedRepPoints" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(head.cls_convs) == len(head.reg_convs) == 3
    assert head.cls_convs[0].norm.num_groups == 32 and head.cls_convs[0].conv.bias is None
    assert head.num_classes == 15 and head.num_points == 9 and head.gradient_mul == 0.1
    assert head.reppoints_cls.weight.shape == (15, 256, 3, 3)
    assert head.pts_init_out.weight.shape == head.pts_refine_out.weight.shape == (18, 256, 1, 1)
    assert head.refine_assign_cfg == dict(pos_iou_thr=0.4, neg_iou_thr=0.3, min_pos_iou=0.0)
    assert head.test_cfg == dict(nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1,
                                 max_per_img=2000)
