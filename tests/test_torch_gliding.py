"""FasterRCNN-OBB and Gliding Vertex in jdet_torch against jdet_tpu, on the
CPU.

The models are `configs/faster_rcnn_obb_r50_fpn_1x_dota.py`'s and
`configs/gliding_r50_fpn_1x_dota.py`'s at the size of
tests/test_torch_redet_rcnn.py (ResNet-18 with frozen_stages=1, FPN 32,
RPN nms_pre 128 / nms_post 48, 32 sampled RoIs, fc_out_channels 64,
128², B=2), with random BN statistics and class layers of std 0.3 (the
RPN's) and 0.05 (the RoI head's: its losses stay near 3, not 17, where
bf16 rounds them by 1/8); their
weights go to the port through `params_from_jax`, the samplers take the
reference's draws (`Replay`), and the reference runs jitted, on a batch
without near ties (see `_batch`). Tolerances:
- the GV coder: encode atol 1e-5 (on the same quads; on each package's
  own quads of rboxes whose angles keep clear of multiples of pi/2; and
  on an axis-aligned rbox, where both see the same exact tie), decode
  atol 1e-4 px; `poly_to_rbox` on glided (general) quads atol 1e-4 px and
  1e-5 rad, away from its edge1 / edge2 tie and its angle wrap;
- `GlidingRPNHead`'s cross-level proposals: the same valid slots, boxes
  atol 1e-4, scores atol 1e-6;
- the heads' losses on the reference's proposals and both detectors'
  losses rtol 1e-5; `predict`'s boxes and scores atol 1e-4 on the same
  valid slots;
- 2 train steps (warmup lr, clip 35): each parameter within 1e-4 of its
  tensor's largest value;
- Gliding's bf16 model within 0.8 of the reference's own bf16 - f32 gap
  (root mean squares): the RPN's outputs and the RoI head's on the
  float32 run's RoIs; the losses pooled within 0.5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.boxes.coder import gv_fix_decode as j_gv_fix_decode
from jdet_tpu.models.boxes.coder import gv_fix_encode as j_gv_fix_encode
from jdet_tpu.models.boxes.coder import gv_ratio_encode as j_gv_ratio_encode
from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.models.pretrained import import_jdet_checkpoint as j_import_jdet_checkpoint
from jdet_tpu.ops.box_convert import poly_to_rbox as j_poly_to_rbox
from jdet_tpu.ops.box_convert import rbox_to_hbox as j_rbox_to_hbox
from jdet_tpu.ops.box_convert import rbox_to_poly as j_rbox_to_poly
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models import pretrained
from jdet_torch.models.boxes.assigner import hbb_overlaps
from jdet_torch.models.boxes.coder import gv_fix_decode, gv_fix_encode, gv_ratio_encode
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.ops import rbox_to_hbox
from jdet_torch.ops.box_convert import poly_to_rbox, rbox_to_poly
from jdet_torch.ops.nms import hbb_iou_matrix, nms
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step
from test_torch_oriented_rcnn import Replay, _margin, model_draws, sampler_draws
from test_torch_pretrained import _assert_same_state, _jdet_detector_sd
from test_torch_retinanet import _randomize_bn
from test_torch_train_step import SCHED


def _cfg(det, rpn, head):
    return dict(
        type=det,
        backbone=dict(type="ResNet", depth=18, frozen_stages=1),
        neck=dict(type="FPN", out_channels=32, num_outs=5),
        rpn_head=dict(type=rpn, in_channels=32, feat_channels=32, nms_pre=128, nms_post=48),
        bbox_head=dict(type=head, num_classes=15, in_channels=32, fc_out_channels=64,
                       train_cfg=dict(sampler=dict(num=32, pos_fraction=0.25)),
                       test_cfg=dict(max_per_img=16, score_thr=0.01)),
    )


CFGS = {"faster": _cfg("FasterRCNNOBB", "RPNHead", "FasterrcnnHead"),
        "gliding": _cfg("GlidingVertex", "GlidingRPNHead", "GlidingHead")}
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)
B, K, SIZE = 2, 8, 128
N_ANCHORS = sum(3 * (SIZE // s) ** 2 for s in (4, 8, 16, 32, 64))
N_ROIS = K + 48
LOSS_KEY = jax.random.PRNGKey(3)
BF16 = torch.bfloat16
NET_GAP, LOSS_GAP = 0.8, 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _numpy_params(module):
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}


def _rboxes(rng, n, lo=30, hi=100, clear=0.0):
    """(n, 5) rboxes; with `clear`, angles at least that far from every
    multiple of pi/2."""
    theta = rng.uniform(clear, np.pi / 2 - clear, n) + np.pi / 2 * rng.randint(-1, 2, n)
    theta = np.where(theta >= 3 * np.pi / 4, theta - np.pi, theta)
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n), rng.uniform(16, 60, n),
                     rng.uniform(8, 30, n), theta], 1).astype(np.float32)


# the GV coder and poly_to_rbox --------------------------------------------------

def test_gv_coder_matches():
    rng = np.random.RandomState(0)
    rb = _rboxes(rng, 256, clear=0.05)
    # the same quads in both packages
    poly = np.asarray(j_rbox_to_poly(jnp.asarray(rb)))
    hbb = np.asarray(j_rbox_to_hbox(jnp.asarray(rb)))
    for j_fn, t_fn in ((j_gv_fix_encode, gv_fix_encode), (j_gv_ratio_encode, gv_ratio_encode)):
        want = np.asarray(j_fn(jnp.asarray(hbb), jnp.asarray(poly)))
        np.testing.assert_allclose(t_fn(_t(hbb), _t(poly)).numpy(), want, rtol=0, atol=1e-5)
    # each package's own quads of the same rboxes, as the heads build them
    want = np.asarray(j_gv_fix_encode(j_rbox_to_hbox(jnp.asarray(rb)), j_rbox_to_poly(jnp.asarray(rb))))
    got = gv_fix_encode(rbox_to_hbox(_t(rb)), rbox_to_poly(_t(rb))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert ((want > 0.01) & (want < 0.99)).mean() > 0.9  # glides, not corners
    # decode: ratios outside [0, 1] clip; k = 1 and k = 2 sets of ratios
    for k in (1, 2):
        fix = rng.uniform(-0.2, 1.2, (256, 4 * k)).astype(np.float32)
        want = np.asarray(j_gv_fix_decode(jnp.asarray(hbb), jnp.asarray(fix)))
        got = gv_fix_decode(_t(hbb), _t(fix)).numpy()
        assert got.shape == want.shape == (256, 8 * k)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_gv_encode_takes_the_same_vertex_on_an_exact_tie():
    """An axis-aligned rbox: two vertices share the top (and each other
    edge) exactly in both packages; the encoder takes the largest x at the
    top and y on the right and the smallest x at the bottom and y on the
    left, so every glide is 1, in both."""
    rb = np.array([[50.0, 40.0, 30.0, 10.0, 0.0], [20.5, 70.25, 12.0, 12.0, 0.0]], np.float32)
    want = np.asarray(j_gv_fix_encode(j_rbox_to_hbox(jnp.asarray(rb)), j_rbox_to_poly(jnp.asarray(rb))))
    got = gv_fix_encode(rbox_to_hbox(_t(rb)), rbox_to_poly(_t(rb))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got, np.ones((2, 4)), atol=1e-6)


def test_poly_to_rbox_matches_on_glided_quads():
    """General quads, as `GlidingHead.predict` makes them, not rectangles:
    held where the first two edges differ by more than 1e-3 relative and
    the angle keeps 1e-4 from the wrap of `norm_angle`."""
    rng = np.random.RandomState(1)
    lo = rng.uniform(0, 100, (512, 2))
    hbb = np.concatenate([lo, lo + rng.uniform(4, 80, (512, 2))], 1).astype(np.float32)
    quads = gv_fix_decode(_t(hbb), _t(rng.uniform(0, 1, (512, 4)).astype(np.float32)))
    want = np.asarray(j_poly_to_rbox(jnp.asarray(quads.numpy())))
    got = poly_to_rbox(quads).numpy()
    q = quads.numpy().reshape(-1, 4, 2)
    e1 = np.linalg.norm(q[:, 0] - q[:, 1], axis=1)
    e2 = np.linalg.norm(q[:, 1] - q[:, 2], axis=1)
    ok = (np.abs(e1 - e2) > 1e-3 * np.maximum(e1, e2)) & (np.abs(want[:, 4] + np.pi / 4) > 1e-4) \
        & (np.abs(want[:, 4] - 3 * np.pi / 4) > 1e-4)
    assert ok.mean() > 0.95
    np.testing.assert_allclose(got[ok, :4], want[ok, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[ok, 4], want[ok, 4], rtol=0, atol=1e-5)


def test_nms_chunks_give_the_one_problem_result():
    """`nms` on (B, n) problems cut to one problem per chunk equals the
    whole batch at once, as the cross-level RPN runs it at 1024²."""
    rng = np.random.RandomState(2)
    lo = rng.uniform(0, 100, (3, 300, 2))
    boxes = _t(np.concatenate([lo, lo + rng.uniform(4, 40, (3, 300, 2))], -1).astype(np.float32))
    scores = _t(rng.rand(3, 300).astype(np.float32))
    valid = _t(rng.rand(3, 300) > 0.1)
    whole = nms(boxes, scores, 0.7, valid=valid)
    cut = nms(boxes, scores, 0.7, valid=valid, max_pairs=1)
    for a, b in zip(whole, cut):
        assert torch.equal(a, b)
    assert 0 < whole[1].sum() < valid.sum()


def test_cross_level_proposals_match_where_levels_overlap():
    """`GlidingRPNHead.get_proposals` on given RPN outputs whose level-0 and
    level-1 boxes are scaled to the same sizes, so that one NMS across the
    levels suppresses boxes that one NMS per level keeps: the reference's
    proposals, and fewer of them than per level."""
    from jdet_tpu.models.heads.rpn_heads import GlidingRPNHead as JGlidingRPNHead
    from jdet_torch.models.heads.rpn_heads import GlidingRPNHead

    kw = dict(in_channels=8, feat_channels=8, nms_pre=96, nms_post=64)
    jhead = JGlidingRPNHead(**kw, rngs=nnx.Rngs(0))
    thead = GlidingRPNHead(**kw)
    rng = np.random.RandomState(4)
    outs = []
    for lvl, hw in enumerate((32, 16, 8, 4, 2)):
        cls = rng.normal(0, 1, (B, hw, hw, 3)).astype(np.float32)
        reg = rng.normal(0, 0.05, (B, hw, hw, 3, 4)).astype(np.float32)
        reg[..., 2:] += {0: np.log(1.5), 1: -np.log(1.5) / 2}.get(lvl, 0.0)
        outs.append((cls, reg.reshape(B, hw, hw, 12)))
    want = jax.jit(jhead.get_proposals)([tuple(map(jnp.asarray, o)) for o in outs])
    touts = [tuple(_t(a).permute(0, 3, 1, 2) for a in o) for o in outs]
    got = thead.get_proposals(touts)
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(got["valid"].numpy(), v)
    np.testing.assert_allclose(got["boxes"].numpy()[v], np.asarray(want["boxes"])[v], rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(got["scores"].numpy()[v], np.asarray(want["scores"])[v], rtol=0,
                               atol=1e-6)
    thead.nms_post = 10**6
    cross = thead.get_proposals(touts)["valid"].sum(1)
    thead.cross_level_nms = False
    per_level = thead.get_proposals(touts)["valid"].sum(1)
    assert (cross < per_level).all() and v.sum(1).min() == 64


# the models ---------------------------------------------------------------------

def _jax_model(cfg):
    """The reference model, built under `nnx.jit` (one compile instead of
    one per initializer shape), with random BN statistics and class
    layers of std 0.3 (the RPN's) and 0.05 (the RoI head's)."""
    jmodel = nnx.jit(lambda: j_build_detector(cfg, seed=0))()
    _randomize_bn(jmodel, seed=1)
    rng = np.random.RandomState(2)
    for kernel, std in ((jmodel.rpn_head.rpn_cls.kernel, 0.3),
                        (jmodel.bbox_head.fc_cls.kernel, 0.05)):
        kernel.set_value(jnp.asarray(rng.normal(0.0, std, kernel.get_value().shape),
                                     jnp.float32))
    return jmodel


def _jax_bf16_twin(jmodel, cfg):
    """The same reference model under the bf16 policy: its structure from
    `nnx.eval_shape`, its state copied from `jmodel`."""
    with j_compute_dtype_scope(jnp.bfloat16):
        twin = nnx.eval_shape(lambda: j_build_detector(cfg, seed=0))
    nnx.update(twin, jax.tree.map(jnp.copy, nnx.state(jmodel)))
    return twin


def _port(weights, cfg, dtype=None):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(cfg, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def _draw(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, SIZE, SIZE, 3).astype(np.float32)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :3] = True
        gt[b, :3] = _rboxes(rng, 3, clear=0.05)
        labels[b, :3] = rng.randint(1, 16, 3)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def _nms_margin(rpn, outs):
    """The smallest gaps, over the RPN's candidates, that decide its
    proposals: in scores, each level's score at the top-k cut from the
    next, the kept candidates' scores up to the first one past nms_post,
    and the scores of every pair whose hbb IoU passes the NMS threshold
    (which of the two suppresses the other); in IoU, each pair's from the
    threshold where the higher scorer is kept. Returns (scores, IoUs)."""
    margin = iou_margin = np.inf
    for b in range(B):
        cand, cand_s = [], []
        for (cls, reg), anchors in zip(outs, rpn._level_anchors(outs)):
            s = torch.sigmoid(rpn._flat(cls, 1))[b]
            top = torch.sort(s.double(), descending=True).values
            if rpn.nms_pre < len(s):
                margin = min(margin, (top[rpn.nms_pre - 1] - top[rpn.nms_pre]).item())
            idx = torch.sort(s, descending=True, stable=True).indices[:rpn.nms_pre]
            cand.append(rpn._decode(anchors[idx], rpn._flat(reg, 4)[b][idx]))
            cand_s.append(s[idx])
        boxes, s = torch.cat(cand), torch.cat(cand_s)
        order = torch.sort(s, descending=True, stable=True).indices
        boxes, s = boxes[order], s[order].double()
        ok = ((boxes[:, 2] - boxes[:, 0]) > 0) & ((boxes[:, 3] - boxes[:, 1]) > 0)
        _, keep = nms(boxes, s.float(), rpn.nms_thresh, valid=ok)
        kept = s[keep][:rpn.nms_post + 1]
        margin = min(margin, (kept[:-1] - kept[1:]).min().item())
        iou = hbb_iou_matrix(boxes, boxes).double()
        upper = torch.ones_like(iou, dtype=torch.bool).triu(1)
        gap = (s[:, None] - s[None, :]).abs()
        margin = min(margin, gap[upper & (iou > rpn.nms_thresh)].min().item())
        iou_margin = min(iou_margin,
                         (iou - rpn.nms_thresh).abs()[upper & keep[:, None]].min().item())
    return margin, iou_margin


def _batch(tmodel):
    """The first seed whose batch has no near tie in the RPN's scores (2e-6:
    the port's stand ~1e-7 from the reference's) or its NMS's IoUs
    (`_nms_margin`), and none (1e-5) in its assigner's hbb IoUs (0.7 /
    0.3) or the RoI head's of the gts and the proposals (0.5)."""
    rpn = tmodel.rpn_head
    anchors = torch.cat([rpn.anchor_generator.grid_anchors((SIZE // s, SIZE // s), lvl, "cpu")
                         for lvl, s in enumerate(rpn.anchor_strides)])
    tmodel.train()
    for seed in range(9, 60):
        images, targets = _draw(seed)
        t = {k: _t(v) for k, v in targets.items()}
        with torch.no_grad():
            outs = rpn(tmodel.extract_feat(_t(images)))
            props = rpn.get_proposals(outs)
        score_margin, margin = _nms_margin(rpn, outs)
        for b in range(B):
            hb = rbox_to_hbox(t["gt_bboxes"][b][t["gt_mask"][b]])
            margin = min(margin, _margin(hbb_overlaps(hb, anchors), (0.7, 0.3)))
            cand = torch.cat([hb, props["boxes"][b][props["valid"][b]]])
            margin = min(margin, _margin(hbb_overlaps(hb, cand), (0.5,), ties=False))
        if margin > 1e-5 and score_margin > 2e-6:
            return images, targets
    raise AssertionError("no tie-free batch")


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


def _head_outs(head, feats, rois):
    """The RoI head's outputs on (rois, valid), either package."""
    x = head._shared_forward(feats, *rois)
    out = [head.fc_cls(x), head.fc_reg(x)]
    if hasattr(head, "fc_fix"):
        out += [head.fc_fix(x), head.fc_ratio(x)]
    return out


def _step_key(it):
    return jax.random.PRNGKey(100 + it)


_REFS = {}


@pytest.fixture(scope="module", params=["faster", "gliding"])
def ref(request):
    return _reference(request.param)


@pytest.fixture(scope="module")
def gliding_ref():
    return _reference("gliding")


def _reference(name):
    """The reference, jitted (once per detector): the RPN's outputs, losses
    and proposals, the RoI head's sampled RoIs (with their matched gts),
    outputs and losses, the model's losses and `predict`; two train steps;
    for Gliding, the same network in bf16 on the float32 run's RoIs."""
    if name in _REFS:
        return _REFS[name]
    cfg = CFGS[name]
    jmodel = _jax_model(cfg)
    weights = _numpy_params(jmodel)
    tmodel = _port(weights, cfg)
    images, targets = _batch(tmodel)
    ji = jnp.asarray(images)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    k2 = jax.random.split(LOSS_KEY)[1]

    def outputs(m):
        feats = m.extract_feat(ji, train=True)
        outs = m.rpn_head(feats, train=True)
        proposals = m.rpn_head.get_proposals(outs)
        head = m.bbox_head
        t = dict(jt, gt_hboxes=j_rbox_to_hbox(jt["gt_bboxes"]))
        s = head.sample_batch(proposals, t, k2)
        rois = (s["rois"], s["valid"])
        # the model's losses are the RPN's (key k1) and the head's (k2) on
        # these proposals: the tests hold each part against them
        return {"rpn_outs": outs, "proposals": proposals, "rois": rois,
                "matched_gt": s["matched_gt"], "head_outs": _head_outs(head, feats, rois),
                "losses": m.loss(ji, jt, key=LOSS_KEY), "predict": m.predict(ji)}

    runs = {"f32": _host(nnx.jit(outputs)(jmodel))}
    if name == "gliding":
        rois = tuple(jnp.asarray(r) for r in runs["f32"]["rois"])

        def bf16_outputs(m):
            feats = m.extract_feat(ji, train=True)
            return {"rpn_outs": m.rpn_head(feats, train=True),
                    "head_outs": _head_outs(m.bbox_head, feats, rois),
                    "losses": m.loss(ji, jt, key=LOSS_KEY)}

        runs["bf16"] = _host(nnx.jit(bf16_outputs)(_jax_bf16_twin(jmodel, cfg)))

    @nnx.jit
    def step(m, opt, key):
        (_, log_vars), grads = nnx.value_and_grad(
            lambda m: j_parse_losses(m.loss(ji, jt, key=key)), has_aux=True)(m)
        opt.update(m, grads)

    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
    for it in range(2):
        step(jmodel, jopt, _step_key(it))
    runs["step_params"] = {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in _numpy_params(jmodel).items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}
    _REFS[name] = name, weights, images, targets, runs
    return _REFS[name]


def _targets(targets):
    return {k: _t(v) for k, v in targets.items()}


def test_params_from_jax_maps_the_new_heads(ref):
    name, weights, *_ = ref
    model = _port(weights, CFGS[name])
    sd = params_from_jax(weights, model)
    assert set(model.state_dict()) == set(sd)
    if name == "gliding":
        assert sd["bbox_head.fc_fix.weight"].shape == (4, 64)
        assert sd["bbox_head.fc_ratio.weight"].shape == (1, 64)
        assert sd["bbox_head.fc_reg.weight"].shape == (4, 64)
    else:
        assert sd["bbox_head.fc_reg.weight"].shape == (5, 64)


def test_rpn_proposals_match(ref):
    """The RPN's outputs, losses and proposals (Gliding's from the NMS
    across levels)."""
    name, weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights, CFGS[name])
    model.train()
    tt = _targets(targets)
    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    rpn = model.rpn_head
    assert rpn.cross_level_nms == (name == "gliding")
    assert rpn.nms_thresh == (0.7 if name == "gliding" else 0.8)
    with torch.no_grad():
        outs = rpn(model.extract_feat(_t(images)))
        for o, w in zip(outs, want["rpn_outs"]):
            for t, wt in zip(o, w):
                np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), wt, rtol=0, atol=1e-5)
        losses = rpn.loss(outs, tt, rand=Replay(sampler_draws(jax.random.split(LOSS_KEY)[0],
                                                              B, N_ANCHORS)))
        proposals = rpn.get_proposals(outs)
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_bbox"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), want["losses"][k], rtol=1e-5, err_msg=k)
    wp = want["proposals"]
    v = wp["valid"]
    assert v.sum() > 40
    np.testing.assert_array_equal(proposals["valid"].numpy(), v)
    np.testing.assert_allclose(proposals["boxes"].numpy()[v], wp["boxes"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(proposals["scores"].numpy()[v], wp["scores"][v], rtol=0,
                               atol=1e-6)


def test_head_loss_matches_on_the_reference_proposals(ref):
    """`_sample_rois` (its RoIs and their matched gts) and the head's
    losses on the reference's proposals."""
    name, weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights, CFGS[name])
    model.train()
    k2 = jax.random.split(LOSS_KEY)[1]
    proposals = {k: _t(v) for k, v in want["proposals"].items()}
    tt = _targets(targets)
    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    head = model.bbox_head
    args = (proposals["boxes"], proposals["valid"], tt["gt_hboxes"], tt["gt_mask"],
            tt["gt_labels"])
    sampled = head._sample_rois(*args, rand=Replay(sampler_draws(k2, B, N_ROIS)),
                                gt_reg=tt["gt_bboxes"])
    assert len(sampled) == 7
    np.testing.assert_array_equal(sampled[1].numpy(), want["rois"][1])
    np.testing.assert_allclose(sampled[0].numpy(), want["rois"][0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(sampled[6].numpy(), want["matched_gt"])
    assert (np.abs(want["matched_gt"]).sum(-1) > 0).sum() >= 4
    losses = head.loss(model.extract_feat(_t(images)), proposals, tt,
                       rand=Replay(sampler_draws(k2, B, N_ROIS)))
    assert set(losses) == set(want["losses"]) - {"loss_rpn_cls", "loss_rpn_bbox"}
    for k, v in losses.items():
        np.testing.assert_allclose(v.item(), want["losses"][k], rtol=1e-5, err_msg=k)
        assert want["losses"][k] > 0, k


def test_loss_and_predict_match(ref):
    name, weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights, CFGS[name])
    model.train()
    losses = model.loss(_t(images), _targets(targets),
                        rand=Replay(model_draws(LOSS_KEY, B, N_ANCHORS, N_ROIS)))
    assert set(losses) == set(want["losses"]) and len(losses) == (6 if name == "gliding" else 4)
    for k, v in want["losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    model.eval()
    got = {k: v.numpy() for k, v in model.predict(_t(images)).items()}
    wp = want["predict"]
    v = wp["valid"]
    assert v.sum() > 4 and got["boxes"].shape == wp["boxes"].shape == (B, 16, 5)
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], wp["labels"][v])
    np.testing.assert_allclose(got["scores"][v], wp["scores"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"][v], wp["boxes"][v], rtol=0, atol=1e-4)


def test_two_train_steps_match(ref):
    name, weights, images, targets, runs = ref
    model = _port(weights, CFGS[name])
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    step = build_train_step(model, opt)
    loss = model.loss
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    for it in range(2):
        draws = Replay(model_draws(_step_key(it), B, N_ANCHORS, N_ROIS))
        model.loss = lambda images, targets, generator=None: loss(images, targets, rand=draws)
        step(_t(images), _targets(targets), it)
        assert not draws.blocks
    want = runs["step_params"]
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    for n, g in got.items():
        w = want[n]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=n)
    moved = {n for n in got if not np.array_equal(got[n], start[n])}
    assert "bbox_head.fc_cls.weight" in moved and "backbone.conv1.weight" not in moved
    if name == "gliding":
        assert {"bbox_head.fc_fix.weight", "bbox_head.fc_ratio.weight"} <= moved


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_bf16_gliding_within_the_reference_gap(gliding_ref):
    """Gliding under the bf16 policy (FasterRCNN-OBB shares its network
    but for the head's last FCs)."""
    name, weights, images, targets, runs = gliding_ref
    f32, bf16 = runs["f32"], runs["bf16"]
    model = _port(weights, CFGS[name], BF16)
    model.train()
    head = model.bbox_head
    fracs = {}
    with torch.no_grad():
        feats = model.extract_feat(_t(images))
        outs = model.rpn_head(feats)
        assert outs[0][0].dtype == BF16
        head_outs = _head_outs(head, feats, tuple(map(_t, f32["rois"])))
        assert head_outs[0].dtype == BF16
    for lvl, (o, b, f) in enumerate(zip(outs, bf16["rpn_outs"], f32["rpn_outs"])):
        for i, (t, bt, ft) in enumerate(zip(o, b, f)):
            fracs[f"rpn {lvl}.{i}"] = (_rms(t.float().permute(0, 2, 3, 1).numpy() - bt)
                                       / _rms(bt - ft))
    for i, (t, bt, ft) in enumerate(zip(head_outs, bf16["head_outs"], f32["head_outs"])):
        fracs[f"head {i}"] = _rms(t.float().numpy() - bt) / _rms(bt - ft)
    worst = max(fracs, key=fracs.get)
    assert fracs[worst] <= NET_GAP, f"{worst} at {fracs[worst]:.3f} of the gap: {fracs}"
    losses = model.loss(_t(images), _targets(targets),
                        rand=Replay(model_draws(LOSS_KEY, B, N_ANCHORS, N_ROIS)))
    assert all(v.dtype == torch.float32 and torch.isfinite(v) for v in losses.values())
    keys = sorted(losses)
    got = np.array([losses[k].item() for k in keys])
    want_b = np.array([bf16["losses"][k] for k in keys])
    want_f = np.array([f32["losses"][k] for k in keys])
    frac = _rms(got - want_b) / _rms(want_b - want_f)
    assert frac <= LOSS_GAP, f"losses at {frac:.3f} of the gap: {got} {want_b} {want_f}"


# full-width configs, weight import -------------------------------------------------

@pytest.mark.parametrize("name,det,rpn,head", [
    ("faster_rcnn_obb_r50_fpn_1x_dota.py", "FasterRCNNOBB", "RPNHead", "FasterrcnnHead"),
    ("gliding_r50_fpn_1x_dota.py", "GlidingVertex", "GlidingRPNHead", "GlidingHead"),
    ("gliding_r50_fpn_1x_dota_ra90_balance.py", "GlidingVertex", "GlidingRPNHead",
     "GlidingHead"),
])
def test_configs_build_at_full_width(name, det, rpn, head):
    cfg = load_cfg_file(f"configs/{name}")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    assert type(model).__name__ == det and model.backbone.depth == 50
    assert type(model.rpn_head).__name__ == rpn and type(model.bbox_head).__name__ == head
    assert (model.rpn_head.nms_pre, model.rpn_head.nms_post) == (2000, 2000)
    assert model.rpn_head.nms_thresh == (0.7 if rpn == "GlidingRPNHead" else 0.8)
    assert tuple(model.bbox_head.shared_fcs[0].weight.shape) == (1024, 256 * 49)
    assert tuple(model.bbox_head.fc_reg.weight.shape) == (5 if head == "FasterrcnnHead" else 4,
                                                          1024)
    assert cfg["optimizer"]["lr"] == 0.005
    if name.endswith("balance.py"):
        assert cfg["dataset"]["train"]["balance_category"] is True
        assert cfg["device_augment"] == dict(flip_h=0.5, rot90=1.0)


def test_jdet_payload_of_gliding_imports_as_the_reference_does():
    """A JDet Gliding Vertex state dict (torchvision names in the backbone,
    ConvModule-wrapped FPN convs, `fc_fix`/`fc_ratio` in the head) goes
    into both packages' models alike."""
    cfg = CFGS["gliding"]
    jm = nnx.eval_shape(lambda: j_build_detector(cfg, seed=0))
    tm = build_detector(cfg, device="cpu", seed=1, load_pretrained=False)
    sd = _jdet_detector_sd(tm)
    assert "bbox_head.fc_fix.weight" in sd and "bbox_head.fc_ratio.bias" in sd
    _, missing, unexpected = j_import_jdet_checkpoint(jm, {"meta": {}, "model": sd})
    assert not missing and not unexpected
    _, missing, unexpected = pretrained.import_jdet_checkpoint(tm, {"meta": {}, "model": sd})
    assert not missing and not unexpected
    _assert_same_state(jm, tm)
