"""The ReDet slice of jdet_torch against jdet_tpu, on the CPU: the model of
`configs/redet_re50_refpn_1x_dota.py` at a small size.

The model: ReResNet-18 (bottlenecks, as the reference builds every
depth) with base_fields=2 and frozen_stages=1, ReFPN 32, `RPNHead` with
nms_pre 128 / nms_post 48, `ReDetHead` with fc_out_channels 64 and 32
sampled RoIs per stage, 128², B=2; random BN statistics and class layers
of std 0.3 (0.01 at init), so that neither the RPN's top-k nor the
scores tie. Its weights are carried into the port through
`params_from_jax`. JAX's random streams do not carry over: the port's
three samplers take the reference's own uniforms, drawn from the same
key splits as `two_stage.py:42`, `rpn_heads.py:139`,
`obb_roi_heads.py:349-351,381-382` and `sampler.py:61`, through `rand`.
The reference runs jitted, as its Runner runs it, on a batch without
near ties in any of the three assignments (see `_batch`); the train
steps are its Runner's (`parallel/spmd.py::build_train_step`).

Tolerances:
- ReResNet and ReFPN outputs atol 1e-5 of their largest value;
- `RPNHead` on the reference's ReFPN outputs: outputs atol 1e-5, losses
  rtol 1e-5, proposals' boxes atol 1e-4 and scores 1e-6 on the same
  valid slots; on the port's own features (18 bottlenecks of C8 convs
  deep, summed in another order) its outputs atol 1e-5 of their largest
  value;
- `ReDetHead` on the reference's proposals: the sampled RoIs of both
  stages atol 1e-5 (the refined ones decode the stage-1 deltas), each
  stage's outputs atol 1e-5 of their largest value, the four losses
  `loss_{cls,bbox}_s{1,2}` rtol 1e-5;
- the whole `ReDet`: the six losses rtol 1e-5, `predict`'s boxes atol
  1e-4 and scores atol 1e-5 on the same valid slots;
- one train step (warmup lr, clip 35, momentum, weight decay; the frozen
  stem and layer1 untouched): each parameter within 1e-4 of its tensor's
  largest value, and its change within 1e-2 of the reference change's
  largest value or one float32 ulp of the tensor's largest value, the
  finest a change can be resolved (a tensor whose gradient is ~1e-7
  moves by a few dozen ulps); resuming a jdet_tpu ReDet checkpoint (its
  InnerBatchNorm leaves, its 5-D and 4-D conv weights and their
  momentum), the next step equal to the reference's next step by the
  same rule;
- bf16 (as tests/test_torch_bf16.py states it, a root mean square over
  the reference's own bf16 - f32 gap): RPN outputs and both stages'
  outputs on the float32 run's RoIs within 0.8; the six losses pooled
  within 0.5, the head's on the reference's bf16 proposals (bf16 scores
  a few ulps apart trade the proposals' places, and a proposal's place
  decides which sampler draw it takes); the first step's change, the RoI
  head again on the reference's bf16 proposals, per module (its weight
  and bias pooled: a lone bias's gap is one noisy sample of a reduction
  over a feature map: one BN bias measured 5.5 of its own gap while the
  median over tensors passed) with the median over modules within 0.9
  and every module within 2.
"""
import pickle

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.ops.box_convert import delta2rbox as j_delta2rbox
from jdet_tpu.ops.box_convert import hbox_to_rbox as j_hbox_to_rbox
from jdet_tpu.ops.box_convert import rbox_to_hbox as j_rbox_to_hbox
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.parallel.spmd import build_train_step as j_build_train_step
from jdet_tpu.parallel.spmd import make_mesh
from jdet_tpu.runner.checkpoint import save_checkpoint as j_save_checkpoint
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models.boxes.assigner import hbb_overlaps
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.ops import box_iou_rotated, rbox_to_hbox
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step
from jdet_torch.runner import load_checkpoint
from test_torch_oriented_rcnn import Replay, sampler_draws
from test_torch_retinanet import _randomize_bn
from test_torch_train_step import SCHED

CFG = dict(
    type="ReDet",
    backbone=dict(type="ReResNet", depth=18, base_fields=2, frozen_stages=1),
    neck=dict(type="ReFPN", out_channels=32, num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=32, feat_channels=32, nms_pre=128, nms_post=48),
    bbox_head=dict(type="ReDetHead", num_classes=15, in_channels=32, fc_out_channels=64,
                   train_cfg=dict(sampler=dict(num=32, pos_fraction=0.25)),
                   test_cfg=dict(max_per_img=16, score_thr=0.01)),
)
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)
B, K, SIZE = 2, 8, 128
N1 = K + 48  # stage-1 candidates: the gts and the proposals
N2 = K + 32  # stage-2 candidates: the gts and the stage-1 RoIs
BF16 = torch.bfloat16
NET_GAP, LOSS_GAP = 0.8, 0.5
LOSS_KEY = jax.random.PRNGKey(3)
ROOT_KEY = jax.random.PRNGKey(0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(module):
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _n_anchors():
    return sum(3 * (SIZE // s) ** 2 for s in (4, 8, 16, 32, 64))


def head_draws(key):
    """What `ReDetHead.loss(key=key)` draws: stage 1 from the first of
    split(key), stage 2 from the second, each per image."""
    k1, k2 = jax.random.split(key)
    return sampler_draws(k1, B, N1) + sampler_draws(k2, B, N2)


def model_draws(key):
    """The six blocks `RCNN.loss(key=key)` draws: RPN pos, neg, stage-1
    pos, neg, stage-2 pos, neg."""
    k1, k2 = jax.random.split(key)
    return sampler_draws(k1, B, _n_anchors()) + head_draws(k2)


def _jax_model(cfg=CFG):
    """The reference model, built under `nnx.jit` (one compile instead of
    one per initializer shape), with random BN statistics and class
    layers of std 0.3."""
    jmodel = nnx.jit(lambda: j_build_detector(cfg, seed=0))()
    _randomize_bn(jmodel, seed=1)
    rng = np.random.RandomState(2)
    head = jmodel.bbox_head
    for kernel in (jmodel.rpn_head.rpn_cls.kernel, head.fc_cls.kernel,
                   getattr(head, "fc_cls2", head.fc_cls).kernel):
        kernel.set_value(jnp.asarray(rng.normal(0.0, 0.3, kernel.get_value().shape),
                                     jnp.float32))
    return jmodel


def _jax_bf16_twin(jmodel, cfg=CFG):
    """The same reference model built under the bf16 policy: its structure
    from `nnx.eval_shape`, its state copied from `jmodel`."""
    with j_compute_dtype_scope(jnp.bfloat16):
        twin = nnx.eval_shape(lambda: j_build_detector(cfg, seed=0))
    # copies: the train step donates its state's buffers
    nnx.update(twin, jax.tree.map(jnp.copy, nnx.state(jmodel)))
    return twin


def _port(weights, dtype=None, seed=0, cfg=CFG):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(cfg, device="cpu", load_pretrained=False, seed=seed)
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
        gt[b, :3] = np.stack([rng.uniform(30, 100, 3), rng.uniform(30, 100, 3),
                              rng.uniform(16, 60, 3), rng.uniform(8, 30, 3),
                              rng.uniform(-np.pi / 4, 3 * np.pi / 4, 3)], 1)
        labels[b, :3] = rng.randint(1, 16, 3)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def _margin(iou, thresholds, ties=True):
    """Smallest distance of IoUs (k, n) from the thresholds and (with
    `ties`) between each gt's best IoU and its best IoU below that."""
    iou = iou.double()
    best = iou.amax(1, keepdim=True)
    below = torch.where(iou < best, iou, -1.0).amax(1, keepdim=True)
    return min([(best - below).min().item() if ties else np.inf]
               + [(iou - t).abs().min().item() for t in thresholds])


def _batch(tmodel):
    """The first seed whose batch has no near tie (1e-5) in the RPN's hbb
    IoUs (0.7 / 0.3), in the scores of the proposals the RPN keeps (up to
    the first one past nms_post), in stage 1's hbb IoUs of the gts and the
    proposals (0.5), or in stage 2's rotated IoUs of the gts and the
    refined RoIs (0.5) for the loss's draws and the first train step's."""
    rpn, head = tmodel.rpn_head, tmodel.bbox_head
    anchors = torch.cat([rpn.anchor_generator.grid_anchors((SIZE // s, SIZE // s), lvl, "cpu")
                         for lvl, s in enumerate(rpn.anchor_strides)])
    tmodel.train()
    for seed in range(9, 60):
        images, targets = _draw(seed)
        t = {k: _t(v) for k, v in targets.items()}
        with torch.no_grad():
            feats = tmodel.extract_feat(_t(images))
            props = rpn.get_proposals(rpn(feats))
            # every proposal kept by the NMS, to see the score gaps up to the
            # nms_post cut: proposals a few ulps apart in score trade places
            # between the port's features and the reference's
            post, rpn.nms_post = rpn.nms_post, 10**6
            kept = rpn.get_proposals(rpn(feats))
            rpn.nms_post = post
        margin = np.inf
        for b in range(B):
            s = kept["scores"][b][kept["valid"][b]][:post + 1].double()
            margin = min(margin, (s[:-1] - s[1:]).min().item())
            gts = t["gt_bboxes"][b][t["gt_mask"][b]]
            hb = rbox_to_hbox(gts)
            margin = min(margin, _margin(hbb_overlaps(hb, anchors), (0.7, 0.3)))
            cand = torch.cat([hb, props["boxes"][b][props["valid"][b]]])
            margin = min(margin, _margin(hbb_overlaps(hb, cand), (0.5,), ties=False))
        for key in (LOSS_KEY, jax.random.fold_in(ROOT_KEY, 0)):
            draws = Replay(head_draws(jax.random.split(key)[1])[:2])
            with torch.no_grad():
                rois, valid, *_ = head._sample_rois(
                    props["boxes"], props["valid"], rbox_to_hbox(t["gt_bboxes"]),
                    t["gt_mask"], t["gt_labels"], rand=draws, gt_reg=t["gt_bboxes"])
                refined = head._refine(rois, head._stage1_forward(feats, rois, valid)[1])
            for b in range(B):
                gts = t["gt_bboxes"][b][t["gt_mask"][b]]
                cand = torch.cat([gts, refined[b][valid[b]]])
                margin = min(margin, _margin(box_iou_rotated(gts, cand), (0.5,), ties=False))
        if margin > 1e-5:
            return images, targets
    raise AssertionError("no tie-free batch")


def _trainable(flat, model):
    return {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in flat.items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale", "weight")}, model).items()}


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference, jitted: backbone and neck outputs, the RPN's outputs,
    losses and proposals, both stages' sampled RoIs and outputs, the
    head's and the model's losses and `predict`; the same network in
    bf16 on the float32 run's RoIs; its Runner's train step from the
    start (f32 and bf16), a checkpoint after it and the next step."""
    jmodel = _jax_model()
    weights = _numpy_params(jmodel)
    tmodel = _port(weights)
    images, targets = _batch(tmodel)
    ji = jnp.asarray(images)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    khead = jax.random.split(LOSS_KEY)[1]
    k1h, k2h = jax.random.split(khead)

    def outputs(m, s1=None, s2=None):
        bb = m.backbone(ji, True)
        feats = m.neck(bb, True)
        outs = m.rpn_head(feats, train=True)
        proposals = m.rpn_head.get_proposals(outs)
        head = m.bbox_head
        t = dict(jt, gt_hboxes=j_rbox_to_hbox(jt["gt_bboxes"]))
        if s1 is None:
            s = head.sample_batch(proposals, t, k1h)
            s1 = (s["rois"], s["valid"])
        x = head._shared_forward(feats, *s1)
        stage1 = (head.fc_cls(x), head.fc_reg(x))
        refined = j_delta2rbox(j_hbox_to_rbox(s1[0]), stage1[1], head.target_means,
                               head.target_stds)
        if s2 is None:
            s = jax.vmap(head._sample_rotated)(refined, s1[1], jt["gt_bboxes"], jt["gt_mask"],
                                               jt["gt_labels"], jax.random.split(k2h, B))
            s2 = (s["rois"], s["valid"])
        return {"backbone": bb, "neck": feats, "rpn_outs": outs,
                "rpn_losses": m.rpn_head.loss(outs, t, key=jax.random.split(LOSS_KEY)[0]),
                "proposals": proposals, "s1": s1, "stage1": stage1, "refined": refined,
                "s2": s2, "stage2": head._stage2_forward(feats, *s2),
                "head_losses": head.loss(feats, proposals, t, key=khead),
                "losses": m.loss(ji, jt, key=LOSS_KEY)}

    def host(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                            else np.asarray(a), tree)

    runs = {"f32": host(nnx.jit(outputs)(jmodel))}
    runs["f32"]["predict"] = host(nnx.jit(lambda m: m.predict(ji))(jmodel))
    s1, s2 = (tuple(jnp.asarray(r) for r in runs["f32"][k]) for k in ("s1", "s2"))
    jbf16 = _jax_bf16_twin(jmodel)
    # the reference's C8 convs read the policy when they are traced, not
    # when they are built: trace the bf16 model under it, as its Runner
    # and bench.py do with the policy set for the whole run
    with j_compute_dtype_scope(jnp.bfloat16):
        runs["bf16"] = host(nnx.jit(outputs)(jbf16, s1, s2))

    def train(m, n_steps, ckpt=None):
        opt = j_build_optimizer(m, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
        _, state, step = j_build_train_step(m, opt, make_mesh(n_devices=1))
        params = []
        for it in range(n_steps):
            state = step(state, ji, jt, ROOT_KEY, jnp.int32(it))[0]
            nnx.update((m, opt), state)
            params.append(_trainable(_numpy_params(m), tmodel))
            if ckpt is not None and it == 0:
                j_save_checkpoint(ckpt, m, opt, meta={"epoch": 1, "iter": 1})
        return params

    ckpt = str(tmp_path_factory.mktemp("redet") / "jax_redet_ckpt_1.pkl")
    runs["f32"]["steps"] = train(jmodel, 2, ckpt)
    with j_compute_dtype_scope(jnp.bfloat16):
        runs["bf16"]["steps"] = train(jbf16, 1)
    return weights, images, targets, runs, ckpt


def _targets(targets):
    return {k: _t(v) for k, v in targets.items()}


def _close(got, want, tol, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=tol * np.abs(want).max(),
                               err_msg=what)


def test_params_from_jax_loads_the_redet_leaves_strictly(ref):
    """The C8 convs' 5-D weights and the lifting conv's 4-D OIHW weight as
    they are, InnerBatchNorm's `bn` leaves by the BN rule, the expansion
    caches and ARF tables skipped; a 4-D weight of a module with no 4-D
    rule raises."""
    weights, *_ = ref
    model = _port(weights)
    sd = params_from_jax(weights, model)
    np.testing.assert_array_equal(sd["backbone.conv1.weight"].numpy(),
                                  weights["backbone.conv1.weight"])
    assert sd["backbone.conv1.weight"].shape == (2, 3, 7, 7)
    assert sd["backbone.layer1.0.conv2.weight"].shape == (2, 2, 8, 3, 3)
    np.testing.assert_array_equal(sd["backbone.layer2.1.bn2.bn.running_var"].numpy(),
                                  weights["backbone.layer2.1.bn2.bn.var"])
    assert not any(k.endswith(("wexp", "_src")) for k in sd)
    assert set(model.state_dict()) == set(sd)
    with pytest.raises(KeyError, match="no 4-D weight rule for REConv2d"):
        params_from_jax({"neck.lateral_convs.0.weight": np.zeros((2, 2, 1, 1), np.float32)},
                        model)
    flat = dict(weights)
    flat.pop("neck.extra_convs.0.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        load_from_jax(model, flat)


def test_build_detector_builds_the_config_at_full_width():
    cfg = load_cfg_file("configs/redet_re50_refpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    bb, neck, rpn, head = model.backbone, model.neck, model.rpn_head, model.bbox_head
    assert type(model).__name__ == "ReDet" and bb.depth == 50 and bb.frozen_stages == 1
    assert bb.out_channels == [256, 512, 1024, 2048]
    assert tuple(bb.conv1.weight.shape) == (8, 3, 7, 7)
    assert tuple(neck.lateral_convs[3].weight.shape) == (32, 256, 8, 1, 1)
    assert tuple(neck.extra_convs[0].weight.shape) == (32, 256, 8, 3, 3)
    assert (rpn.nms_pre, rpn.nms_post, rpn.num_anchors, rpn.reg_dim) == (2000, 2000, 3, 4)
    assert tuple(head.shared_fcs[0].weight.shape) == (1024, 256 * 49)
    assert tuple(head.shared_fcs2[0].weight.shape) == (1024, 256 * 49)
    assert tuple(head.fc_cls2.weight.shape) == (16, 1024)
    assert head.train_cfg["sampler"]["num"] == 512
    assert not any(p.requires_grad for p in bb.layer1.parameters())


def test_backbone_neck_and_rpn_match(ref):
    weights, images, targets, runs, _ = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    tt = _targets(targets)
    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    with torch.no_grad():
        bb = model.backbone(_t(images).permute(0, 3, 1, 2))
        feats = model.neck(bb)
        own = model.rpn_head(feats)
        outs = model.rpn_head([_t(f).permute(0, 3, 1, 2) for f in want["neck"]])
        losses = model.rpn_head.loss(outs, tt, rand=Replay(sampler_draws(
            jax.random.split(LOSS_KEY)[0], B, _n_anchors())))
        proposals = model.rpn_head.get_proposals(outs)
    for name, got in (("backbone", bb), ("neck", feats)):
        assert len(got) == len(want[name]) == (4 if name == "backbone" else 5)
        for lvl, (g, w) in enumerate(zip(got, want[name])):
            _close(g.permute(0, 2, 3, 1).numpy(), w, 1e-5, f"{name} level {lvl}")
    for lvl, (o, w) in enumerate(zip(own, want["rpn_outs"])):
        for t, wt in zip(o, w):
            _close(t.permute(0, 2, 3, 1).numpy(), wt, 1e-5, f"rpn level {lvl}, own features")
    for lvl, (o, w) in enumerate(zip(outs, want["rpn_outs"])):
        for t, wt in zip(o, w):
            np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), wt, rtol=0, atol=1e-5,
                                       err_msg=f"rpn level {lvl}")
    for k, v in want["rpn_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    wp = want["proposals"]
    v = wp["valid"]
    assert v.sum() > 20 and proposals["boxes"].shape == (B, 48, 4)
    np.testing.assert_array_equal(proposals["valid"].numpy(), v)
    np.testing.assert_allclose(proposals["boxes"].numpy()[v], wp["boxes"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(proposals["scores"].numpy()[v], wp["scores"][v], rtol=0,
                               atol=1e-6)


def test_redet_head_matches_on_the_reference_proposals(ref):
    weights, images, targets, runs, _ = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    head = model.bbox_head
    tt = _targets(targets)
    gt_h = rbox_to_hbox(tt["gt_bboxes"])
    proposals = {k: _t(v) for k, v in want["proposals"].items()}
    khead = jax.random.split(LOSS_KEY)[1]
    draws = head_draws(khead)
    feats = model.extract_feat(_t(images))
    rois, valid, *_ = head._sample_rois(proposals["boxes"], proposals["valid"], gt_h,
                                        tt["gt_mask"], tt["gt_labels"],
                                        rand=Replay(draws[:2]), gt_reg=tt["gt_bboxes"])
    np.testing.assert_array_equal(valid.numpy(), want["s1"][1])
    np.testing.assert_allclose(rois.numpy(), want["s1"][0], rtol=0, atol=1e-5)
    with torch.no_grad():
        stage1 = head._stage1_forward(feats, rois, valid)
        refined = head._refine(rois, stage1[1])
        rois2, valid2, *_ = head._sample_rois(refined, valid, tt["gt_bboxes"], tt["gt_mask"],
                                              tt["gt_labels"], rand=Replay(draws[2:]),
                                              rotated=True, encode=head._encode2)
        stage2 = head._stage2_forward(feats, rois2, valid2)
    np.testing.assert_allclose(refined.numpy(), want["refined"], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(valid2.numpy(), want["s2"][1])
    np.testing.assert_allclose(rois2.numpy(), want["s2"][0], rtol=0, atol=1e-5)
    assert int(valid2.sum()) == 2 * 32
    for stage, got in (("stage1", stage1), ("stage2", stage2)):
        for o, w in zip(got, want[stage]):
            _close(o.numpy(), w, 1e-5, stage)
    losses = head.loss(feats, proposals, dict(tt, gt_hboxes=gt_h), rand=Replay(draws))
    assert set(losses) == {"loss_cls_s1", "loss_bbox_s1", "loss_cls_s2", "loss_bbox_s2"}
    for k, v in want["head_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
        assert v > 0, k


def test_redet_loss_and_predict_match(ref):
    weights, images, targets, runs, _ = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    losses = model.loss(_t(images), _targets(targets), rand=Replay(model_draws(LOSS_KEY)))
    assert len(losses) == 6
    for k, v in want["losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    model.eval()
    got = {k: v.numpy() for k, v in model.predict(_t(images)).items()}
    wp = want["predict"]
    v = wp["valid"]
    assert v.sum() > 4 and got["boxes"].shape == wp["boxes"].shape == (B, 16, 5)
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], wp["labels"][v])
    np.testing.assert_allclose(got["scores"][v], wp["scores"][v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], wp["boxes"][v], rtol=0, atol=1e-4)


def _step(model, opt, images, targets, it):
    """One port train step on the reference's draws for iteration `it`."""
    step = build_train_step(model, opt)
    loss = model.loss
    draws = Replay(model_draws(jax.random.fold_in(ROOT_KEY, it)))
    model.loss = lambda images, targets, generator=None: loss(images, targets, rand=draws)
    step(_t(images), _targets(targets), it)
    assert not draws.blocks
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _assert_step_matches(got, want, start):
    for n, g in got.items():
        w = want[n]
        scale = np.abs(w).max()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(scale, 1e-12), err_msg=n)
        np.testing.assert_allclose(
            g - start[n], w - start[n], rtol=0,
            atol=max(1e-2 * np.abs(w - start[n]).max(), np.spacing(np.float32(scale))),
            err_msg=n)


def test_train_step_matches_and_leaves_the_frozen_stages(ref):
    weights, images, targets, runs, _ = ref
    model = _port(weights)
    start = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    got = _step(model, opt, images, targets, 0)
    _assert_step_matches(got, runs["f32"]["steps"][0], start)
    # the frozen stem and layer1 took no step and kept their expansions cached
    bb = model.backbone
    for name in ("conv1.weight", "layer1.1.conv2.weight", "layer1.0.bn1.bn.weight"):
        np.testing.assert_array_equal(got[f"backbone.{name}"], start[f"backbone.{name}"])
    assert bb.conv1.cache_on and bb.layer1[0].conv2.cache_on and not bb.layer2[0].conv2.cache_on
    for n in ("backbone.layer2.0.conv2.weight", "neck.extra_convs.0.weight",
              "bbox_head.fc_reg2.weight"):
        assert not np.array_equal(got[n], start[n]), n


def test_jax_checkpoint_resumes_into_the_reference_next_step(ref):
    """The reference's checkpoint after its first step (with the optax
    count and momentum) loads strictly into a port built from another
    seed, and the port's second step equals the reference's."""
    weights, images, targets, runs, ckpt = ref
    model = build_detector(CFG, device="cpu", load_pretrained=False, seed=7)
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    load_checkpoint(ckpt, model, opt)
    assert opt.count == 1
    with open(ckpt, "rb") as f:
        saved = pickle.load(f)
    traces = {k.split("/trace/", 1)[1]: v for k, v in saved["optimizer"].items()
              if "/trace/" in k}
    params = dict(model.named_parameters())
    buf = {n: opt.sgd.state[p]["momentum_buffer"].numpy() for n, p in params.items()
           if p in opt.sgd.state}
    assert len(buf) == sum(p.requires_grad for p in params.values())
    np.testing.assert_array_equal(buf["neck.fpn_convs.0.weight"],
                                  traces["neck/fpn_convs/0/weight"])
    np.testing.assert_array_equal(buf["backbone.layer3.0.bn2.bn.weight"],
                                  traces["backbone/layer3/0/bn2/bn/scale"])
    assert "backbone.conv1.weight" not in buf and "backbone.layer1.0.conv1.weight" not in buf
    start = {n: p.detach().numpy().copy() for n, p in params.items()}
    got = _step(model, opt, images, targets, 1)
    assert opt.count == 2
    _assert_step_matches(got, runs["f32"]["steps"][1], start)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_bf16_model_within_the_reference_gap(ref):
    """The port under the bf16 policy: the RPN's outputs, both stages'
    outputs on the float32 run's RoIs and the six losses against the
    reference's bf16 results, over its bf16 - f32 gap; then the first
    train step's change of each trainable tensor."""
    weights, images, targets, runs, _ = ref
    f32, bf16 = runs["f32"], runs["bf16"]
    model = _port(weights, BF16)
    model.train()
    head = model.bbox_head
    fracs = {}
    with torch.no_grad():
        feats = model.extract_feat(_t(images))
        outs = model.rpn_head(feats)
        assert outs[0][0].dtype == BF16 and feats[0].dtype == BF16
        stage1 = head._stage1_forward(feats, *map(_t, f32["s1"]))
        stage2 = head._stage2_forward(feats, *map(_t, f32["s2"]))
    for lvl, (o, b, f) in enumerate(zip(outs, bf16["rpn_outs"], f32["rpn_outs"])):
        for name, t, bt, ft in zip(("cls", "reg"), o, b, f):
            fracs[f"rpn level {lvl} {name}"] = (_rms(t.float().permute(0, 2, 3, 1).numpy() - bt)
                                                / _rms(bt - ft))
    for stage, got in (("stage1", stage1), ("stage2", stage2)):
        for name, t, bt, ft in zip(("cls", "reg"), got, bf16[stage], f32[stage]):
            fracs[f"{stage} {name}"] = _rms(t.float().numpy() - bt) / _rms(bt - ft)
    worst = max(fracs, key=fracs.get)
    assert fracs[worst] <= NET_GAP, f"{worst} at {fracs[worst]:.3f} of the gap: {fracs}"
    tt = _targets(targets)
    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    k_rpn, k_head = jax.random.split(LOSS_KEY)
    losses = model.rpn_head.loss(outs, tt, rand=Replay(sampler_draws(k_rpn, B, _n_anchors())))
    proposals = {k: _t(v) for k, v in bf16["proposals"].items()}
    losses.update(head.loss(feats, proposals, tt, rand=Replay(head_draws(k_head))))
    assert len(losses) == 6 and all(v.dtype == torch.float32 for v in losses.values())
    got, b, f = (np.array([d[k] for k in sorted(losses)]) for d in (
        {k: v.item() for k, v in losses.items()}, bf16["losses"], f32["losses"]))
    frac = _rms(got - b) / _rms(b - f)
    assert frac <= LOSS_GAP, f"losses at {frac:.3f} of the gap: {got} {b} {f}"

    start = {k: v.numpy() for k, v in params_from_jax(weights, model).items()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    model.rpn_head.get_proposals = lambda outs: proposals
    stepped = _step(model, opt, images, targets, 0)
    # per module (a conv's or an FC's weight and bias, a norm's scale and
    # bias): the gap of a single small tensor, a reduction over a whole
    # feature map, is itself one noisy sample of the bf16 rounding
    diffs, gaps = {}, {}
    for n, g in stepped.items():
        if not model.get_parameter(n).requires_grad:
            continue
        bt, ft = bf16["steps"][0][n] - start[n], f32["steps"][0][n] - start[n]
        mod = n.rsplit(".", 1)[0]
        diffs.setdefault(mod, []).append((g - start[n] - bt).ravel())
        gaps.setdefault(mod, []).append((bt - ft).ravel())
    step_fracs = {m: _rms(np.concatenate(diffs[m])) / _rms(np.concatenate(gaps[m]))
                  for m in diffs}
    median = float(np.median(list(step_fracs.values())))
    worst = max(step_fracs, key=step_fracs.get)
    assert median <= 0.9, f"median step change at {median:.3f} of the gap"
    assert step_fracs[worst] <= 2.0, f"{worst} at {step_fracs[worst]:.3f} of the gap"
