"""LSKNet-S / StripNet-S on the two-stage heads in jdet_torch against
jdet_tpu, on the CPU: `LSKNet`, `StripNet`, `StripHead`, `StripRCNN`,
and Oriented R-CNN on LSKNet.

The models are narrow (`embed_dims=(8, 16, 24, 32)`, one block per stage,
FPN 32, RPN nms_pre 128 / nms_post 64, 48 sampled RoIs, fc_out_channels
64, B=2 at 128²), their weights drawn from a numpy seed (kernels with
variance 1/fan_in, BN and LayerNorm affines and statistics and the layer
scales at random, the class layers with std 0.3 so that scores do not
tie) and given to both packages. The reference is built abstract
(`nnx.eval_shape`) and filled, and runs under `nnx.jit`; its samplers'
uniforms are replayed into the port (`Replay`, as
tests/test_torch_oriented_rcnn.py does), on a batch without near ties in
either assignment. Tolerances:
- backbone features in float32 within 1e-5 of each level's largest
  magnitude, in eval mode and in training mode with `norm_eval=False`
  (the BN running statistics after the call within 1e-5 of their
  largest); under the bf16 policy, the RMS distance to the reference's
  bf16 features within 0.9 of the reference's own bf16 - f32 gap at
  each level (conv sum-order flips cascade through the blocks, as
  tests/test_torch_bf16.py states; bf16 GELU, sigmoid and BN follow
  XLA's step-by-step arithmetic, without which the levels sit at about
  1.0 of the gap);
- the RPN's and the RoI head's outputs within 1e-5 of their largest
  value; the losses rtol 1e-5; `predict`'s boxes within 1e-3 px and
  scores within 1e-4 on the same valid slots, the labels equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.pretrained import assign_flat, flat_paths
from jdet_tpu.ops.box_convert import rbox_to_hbox as j_rbox_to_hbox
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.optim import build_lr_schedule, build_optimizer
from test_torch_oriented_rcnn import (B, K, Replay, _batch, _n_anchors, _t, _targets,
                                      model_draws, sampler_draws)
from test_torch_pretrained import _abstract

NARROW = dict(embed_dims=(8, 16, 24, 32), depths=(1, 1, 1, 1))
HEAD_KW = dict(num_classes=15, in_channels=32, fc_out_channels=64,
               featmap_strides=(4, 8, 16, 32),
               train_cfg=dict(sampler=dict(num=48, pos_fraction=0.25)),
               test_cfg=dict(max_per_img=16, score_thr=0.01))
RPN = dict(type="OrientedRPNHead", in_channels=32, feat_channels=32,
           anchor_strides=(4, 8, 16, 32, 64), nms_pre=128, nms_post=64)
CFGS = {
    "lsknet": dict(type="OrientedRCNN", backbone=dict(type="LSKNet", arch="t", **NARROW),
                   neck=dict(type="FPN", out_channels=32, num_outs=5), rpn_head=RPN,
                   bbox_head=dict(type="OrientedHead", **HEAD_KW)),
    "strip": dict(type="StripRCNN", backbone=dict(type="StripNet", arch="s", **NARROW),
                  neck=dict(type="FPN", out_channels=32, num_outs=5), rpn_head=RPN,
                  bbox_head=dict(type="StripHead", **HEAD_KW)),
}
BF16 = torch.bfloat16
# measured 0.63-0.81 (both families, 4 levels); with GELU and the sigmoid
# each rounded once and the BN's bf16 rsqrt rounded twice, LSKNet's levels
# read 0.99-1.08 of the gap
FEATURE_GAP = 0.9


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _weights(module, seed):
    """A value for every leaf of the reference `module`, from a seed."""
    rng = np.random.RandomState(seed)
    _, flat = flat_paths(module)
    out = {}
    for path, var in flat.items():
        shape = tuple(var.get_value().shape)
        leaf = path.rsplit(".", 1)[-1]
        if leaf == "kernel":
            std = 0.3 if path.endswith(("rpn_cls.kernel", "fc_cls.kernel")) else (
                1.0 / np.sqrt(np.prod(shape[:-1])))
            v = rng.normal(0.0, std, shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("ls1", "ls2"):
            v = rng.uniform(0.05, 0.2, shape)
        else:  # bias, mean
            v = rng.normal(0.0, 0.1, shape)
        out[path] = v.astype(np.float32)
    return out


def _jax_model(cfg, weights=None, dtype=None, seed=1):
    with j_compute_dtype_scope(dtype):
        jm = _abstract(lambda rngs: j_build_detector(cfg, rngs=rngs, load_pretrained=False))
    weights = _weights(jm, seed) if weights is None else weights
    assign_flat(jm, weights, strict=True)
    return jm, weights


def _port(cfg, weights, dtype=None):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(cfg, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def _host(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                        else np.asarray(a), tree)


@pytest.fixture(scope="module", params=sorted(CFGS))
def ref(request):
    """One family's reference run, jitted once: the backbone's features,
    the RPN's outputs and proposals, the RoI head's sampled RoIs, outputs
    and losses, the model's losses and `predict`; the bf16 twin's
    features. Also the weights and the batch."""
    name = request.param
    cfg = CFGS[name]
    jmodel, weights = _jax_model(cfg)
    tmodel = _port(cfg, weights)
    images, targets = _batch(tmodel)
    ji, jt = jnp.asarray(images), _targets(targets, "jax")
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)

    def outputs(m):
        feats = m.backbone(ji, False)
        neck = m.neck(feats, False)
        outs = m.rpn_head(neck, train=True)
        proposals = m.rpn_head.get_proposals(outs)
        head = m.bbox_head
        t = dict(jt, gt_hboxes=j_rbox_to_hbox(jt["gt_bboxes"]))
        rois = jax.vmap(head._sample_rois)(
            proposals["boxes"], proposals["valid"], jt["gt_bboxes"], jt["gt_mask"],
            jt["gt_labels"], jax.random.split(k2, B))[:2]
        return {"feats": feats, "rpn_outs": outs, "rpn_losses": m.rpn_head.loss(outs, t, key=k1),
                "proposals": proposals, "rois": rois, "head_outs": head._forward_rois(neck, *rois),
                "head_losses": head.loss(neck, proposals, jt, key=k2),
                "losses": m.loss(ji, jt, key=key), "predict": m.predict(ji)}

    run = _host(nnx.jit(outputs)(jmodel))
    jbf16, _ = _jax_model(cfg, weights, jnp.bfloat16)
    run["bf16_feats"] = _host(nnx.jit(lambda m: m.backbone(ji, False))(jbf16))
    return name, weights, images, targets, run


def _features(model, images):
    with torch.no_grad():
        return [f.float().permute(0, 2, 3, 1).numpy()
                for f in model.backbone(_t(images).permute(0, 3, 1, 2).contiguous())]


def test_backbone_features_match(ref):
    name, weights, images, _, run = ref
    model = _port(CFGS[name], weights)
    for lvl, (got, want) in enumerate(zip(_features(model, images), run["feats"])):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{name} level {lvl}")


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_backbone_bf16_within_the_reference_gap(ref):
    name, weights, images, _, run = ref
    model = _port(CFGS[name], weights, BF16)
    fracs = {}
    for lvl, (got, b, f) in enumerate(zip(_features(model, images), run["bf16_feats"],
                                           run["feats"])):
        fracs[lvl] = _rms(got - b) / _rms(b - f)
    assert max(fracs.values()) <= FEATURE_GAP, f"{name}: fractions of the gap {fracs}"


def test_backbone_trains_its_norms_as_flax_does_without_norm_eval():
    """`norm_eval=False` in training mode: the BNs normalize with the
    batch statistics and move their running ones by flax's momentum 0.9,
    biased variance included."""
    bcfg = dict(type="LSKNet", arch="t", norm_eval=False, **NARROW)
    from jdet_tpu.utils.registry import BACKBONES as JBACKBONES
    from jdet_torch.utils.registry import BACKBONES

    kw = {k: v for k, v in bcfg.items() if k != "type"}
    jbb = _abstract(lambda rngs: JBACKBONES.get("LSKNet")(rngs=rngs, **kw))
    weights = _weights(jbb, seed=5)
    assign_flat(jbb, weights, strict=True)
    tbb = BACKBONES.get("LSKNet")(**kw)
    load_from_jax(tbb, weights)
    tbb.train()
    images = np.random.RandomState(6).rand(2, 64, 64, 3).astype(np.float32)
    want = _host(nnx.jit(lambda m: m(jnp.asarray(images), True))(jbb))
    with torch.no_grad():
        got = tbb(_t(images).permute(0, 3, 1, 2).contiguous())
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=f"level {lvl}")
    _, flat = flat_paths(jbb)
    stats = {k: np.asarray(v.get_value()) for k, v in flat.items() if k.endswith((".mean", ".var"))}
    assert len(stats) == 2 * 3 * 4
    sd = params_from_jax(stats, tbb)
    state = tbb.state_dict()
    for k, v in sd.items():
        assert not np.array_equal(v.numpy(), weights[k.replace("running_mean", "mean")
                                                          .replace("running_var", "var")]), k
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(v.numpy()).max(), err_msg=k)


def test_rpn_and_roi_head_outputs_and_losses_match(ref):
    """On the reference's proposals: the RPN's outputs and losses, the
    RoI sampling, the RoI head's outputs (`StripHead`'s strip convs
    included) and its losses."""
    name, weights, images, targets, run = ref
    model = _port(CFGS[name], weights)
    model.train()
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    tt = _targets(targets, "torch")
    from jdet_torch.ops import rbox_to_hbox

    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    feats = model.extract_feat(_t(images))
    with torch.no_grad():
        outs = model.rpn_head(feats)
        for lvl, (o, w) in enumerate(zip(outs, run["rpn_outs"])):
            for t, wt in zip(o, w):
                np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), wt, rtol=0,
                                           atol=1e-5 * np.abs(wt).max(), err_msg=f"level {lvl}")
        losses = model.rpn_head.loss(outs, tt, rand=Replay(sampler_draws(k1, B,
                                                                          _n_anchors(model))))
    for k, v in run["rpn_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    proposals = {k: _t(v) for k, v in run["proposals"].items()}
    head = model.bbox_head
    rois, valid, *_ = head._sample_rois(
        proposals["boxes"], proposals["valid"], _t(targets["gt_bboxes"]),
        _t(targets["gt_mask"]), _t(targets["gt_labels"]),
        rand=Replay(sampler_draws(k2, B, K + 64)))
    np.testing.assert_array_equal(valid.numpy(), run["rois"][1])
    np.testing.assert_allclose(rois.numpy(), run["rois"][0], rtol=0, atol=1e-5)
    with torch.no_grad():
        outs = head._forward_rois(feats, _t(run["rois"][0]), _t(run["rois"][1]))
    for o, w in zip(outs, run["head_outs"]):
        np.testing.assert_allclose(o.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())
    losses = head.loss(feats, proposals, _targets(targets, "torch"),
                       rand=Replay(sampler_draws(k2, B, K + 64)))
    for k, v in run["head_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)


def test_detector_losses_and_predict_match(ref):
    name, weights, images, targets, run = ref
    model = _port(CFGS[name], weights)
    assert type(model).__name__ == CFGS[name]["type"]
    model.train()
    losses = model.loss(_t(images), _targets(targets, "torch"),
                        rand=Replay(model_draws(jax.random.PRNGKey(3), B, _n_anchors(model),
                                                K + 64)))
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"}
    for k, v in run["losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
        assert v > 0, k
    model.eval()
    got = {k: v.numpy() for k, v in model.predict(_t(images)).items()}
    want = run["predict"]
    v = want["valid"]
    assert v.sum() > 4 and got["boxes"].shape == want["boxes"].shape == (B, 16, 5)
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-3)


# the configs -------------------------------------------------------------------

def test_lsknet_config_builds_at_full_width_with_adamw():
    """`configs/oriented_rcnn_lsknet_s_fpn_1x_dota.py` from its file: the
    LSKNet-S shapes (64-128-320-512, depths 2-2-4-2), every parameter and
    statistic of the reference's model under the port's names, and the
    config's AdamW."""
    cfg = load_cfg_file("configs/oriented_rcnn_lsknet_s_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    bb = model.backbone
    assert type(model).__name__ == "OrientedRCNN" and type(bb).__name__ == "LSKNet"
    assert bb.out_channels == [64, 128, 320, 512]
    assert [len(s) for s in bb.stages] == [2, 2, 4, 2] and bb.norm_eval
    assert tuple(bb.stages[1][0].attn.gate.conv_spatial.weight.shape) == (128, 1, 7, 7)
    jm = _abstract(lambda rngs: j_build_detector(cfg["model"], rngs=rngs, load_pretrained=False))
    _, flat = flat_paths(jm)
    shapes = params_from_jax({k: np.zeros(v.get_value().shape, np.float32)
                              for k, v in flat.items()}, model)
    state = model.state_dict()
    assert set(shapes) == set(state)
    assert all(tuple(shapes[k].shape) == tuple(v.shape) for k, v in state.items())
    ocfg = cfg["optimizer"]
    opt = build_optimizer(model, opt_type=ocfg["type"], lr_schedule=build_lr_schedule(ocfg["lr"]),
                          weight_decay=ocfg["weight_decay"], grad_clip=ocfg["grad_clip"])
    assert opt.kind == "adamw" and opt.max_norm == 35
    assert opt.inner.param_groups[0]["weight_decay"] == 0.05


def test_committed_strip_config_is_refused_by_both_packages():
    """`configs/strip_rcnn_stripnet_s_fpn_1x_dota.py` as committed puts the
    hbb `RPNHead` under `StripHead`: the reference fails in its loss
    (concatenating (B, K, 5) gts with (B, N, 4) proposals,
    `oriented_head.py:121`), the port refuses to build it; with
    `OrientedRPNHead` both build."""
    cfg = load_cfg_file("configs/strip_rcnn_stripnet_s_fpn_1x_dota.py")["model"]
    assert cfg["rpn_head"]["type"] == "RPNHead" and cfg["bbox_head"]["type"] == "StripHead"
    with pytest.raises(ValueError, match="oriented_head.py:121"):
        build_detector(cfg, device="cpu", load_pretrained=False)
    jm = _abstract(lambda rngs: j_build_detector(cfg, rngs=rngs, load_pretrained=False))
    images = jnp.zeros((1, 128, 128, 3), jnp.float32)
    targets = {"gt_bboxes": jnp.full((1, 4, 5), 20.0), "gt_labels": jnp.ones((1, 4), jnp.int32),
               "gt_mask": jnp.ones((1, 4), bool)}
    with pytest.raises(TypeError, match="concatenate"):
        nnx.eval_shape(lambda m: m.loss(images, targets), jm)
    fixed = dict(cfg, rpn_head=dict(cfg["rpn_head"], type="OrientedRPNHead"))
    model = build_detector(fixed, device="cpu", load_pretrained=False)
    assert type(model).__name__ == "StripRCNN" and model.bbox_head.strip_h.groups == 256
