"""Res2Net (`models/backbones/res2net.py`) and Rotated RetinaNet-OBB on it,
in jdet_torch against jdet_tpu, on the CPU.

- Res2Net-50 (26w x 4s, frozen_stages 1, norm_eval off) on 2-image
  batches, its weights drawn from a seed and carried strictly through
  `params_from_jax`: eval-mode features at 40² (stages of 5 and 3
  pixels: odd sizes under the stride-2 split convs and the "stage"
  average pool; the RetinaNet below runs it at 64²) atol 1e-4 of each
  output's largest value (16 blocks sum in another order); train-mode
  features at 40² atol 5e-3 of it (stage
  4's batch statistics are taken over 8 values a channel, which cancel;
  the port in float64 reads the same distances), and the BN statistics
  that pass leaves (momentum 0.9) within 1e-3 of each tensor's largest
  value, for the same reason; frozen stages take no gradient;
- a torchvision-style Res2Net file through `backbone.pretrained`'s
  converter, `load_torch_resnet` and the `Resnet18`...`Resnet152`
  registry names, exactly;
- `configs/rotated_retinanet_obb_r50_fpn_1x_dota.py` with the backbone
  overridden to Res2Net-50, as `chip_smoke.py` runs it (FPN and head at
  32 channels here, 64², B=2), on a batch without near ties in the
  assigner: the loss forward rtol 1e-4 and `predict` (boxes atol 1e-3,
  scores atol 1e-5 on the same slots), the reference compiled once with
  XLA's fusion off, its loss and `predict` on one forward (under
  `norm_eval` the loss's train-mode backbone is the eval one).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.backbones.res2net import Res2Net as JRes2Net
from jdet_tpu.models.pretrained import assign_flat as j_assign_flat
from jdet_tpu.models.pretrained import backbone_to_flat as j_backbone_to_flat
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.config import load_cfg_file
from jdet_torch.models.backbones import Res2Net, load_torch_resnet
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.pretrained import assign_state, backbone_to_flat
from jdet_torch.ops import box_iou_rotated
from jdet_torch.parallel import make_device_normalizer
from jdet_torch.utils.registry import BACKBONES
from test_torch_pretrained import (_abstract, _assert_same_state, _backbones, _source_sd,
                                   _torchvision_name)
from torch_single_stage_parity import (MEAN, STD, assert_predict_matches, compile_unfused,
                                       jax_model, make_batch, numpy_params, port, t,
                                       weights_for)

RES2NET = dict(type="Res2Net", depth=50, scales=4, base_width=26, frozen_stages=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the backbone ----------------------------------------------------------------------

@functools.cache
def _backbone_run():
    """Both backbones from one set of weights, and the reference's eval
    and train features at 40² and its BN statistics after them (one
    function compiled once, with XLA's fusion on: the backbone has no IoU
    whose fused recomputation could tie apart, and Res2Net's 16 blocks
    compile in a third of the fusion-off time)."""
    kw = dict(depth=50, scales=4, base_width=26, frozen_stages=1, norm_eval=False)
    jm = _abstract(lambda rngs: JRes2Net(rngs=rngs, **kw))
    weights = weights_for(jm, ())
    j_assign_flat(jm, weights, strict=True)
    tm = Res2Net(**kw)
    load_from_jax(tm, weights)
    x40 = np.random.RandomState(0).normal(0, 1, (2, 40, 40, 3)).astype(np.float32)
    graphdef, state = nnx.split(jm)

    def run(state, x):
        m = nnx.merge(graphdef, state)
        evals = m(x, train=False)
        trains = m(x, train=True)
        return evals, trains, nnx.state(m)

    evals, trains, state = jax.jit(run)(state, x40)
    nnx.update(jm, state)
    return tm, x40, evals, trains, numpy_params(jm)


def _assert_features(got, want, tol=1e-4):
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        w = np.asarray(w)
        g = g.detach().permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape, (i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * np.abs(w).max(),
                                   err_msg=f"stage {i + 1}")


def test_res2net_features_match_at_even_and_odd_sizes():
    tm, x40, evals, trains, after = _backbone_run()
    assert [f.shape[1] for f in trains] == [10, 5, 3, 2]
    tm.eval()
    with torch.no_grad():
        _assert_features(tm(t(x40).permute(0, 3, 1, 2)), evals)
    tm.train()
    _assert_features(tm(t(x40).permute(0, 3, 1, 2)), trains, tol=5e-3)
    # the running statistics the train pass left: the stem and stage 1's
    # (frozen) unchanged, the others moved by flax's momentum 0.9
    state = tm.state_dict()
    moved = 0
    for k, v in params_from_jax(after, tm).items():
        if "running" in k:
            want = v.numpy()
            np.testing.assert_allclose(state[k].numpy(), want, rtol=0,
                                       atol=1e-3 * np.abs(want).max(), err_msg=k)
            moved += not k.startswith(("bn1.", "layer1."))
    assert moved > 100


def test_res2net_freezes_the_stem_and_stage_one():
    tm = Res2Net(depth=50, frozen_stages=1)
    assert tm.layer1[0].stype == "stage" and tm.layer1[1].stype == "normal"
    assert len(tm.layer1[0].convs) == 3 and tm.layer1[0].width == 26
    frozen = {n for n, p in tm.named_parameters() if not p.requires_grad}
    assert frozen == {n for n, _ in tm.named_parameters() if n.startswith(("conv1.", "bn1.",
                                                                          "layer1."))}
    tm.train()
    assert not tm.layer2[0].bns[0].training  # norm_eval
    assert tm.out_channels == [256, 512, 1024, 2048]


def test_res2net_and_resnet_imports_equal_the_reference():
    """A torchvision-style Res2Net file through the converter (its
    `convs.i` / `bns.i` keep their names), `load_torch_resnet` on a
    torchvision ResNet-18, and the JDet registry names."""
    jm, tm = _backbones("resnet", depth=18)
    jr2 = _abstract(lambda rngs: JRes2Net(depth=50, rngs=rngs))
    tr2 = Res2Net(depth=50)
    sd = _source_sd(tr2, _torchvision_name, seed=3)
    assert "layer2.0.convs.2.weight" in sd and "layer3.0.downsample.0.weight" in sd
    _, missing, unexpected = j_assign_flat(jr2, j_backbone_to_flat(jr2, sd), strict=True)
    assert not missing and not unexpected
    _, missing, unexpected = assign_state(tr2, backbone_to_flat(tr2, sd), strict=True)
    assert not missing and not unexpected
    _assert_same_state(jr2, tr2)
    from jdet_tpu.models.backbones.resnet import load_torch_resnet as j_load_torch_resnet

    sd = _source_sd(tm, _torchvision_name, seed=4)
    sd["fc.weight"], sd["fc.bias"] = np.ones((10, 512), np.float32), np.ones(10, np.float32)
    jm = _abstract(lambda rngs: __import__("jdet_tpu.models.backbones.resnet", fromlist=["x"])
                   .ResNet(depth=18, rngs=rngs))
    j_assign_flat(jm, weights_for(jm, ()), strict=True)
    j_load_torch_resnet(jm, sd)
    assert load_torch_resnet(tm, sd) is tm
    _assert_same_state(jm, tm)
    with pytest.raises(KeyError):
        load_torch_resnet(tm, {k: v for k, v in sd.items() if k != "layer1.0.conv1.weight"})
    for depth in (18, 34, 50, 101, 152):
        m = BACKBONES.get(f"Resnet{depth}")(frozen_stages=1)
        assert type(m).__name__ == "ResNet" and m.depth == depth and m.frozen_stages == 1


# Rotated RetinaNet-OBB on Res2Net-50 ---------------------------------------------------

def _retina_cfg():
    """The committed RetinaNet config with the Res2Net backbone, FPN and
    head narrowed to 32 channels and one tower conv."""
    cfg = load_cfg_file("configs/rotated_retinanet_obb_r50_fpn_1x_dota.py")["model"]
    cfg["backbone"] = dict(RES2NET)
    cfg["neck"] = dict(cfg["neck"], out_channels=32)
    cfg["bbox_head"] = dict(cfg["bbox_head"], in_channels=32, feat_channels=32, stacked_convs=1,
                            test_cfg=dict(nms_pre=256, max_per_img=32, score_thr=0.0))
    return cfg


def _margin(gts, mask, anchors):
    """The smallest gap between a gt's best IoU and its best IoU below that
    (the largest anchors, 1x1 maps at 64², hold a small gt whole, each at
    the same IoU, a tie exact in any rounding), and between an anchor's
    best IoU and either threshold."""
    margin = np.inf
    for b in range(len(gts)):
        iou = box_iou_rotated(t(gts[b][mask[b]]), anchors).double()
        top = iou.amax(1, keepdim=True)
        below = torch.where(iou < top, iou, -1.0).amax(1)
        best = iou.max(0).values
        margin = min(margin, (top[:, 0] - below).min().item(),
                     (best - 0.5).abs().min().item(), (best - 0.4).abs().min().item())
    return margin


@functools.cache
def _retina_run():
    cfg = _retina_cfg()
    jmodel, weights = jax_model(cfg, ("bbox_head.retina_cls",))
    tmodel = port(cfg, weights)
    head = tmodel.bbox_head
    anchors = head._flat_anchors([(64 // s, 64 // s) for s in head.anchor_strides], "cpu")
    for seed in range(1, 40):
        u8, targets = make_batch(seed, size=64, K=6, real=3)
        targets["gt_bboxes"][..., :2] *= 0.5
        targets["gt_bboxes"][..., 2:4] *= 0.6
        if _margin(targets["gt_bboxes"], targets["gt_mask"], anchors) > 1e-5:
            break
    else:
        raise AssertionError("no tie-free batch")
    images = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    graphdef, state = nnx.split(jmodel)

    def run(state):
        m = nnx.merge(graphdef, state)
        outs = m.bbox_head(m.extract_feat(images))
        return j_parse_losses(m.bbox_head.loss(outs, jt))[1], m.bbox_head.predict(outs)

    losses, det = compile_unfused(run, state)(state)
    return tmodel, u8, targets, jax.tree.map(np.asarray, losses), jax.tree.map(np.asarray, det)


def test_res2net_retinanet_loss_forward_and_predict_match():
    tmodel, u8, targets, want_losses, want_det = _retina_run()
    assert type(tmodel.backbone).__name__ == "Res2Net"
    images = make_device_normalizer(MEAN, STD)(t(u8))
    tmodel.train()
    losses = tmodel.loss(images, {k: t(v) for k, v in targets.items()})
    assert set(losses) == {"loss_cls", "loss_bbox"}
    for k, v in losses.items():
        assert float(want_losses[k]) > 0, k
        np.testing.assert_allclose(v.item(), float(want_losses[k]), rtol=1e-4, err_msg=k)
    tmodel.eval()
    with torch.no_grad():
        got = {k: v.numpy() for k, v in tmodel.predict(images).items()}
    v = want_det["valid"]
    assert v.sum() > 4
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want_det["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want_det["scores"][v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], want_det["boxes"][v], rtol=0, atol=1e-3)


def test_the_full_width_res2net_retinanet_builds():
    cfg = load_cfg_file("configs/rotated_retinanet_obb_r50_fpn_1x_dota.py")["model"]
    cfg["backbone"] = dict(RES2NET)
    model = build_detector(cfg, device="cpu", load_pretrained=False)
    assert type(model.backbone).__name__ == "Res2Net" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(model.bbox_head.cls_convs) == 4
    n = sum(p.numel() for p in model.backbone.parameters())
    assert 23_000_000 < n < 24_000_000  # Res2Net-50 26w x 4s without its classifier
