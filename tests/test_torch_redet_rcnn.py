"""RoI-Transformer against jdet_tpu, and ReDet's expanded-weight cache
through the Runner, on the CPU.

RoI-Transformer is `configs/roi_transformer_r50_fpn_1x_dota.py`'s model
at the size of tests/test_torch_redet.py (ResNet-18 with frozen_stages=1,
FPN 32, `RPNHead`, `RoITransHead` whose stage 2 aligns with w, h
enlarged by (1.2, 1.4)), its weights carried over by `params_from_jax`,
the samplers fed the reference's draws, the reference jitted, on a batch
without near ties. Tolerances: the six losses rtol 1e-5, `predict`'s
boxes atol 1e-4 and scores atol 1e-5 on the same valid slots.

The cache: a ReDet predict with every expansion cached is bit-identical
to the live one; building the train step leaves only the frozen stem's
and layer1's expansions cached, and a step after an inference cycle
gives every trainable base weight a gradient; the Runner caches every
expansion for `val` and `test` and keeps the frozen ones only
afterwards, and refills the frozen ones from loaded weights.
"""
import os
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_torch.data.synthetic import make_synthetic_dota
from jdet_torch.models.builder import build_detector
from jdet_torch.models.equivariant import REConv2d, REConv2dLift, cache_expanded_weights
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step
from jdet_torch.runner import Runner
from test_torch_redet import (
    B, CFG, LOSS_KEY, OPT_KW, Replay, _batch, _jax_model, _numpy_params, _port, _t,
    _targets, model_draws,
)
from test_torch_train_step import SCHED

ROI_TRANS = dict(
    type="RoITransformer",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=32, num_outs=5),
    rpn_head=dict(type="RPNHead", in_channels=32, feat_channels=32, nms_pre=128, nms_post=48),
    bbox_head=dict(type="RoITransHead", num_classes=15, in_channels=32, fc_out_channels=64,
                   train_cfg=dict(sampler=dict(num=32, pos_fraction=0.25)),
                   test_cfg=dict(max_per_img=16, score_thr=0.01)),
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TensorBoard's import takes ~20 s where TensorFlow is installed."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_roi_transformer_loss_and_predict_match():
    jmodel = _jax_model(ROI_TRANS)
    weights = _numpy_params(jmodel)
    model = _port(weights, cfg=ROI_TRANS)
    assert type(model).__name__ == "RoITransformer"
    assert model.bbox_head.roi_extractor2.extend_factor == (1.2, 1.4)
    images, targets = _batch(model)
    ji = jnp.asarray(images)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    want_losses, want_det = nnx.jit(lambda m: (m.loss(ji, jt, key=LOSS_KEY), m.predict(ji)))(
        jmodel)
    model.train()
    losses = model.loss(_t(images), _targets(targets), rand=Replay(model_draws(LOSS_KEY)))
    assert set(losses) == set(want_losses) and len(losses) == 6
    for k, v in want_losses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5, err_msg=k)
        assert float(v) > 0, k
    model.eval()
    got = {k: v.numpy() for k, v in model.predict(_t(images)).items()}
    wp = {k: np.asarray(v) for k, v in want_det.items()}
    v = wp["valid"]
    assert v.sum() > 4 and got["boxes"].shape == (B, 16, 5)
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], wp["labels"][v])
    np.testing.assert_allclose(got["scores"][v], wp["scores"][v], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["boxes"][v], wp["boxes"][v], rtol=0, atol=1e-4)


def _expanded(model):
    return [m for m in model.modules() if isinstance(m, (REConv2d, REConv2dLift))]


def _frozen(model):
    bb = model.backbone
    return {id(m) for part in (bb.conv1, bb.layer1) for m in part.modules()
            if isinstance(m, (REConv2d, REConv2dLift))}


def test_redet_cached_predict_is_exact_and_training_after_it_reaches_the_weights():
    model = build_detector(CFG, device="cpu", load_pretrained=False, seed=3)
    model.bbox_head.test_cfg = dict(model.bbox_head.test_cfg, score_thr=0.0)
    model.eval()
    images = torch.rand(B, 128, 128, 3, generator=torch.Generator().manual_seed(0))
    live = model.predict(images)
    # the stem, 8 blocks of 3 convs, 4 downsamples, 4 lateral, 4 output and 1 extra
    assert cache_expanded_weights(model) == len(_expanded(model)) == 38
    cached = model.predict(images)
    for k in live:
        assert torch.equal(cached[k], live[k]), k
    assert int(live["valid"].sum()) > 0

    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    step = build_train_step(model, opt)
    frozen = _frozen(model)
    assert {id(m) for m in _expanded(model) if m.cache_on} == frozen
    assert all(m.wexp.numel() == 0 for m in _expanded(model) if id(m) not in frozen)
    gt = torch.zeros(B, 8, 5)
    gt[:, :2] = torch.tensor([[60.0, 60.0, 40.0, 20.0, 0.4], [90.0, 40.0, 30.0, 15.0, -0.2]])
    targets = {"gt_bboxes": gt, "gt_labels": torch.tensor([[3, 7] + [0] * 6] * B),
               "gt_mask": torch.tensor([[True, True] + [False] * 6] * B)}
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    log_vars = step(images, targets, 0)
    assert all(np.isfinite(v.item()) for v in log_vars.values())
    for n, p in model.named_parameters():
        if p.requires_grad and p.dim() == 5:  # the C8 convs' base weights
            assert p.grad is not None and p.grad.abs().sum() > 0, n
            assert not torch.equal(p, before[n]), n
        elif not p.requires_grad:
            assert torch.equal(p, before[n]), n


def test_runner_caches_redet_expansions_around_inference(tmp_path, monkeypatch):
    """`run()` of the small ReDet config (1 epoch of 2 iterations, a val, a
    checkpoint, a test): every predict sees every expansion cached, the
    steps see only the frozen ones, and a load refills the frozen ones."""
    from test_torch_runner import _mini_cfg

    img_dir, ann = make_synthetic_dota(str(tmp_path), n_images=4, size=128, n_obj=(2, 5), seed=1)
    model_cfg = dict(CFG, bbox_head=dict(CFG["bbox_head"],
                                         test_cfg=dict(max_per_img=16, score_thr=0.0)))
    cfg = _mini_cfg(str(tmp_path), img_dir, ann, max_epoch=1, model=model_cfg)
    runner = Runner(cfg, device="cpu")
    model = runner.model
    frozen = _frozen(model)
    seen = []
    predict, loss = model.predict, model.loss

    def record(kind, fn):
        def wrapped(*a, **kw):
            seen.append((kind, {id(m) for m in _expanded(model) if m.cache_on}))
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(model, "predict", record("predict", predict))
    monkeypatch.setattr(model, "loss", record("loss", loss))
    runner.run()
    assert (runner.epoch, runner.iter) == (1, 2)
    every = {id(m) for m in _expanded(model)}
    kinds = [k for k, _ in seen]
    assert kinds.count("loss") == 2 and kinds.count("predict") >= 2
    for kind, cached in seen:
        assert cached == (every if kind == "predict" else frozen), kind
    assert {id(m) for m in _expanded(model) if m.cache_on} == frozen
    assert os.path.exists(os.path.join(runner.work_dir, "test", "test_1.pkl"))
    # a load moves the weights on: the frozen expansions come from the new ones
    with torch.no_grad():
        model.backbone.conv1.weight.mul_(0.5)
    runner.load(os.path.join(runner.work_dir, "checkpoints", "ckpt_1.pkl"))
    torch.testing.assert_close(model.backbone.conv1.wexp, model.backbone.conv1._expand(),
                               rtol=0, atol=0)
