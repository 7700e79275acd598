"""Checkpoints, the Runner and the CLI of jdet_torch, on the CPU.

- A checkpoint that `jdet_tpu.runner.checkpoint.save_checkpoint` wrote
  loads into the port, which then predicts like the JAX model at the
  tolerances of tests/test_torch_retinanet.py (head outputs atol 1e-4;
  predict on the JAX head outputs: the same valid slots and labels,
  scores rtol 1e-6).
- A save/load round trip of the port gives the next train step bit for
  bit.
- The Runner on a mini DOTA tree (ResNet-18, FPN 64, 128², B=2): its
  per-iteration losses equal those of `build_train_step` driven by hand
  over the same batches (that step is held against JAX in
  tests/test_torch_train_step.py); val, save, resume, test and
  `test_time` work; the CLI trains in a subprocess.
"""
import json
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.runner.checkpoint import save_checkpoint as j_save_checkpoint
from jdet_tpu.runner.runner import _unflip_dets as j_unflip_dets
from jdet_torch.data.dota import DOTADataset
from jdet_torch.data.image_io import imread
from jdet_torch.data.synthetic import make_synthetic_dota
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import params_from_jax
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_augmenter, make_device_normalizer
from jdet_torch.runner import Runner, load_checkpoint, save_checkpoint
from jdet_torch.runner import runner as runner_module
from jdet_torch.tools import merge_results as merge_cli
from jdet_torch.tools import run_net
from jdet_torch.utils.logger import RunLogger
from test_torch_retinanet import CFG, _numpy_params, _randomize_bn
from test_torch_train_step import _assert_close_per_tensor, _assignment_margin, _batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made these small models ~10x
    slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    """TensorBoard's import takes ~20 s where TensorFlow is installed; the
    Runner's logger must go on without it."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


# checkpoints -------------------------------------------------------------

# the model of tests/test_torch_retinanet.py with a smaller NMS input
SMALL = dict(CFG, bbox_head=dict(CFG["bbox_head"], test_cfg=dict(nms_pre=64, max_per_img=20)))


def test_jax_checkpoint_loads_and_predicts_like_the_jax_model(tmp_path):
    jmodel = j_build_detector(SMALL, seed=0)
    _randomize_bn(jmodel, seed=1)
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01), frozen_stages=1)
    path = str(tmp_path / "jax_ckpt.pkl")
    j_save_checkpoint(path, jmodel, jopt, meta={"epoch": 3, "iter": 30})
    with open(path, "rb") as f:
        leaves = {k.rsplit("/", 1)[1] for k in pickle.load(f)["model"]}
    assert leaves == {"kernel", "bias", "scale", "mean", "var"}

    tmodel = build_detector(SMALL, device="cpu", load_pretrained=False, seed=7)
    topt = build_optimizer(tmodel, lr_schedule=build_lr_schedule(0.01), frozen_stages=1)
    meta = load_checkpoint(path, tmodel, topt)
    assert (meta["epoch"], meta["iter"]) == (3, 30)
    # the optimizer state comes over: the schedule's count leaf (0: no
    # update was made, whatever meta says) and a momentum buffer, here
    # zero, for every parameter SGD updates
    updated = {p for g in topt.sgd.param_groups for p in g["params"]}
    assert topt.count == 0 and set(topt.sgd.state) == updated
    assert all(not topt.sgd.state[p]["momentum_buffer"].any() for p in updated)

    # the JAX side jitted, as the reference's Runner runs it (eager JAX
    # takes minutes here)
    jmodel.bbox_head.test_cfg = dict(jmodel.bbox_head.test_cfg, score_thr=0.0)
    graphdef, state = nnx.split(jmodel)

    @jax.jit
    def head_outputs(state, x):
        m = nnx.merge(graphdef, state)
        return m.bbox_head(m.extract_feat(x))

    @jax.jit
    def predict(state, outs):
        return nnx.merge(graphdef, state).bbox_head.predict(outs)

    images = np.random.RandomState(0).rand(2, 128, 128, 3).astype(np.float32)
    outs = head_outputs(state, jnp.asarray(images))
    tmodel.eval()
    with torch.no_grad():
        got = tmodel.bbox_head(tmodel.extract_feat(torch.from_numpy(images)))
    for (gc, gr), (wc, wr) in zip(got, outs):
        np.testing.assert_allclose(gc.permute(0, 2, 3, 1).numpy(), np.asarray(wc), atol=1e-4)
        np.testing.assert_allclose(gr.permute(0, 2, 3, 1).numpy(), np.asarray(wr), atol=1e-4)
    tmodel.bbox_head.test_cfg = dict(tmodel.bbox_head.test_cfg, score_thr=0.0)
    want = {k: np.asarray(v) for k, v in predict(state, outs).items()}
    touts = [(torch.from_numpy(np.array(c)).permute(0, 3, 1, 2),
              torch.from_numpy(np.array(r)).permute(0, 3, 1, 2)) for c, r in outs]
    det = {k: v.numpy() for k, v in tmodel.bbox_head.predict(touts).items()}
    v = want["valid"]
    assert v.sum() > 0
    np.testing.assert_array_equal(det["valid"], v)
    np.testing.assert_array_equal(det["labels"][v], want["labels"][v])
    np.testing.assert_allclose(det["scores"][v], want["scores"][v], rtol=1e-6)


def test_checkpoint_payloads_the_port_cannot_take(tmp_path):
    """A payload that names a global other than numpy's or flax's state
    classes (here in its EMA entry), and one of no known package; a JDet
    payload ("jdet_version") is imported, as the reference imports it
    (tests/test_torch_pretrained.py holds the import)."""
    model = build_detector(CFG, device="cpu", load_pretrained=False)
    for name, payload, error in (
            ("ema.pkl", {"meta": {"jdet_tpu_version": "0.1.0"}, "model": {},
                         "ema": {"state": types.SimpleNamespace()}},
             pickle.UnpicklingError),
            ("other.pkl", {"meta": {"other_version": "0.2"}, "model": {"conv.kernel": 0}},
             ValueError)):
        with open(tmp_path / name, "wb") as f:
            pickle.dump(payload, f)
        with pytest.raises(error, match=name):
            load_checkpoint(str(tmp_path / name), model)
    with open(tmp_path / "jdet.pkl", "wb") as f:
        pickle.dump({"meta": {"jdet_version": "0.2", "epoch": 3}, "model": {}}, f)
    assert load_checkpoint(str(tmp_path / "jdet.pkl"), model)["epoch"] == 3


def test_resume_from_a_jax_checkpoint_takes_the_reference_next_step(tmp_path):
    """The reference trains 3 steps inside its warmup with clip and saves;
    the port loads that checkpoint with the update count and every
    momentum buffer, and its 4th step equals the reference's 4th: the
    parameters, and the step's change of each, within 1e-3 of the
    tensor's largest value (tests/test_torch_train_step.py's tolerance).
    A resume that restarted the schedule (lr(0) = lr(3) / 1.4) or the
    momentum would change every update by far more."""
    from jdet_tpu.parallel.spmd import build_train_step as j_build_train_step
    from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
    from jdet_tpu.parallel.spmd import make_mesh

    sched = dict(scheduler_type="StepLR", milestones=[8], steps_per_epoch=2,
                 warmup="linear", warmup_iters=5, warmup_ratio=1.0 / 3)
    opt_kw = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
                  grad_clip=dict(max_norm=35.0), frozen_stages=1)
    u8, targets = _batch()
    jmodel = j_build_detector(CFG, seed=0)
    _randomize_bn(jmodel, seed=1)
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **sched), **opt_kw)
    _, state, jstep = j_build_train_step(jmodel, jopt, make_mesh(n_devices=1),
                                         preprocess=j_make_device_normalizer(MEAN, STD))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def jax_step(state, it):
        return jstep(state, jnp.asarray(u8), jt, jax.random.PRNGKey(0), jnp.int32(it))[0]

    for it in range(3):
        state = jax_step(state, it)
    nnx.update((jmodel, jopt), state)
    path = str(tmp_path / "jax_ckpt_3.pkl")
    j_save_checkpoint(path, jmodel, jopt, meta={"epoch": 1, "iter": 3})
    with open(path, "rb") as f:
        saved = pickle.load(f)
    nnx.update((jmodel, jopt), jax_step(state, 3))

    tmodel = build_detector(CFG, device="cpu", load_pretrained=False, seed=7)

    def trainable(flat):
        return {k: v.numpy() for k, v in params_from_jax(
            {k: v for k, v in flat.items()
             if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}

    p3 = trainable({k.replace("/", "."): v for k, v in saved["model"].items()})
    p4 = trainable(_numpy_params(jmodel))

    assert _assignment_margin(tmodel, targets) > 1e-5
    topt = build_optimizer(tmodel, lr_schedule=build_lr_schedule(0.01, **sched), **opt_kw)
    load_checkpoint(path, tmodel, topt)
    assert topt.count == 3
    traces = params_from_jax({k.split("/trace/", 1)[1].replace("/", "."): v
                              for k, v in saved["optimizer"].items() if "/trace/" in k},
                             tmodel)
    n_buf = 0
    for name, p in tmodel.named_parameters():
        if p in topt.sgd.state:
            torch.testing.assert_close(topt.sgd.state[p]["momentum_buffer"], traces[name],
                                       rtol=0, atol=0, msg=name)
            assert traces[name].abs().sum() > 0, name
            n_buf += 1
        else:
            assert not p.requires_grad, name
    assert n_buf == len({p for g in topt.sgd.param_groups for p in g["params"]}) > 50

    step = build_train_step(tmodel, topt, preprocess=make_device_normalizer(MEAN, STD))
    step(torch.from_numpy(u8), {k: torch.from_numpy(v) for k, v in targets.items()}, 3)
    assert topt.count == 4
    got = {n: p.detach().numpy() for n, p in tmodel.named_parameters()}
    _assert_close_per_tensor(got, {n: p4[n] for n in got}, "param")
    _assert_close_per_tensor({n: got[n] - p3[n] for n in got},
                             {n: p4[n] - p3[n] for n in got if p4[n].any()}, "step 4 change")


def test_ema_checkpoint_loads_model_only(tmp_path):
    """An EMA-trained jdet_tpu checkpoint: its weights load with
    model_only=True (as `pretrained_weights` loads them) and the `ema`
    entry is ignored, as the reference ignores it there; a full load
    hands the entry to the Runner (tests/test_torch_yolo.py loads a real
    one)."""
    jmodel = j_build_detector(SMALL, seed=0)
    _randomize_bn(jmodel, seed=1)
    path = str(tmp_path / "ema_ckpt.pkl")
    j_save_checkpoint(path, jmodel, meta={"epoch": 1, "iter": 10})
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["ema"] = {"state": {}, "updates": 10, "decay": 0.9999}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    tmodel = build_detector(SMALL, device="cpu", load_pretrained=False, seed=7)
    meta = load_checkpoint(path, tmodel, model_only=True)
    assert meta["iter"] == 10
    want = params_from_jax({k.replace("/", "."): v for k, v in payload["model"].items()},
                           tmodel)
    for name, t in tmodel.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0, msg=name)
    assert "_ema_payload" not in meta
    meta = load_checkpoint(path, tmodel)
    assert meta["_ema_payload"] == {"state": {}, "updates": 10, "decay": 0.9999}


def test_s2anet_jax_checkpoint_resumes_with_the_deform_and_orconv_momentum(tmp_path):
    """A jdet_tpu S2ANet checkpoint (ResNet-18, FPN 64) with momentum in
    every trace: the port loads it strictly (the ORConv's expanded-weight
    cache `wexp` and its ARF table `_src`, which the payload carries, are
    skipped) and takes each trace as the SGD momentum of the parameter it
    updates, the deformable conv's HWIO trace transposed as its weight is."""
    from test_torch_s2anet import CFG as S2ANET

    jmodel = j_build_detector(S2ANET, seed=0)
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, steps_per_epoch=2),
                             opt_type="SGD", momentum=0.9, weight_decay=1e-4,
                             grad_clip=dict(max_norm=35.0), frozen_stages=1)
    rng = np.random.RandomState(3)
    for path, var in flat_paths(jopt)[1].items():
        if "/trace/" in path.replace(".", "/") and hasattr(var, "set_value"):
            shape = var.get_value().shape
            var.set_value(jnp.asarray(rng.normal(0.0, 1e-3, shape), jnp.float32))
    path = str(tmp_path / "s2anet_ckpt.pkl")
    j_save_checkpoint(path, jmodel, jopt, meta={"epoch": 1, "iter": 6})
    with open(path, "rb") as f:
        saved = pickle.load(f)
    assert {"bbox_head/or_conv/wexp", "bbox_head/or_conv/_src"} <= set(saved["model"])

    tmodel = build_detector(S2ANET, device="cpu", load_pretrained=False, seed=7)
    topt = build_optimizer(tmodel, lr_schedule=build_lr_schedule(0.01, steps_per_epoch=2),
                           opt_type="SGD", momentum=0.9, weight_decay=1e-4,
                           grad_clip=dict(max_norm=35.0), frozen_stages=1)
    load_checkpoint(path, tmodel, topt)
    traces = {k.split("/trace/", 1)[1]: v for k, v in saved["optimizer"].items()
              if "/trace/" in k}
    params = dict(tmodel.named_parameters())
    buf = {n: topt.sgd.state[p]["momentum_buffer"].numpy() for n, p in params.items()
           if p in topt.sgd.state}
    np.testing.assert_array_equal(
        buf["bbox_head.align_conv.deform_conv.weight"],
        traces["bbox_head/align_conv/deform_conv/weight"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(buf["bbox_head.or_conv.weight"],
                                  traces["bbox_head/or_conv/weight"])
    # the frozen stem keeps no momentum in the port, as in its own checkpoints
    assert len(buf) == sum(p.requires_grad for p in params.values()) > 50
    mapped = params_from_jax({k.replace("/", "."): v for k, v in traces.items()}, tmodel)
    for name, b in buf.items():
        np.testing.assert_array_equal(b, mapped[name].numpy(), err_msg=name)
        assert np.abs(b).sum() > 0, name
    want = params_from_jax({k.replace("/", "."): v for k, v in saved["model"].items()}, tmodel)
    for name, t in tmodel.state_dict().items():
        torch.testing.assert_close(t, want[name], rtol=0, atol=0, msg=name)


def test_oriented_rcnn_jax_checkpoint_resumes_and_takes_the_reference_next_step(tmp_path):
    """The reference Oriented R-CNN (tests/test_torch_oriented_rcnn.py's
    model) trains 3 steps with its own train step and saves, with the
    optax count and momentum; the port loads it, the RPN's and the RoI
    head's leaves included (its Linear kernels and their traces
    transposed), and its 4th step, on the reference's own sampler draws
    for that step (fold_in(key, 3)), equals the reference's 4th: each
    parameter within 1e-3 of its tensor's largest value."""
    from jdet_tpu.parallel.spmd import build_train_step as j_build_train_step
    from jdet_tpu.parallel.spmd import make_mesh
    from test_torch_oriented_rcnn import B as ORCNN_B, CFG as ORCNN, K as ORCNN_K
    from test_torch_oriented_rcnn import Replay, _batch as orcnn_batch, _jax_model
    from test_torch_oriented_rcnn import _n_anchors, _port, model_draws

    sched = dict(scheduler_type="StepLR", milestones=[8], steps_per_epoch=2,
                 warmup="linear", warmup_iters=5, warmup_ratio=1.0 / 3)
    opt_kw = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
                  grad_clip=dict(max_norm=35.0))
    jmodel = _jax_model()
    images, targets = orcnn_batch(_port(_numpy_params(jmodel)))
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **sched), **opt_kw)
    _, state, jstep = j_build_train_step(jmodel, jopt, make_mesh(n_devices=1))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    root_key = jax.random.PRNGKey(0)

    def jax_step(state, it):
        return jstep(state, jnp.asarray(images), jt, root_key, jnp.int32(it))[0]

    for it in range(3):
        state = jax_step(state, it)
    nnx.update((jmodel, jopt), state)
    path = str(tmp_path / "orcnn_ckpt_3.pkl")
    j_save_checkpoint(path, jmodel, jopt, meta={"epoch": 1, "iter": 3})
    with open(path, "rb") as f:
        saved = pickle.load(f)
    nnx.update((jmodel, jopt), jax_step(state, 3))
    tmodel = build_detector(ORCNN, device="cpu", load_pretrained=False, seed=7)
    p4 = {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in _numpy_params(jmodel).items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}

    topt = build_optimizer(tmodel, lr_schedule=build_lr_schedule(0.01, **sched), **opt_kw)
    load_checkpoint(path, tmodel, topt)
    assert topt.count == 3
    traces = {k.split("/trace/", 1)[1]: v for k, v in saved["optimizer"].items()
              if "/trace/" in k}
    params = dict(tmodel.named_parameters())
    buf = {n: topt.sgd.state[p]["momentum_buffer"].numpy() for n, p in params.items()
           if p in topt.sgd.state}
    assert len(buf) == len(params)
    np.testing.assert_array_equal(buf["bbox_head.shared_fcs.0.weight"],
                                  traces["bbox_head/shared_fcs/0/kernel"].T)
    np.testing.assert_array_equal(buf["rpn_head.rpn_reg.weight"],
                                  traces["rpn_head/rpn_reg/kernel"].transpose(3, 2, 0, 1))
    for n in ("bbox_head.fc_cls.weight", "bbox_head.fc_reg.bias", "rpn_head.rpn_cls.bias"):
        assert np.abs(buf[n]).sum() > 0, n

    step = build_train_step(tmodel, topt)
    loss = tmodel.loss
    draws = Replay(model_draws(jax.random.fold_in(root_key, 3), ORCNN_B, _n_anchors(tmodel),
                               ORCNN_K + tmodel.rpn_head.nms_post))
    tmodel.loss = lambda images, targets, generator=None: loss(images, targets, rand=draws)
    step(torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in targets.items()}, 3)
    assert topt.count == 4 and not draws.blocks
    got = {n: p.detach().numpy() for n, p in tmodel.named_parameters()}
    _assert_close_per_tensor(got, {n: p4[n] for n in got}, "param")


def test_checkpoint_round_trip_gives_the_next_step_bit_for_bit(tmp_path):
    images, targets = _batch(seed=1)
    images = torch.from_numpy(images)
    targets = {k: torch.from_numpy(v) for k, v in targets.items()}

    def trainer(seed):
        model = build_detector(CFG, device="cpu", load_pretrained=False, seed=seed)
        opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, warmup="linear",
                                                                   warmup_iters=4),
                              grad_clip=dict(max_norm=35), frozen_stages=1)
        step = build_train_step(model, opt, preprocess=make_device_normalizer(MEAN, STD),
                                augment=make_device_augmenter(flip_h=0.5), seed=3)
        return model, opt, step

    model, opt, step = trainer(0)
    step(images, targets, 0)
    path = save_checkpoint(str(tmp_path / "ckpt_1.pkl"), model, opt, meta={"epoch": 1, "iter": 1})
    assert not os.path.exists(path + ".tmp")
    model2, opt2, step2 = trainer(1)
    meta = load_checkpoint(path, model2, opt2)
    assert (meta["epoch"], meta["iter"], meta["jdet_torch_version"]) == (1, 1, "0.1.0")
    assert opt2.count == 1
    want, got = step(images, targets, 1), step2(images, targets, 1)
    for k in want:
        assert got[k].item() == want[k].item(), k
    for (name, p), p2 in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(p, p2), name
    state2 = {id(p): s for p, s in opt2.sgd.state.items()}
    for p, p2 in zip(model.parameters(), model2.parameters()):
        if p in opt.sgd.state:
            assert torch.equal(opt.sgd.state[p]["momentum_buffer"],
                               state2[id(p2)]["momentum_buffer"])


# the Runner ----------------------------------------------------------------

def _mini_cfg(root, img_dir, ann, **kw):
    ds = dict(type="DOTADataset", annotations_file=ann, images_dir=img_dir,
              image_size=(128, 128), max_gt=16, image_dtype="uint8", num_workers=0,
              transforms=[dict(type="RotatedResize", min_size=128, max_size=128)])
    cfg = dict(
        name="mini", work_dir=os.path.join(root, "work"), max_epoch=2, log_interval=1,
        checkpoint_interval=1, eval_interval=1, seed=0,
        model=dict(
            type="RotatedRetinaNet", backbone=dict(type="ResNet", depth=18, frozen_stages=1),
            neck=dict(type="FPN", out_channels=64, num_outs=5, start_level=1,
                      add_extra_convs="on_input"),
            bbox_head=dict(type="RotatedRetinaHead", num_classes=16, in_channels=64,
                           feat_channels=64, stacked_convs=1,
                           test_cfg=dict(nms_pre=32, max_per_img=16, score_thr=0.0))),
        optimizer=dict(type="SGD", lr=0.005, momentum=0.9, weight_decay=1e-4,
                       grad_clip=dict(max_norm=35)),
        scheduler=dict(type="StepLR", warmup="linear", warmup_iters=4, warmup_ratio=1 / 3,
                       milestones=[1]),
        device_normalize=dict(mean=MEAN, std=STD),
        device_augment=dict(flip_h=0.5),
        dataset=dict(
            train=dict(ds, batch_size=2, shuffle=True, image_cache="auto"),
            val=dict(ds, batch_size=2, filter_empty_gt=False, drop_last=False),
            test=dict(type="ImageDataset", images_dir=img_dir, image_size=(128, 128),
                      batch_size=4, drop_last=False, image_dtype="uint8", num_workers=0,
                      transforms=[dict(type="RotatedResize", min_size=128, max_size=128)])),
    )
    cfg.update(kw)
    return cfg


@pytest.fixture(scope="module")
def mini_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runner_dota"))
    img_dir, ann = make_synthetic_dota(root, n_images=6, size=128, n_obj=(2, 5), seed=1)
    return root, img_dir, ann


def _losses_by_hand(cfg):
    """build_train_step over the planned batches, with the model, optimizer,
    schedule and device input built from the config by hand."""
    model = build_detector(cfg["model"], device="cpu", seed=cfg["seed"])
    ds_cfg = {k: v for k, v in cfg["dataset"]["train"].items() if k not in ("type", "image_cache")}
    ds = DOTADataset(**ds_cfg)
    ocfg, scfg = cfg["optimizer"], cfg["scheduler"]
    schedule = build_lr_schedule(
        ocfg["lr"], scheduler_type=scfg["type"], milestones=scfg["milestones"],
        steps_per_epoch=ds.num_batches, max_steps=cfg["max_epoch"] * ds.num_batches,
        warmup=scfg["warmup"], warmup_iters=scfg["warmup_iters"],
        warmup_ratio=scfg["warmup_ratio"])
    opt = build_optimizer(model, lr_schedule=schedule, momentum=ocfg["momentum"],
                          weight_decay=ocfg["weight_decay"], grad_clip=ocfg["grad_clip"],
                          frozen_stages=cfg["model"]["backbone"]["frozen_stages"])
    step = build_train_step(model, opt, preprocess=make_device_normalizer(**cfg["device_normalize"]),
                            augment=make_device_augmenter(**cfg["device_augment"]),
                            seed=cfg["seed"])
    losses, it = [], 0
    for epoch in range(cfg["max_epoch"]):
        for batch, _ in ds.batches(epoch=epoch, seed=cfg["seed"]):
            losses.append({k: v.item() for k, v in
                           step(batch["images"], batch["targets"], it).items()})
            it += 1
    return losses


def test_runner_trains_evaluates_saves_resumes_and_tests(mini_tree, monkeypatch, capsys):
    root, img_dir, ann = mini_tree
    cfg = _mini_cfg(root, img_dir, ann)
    seen = []
    real_build = runner_module.build_train_step

    def recording_build(*args, **kw):
        step = real_build(*args, **kw)

        def recorded(images, targets, it):
            out = step(images, targets, it)
            seen.append({k: v.item() for k, v in out.items()})
            return out
        return recorded

    monkeypatch.setattr(runner_module, "build_train_step", recording_build)
    runner = Runner(cfg, device="cpu")
    assert "TensorboardLogger disabled" in capsys.readouterr().out
    assert runner.max_iter == 6 and os.path.exists(os.path.join(runner.work_dir, "config.json"))
    metrics = []
    real_val = runner.val
    runner.val = lambda: metrics.append(real_val()) or metrics[-1]
    runner.run()
    log = capsys.readouterr().out
    assert (runner.epoch, runner.iter) == (2, 6)
    assert "lr: " in log and "fps: " in log and "eta_min: " in log

    # the losses equal those of the step driven by hand over the same batches
    assert seen == _losses_by_hand(cfg)
    assert all(np.isfinite(v) for lv in seen for v in lv.values())
    assert [len(t) for t in runner.iteration_times] == [3, 3]

    assert len(metrics) == 2
    for m in metrics:
        assert len(m) == 16 and 0.0 <= m["eval/0_meanAP"] <= 1.0
    ckpts = sorted(os.listdir(os.path.join(runner.work_dir, "checkpoints")))
    assert ckpts == ["ckpt_1.pkl", "ckpt_2.pkl"]
    test_pkl = os.path.join(runner.work_dir, "test", "test_2.pkl")
    with open(test_pkl, "rb") as f:
        results = pickle.load(f)
    assert len(results) == 6 and set(results[0][1]) == {"filename", "img_id", "img_size",
                                                        "scale_factor"}
    assert results[0][0]["polys"].shape == (16, 8)
    files = merge_cli.main(["--results", test_pkl, "--out-dir", os.path.join(root, "merged")])
    assert len(files) == 15

    resumed = Runner(dict(cfg, resume=True), device="cpu")
    assert (resumed.epoch, resumed.iter, resumed.optimizer.count) == (2, 6, 6)
    for (name, p), p2 in zip(runner.model.state_dict().items(),
                             resumed.model.state_dict().values()):
        assert torch.equal(p, p2), name
    momentum = {n: runner.optimizer.sgd.state[p]["momentum_buffer"]
                for n, p in runner.model.named_parameters() if p in runner.optimizer.sgd.state}
    resumed_params = dict(resumed.model.named_parameters())
    assert momentum
    for n, buf in momentum.items():
        assert torch.equal(resumed.optimizer.sgd.state[resumed_params[n]]["momentum_buffer"], buf)
    assert resumed.finish
    assert resumed.test_time(warmup=1, rerun=1) > 0
    # flip test: one more predict pass per flip, unflipped back
    resumed.cfg["flip_test"] = ["H", "HV"]
    assert len(resumed._run_inference(resumed.val_dataset)) == 3 * 6


def test_runner_runs_oriented_rcnn(mini_tree):
    """`run()` of an Oriented R-CNN config (ResNet-18, FPN 64, 128²): one
    epoch of 3 iterations, a val and a test, on the CPU."""
    root, img_dir, ann = mini_tree
    cfg = _mini_cfg(root, img_dir, ann, work_dir=os.path.join(root, "orcnn_work"), max_epoch=1,
                    model=dict(
                        type="OrientedRCNN", backbone=dict(type="ResNet", depth=18,
                                                           frozen_stages=1),
                        neck=dict(type="FPN", out_channels=64, num_outs=5),
                        rpn_head=dict(type="OrientedRPNHead", in_channels=64,
                                      feat_channels=64, nms_pre=128, nms_post=64),
                        bbox_head=dict(type="OrientedHead", num_classes=15, in_channels=64,
                                       fc_out_channels=128,
                                       train_cfg=dict(sampler=dict(num=48, pos_fraction=0.25)),
                                       test_cfg=dict(max_per_img=16, score_thr=0.0))))
    runner = Runner(cfg, device="cpu")
    assert type(runner.model).__name__ == "OrientedRCNN"
    runner.run()
    assert (runner.epoch, runner.iter) == (1, 3)
    with open(os.path.join(runner.work_dir, "test", "test_1.pkl"), "rb") as f:
        results = pickle.load(f)
    assert len(results) == 6 and results[0][0]["polys"].shape == (16, 8)
    assert sorted(os.listdir(os.path.join(runner.work_dir, "checkpoints"))) == ["ckpt_1.pkl"]


def test_runner_profile_writes_a_trace(mini_tree):
    """`Runner.profile` on the CPU: one step outside the trace, then the
    traced one, whose convolutions and SGD step show up as host events in
    a Chrome trace under work_dir/profile. Both steps train, as the
    reference's do; the Runner's iteration stays where it was."""
    root, img_dir, ann = mini_tree
    runner = Runner(_mini_cfg(root, img_dir, ann, work_dir=os.path.join(root, "profiled")),
                    device="cpu")
    path = runner.profile(n_steps=1)
    assert path == os.path.join(runner.work_dir, "profile", "train_steps_trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names and "Optimizer.step#SGD.step" in names
    assert runner.optimizer.count == 2 and runner.iter == 0
    runner.close()


def test_unflip_matches_the_reference():
    rng = np.random.default_rng(0)
    det = {"boxes": rng.uniform(0, 128, (2, 9, 5)).astype(np.float32),
           "polys": rng.uniform(0, 128, (2, 9, 8)).astype(np.float32)}
    det["boxes"][..., 4] = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 9))
    for mode in ("H", "V", "HV"):
        got = runner_module._unflip_dets({k: v.copy() for k, v in det.items()}, mode, 128, 96)
        want = j_unflip_dets({k: v.copy() for k, v in det.items()}, mode, 128, 96)
        for k in det:
            np.testing.assert_array_equal(got[k], want[k])


def test_runner_refuses_what_it_cannot_honour(mini_tree):
    root, img_dir, ann = mini_tree
    # ema, refused before the model EMA was ported, is taken (its EMA is
    # made at the first train epoch: tests/test_torch_yolo.py runs it)
    runner = Runner(_mini_cfg(root, img_dir, ann, ema=dict(decay=0.9999)), device="cpu")
    assert runner._ema_cfg == {"decay": 0.9999} and runner.ema is None
    runner.close()
    # scheduler.groups, refused before the per-group schedules were
    # ported, is taken: each parameter group's lr at each step is the
    # reference's `build_group_lr_schedules` (the first matching glob; the
    # base schedule for the rest)
    from jdet_tpu.optim.lr_scheduler import build_group_lr_schedules as j_groups

    groups = [dict(pattern="backbone.*", lr_mult=0.1, warmup=None),
              dict(pattern="bbox_head.*", warmup_init_lr=0.001)]
    cfg = _mini_cfg(root, img_dir, ann)
    cfg["scheduler"] = dict(cfg["scheduler"], groups=groups)
    runner = Runner(cfg, device="cpu")
    scfg = cfg["scheduler"]
    want = dict(j_groups(0.005, groups, scheduler_type="StepLR", milestones=[1],
                         gamma=0.1, steps_per_epoch=runner.train_dataset.num_batches,
                         max_steps=runner.max_iter, warmup="linear", warmup_iters=4,
                         warmup_ratio=scfg["warmup_ratio"]))
    want["base"] = runner.lr_schedule
    pattern = ["backbone.*", "bbox_head.*", "base"]
    assert sorted(g["schedule"] for g in runner.optimizer.inner.param_groups) == [0, 1, 2]
    for step in range(6):
        for g, lr in zip(runner.optimizer.inner.param_groups, runner.optimizer.group_lrs(step)):
            np.testing.assert_allclose(lr, float(want[pattern[g["schedule"]]](step)),
                                       rtol=1e-5, err_msg=f"step {step}")
    runner.close()
    # vis_test, refused before the visualizer was ported, writes the images
    work = os.path.join(root, "vis_work")
    cfg_file = os.path.join(root, "vis_cfg.py")
    vis_cfg = _mini_cfg(root, img_dir, ann, work_dir=work, images_dir=img_dir,
                        dataset_type="DOTA")
    with open(cfg_file, "w") as f:
        f.write("\n".join(f"{k} = {v!r}" for k, v in vis_cfg.items()) + "\n")
    run_net.main(["--config-file", cfg_file, "--task", "vis_test", "--cpu"])
    tiles = sorted(f for f in os.listdir(img_dir) if f.endswith(".png"))
    assert sorted(os.listdir(os.path.join(work, "vis"))) == tiles
    for f in tiles:
        assert imread(os.path.join(work, "vis", f)).shape == imread(
            os.path.join(img_dir, f)).shape


def test_tensorboard_logger_writes_scalars(tmp_path, monkeypatch):
    """RunLogger with a stand-in for torch.utils.tensorboard: scalars go to
    it by `iter`, strings and the iteration itself do not."""
    calls = []

    class SummaryWriter:
        def __init__(self, log_dir):
            calls.append(("dir", log_dir))

        def add_scalar(self, k, v, step):
            calls.append((k, v, step))

        def flush(self):
            calls.append("flush")

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard",
                        types.SimpleNamespace(SummaryWriter=SummaryWriter))
    logger = RunLogger(str(tmp_path))
    assert len(logger.loggers) == 2
    logger.log({"name": "x", "iter": 7, "loss": np.float32(0.25), "lr": 0.1})
    assert calls == [("dir", str(tmp_path / "tensorboard")), ("loss", 0.25, 7),
                     ("lr", 0.1, 7), "flush"]
    text = open(logger.loggers[0].path).read()
    assert "name: x, iter: 7, loss: 0.25, lr: 0.1" in text


def test_cli_trains_on_the_cpu(mini_tree, tmp_path):
    root, img_dir, ann = mini_tree
    cfg = _mini_cfg(str(tmp_path), img_dir, ann, max_epoch=1, eval_interval=None)
    cfg_file = tmp_path / "mini_cfg.py"
    cfg_file.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    code = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
            "from jdet_torch.tools.run_net import main; main()")
    proc = subprocess.run(
        [sys.executable, "-c", code, "--config-file", str(cfg_file), "--task", "train", "--cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    work = tmp_path / "work"
    assert (work / "checkpoints" / "ckpt_1.pkl").exists()
    assert (work / "test" / "test_1.pkl").exists()
    assert "total_loss" in proc.stdout
