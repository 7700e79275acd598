"""Localization distillation in jdet_torch against jdet_tpu, float32 on the
CPU: `KnowledgeDistillationSingleStageDetector` with an
`LDRotatedRetinaHead` student and a `RotatedRetinaDistributionHead`
teacher (reg_max 8), its KD loss, the teacher's freezing, the weight
bridge and checkpoints on `teacher.*`.

`configs/ld_r50_fpn_1x_dota.py` distils an R18 student from an R50
teacher at FPN 256. On the CPU both are cut: an R18 teacher as well, FPN
64, one tower conv, 128², B=2; the model's structure (the teacher's
frozen stages, the distribution heads, the KD term) is the config's.
Tolerances: the whole model's losses rtol 1e-4 (convolutions sum in
another order); on the JAX head outputs, the losses rtol 1e-4 and their
gradients with respect to the student's outputs rtol 1e-4, atol 1e-6;
the expected deltas of the distributions atol 1e-6."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.pretrained import flat_paths
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step
from jdet_torch.runner.checkpoint import load_checkpoint, save_checkpoint
from test_torch_retina_variants import _gts, unfused_jit
from test_torch_retinanet import _randomize_bn

_FPN = dict(type="FPN", out_channels=64, num_outs=5, start_level=1, add_extra_convs="on_input")
_HEAD = dict(num_classes=16, in_channels=64, feat_channels=64, stacked_convs=1, reg_max=8,
             test_cfg=dict(nms_pre=64, max_per_img=24, score_thr=0.0))
CFG = dict(
    type="KnowledgeDistillationSingleStageDetector",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=_FPN,
    bbox_head=dict(type="LDRotatedRetinaHead", **_HEAD),
    teacher=dict(
        type="RotatedRetinaNet",
        backbone=dict(type="ResNet", depth=18, frozen_stages=4),
        neck=_FPN,
        bbox_head=dict(type="RotatedRetinaDistributionHead", **_HEAD),
    ),
    teacher_ckpt=None,
)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(module):
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value()) for k, v in flat.items()}


def _batch():
    images = np.random.RandomState(8).rand(2, 128, 128, 3).astype(np.float32)
    gt, mask, labels = _gts(8)
    return images, {"gt_bboxes": gt, "gt_labels": labels.astype(np.int32), "gt_mask": mask}


def _torch_batch(images, targets):
    return torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in targets.items()}


@pytest.fixture(scope="module")
def pair():
    # built under nnx.jit: one compile instead of one per initializer shape
    jmodel = nnx.jit(lambda: j_build_detector(CFG, seed=0, load_pretrained=False))()
    _randomize_bn(jmodel, seed=2)
    tmodel = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(tmodel, _numpy_params(jmodel))
    return jmodel, tmodel


def test_params_from_jax_is_strict_on_the_teacher(pair):
    jmodel, tmodel = pair
    flat = _numpy_params(jmodel)
    sd = params_from_jax(flat, tmodel)
    assert sd["teacher.backbone.layer4.1.conv2.weight"].shape == (512, 512, 3, 3)
    assert sd["teacher.bbox_head.retina_reg.weight"].shape == (9 * 5 * 9, 64, 1, 1)
    assert sd["bbox_head.retina_reg.weight"].shape == (9 * 5 * 9, 64, 1, 1)
    flat.pop("teacher.bbox_head.retina_reg.bias")
    with pytest.raises(RuntimeError, match="Missing"):
        load_from_jax(tmodel, flat)
    flat = _numpy_params(jmodel)
    flat["teacher.neck.extra.kernel"] = np.zeros((1, 1, 1, 1), np.float32)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_from_jax(tmodel, flat)
    load_from_jax(tmodel, _numpy_params(jmodel))


def test_losses_and_gradients_match(pair):
    """The port's whole-model loss against the reference's losses on its
    own head outputs, which is what the reference's `loss` computes; then
    the port's head on those outputs, with the gradients of the total
    loss with respect to the student's outputs."""
    jmodel, tmodel = pair
    images, targets = _batch()
    x = jnp.asarray(images)
    s_outs, t_outs = nnx.jit(lambda m: (m.bbox_head(m.extract_feat(x)),
                                        m.teacher.bbox_head(m.teacher.extract_feat(x))))(jmodel)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    graphdef, state = nnx.split(jmodel.bbox_head)

    def total_and_grad(state, o):
        def total(o):
            losses = nnx.merge(graphdef, state).loss_with_teacher(o, t_outs, jt)
            return sum(losses.values()), losses
        return jax.value_and_grad(total, has_aux=True)(o)

    (_, want), want_grads = unfused_jit(total_and_grad, state, s_outs)
    assert set(want) == {"loss_cls", "loss_bbox", "loss_ld"}

    tmodel.train()
    assert not tmodel.teacher.training and not tmodel.teacher.backbone.training
    got = tmodel.loss(*_torch_batch(images, targets))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    assert got["loss_ld"].item() > 0

    def to_torch(outs, grad=False):
        return [tuple(torch.from_numpy(np.array(o)).permute(0, 3, 1, 2).contiguous()
                      .requires_grad_(grad) for o in lvl) for lvl in outs]

    touts = to_torch(s_outs, grad=True)
    got = tmodel.bbox_head.loss_with_teacher(touts, to_torch(t_outs),
                                             _torch_batch(images, targets)[1])
    for k in want:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-4, err_msg=k)
    sum(got.values()).backward()
    for jl, tl in zip(want_grads, touts):
        for j, t in zip(jl, tl):
            np.testing.assert_allclose(t.grad.permute(0, 2, 3, 1).numpy(), np.asarray(j),
                                       rtol=1e-4, atol=1e-6)

    # the expected deltas that the loss and predict decode
    want = np.asarray(jmodel.bbox_head._reg_to_deltas(s_outs[0][1], 2))
    got = tmodel.bbox_head._reg_to_deltas(to_torch(s_outs)[0][1], 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6)
    tmodel.eval()
    det = tmodel.predict(torch.from_numpy(images))
    assert det["boxes"].shape == (2, 24, 5) and det["valid"].any()


def test_build_optimizer_freezes_the_teacher_and_train_keeps_it_in_eval():
    model = build_detector(CFG, device="cpu", seed=3, load_pretrained=False)
    model.train()
    assert model.bbox_head.training and model.backbone.layer4.training
    assert not any(m.training for m in model.teacher.modules())
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01), weight_decay=1e-4,
                          grad_clip=35.0, frozen_stages=1)
    updated = {id(p) for g in opt.sgd.param_groups for p in g["params"]}
    names = [n for n, p in model.named_parameters() if id(p) in updated]
    assert names and not any(n.startswith("teacher.") for n in names)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = build_train_step(model, opt)
    images, targets = _torch_batch(*_batch())
    for it in range(2):
        log_vars = step(images, targets, it)
        assert all(torch.isfinite(v) for v in log_vars.values())
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("teacher."):
            assert torch.equal(after[k], v), k
    assert not torch.equal(after["bbox_head.retina_reg.weight"], before["bbox_head.retina_reg.weight"])
    assert model.teacher.bbox_head.retina_reg.weight.grad is None


def test_checkpoint_round_trip_and_teacher_ckpt(tmp_path):
    model = build_detector(CFG, device="cpu", seed=4, load_pretrained=False)
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01), frozen_stages=1)
    build_train_step(model, opt)(*_torch_batch(*_batch()), 0)
    path = save_checkpoint(os.path.join(tmp_path, "ld.pkl"), model, opt, meta={"iter": 1})
    fresh = build_detector(CFG, device="cpu", seed=5, load_pretrained=False)
    fresh_opt = build_optimizer(fresh, lr_schedule=build_lr_schedule(0.01), frozen_stages=1)
    load_checkpoint(path, fresh, fresh_opt)
    want = model.state_dict()
    assert any(k.startswith("teacher.") for k in want)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert fresh_opt.count == 1

    # teacher_ckpt: the teacher loaded model-only from a detector checkpoint
    teacher_path = save_checkpoint(os.path.join(tmp_path, "teacher.pkl"), model.teacher)
    kd = build_detector(dict(CFG, teacher_ckpt=teacher_path), device="cpu", seed=6,
                        load_pretrained=False)
    for k, v in kd.teacher.state_dict().items():
        assert torch.equal(v, model.teacher.state_dict()[k]), k
    assert not torch.equal(kd.bbox_head.retina_cls.weight, model.bbox_head.retina_cls.weight)
