"""The train step of jdet_torch against jdet_tpu, float32 on the CPU.

The model is the one of tests/test_torch_retinanet.py (ResNet-18 with
frozen_stages=1, FPN 64, stacked_convs=2, 128², B=2) with random BN
statistics, its weights carried into the port through `params_from_jax`;
images are uint8 and normalized inside the step. Tolerances: lr
schedules rtol 1e-6 (the reference computes in float32, the port in
Python floats); gradients and parameters within 1e-3 of each tensor's
largest absolute value and losses rtol 1e-3 (convolutions sum in another
order); the augmenter's images exactly, flipped boxes exactly (the same
float32 operations), rotated boxes atol 1e-3 (cos/sin of k*90 degrees
round in the last place)."""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.parallel.spmd import build_train_step as j_build_train_step
from jdet_tpu.parallel.spmd import make_device_augmenter as j_make_device_augmenter
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.parallel.spmd import make_mesh
from jdet_tpu.utils.general import check_interval as j_check_interval
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_augmenter, make_device_normalizer
from jdet_torch.ops.box_iou_rotated import box_iou_rotated
from jdet_torch.utils.general import check_interval, parse_losses
from test_torch_retinanet import CFG, _numpy_params, _randomize_bn

MEAN = [123.675, 116.28, 103.53]
STD = [58.395, 57.12, 57.375]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made these small models several
    times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
# warmup and a milestone inside 3 steps: lr(0), lr(1) warm up, step 2 is
# past both the warmup and the first milestone (epoch 1 = step 2)
SCHED = dict(scheduler_type="StepLR", milestones=[1, 5], gamma=0.1,
             steps_per_epoch=2, warmup="linear", warmup_iters=2,
             warmup_ratio=1.0 / 3)


def _batch(seed=1, B=2, size=128, K=8, real=3):
    """uint8 images and padded targets drawn like test_retinanet_e2e's
    `synthetic_batch`, from a seed whose anchor assignment has no near tie
    (see `_assignment_margin`)."""
    rng = np.random.RandomState(seed)
    u8 = rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int32)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real] = np.stack([
            rng.uniform(30, 100, real), rng.uniform(30, 100, real),
            rng.uniform(16, 60, real), rng.uniform(8, 30, real),
            rng.uniform(-np.pi / 4, 3 * np.pi / 4, real)], 1)
        labels[b, :real] = rng.randint(1, 16, real)
    return u8, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def _assignment_margin(model, targets, size=128):
    """Smallest distance, over the batch, between a gt's best IoU and its
    second best, and between an anchor's best IoU and the 0.4 / 0.5
    thresholds. The assigner's low-quality match takes every anchor whose
    IoU equals the gt's best exactly, so a gt inside several anchors of
    equal area ties them, and a rounding difference (XLA fuses the jitted
    reference's IoU differently from its eager ops) breaks the tie:
    the same batch then trains on other targets."""
    head = model.bbox_head
    anchors = head._flat_anchors([(size // s, size // s) for s in head.anchor_strides], "cpu")
    margin = np.inf
    for gt, m in zip(targets["gt_bboxes"], targets["gt_mask"]):
        iou = box_iou_rotated(torch.from_numpy(gt[m]), anchors).double()
        top2 = iou.topk(2, dim=1).values
        best = iou.max(0).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item(),
                     (best - 0.5).abs().min().item(), (best - 0.4).abs().min().item())
    return margin


def _models(seed=0):
    """The JAX model and the port with the same weights."""
    jmodel = j_build_detector(CFG, seed=seed)
    _randomize_bn(jmodel, seed=seed + 1)
    tmodel = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(tmodel, _numpy_params(jmodel))
    return jmodel, tmodel


def _torch_targets(targets):
    return {k: torch.from_numpy(v) for k, v in targets.items()}


def _flat(state):
    """nnx State -> {dotted path: np.ndarray}."""
    out = {}
    for path, v in state.flat_state():
        v = v.get_value() if hasattr(v, "get_value") else v
        out[".".join(str(p) for p in path)] = np.asarray(v)
    return out


def _assert_close_per_tensor(got, want, what):
    for name, w in want.items():
        tol = 1e-3 * max(float(np.abs(w).max()), 1e-12)
        np.testing.assert_allclose(got[name], w, rtol=0, atol=tol, err_msg=f"{what} {name}")


# (a) schedules -------------------------------------------------------------

_STEPS = (0, 1, 4, 5, 6, 7, 8, 9, 12, 13, 39, 40, 41)  # warmup_iters=5; milestones 8, 12


@pytest.mark.parametrize("warmup", [None, "constant", "linear", "exp"])
@pytest.mark.parametrize("decay", ["StepLR", "CosineAnnealingLR", "ExpLR", "PolyLR", "InvLR"])
def test_lr_schedule_matches(decay, warmup):
    kw = dict(scheduler_type=decay, milestones=[2, 3], gamma=0.5, steps_per_epoch=4,
              max_steps=40, warmup=warmup, warmup_iters=5, warmup_ratio=0.2,
              min_lr=0.001, power=0.9)
    got = build_lr_schedule(0.01, **kw)
    want = j_build_lr_schedule(0.01, **kw)
    for step in _STEPS:
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=f"step {step}")


def test_lr_schedule_rejects_unknown_names():
    with pytest.raises(ValueError):
        build_lr_schedule(0.01, scheduler_type="OneCycle")
    with pytest.raises(ValueError):
        build_lr_schedule(0.01, warmup="cosine")


# (b) gradients -------------------------------------------------------------

def test_gradients_match():
    jmodel, tmodel = _models()
    u8, targets = _batch()
    assert _assignment_margin(tmodel, targets) > 1e-5
    jimages = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))

    @nnx.jit
    def value_and_grad(m):
        def lf(m):
            return j_parse_losses(m.loss(jimages, {k: jnp.asarray(v) for k, v in targets.items()}))
        return nnx.value_and_grad(lf, has_aux=True)(m)

    (jtotal, _), jgrads = value_and_grad(jmodel)
    want = params_from_jax({k: v for k, v in _flat(jgrads).items()}, tmodel)

    tmodel.train()
    images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
    total, _ = parse_losses(tmodel.loss(images, _torch_targets(targets)))
    total.backward()
    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-4)

    n_trainable = n_frozen = 0
    for name, p in tmodel.named_parameters():
        w = want[name].numpy()
        if p.requires_grad:
            n_trainable += 1
            assert p.grad is not None, name
            _assert_close_per_tensor({name: p.grad.numpy()}, {name: w}, "grad")
        else:
            # frozen stem and layer1: no gradient here, zero in the reference
            n_frozen += 1
            assert p.grad is None, name
            assert not w.any(), name
    assert n_frozen == 3 + 2 * 6  # conv1, bn1 (2); layer1: 2 blocks x (2 convs, 2 BNs x 2)
    assert n_trainable > 50
    # the BNs of unfrozen stages still train under norm_eval
    assert tmodel.backbone.layer2[0].bn1.weight.grad.abs().sum() > 0


@pytest.mark.parametrize("loss", ["focal", "smooth_l1"])
def test_loss_input_gradients_match(loss):
    """The gradient of each loss with respect to its predictions, on
    logits and deltas that reach both branches (large and small |x|,
    |d| above and below beta)."""
    from jdet_tpu.models.losses import sigmoid_focal_loss as j_focal
    from jdet_tpu.models.losses import smooth_l1_loss as j_smooth_l1
    from jdet_torch.models.losses import sigmoid_focal_loss, smooth_l1_loss

    rng = np.random.RandomState(11)
    if loss == "focal":
        x = (rng.randn(2, 50, 15) * 4).astype(np.float32)
        labels = rng.randint(0, 16, (2, 50)).astype(np.int32)
        weight = (rng.rand(2, 50) > 0.2).astype(np.float32)
        kw = dict(gamma=2.0, alpha=0.25, avg_factor=7.0)
        jfn = lambda p: j_focal(p, jnp.asarray(labels), weight=jnp.asarray(weight), **kw)
        tfn = lambda p: sigmoid_focal_loss(p, torch.from_numpy(labels).long(),
                                           weight=torch.from_numpy(weight), **kw)
    else:
        x = (rng.randn(2, 50, 5) * 0.2).astype(np.float32)
        target = (rng.randn(2, 50, 5) * 0.2).astype(np.float32)
        weight = (rng.rand(2, 50, 5) > 0.3).astype(np.float32)
        kw = dict(beta=1.0 / 9.0, avg_factor=7.0)
        jfn = lambda p: j_smooth_l1(p, jnp.asarray(target), weight=jnp.asarray(weight), **kw)
        tfn = lambda p: smooth_l1_loss(p, torch.from_numpy(target),
                                       weight=torch.from_numpy(weight), **kw)
    want_v, want_g = jax.value_and_grad(jfn)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got_v = tfn(xt)
    got_v.backward()
    np.testing.assert_allclose(got_v.item(), float(want_v), rtol=1e-5)
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0,
                               atol=1e-3 * np.abs(want_g).max())


# (c) full steps ------------------------------------------------------------

@pytest.mark.parametrize("max_norm", [35.0, 0.5])
def test_three_sgd_steps_match(max_norm):
    jmodel, tmodel = _models()
    frozen0 = {n: p.detach().clone() for n, p in tmodel.named_parameters() if not p.requires_grad}
    u8, targets = _batch()
    assert _assignment_margin(tmodel, targets) > 1e-5
    opt_kw = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
                  grad_clip=dict(max_norm=max_norm), frozen_stages=1)

    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **opt_kw)
    _, state, jstep = j_build_train_step(
        jmodel, jopt, make_mesh(n_devices=1),
        preprocess=j_make_device_normalizer(MEAN, STD))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    jlosses = []
    for it in range(3):
        state, lv = jstep(state, jnp.asarray(u8), jt, jax.random.PRNGKey(0), jnp.int32(it))
        jlosses.append({k: float(v) for k, v in lv.items()})
    nnx.update((jmodel, jopt), state)

    topt = build_optimizer(tmodel, lr_schedule=build_lr_schedule(0.01, **SCHED), **opt_kw)
    step = build_train_step(tmodel, topt, preprocess=make_device_normalizer(MEAN, STD))
    images, tt = torch.from_numpy(u8), _torch_targets(targets)
    for it in range(3):
        lv = step(images, tt, it)
        for k in ("loss_cls", "loss_bbox", "total_loss"):
            np.testing.assert_allclose(lv[k].item(), jlosses[it][k], rtol=1e-3,
                                       err_msg=f"step {it} {k}")
        if it == 0:
            # the gradients left by the step are the clipped ones
            norm = torch.nn.utils.get_total_norm(
                [p.grad for p in tmodel.parameters() if p.grad is not None]).item()
            if max_norm < 1:
                np.testing.assert_allclose(norm, max_norm, rtol=1e-5)
            else:
                assert 1 < norm < max_norm
    assert topt.count == 3
    assert topt.sgd.param_groups[0]["lr"] == pytest.approx(0.001)

    want = {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in _numpy_params(jmodel).items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}
    got = {n: p.detach().numpy() for n, p in tmodel.named_parameters()}
    _assert_close_per_tensor(got, {n: want[n] for n in got}, "param")
    for n, p0 in frozen0.items():
        torch.testing.assert_close(dict(tmodel.named_parameters())[n], p0, rtol=0, atol=0)


def test_sgd_chain_matches_optax_on_groups_and_teacher():
    """clip -> wd -> momentum SGD -> multipliers, with param_groups lr_mult
    (multiplying across matching groups) and a teacher left frozen."""
    rng = np.random.RandomState(0)
    w = {name: (rng.randn(3, 4).astype(np.float32), rng.randn(4).astype(np.float32))
         for name in ("backbone", "head", "teacher")}

    class JM(nnx.Module):
        def __init__(self):
            for name, (k, b) in w.items():
                lin = nnx.Linear(3, 4, rngs=nnx.Rngs(0))
                lin.kernel.value, lin.bias.value = jnp.asarray(k), jnp.asarray(b)
                setattr(self, name, lin)

        def __call__(self, x):
            return (self.head(x) * self.backbone(x) + self.teacher(x)) ** 2

    class TM(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for name, (k, b) in w.items():
                lin = torch.nn.Linear(3, 4)
                with torch.no_grad():
                    lin.weight.copy_(torch.from_numpy(k.T.copy()))
                    lin.bias.copy_(torch.from_numpy(b))
                setattr(self, name, lin)

        def forward(self, x):
            return (self.head(x) * self.backbone(x) + self.teacher(x)) ** 2

    x = rng.randn(5, 3).astype(np.float32)
    groups = [dict(pattern="backbone.*", lr_mult=0.1), dict(pattern="*.bias", lr_mult=2.0)]
    kw = dict(opt_type="SGD", momentum=0.9, weight_decay=0.01, grad_clip=1.0,
              param_groups=groups)
    sched = dict(scheduler_type="StepLR", warmup="linear", warmup_iters=3)

    jm = JM()
    jopt = j_build_optimizer(jm, lr_schedule=j_build_lr_schedule(0.1, **sched), **kw)
    tm = TM()
    topt = build_optimizer(tm, lr_schedule=build_lr_schedule(0.1, **sched), **kw)
    for _ in range(3):
        _, grads = nnx.value_and_grad(lambda m: m(jnp.asarray(x)).mean())(jm)
        jopt.update(jm, grads)
        topt.zero_grad()
        tm(torch.from_numpy(x)).mean().backward()
        topt.step()
    for name in w:
        jl, tl = getattr(jm, name), getattr(tm, name)
        np.testing.assert_allclose(tl.weight.detach().numpy().T, np.asarray(jl.kernel.value),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(tl.bias.detach().numpy(), np.asarray(jl.bias.value),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tm.teacher.bias.detach().numpy(), w["teacher"][1])
    assert sorted(g["lr_mult"] for g in topt.sgd.param_groups) == pytest.approx([0.1, 0.2, 1.0, 2.0])


# (d) device normalize and augment ------------------------------------------

def _aug_batch(B=4, S=64, K=6, seed=3):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 255, (B, S, S, 3), dtype=np.uint8)
    gb = np.stack([
        rng.uniform(10, S - 10, (B, K)), rng.uniform(10, S - 10, (B, K)),
        rng.uniform(4, 20, (B, K)), rng.uniform(4, 12, (B, K)),
        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, K)),
    ], -1).astype(np.float32)
    return images, gb


@pytest.mark.parametrize("to_bgr", [False, True])
def test_device_normalizer_matches(to_bgr):
    images, _ = _aug_batch()
    want = np.asarray(j_make_device_normalizer(MEAN, STD, to_bgr)(jnp.asarray(images)))
    got = make_device_normalizer(MEAN, STD, to_bgr)(torch.from_numpy(images))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("flip", ["flip_h", "flip_v"])
def test_device_flip_matches(flip):
    images, gb = _aug_batch(seed=5)
    want_img, want_t = j_make_device_augmenter(**{flip: 1.0})(
        jnp.asarray(images), {"gt_bboxes": jnp.asarray(gb)}, jax.random.PRNGKey(0))
    got_img, got_t = make_device_augmenter(**{flip: 1.0})(
        torch.from_numpy(images), {"gt_bboxes": torch.from_numpy(gb)},
        torch.Generator().manual_seed(0))
    assert got_img.dtype == torch.float32
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(got_t["gt_bboxes"].numpy(), np.asarray(want_t["gt_bboxes"]))
    assert not np.array_equal(got_img.numpy(), images.astype(np.float32))


def test_device_rot90_matches():
    images, gb = _aug_batch(B=8, seed=7)
    jaug = j_make_device_augmenter(rot90=1.0)
    aug = make_device_augmenter(rot90=1.0)
    got_img, got_t = aug(torch.from_numpy(images), {"gt_bboxes": torch.from_numpy(gb)},
                         torch.Generator().manual_seed(2))
    got_img = got_img.numpy().astype(np.uint8)
    ks = []
    for b in range(len(images)):
        # recover this sample's k from the image, then run the reference
        # on a batch of that image alone with its k forced
        k = next((k for k in range(4) if np.array_equal(got_img[b], np.rot90(images[b], k))), None)
        assert k is not None, f"sample {b} matches no rotation"
        ks.append(k)
        seed = 0
        while True:  # the key whose draw is k for a batch of one
            key = jax.random.PRNGKey(seed)
            out_img, out_t = jaug(jnp.asarray(images[b:b + 1]),
                                  {"gt_bboxes": jnp.asarray(gb[b:b + 1])}, key)
            if np.array_equal(np.asarray(out_img[0], np.uint8), got_img[b]):
                break
            seed += 1
        np.testing.assert_allclose(got_t["gt_bboxes"][b].numpy(),
                                   np.asarray(out_t["gt_bboxes"][0]), atol=1e-3)
    assert len(set(ks)) > 1  # the generator varies k across samples


def test_train_step_draws_fresh_augmentation_each_step():
    """The step seeds its generator from (seed, it): the same it repeats
    the draws, another it gives others."""
    images, gb = _aug_batch(B=16)
    seen = []
    aug = make_device_augmenter(flip_h=0.5)

    class Probe(torch.nn.Module):
        def loss(self, x, t, generator=None):
            seen.append(t["gt_bboxes"].clone())
            return {"loss_x": (self.p * x.mean()) ** 2}

        def __init__(self):
            super().__init__()
            self.p = torch.nn.Parameter(torch.ones(()))

    m = Probe()
    opt = build_optimizer(m, lr_schedule=build_lr_schedule(0.1))
    step = build_train_step(m, opt, augment=aug, seed=3)
    t = {"gt_bboxes": torch.from_numpy(gb)}
    for it in (0, 0, 1):
        log_vars = step(torch.from_numpy(images), t, it)
    assert set(log_vars) == {"loss_x", "total_loss"}
    assert not log_vars["total_loss"].requires_grad
    torch.testing.assert_close(seen[0], seen[1], rtol=0, atol=0)
    assert not torch.equal(seen[0], seen[2])


# (e) helpers ---------------------------------------------------------------

def test_parse_losses_and_check_interval_match():
    losses = {"loss_cls": 1.5, "loss_bbox": [0.25, 0.5], "acc": 0.9}
    total, log_vars = parse_losses(losses)
    j_total, j_log_vars = j_parse_losses(losses)
    assert total == j_total == 2.25
    assert log_vars == j_log_vars
    assert log_vars["total_loss"] == 2.25 and log_vars["acc"] == 0.9
    t, _ = parse_losses({"loss_a": torch.tensor(2.0, requires_grad=True)})
    assert t.requires_grad
    for step, interval in [(0, 5), (10, 5), (11, 5), (3, None), (3, 0)]:
        assert check_interval(step, interval) == j_check_interval(step, interval)
