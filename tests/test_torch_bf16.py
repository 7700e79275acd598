"""The bf16 compute policy of jdet_torch against jdet_tpu's, on the CPU.

Both models are the one of tests/test_torch_retinanet.py (ResNet-18 with
frozen_stages=1, FPN 64, stacked_convs=2, 128², B=2) with random BN
statistics: jdet_tpu's built under its `compute_dtype_scope(jnp.bfloat16)`
and jitted as its Runner runs it, the port's built under its own scope
with the same weights (`params_from_jax`). The JAX model also runs in
float32 on the same inputs, and each tolerance is a fraction of that
gap, the reference's own bf16 - f32 difference: the port's distance to
the reference's bf16 result over its gap, each a root mean square over
the tensor.

- Single layers on the same bf16 input match flax's bits: the BN on every
  element, the conv on all but ~1e-4 of them (its sum runs in another
  order, so a few outputs round one ulp apart).
- Those flips spread through the network: at the head the port sits at
  0.15-0.18 of the gap on the classification outputs and 0.47-0.71 on the
  regression outputs. A port with torch-autocast arithmetic (bias fused
  into the conv, BN in float32 rounded once) sits at 0.23-0.26 and
  0.94-1.12 on the same check, and a float32 port at 1.0 by definition.
  So head outputs are held to 0.8 of the gap (the 0.25 hoped for holds
  for single layers, not after 40 layers of flips).
- Losses: within 0.25 of the gap (0.02 and 0.14 measured).
- Gradients and the first SGD step's change of each trainable tensor:
  the median over tensors within 0.9 of the gap (0.78 measured; 1.13 for
  the autocast-like port) and every tensor within 2 (1.57 measured: the
  gradient of a bias or a BN scale is a sum over the whole feature map,
  which each framework reduces in its own order and precision).

Why a root mean square and not the maximum: at the end of the network a
few outputs differ by one ulp of their value, and the classification
logits sit near -4.6, where one ulp (0.031) is larger than the largest
bf16 - f32 gap (0.017).
"""
import importlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.parallel.spmd import build_train_step as j_build_train_step
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.parallel.spmd import make_mesh
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.layers import BatchNorm2d, Conv2d
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_normalizer
from jdet_torch.utils.general import parse_losses
from test_torch_retinanet import CFG, _numpy_params, _randomize_bn
from test_torch_train_step import MEAN, SCHED, STD, _assignment_margin, _batch, _flat

BF16 = torch.bfloat16
# fractions of the reference's bf16 - f32 gap (module docstring)
HEAD, LOSS, GRAD_MEDIAN, GRAD_MAX = 0.8, 0.25, 0.9, 2.0
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made these small models several
    times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _port_policy_restored():
    """tests/conftest.py isolates only the JAX package's policy."""
    prev = tnn.compute_dtype()
    yield
    tnn.set_compute_dtype(prev)


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def _gap_fraction(got, bf16, f32, what):
    """RMS |got - bf16| / RMS |bf16 - f32|."""
    got, bf16, f32 = (np.asarray(a, np.float32) for a in (got, bf16, f32))
    gap = _rms(bf16 - f32)
    assert gap > 0, f"{what}: bf16 equals f32"
    return _rms(got - bf16) / gap


def _assert_fractions(fracs, median, most, what):
    worst = max(fracs, key=fracs.get)
    assert np.median(list(fracs.values())) <= median, f"{what}: median {np.median(list(fracs.values()))}"
    assert fracs[worst] <= most, f"{what}: {worst} at {fracs[worst]:.3f} of the gap"


def _jax_run(dtype, u8, targets):
    """The reference under `dtype`: eval-mode head outputs, the loss and
    its gradients (one jit), then one train step of its Runner's
    `build_train_step`. Returns numpy results and the starting weights."""
    with j_compute_dtype_scope(dtype):
        jmodel = j_build_detector(CFG, seed=0)
    _randomize_bn(jmodel, seed=1)
    weights = _numpy_params(jmodel)
    normalize = j_make_device_normalizer(MEAN, STD)
    images = normalize(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    @nnx.jit
    def forward_and_grads(m):
        outs = m.bbox_head(m.extract_feat(images))

        def lf(m):
            return j_parse_losses(m.loss(images, jt))

        (total, log_vars), grads = nnx.value_and_grad(lf, has_aux=True)(m)
        return outs, log_vars, grads

    outs, log_vars, grads = forward_and_grads(jmodel)
    tmodel = build_detector(CFG, device="cpu", load_pretrained=False)
    out = {
        "outs": [(np.asarray(c), np.asarray(r)) for c, r in outs],
        "losses": {k: float(v) for k, v in log_vars.items()},
        "grads": {k: v.numpy() for k, v in params_from_jax(_flat(grads), tmodel).items()},
    }
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
    _, state, jstep = j_build_train_step(jmodel, jopt, make_mesh(n_devices=1),
                                         preprocess=normalize)
    state, _ = jstep(state, jnp.asarray(u8), jt, jax.random.PRNGKey(0), jnp.int32(0))
    nnx.update((jmodel, jopt), state)
    out["params"] = {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in _numpy_params(jmodel).items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}
    return out, weights


@pytest.fixture(scope="module")
def ref():
    u8, targets = _batch()
    runs = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        runs[name], weights = _jax_run(dtype, u8, targets)
    return u8, targets, weights, runs


def _port(weights, dtype=BF16):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def _torch_targets(targets):
    return {k: torch.from_numpy(v) for k, v in targets.items()}


# the policy --------------------------------------------------------------

def test_policy_binds_when_built_and_the_scope_restores():
    assert tnn.compute_dtype() is None
    with tnn.compute_dtype_scope(BF16):
        assert tnn.compute_dtype() is BF16
        conv, bn = Conv2d(4, 4, 3), BatchNorm2d(4)
    assert tnn.compute_dtype() is None
    assert tnn.set_compute_dtype(BF16) is None and tnn.set_compute_dtype(None) is BF16
    with pytest.raises(RuntimeError), tnn.compute_dtype_scope(BF16):
        raise RuntimeError
    assert tnn.compute_dtype() is None
    # built in the scope, used after it: still bf16, parameters float32
    x = torch.randn(1, 4, 8, 8)
    bn.eval()
    assert conv(x).dtype == BF16 and bn(x).dtype == BF16
    assert conv.weight.dtype == conv.bias.dtype == bn.weight.dtype == torch.float32
    assert bn.running_mean.dtype == torch.float32 and isinstance(bn, torch.nn.BatchNorm2d)
    assert Conv2d(4, 4, 3)(x).dtype == torch.float32


def test_the_weight_bridge_loads_f32_and_bf16_models_alike(ref):
    """`params_from_jax` needs no change for bf16: the parameters and BN
    statistics stay float32, so one set of weights loads into both."""
    weights = ref[2]
    f32, bf16 = _port(weights, None), _port(weights)
    sd32, sd16 = f32.state_dict(), bf16.state_dict()
    assert sd32.keys() == sd16.keys()
    for k, v in sd32.items():
        assert sd16[k].dtype == v.dtype and torch.equal(sd16[k], v), k
    convs = [m for m in bf16.modules() if isinstance(m, (Conv2d, BatchNorm2d))]
    assert len(convs) > 40 and all(m.dtype is BF16 for m in convs)
    assert all(m.dtype is None for m in f32.modules() if isinstance(m, (Conv2d, BatchNorm2d)))


@pytest.mark.parametrize("layer", ["conv_bias", "conv_stride2", "bn", "bn_train"])
def test_single_layers_round_like_flax(layer):
    """One layer on the same bf16 input, jdet_tpu's jitted: a conv with
    its bias added apart matches flax's bits on all but a few outputs
    (the sum runs in another order, so a few round one ulp apart); the
    BN matches every bit, on running statistics (bf16 step by step) and
    on batch statistics (float32, rounded once)."""
    from jdet_tpu.models import nn as jnn

    rng = np.random.RandomState(3)
    x = jnp.asarray(rng.randn(2, 16, 16, 32).astype(np.float32) * 2, jnp.bfloat16)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).permute(0, 3, 1, 2).to(BF16)
    conv = layer.startswith("conv")
    stride = 2 if layer == "conv_stride2" else 1
    with j_compute_dtype_scope(jnp.bfloat16):
        if conv:
            jl = jnn.Conv(32, 32, (3, 3), strides=stride, rngs=nnx.Rngs(0))
            jl.bias.value = jnp.asarray(rng.randn(32).astype(np.float32))
        else:
            jl = jnn.BatchNorm(32, momentum=0.9, epsilon=1e-5, rngs=nnx.Rngs(0))
            for leaf, v in (("scale", rng.uniform(0.5, 1.5, 32)), ("bias", rng.normal(0, 0.1, 32)),
                            ("mean", rng.normal(0, 0.1, 32)), ("var", rng.uniform(0.5, 1.5, 32))):
                getattr(jl, leaf).value = jnp.asarray(v, jnp.float32)
    with tnn.compute_dtype_scope(BF16):
        tl = Conv2d(32, 32, 3, stride) if conv else BatchNorm2d(32)
    flat = {f"l.{k}": np.asarray(getattr(jl, k).value)
            for k in (("kernel", "bias") if conv else ("scale", "bias", "mean", "var"))}
    tl.load_state_dict({k[2:]: v for k, v in params_from_jax(
        flat, torch.nn.ModuleDict({"l": tl})).items()})
    train = layer == "bn_train"
    tl.train(train)
    want = nnx.jit(lambda m, x: m(x) if conv else m(x, use_running_average=not train))(jl, x)
    with torch.no_grad():
        got = tl(tx)
    assert got.dtype == BF16 and want.dtype == jnp.bfloat16
    same = (got.float().permute(0, 2, 3, 1).numpy() == np.asarray(want.astype(jnp.float32))).mean()
    assert same >= (0.999 if conv else 1.0), same


# the main model in bf16 -----------------------------------------------------

def test_head_outputs_within_the_reference_gap(ref, monkeypatch):
    """The head's bf16 outputs; `predict` decodes them in float32 and runs
    the NMS IoU on float32 boxes."""
    nms_rotated = importlib.import_module("jdet_torch.ops.nms_rotated")
    u8, _, weights, runs = ref
    model = _port(weights)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
    with torch.no_grad():
        outs = model.bbox_head(model.extract_feat(images))
    fracs = {}
    for lvl, ((cls, reg), (bc, br), (fc, fr)) in enumerate(
            zip(outs, runs["bf16"]["outs"], runs["f32"]["outs"])):
        assert cls.dtype == reg.dtype == BF16
        assert bc.dtype == br.dtype == jnp.bfloat16
        for got, b, f, what in ((cls, bc, fc, "cls"), (reg, br, fr, "reg")):
            got = got.float().permute(0, 2, 3, 1).numpy()
            fracs[f"level {lvl} {what}"] = _gap_fraction(got, b.astype(np.float32), f, what)
    _assert_fractions(fracs, HEAD, HEAD, "head outputs")

    # the CPU NMS evaluates its IoU pairs (`_plain_suppression`) in chunks
    seen = []
    real_iou = nms_rotated.box_iou_rotated_aligned
    monkeypatch.setattr(nms_rotated, "box_iou_rotated_aligned",
                        lambda a, b, **kw: (seen.append((a.dtype, b.dtype)), real_iou(a, b, **kw))[1])
    model.bbox_head.test_cfg = dict(score_thr=0.0, nms_pre=64, nms_iou_thr=0.1, max_per_img=20)
    det = model.predict(images)
    assert seen and set(seen) == {(torch.float32, torch.float32)}
    assert {k: v.dtype for k, v in det.items()} == {
        "boxes": torch.float32, "polys": torch.float32, "scores": torch.float32,
        "labels": torch.int64, "valid": torch.bool}
    assert det["valid"].sum() > 0 and torch.isfinite(det["boxes"]).all()


def test_loss_gradients_and_one_sgd_step_within_the_reference_gap(ref, monkeypatch):
    """The losses, every trainable parameter's gradient and the parameters
    after one train step (warmup lr, clip 35, momentum, wd), each held to
    the reference's bf16 - f32 gap; the frozen stages stay untouched. The
    head's loss inputs, the fused assigner's boxes and the parameters and
    gradients are float32."""
    from jdet_torch.models.boxes import anchor_target

    u8, targets, weights, runs = ref
    assert _assignment_margin(_port(weights, None), targets) > 1e-5
    seen = {}
    real_assign = anchor_target.max_iou_assign_rotated

    def spy_assign(anchors, gt_bboxes, *a, **kw):
        seen["assigner"] = (anchors.dtype, gt_bboxes.dtype)
        return real_assign(anchors, gt_bboxes, *a, **kw)

    monkeypatch.setattr(anchor_target, "max_iou_assign_rotated", spy_assign)
    head_module = importlib.import_module("jdet_torch.models.heads.rotated_retina_head")
    for loss_name in ("sigmoid_focal_loss", "smooth_l1_loss"):
        real = getattr(head_module, loss_name)

        def spy_loss_fn(pred, target, *a, _real=real, _name=loss_name, **kw):
            seen[_name] = pred.dtype
            return _real(pred, target, *a, **kw)

        monkeypatch.setattr(head_module, loss_name, spy_loss_fn)
    model = _port(weights)
    real_loss = model.bbox_head.loss

    def spy_loss(outs, t):
        seen["head_outputs"] = {o.dtype for lvl in outs for o in lvl}
        return real_loss(outs, t)

    model.bbox_head.loss = spy_loss
    model.train()
    images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
    losses = model.loss(images, _torch_targets(targets))
    total, log_vars = parse_losses(losses)
    total.backward()
    assert seen == {"head_outputs": {BF16}, "assigner": (torch.float32, torch.float32),
                    "sigmoid_focal_loss": torch.float32, "smooth_l1_loss": torch.float32}
    assert all(v.dtype == torch.float32 for v in losses.values())
    _assert_fractions({k: _gap_fraction(log_vars[k].item(), runs["bf16"]["losses"][k],
                                        runs["f32"]["losses"][k], k)
                       for k in ("loss_cls", "loss_bbox", "total_loss")}, LOSS, LOSS, "losses")

    fracs = {}
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        if not p.requires_grad:
            assert p.grad is None, name
            continue
        assert p.grad.dtype == torch.float32, name
        fracs[name] = _gap_fraction(p.grad.numpy(), runs["bf16"]["grads"][name],
                                    runs["f32"]["grads"][name], name)
    assert len(fracs) > 50
    _assert_fractions(fracs, GRAD_MEDIAN, GRAD_MAX, "gradients")

    model = _port(weights)
    frozen0 = {k: p.detach().clone() for k, p in model.named_parameters() if not p.requires_grad}
    start = {k: p.detach().clone() for k, p in model.named_parameters()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    step = build_train_step(model, opt, preprocess=make_device_normalizer(MEAN, STD))
    step(torch.from_numpy(u8), _torch_targets(targets), 0)
    fracs = {}
    for name, p in model.named_parameters():
        assert p.dtype == torch.float32, name
        if name in frozen0:
            torch.testing.assert_close(p.detach(), frozen0[name], rtol=0, atol=0)
            continue
        # the step's change, against the reference's changes in bf16 and f32
        s = start[name].numpy()
        fracs[name] = _gap_fraction(p.detach().numpy() - s, runs["bf16"]["params"][name] - s,
                                    runs["f32"]["params"][name] - s, name)
    _assert_fractions(fracs, GRAD_MEDIAN, GRAD_MAX, "one SGD step")
