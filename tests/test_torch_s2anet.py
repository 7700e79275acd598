"""The S2ANet slice of jdet_torch against jdet_tpu, on the CPU.

The model is the one of tests/test_s2anet.py (ResNet-18, FPN 64,
stacked_convs=2, 128², B=2), here with frozen_stages=1 and random BN
statistics; its weights are carried into the port through
`params_from_jax`. Tolerances:
- `AlignConv.get_offset` atol 1e-5 (the same float32 operations);
- `deform_conv2d` outputs and gradients with respect to input and weight
  (against `jax.grad`) rtol 1e-4, with an atol of 1e-5 of the tensor's
  largest value: the port samples through `grid_sample` on coordinates
  mapped to [-1, 1] and back (~1e-5 px of rounding at these sizes), and
  sums in another order;
- `rotate_arf` and `rotation_invariant_pooling` exactly, `ORConv2d` as the
  deformable conv;
- head outputs atol 1e-4 (convolutions sum in another order); the four
  losses rtol 1e-4; `predict`, fed the JAX head outputs: the same valid
  slots and labels, scores rtol 1e-6, boxes atol 1e-4;
- one train step (warmup lr, clip 35): the parameters within 1e-3 of each
  tensor's largest value (tests/test_torch_train_step.py's tolerance), and
  each tensor's change within 1e-3 of the reference change's largest
  value or two float32 spacings of the tensor's largest value, whichever
  is larger (a change below the parameter's resolution is its rounding);
- the bf16 model as a fraction of the reference's own bf16 - f32 gap
  (root mean squares, as tests/test_torch_bf16.py states them): each head
  output of each level within 0.8 of it (0.16-0.78 measured: one-ulp
  flips of bf16 outputs, as there), and the four losses together within
  0.25 (0.15 measured). The four are pooled: the gap of one loss can
  cancel to 1e-5 (loss_fam_bbox's did) while the port's bf16 outputs
  stand 1-4 ulps from the reference's, as the reference's stand from its
  float32 ones. The reference's losses are taken on its head outputs as
  returned, rounded to bf16, as its `loss` specifies: its own jitted
  loss sees XLA's excess precision, float32 sums of the fused output
  convs that the returned outputs never hold, and sits 1.8 gaps from
  both its returned outputs' losses and the port's.
The batch is drawn without near ties (1e-5) in either assignment, FAM on
the init anchors and ODM on the refined ones."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.heads.s2anet_head import AlignConv as JAlignConv
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.ops.deform_conv import deform_conv2d as j_deform_conv2d
from jdet_tpu.ops.orn import ORConv2d as JORConv2d
from jdet_tpu.ops.orn import arf_gather_indices as j_arf_gather_indices
from jdet_tpu.ops.orn import rotate_arf as j_rotate_arf
from jdet_tpu.ops.orn import rotation_invariant_pooling as j_rotation_invariant_pooling
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.parallel.spmd import make_device_normalizer as j_make_device_normalizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.heads.s2anet_head import AlignConv
from jdet_torch.ops.box_iou_rotated import box_iou_rotated
from jdet_torch.ops.deform_conv import deform_conv2d
from jdet_torch.ops.orn import ORConv2d, arf_gather_indices, rotate_arf, rotation_invariant_pooling
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step, make_device_normalizer
from test_torch_retinanet import _randomize_bn
from test_torch_train_step import MEAN, SCHED, STD, _assert_close_per_tensor

CFG = dict(
    type="S2ANet",
    backbone=dict(type="ResNet", depth=18, frozen_stages=1),
    neck=dict(type="FPN", out_channels=64, num_outs=5, start_level=1,
              add_extra_convs="on_input"),
    bbox_head=dict(type="S2ANetHead", num_classes=16, in_channels=64, feat_channels=64,
                   stacked_convs=2, test_cfg=dict(nms_pre=256, max_per_img=32)),
)
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0), frozen_stages=1)
BF16 = torch.bfloat16
HEAD_GAP, LOSS_GAP = 0.8, 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once, and
    torch's thread pool on a busy machine made these small models several
    times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_params(module):
    """{flat path: array} of every variable, the ARF table `_src` (a plain
    array in the nnx state) included."""
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}


def _trainable(flat, model):
    """The port's names and values of the reference's parameters."""
    return {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in flat.items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale", "weight")}, model).items()}


def _margin(head, gts, mask, anchors):
    """Smallest gap between a gt's best IoU and its second best, and
    between an anchor's best IoU and 0.4 / 0.5, on (B, N, 5) anchors."""
    margin = np.inf
    for b in range(len(gts)):
        iou = box_iou_rotated(torch.as_tensor(gts[b][mask[b]]), anchors[b]).double()
        top2 = iou.topk(2, dim=1).values
        best = iou.max(0).values
        margin = min(margin, (top2[:, 0] - top2[:, 1]).min().item(),
                     (best - 0.5).abs().min().item(), (best - 0.4).abs().min().item())
    return margin


def _batch(tmodel, size=128, B=2, K=8, real=3):
    """uint8 images and padded targets, the first seed from 1 whose FAM and
    ODM assignments have no near tie."""
    head = tmodel.bbox_head
    init = head._flat_init_anchors([(size // s, size // s) for s in head.anchor_strides], "cpu")
    for seed in range(1, 50):
        rng = np.random.RandomState(seed)
        u8 = (rng.rand(B, size, size, 3) * 255).astype(np.uint8)
        gt = np.zeros((B, K, 5), np.float32)
        mask = np.zeros((B, K), bool)
        labels = np.zeros((B, K), np.int64)
        for b in range(B):
            mask[b, :real] = True
            gt[b, :real] = np.stack([
                rng.uniform(30, 100, real), rng.uniform(30, 100, real),
                rng.uniform(16, 60, real), rng.uniform(8, 30, real),
                rng.uniform(-np.pi / 4, 3 * np.pi / 4, real)], 1)
            labels[b, :real] = rng.randint(1, 16, real)
        with torch.no_grad():
            images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
            outs = head(tmodel.extract_feat(images))
        refine = torch.cat([o[2].reshape(B, -1, 5) for o in outs], 1)
        if min(_margin(head, gt, mask, init.expand(B, -1, -1)),
               _margin(head, gt, mask, refine)) > 1e-5:
            return u8, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}
    raise AssertionError("no tie-free batch")


def _jax_model(dtype=None):
    """The reference model with random BN statistics and an ODM class conv
    of std 0.3 (0.01 at init), so that `predict`'s scores do not tie."""
    with j_compute_dtype_scope(dtype):
        jmodel = j_build_detector(CFG, seed=0)
    _randomize_bn(jmodel, seed=1)
    kernel = jmodel.bbox_head.odm_cls.kernel
    kernel.set_value(jnp.asarray(np.random.RandomState(2).normal(
        0.0, 0.3, kernel.get_value().shape), jnp.float32))
    return jmodel


def _port(weights, dtype=None):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def _nhwc(outs):
    """Head outputs -> numpy, NHWC like the reference's (the refined
    anchors are (B, H, W, 5) already)."""
    return [[(t.permute(0, 2, 3, 1) if i != 2 else t).float().detach().numpy()
             for i, t in enumerate(lvl)] for lvl in outs]


@pytest.fixture(scope="module")
def ref():
    """The reference, jitted once per dtype as its Runner runs it: in
    float32 the eval-mode head outputs, `predict` on them (score_thr 0),
    and one train step as its `build_train_step` takes it (the losses, then
    the optimizer's update of the gradients); in bf16 the head outputs and
    the losses. Also the weights, the port with them, and the batch."""
    jmodel = _jax_model()
    weights = _numpy_params(jmodel)
    tmodel = _port(weights)
    tmodel.eval()
    u8, targets = _batch(tmodel)
    images = j_make_device_normalizer(MEAN, STD)(jnp.asarray(u8))
    jt = {k: jnp.asarray(v) for k, v in targets.items()}

    def bf16_forward(m):
        # the losses of the outputs as returned, rounded to bf16: under jit,
        # XLA keeps the fused output convs' sums in float32 where `loss`
        # casts them to float32 at once, so the reference's own jitted loss
        # sees logits the returned outputs never hold
        outs = m.bbox_head(m.extract_feat(images))
        return outs, m.bbox_head.loss(jax.lax.optimization_barrier(outs), jt)

    @nnx.jit
    def f32_run(m, opt):
        outs = m.bbox_head(m.extract_feat(images))
        det = m.bbox_head.predict(outs)
        (_, log_vars), grads = nnx.value_and_grad(
            lambda m: j_parse_losses(m.loss(images, jt)), has_aux=True)(m)
        opt.update(m, grads)
        return outs, det, log_vars

    jmodel.bbox_head.test_cfg = dict(jmodel.bbox_head.test_cfg, score_thr=0.0)
    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
    outs, det, log_vars = f32_run(jmodel, jopt)
    runs = {"f32": {"outs": [[np.asarray(t) for t in lvl] for lvl in outs],
                    "predict": {k: np.asarray(v) for k, v in det.items()},
                    "losses": {k: float(v) for k, v in log_vars.items()},
                    "step_params": _trainable(_numpy_params(jmodel), tmodel)}}
    outs, log_vars = nnx.jit(bf16_forward)(_jax_model(jnp.bfloat16))
    runs["bf16"] = {"outs": [[np.asarray(t, np.float32) for t in lvl] for lvl in outs],
                    "losses": {k: float(v) for k, v in log_vars.items()}}
    return weights, tmodel, u8, targets, runs


# the ops ------------------------------------------------------------------

def test_get_offset_matches():
    rng = np.random.RandomState(0)
    B, H, W, stride = 2, 6, 9, 16
    anchors = np.stack([rng.uniform(-20, W * stride + 20, (B, H, W)),
                        rng.uniform(-20, H * stride + 20, (B, H, W)),
                        rng.uniform(4, 400, (B, H, W)), rng.uniform(4, 120, (B, H, W)),
                        rng.uniform(-np.pi / 4, 3 * np.pi / 4, (B, H, W))], -1)
    anchors = anchors.astype(np.float32)
    want = JAlignConv(4, 4, 3, rngs=nnx.Rngs(0)).get_offset(jnp.asarray(anchors), stride)
    got = AlignConv(4, 4, 3).get_offset(torch.from_numpy(anchors), stride)
    assert got.shape == (B, H, W, 9, 2) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def _assert_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("offsets", ["zero", "integer_shift", "fractional"])
def test_deform_conv2d_and_its_gradients_match(offsets):
    """Zero offsets (a plain 3x3 conv, checked against F.conv2d too), an
    integer shift of every tap, and fractional offsets of up to 6 px that
    send some samples outside the image and some past (-1, H)."""
    rng = np.random.RandomState(1)
    B, C, H, W, O = 2, 6, 9, 11, 5
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, O) * 0.2).astype(np.float32)
    if offsets == "zero":
        off = np.zeros((B, H, W, 9, 2), np.float32)
    elif offsets == "integer_shift":
        off = np.broadcast_to(np.float32([2.0, -1.0]), (B, H, W, 9, 2)).copy()
    else:
        off = rng.uniform(-6, 6, (B, H, W, 9, 2)).astype(np.float32)
    cot = rng.randn(B, H, W, O).astype(np.float32)

    def j_f(x, w):
        return (j_deform_conv2d(x, jnp.asarray(off), w) * cot).sum()

    want = j_deform_conv2d(jnp.asarray(x), jnp.asarray(off), jnp.asarray(w))
    want_dx, want_dw = jax.grad(j_f, (0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).contiguous().requires_grad_()
    got = deform_conv2d(xt, torch.from_numpy(off), wt)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    _assert_close(got.detach().permute(0, 2, 3, 1).numpy(), want, "output")
    _assert_close(xt.grad.permute(0, 2, 3, 1).numpy(), want_dx, "d input")
    _assert_close(wt.grad.permute(2, 3, 1, 0).numpy(), want_dw, "d weight")
    if offsets == "zero":
        conv = torch.nn.functional.conv2d(xt.detach(), wt.detach(), padding=1)
        torch.testing.assert_close(got.detach(), conv, rtol=1e-4, atol=1e-5)


def test_rotate_arf_and_pooling_are_exact():
    rng = np.random.RandomState(2)
    for n_or, n_rot, k in ((1, 8, 3), (8, 8, 3), (8, 8, 1), (4, 8, 3)):
        np.testing.assert_array_equal(arf_gather_indices(n_or, n_rot, k),
                                      j_arf_gather_indices(n_or, n_rot, k))
    weight = rng.randn(5, 3, 8, 3, 3).astype(np.float32)
    src = arf_gather_indices(8, 8, 3)
    want = np.asarray(j_rotate_arf(jnp.asarray(weight), src))  # HWIO
    got = rotate_arf(torch.from_numpy(weight), torch.from_numpy(src))
    np.testing.assert_array_equal(got.numpy(), want.transpose(3, 2, 0, 1))
    x = rng.randn(2, 4, 5, 24).astype(np.float32)
    np.testing.assert_array_equal(
        rotation_invariant_pooling(torch.from_numpy(x).permute(0, 3, 1, 2), 8)
        .permute(0, 2, 3, 1).numpy(),
        np.asarray(j_rotation_invariant_pooling(jnp.asarray(x), 8)))


def test_orconv_matches_and_its_arf_backward_is_a_scatter_add():
    rng = np.random.RandomState(3)
    jconv = JORConv2d(16, 4, kernel_size=3, padding=1, arf_config=(1, 8), rngs=nnx.Rngs(4))
    jconv.bias.set_value(jnp.asarray(rng.normal(0, 0.1, 32).astype(np.float32)))
    conv = ORConv2d(16, 4, kernel_size=3, arf_config=(1, 8))
    conv.load_state_dict(params_from_jax(
        {k.split(".", 1)[1] if "." in k else k: v
         for k, v in {f"m.{k}": v for k, v in _numpy_params(jconv).items()}.items()}, conv))
    x = rng.randn(2, 7, 6, 16).astype(np.float32)
    cot = rng.randn(2, 7, 6, 32).astype(np.float32)

    def j_f(m, x):
        return (m(x) * cot).sum()

    want = jconv(jnp.asarray(x))
    want_dw = nnx.grad(j_f)(jconv, jnp.asarray(x))["weight"].get_value()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = conv(xt)
    (got * torch.from_numpy(cot).permute(0, 3, 1, 2)).sum().backward()
    assert got.dtype == torch.float32 and conv(xt.to(BF16)).dtype == torch.float32
    _assert_close(got.detach().permute(0, 2, 3, 1).numpy(), want, "output")
    _assert_close(conv.weight.grad.numpy(), want_dw, "d weight")


# the model ----------------------------------------------------------------

def test_params_from_jax_maps_the_s2anet_leaves(ref):
    weights, tmodel, *_ = ref
    sd = params_from_jax(weights, tmodel)
    assert sd["bbox_head.align_conv.deform_conv.weight"].shape == (64, 64, 3, 3)
    np.testing.assert_array_equal(sd["bbox_head.align_conv.deform_conv.weight"].numpy(),
                                  weights["bbox_head.align_conv.deform_conv.weight"]
                                  .transpose(3, 2, 0, 1))
    assert sd["bbox_head.or_conv.weight"].shape == (8, 64, 1, 3, 3)
    assert weights["bbox_head.or_conv.wexp"].shape == (0,)
    assert not any(k.endswith(("wexp", "_src")) for k in sd)
    flat = dict(weights)
    flat.pop("bbox_head.or_conv.weight")
    with pytest.raises(RuntimeError, match="Missing"):
        load_from_jax(tmodel, flat)
    load_from_jax(tmodel, weights)


def test_build_detector_builds_the_config_at_full_width():
    cfg = load_cfg_file("configs/s2anet_r50_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    head = model.bbox_head
    assert type(model).__name__ == "S2ANet" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and head.cls_out_channels == 15
    assert len(head.fam_cls_convs) == len(head.odm_reg_convs) == 2
    assert tuple(head.or_conv.weight.shape) == (32, 256, 1, 3, 3)
    assert tuple(head.align_conv.deform_conv.weight.shape) == (256, 256, 3, 3)
    anchors = head._flat_init_anchors([(1024 // s, 1024 // s) for s in head.anchor_strides],
                                      "cpu")
    assert anchors.shape == (21824, 5)
    assert head.test_cfg == dict(nms_pre=2000, score_thr=0.05, nms_iou_thr=0.1,
                                 max_per_img=2000)


def test_head_outputs_match(ref):
    _, tmodel, u8, _, runs = ref
    tmodel.eval()
    with torch.no_grad():
        images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
        got = _nhwc(tmodel.bbox_head(tmodel.extract_feat(images)))
    assert len(got) == len(runs["f32"]["outs"]) == 5
    for lvl, (g, w) in enumerate(zip(got, runs["f32"]["outs"])):
        assert g[2].shape == w[2].shape and g[2].shape[-1] == 5
        for i, (gi, wi) in enumerate(zip(g, w)):
            # refined anchors are image coordinates: atol 1e-4 of their scale
            atol = 1e-4 * (max(1.0, np.abs(wi).max()) if i == 2 else 1.0)
            np.testing.assert_allclose(gi, wi, rtol=0, atol=atol, err_msg=f"level {lvl} out {i}")


def test_losses_match(ref):
    _, tmodel, u8, targets, runs = ref
    tmodel.train()
    images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
    got = tmodel.loss(images, {k: torch.from_numpy(v) for k, v in targets.items()})
    tmodel.eval()
    assert set(got) == {"loss_fam_cls", "loss_fam_bbox", "loss_odm_cls", "loss_odm_bbox"}
    for k in got:
        want = runs["f32"]["losses"][k]
        np.testing.assert_allclose(got[k].item(), want, rtol=1e-4, err_msg=k)
        assert want > 0, k


def test_predict_matches_on_jax_head_outputs(ref):
    _, tmodel, _, _, runs = ref
    want = runs["f32"]["predict"]
    touts = [tuple(torch.tensor(t) if i == 2 else torch.tensor(t).permute(0, 3, 1, 2)
                   for i, t in enumerate(lvl)) for lvl in runs["f32"]["outs"]]
    head = tmodel.bbox_head
    head.test_cfg = dict(head.test_cfg, score_thr=0.0)
    got = {k: v.numpy() for k, v in head.predict(touts).items()}
    head.test_cfg = dict(head.test_cfg, score_thr=0.05)
    v = want["valid"]
    assert v.sum() > 0 and got["boxes"].shape == want["boxes"].shape == (2, 32, 5)
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], atol=1e-4)
    np.testing.assert_allclose(got["polys"][v], want["polys"][v], atol=1e-4)


def test_one_train_step_matches(ref):
    weights, _, u8, targets, runs = ref
    model = _port(weights)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    step = build_train_step(model, opt, preprocess=make_device_normalizer(MEAN, STD))
    lv = step(torch.from_numpy(u8), {k: torch.from_numpy(v) for k, v in targets.items()}, 0)
    for k, want in runs["f32"]["losses"].items():
        np.testing.assert_allclose(lv[k].item(), want, rtol=1e-3, err_msg=k)
    want = runs["f32"]["step_params"]
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    _assert_close_per_tensor(got, {n: want[n] for n in got}, "param")
    moved = [n for n in got if (want[n] != start[n].numpy()).any()]
    assert {"bbox_head.align_conv.deform_conv.weight", "bbox_head.or_conv.weight"} <= set(moved)
    for n in moved:
        s0 = start[n].numpy()
        tol = max(1e-3 * np.abs(want[n] - s0).max(), 2 * np.spacing(np.abs(s0).max()))
        np.testing.assert_allclose(got[n] - s0, want[n] - s0, rtol=0, atol=tol,
                                   err_msg=f"step change {n}")
    for n, p in model.named_parameters():
        if not p.requires_grad:
            assert n not in moved and torch.equal(p.detach(), start[n]), n


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_bf16_model_within_the_reference_gap(ref):
    """The port built under the bf16 policy: the head outputs (FAM and ODM
    class and box outputs, the refined anchors) and the four losses, each
    the RMS distance to the reference's bf16 result over the reference's
    own bf16 - f32 gap. The deformable conv's output and the ORConv run in
    float32, as in the reference."""
    weights, _, u8, targets, runs = ref
    model = _port(weights, BF16)
    model.eval()
    images = make_device_normalizer(MEAN, STD)(torch.from_numpy(u8))
    feats = model.extract_feat(images)
    with torch.no_grad():
        outs = model.bbox_head(feats)
        align = model.bbox_head.align_conv(feats[0], outs[0][2], 8)
    assert [t.dtype for t in outs[0]] == [BF16, BF16, torch.float32, BF16, BF16]
    assert align.dtype == torch.float32
    fracs = {}
    for lvl, (g, b, f) in enumerate(zip(_nhwc(outs), runs["bf16"]["outs"], runs["f32"]["outs"])):
        for i, name in enumerate(("fam_cls", "fam_reg", "refined", "odm_cls", "odm_reg")):
            gap = _rms(b[i] - f[i])
            if gap > 0:
                fracs[f"level {lvl} {name}"] = _rms(g[i] - b[i]) / gap
    worst = max(fracs, key=fracs.get)
    assert fracs[worst] <= HEAD_GAP, f"{worst} at {fracs[worst]:.3f} of the gap: {fracs}"
    model.train()
    losses = model.loss(images, {k: torch.from_numpy(v) for k, v in targets.items()})
    assert all(v.dtype == torch.float32 for v in losses.values())
    got, bf16, f32 = (np.array([d[k] for k in sorted(losses)]) for d in (
        {k: v.item() for k, v in losses.items()}, runs["bf16"]["losses"], runs["f32"]["losses"]))
    frac = _rms(got - bf16) / _rms(bf16 - f32)
    assert frac <= LOSS_GAP, f"losses at {frac:.3f} of the gap: {got} {bf16} {f32}"
