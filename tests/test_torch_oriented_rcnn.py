"""The Oriented R-CNN slice of jdet_torch against jdet_tpu, on the CPU.

The model is the one of tests/test_oriented_rcnn.py (ResNet-18, FPN 64,
128², RPN nms_pre 128 / nms_post 64, 48 sampled RoIs, fc_out_channels
128, B=2), here with random BN statistics; its weights are carried into
the port through `params_from_jax`. JAX's random streams do not carry
over: the port's samplers take the reference's own uniforms, drawn here
from the same key splits as `two_stage.py:42`, `rpn_heads.py:139`,
`oriented_head.py:166-167` and `sampler.py:61`, through their `rand`
argument. The ops are held against the reference run eagerly; the model
against the reference jitted, as its Runner runs it, on a batch drawn
without near ties in either assignment (see `_batch`). Tolerances:
- the midpoint coder: encode atol 1e-5, decode atol 1e-4 px and 1e-5 rad;
  HBB anchors, `hbb_overlaps`, `max_iou_assign_hbb` (on gts placed to
  tie on the anchor grid), `random_sample` on replayed draws, the hbb
  anchor targets and `nms` exactly; CE/BCE rtol 1e-6;
- `Linear` rtol 1e-6 in float32, in bf16 within one bf16 ulp of the
  output's scale (the product's float32 sums run in another order);
- the FPN with the defaults and with each extra-level option atol 1e-5;
- RPN: outputs atol 1e-5, losses rtol 1e-5, proposals' boxes atol 1e-4
  and scores 1e-6 on the same valid slots;
- `roi_align_rotated_multilevel`: forward atol 1e-5, its gradient
  against `jax.vjp` atol 1e-4; `roi_align_rotated` on one level atol 1e-5;
- `OrientedHead` and the whole `OrientedRCNN`: losses rtol 1e-5, the
  RoI head's outputs atol 1e-5 of their largest value (the first FC sums
  3136 products), `predict`'s boxes and scores atol 1e-4 on the same
  valid slots;
- 2 train steps (warmup lr, clip 35): each parameter within 1e-4 of its
  tensor's largest value;
- the bf16 model as a fraction of the reference's own bf16 - f32 gap
  (root mean squares, as tests/test_torch_bf16.py states them): RPN
  outputs and the RoI head's outputs on the same RoIs within 0.8, the
  losses pooled within 0.5.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.boxes.anchor_generator import AnchorGeneratorHBB as JAnchorGeneratorHBB
from jdet_tpu.models.boxes.anchor_target import anchor_target_batch as j_anchor_target_batch
from jdet_tpu.models.boxes.assigner import hbb_overlaps as j_hbb_overlaps
from jdet_tpu.models.boxes.assigner import max_iou_assign_hbb as j_max_iou_assign_hbb
from jdet_tpu.models.boxes.coder import midpoint_offset_decode as j_decode
from jdet_tpu.models.boxes.coder import midpoint_offset_encode as j_encode
from jdet_tpu.models.boxes.sampler import random_sample as j_random_sample
from jdet_tpu.models.builder import build_detector as j_build_detector
from jdet_tpu.models.losses import binary_cross_entropy_loss as j_bce
from jdet_tpu.models.losses import cross_entropy_loss as j_ce
from jdet_tpu.models.necks.fpn import FPN as JFPN
from jdet_tpu.models.nn import Linear as JLinear
from jdet_tpu.models.nn import compute_dtype_scope as j_compute_dtype_scope
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.ops.box_convert import rbox_to_hbox as j_rbox_to_hbox
from jdet_tpu.ops.nms import nms as j_nms
from jdet_tpu.ops.roi_align_rotated import roi_align_rotated as j_roi_align
from jdet_tpu.ops.roi_align_rotated import roi_align_rotated_multilevel as j_roi_align_ml
from jdet_tpu.optim.lr_scheduler import build_lr_schedule as j_build_lr_schedule
from jdet_tpu.optim.optimizer import build_optimizer as j_build_optimizer
from jdet_tpu.utils.general import parse_losses as j_parse_losses
from jdet_torch.config import load_cfg_file
from jdet_torch.models import nn as tnn
from jdet_torch.models.boxes.anchor_generator import AnchorGeneratorHBB
from jdet_torch.models.boxes.anchor_target import anchor_target_batch
from jdet_torch.models.boxes.assigner import hbb_overlaps, max_iou_assign_hbb
from jdet_torch.models.boxes.coder import midpoint_offset_decode, midpoint_offset_encode
from jdet_torch.models.boxes.sampler import random_sample
from jdet_torch.models.builder import build_detector
from jdet_torch.models.convert import load_from_jax, params_from_jax
from jdet_torch.models.layers import Linear
from jdet_torch.models.losses import binary_cross_entropy_loss, cross_entropy_loss
from jdet_torch.models.necks import FPN
from jdet_torch.ops import box_iou_rotated, rbox_to_hbox
from jdet_torch.ops.nms import nms
from jdet_torch.ops.roi_align_rotated import roi_align_rotated, roi_align_rotated_multilevel
from jdet_torch.optim import build_lr_schedule, build_optimizer
from jdet_torch.parallel import build_train_step
from test_torch_retinanet import _randomize_bn
from test_torch_train_step import SCHED

CFG = dict(
    type="OrientedRCNN",
    backbone=dict(type="ResNet", depth=18, frozen_stages=-1),
    neck=dict(type="FPN", out_channels=64, num_outs=5),
    rpn_head=dict(type="OrientedRPNHead", in_channels=64, feat_channels=64,
                  anchor_strides=(4, 8, 16, 32, 64), nms_pre=128, nms_post=64),
    bbox_head=dict(type="OrientedHead", num_classes=15, in_channels=64,
                   fc_out_channels=128, featmap_strides=(4, 8, 16, 32),
                   train_cfg=dict(sampler=dict(num=48, pos_fraction=0.25)),
                   test_cfg=dict(max_per_img=16, score_thr=0.01)),
)
OPT_KW = dict(opt_type="SGD", momentum=0.9, weight_decay=1e-4,
              grad_clip=dict(max_norm=35.0))
BF16 = torch.bfloat16
NET_GAP, LOSS_GAP = 0.8, 0.5


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
    _, flat = flat_paths(module)
    return {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}


def _t(a):
    return torch.from_numpy(np.array(a))


class Replay:
    """The reference's sampler uniforms, handed out in the order the port
    asks for them: `rand(shape)` returns the next (B, n) block."""

    def __init__(self, blocks):
        self.blocks = list(blocks)

    def __call__(self, shape):
        block = self.blocks.pop(0)
        assert tuple(block.shape) == tuple(shape), (block.shape, shape)
        return _t(block)


def sampler_draws(key, B, n):
    """What `anchor_target_batch`/`OrientedHead.loss` draw from `key`: per
    image split(key, B)[b], then `random_sample`'s (kp, kn) =
    split(key_b), one uniform (n,) from each. Returns [pos (B, n), neg (B, n)]."""
    keys = jax.random.split(key, B)
    pairs = [jax.random.split(k) for k in keys]
    return [np.stack([np.asarray(jax.random.uniform(p[i], (n,))) for p in pairs])
            for i in (0, 1)]


def model_draws(key, B, n_anchors, n_rois):
    """The four blocks `RCNN.loss(key=key)` draws: RPN pos, RPN neg, RoI
    pos, RoI neg."""
    k1, k2 = jax.random.split(key)
    return sampler_draws(k1, B, n_anchors) + sampler_draws(k2, B, n_rois)


def _rboxes(rng, n, lo=30, hi=100):
    return np.stack([rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
                     rng.uniform(16, 60, n), rng.uniform(8, 30, n),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)


# the ops --------------------------------------------------------------------

def test_midpoint_coder_matches():
    rng = np.random.RandomState(0)
    gts = _rboxes(rng, 64)
    hbb = np.sort(rng.uniform(10, 120, (64, 2, 2)), axis=1).reshape(64, 4)[:, [0, 2, 1, 3]]
    hbb = hbb.astype(np.float32)
    hbb[:, 2:] += 4
    want = np.asarray(j_encode(jnp.asarray(hbb), jnp.asarray(gts)))
    got = midpoint_offset_encode(_t(hbb), _t(gts)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    deltas = rng.normal(0, 0.3, (64, 6)).astype(np.float32)
    want = np.asarray(j_decode(jnp.asarray(hbb), jnp.asarray(deltas)))
    got = midpoint_offset_decode(_t(hbb), _t(deltas)).numpy()
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[:, 4], want[:, 4], rtol=0, atol=1e-5)


def test_hbb_anchors_match():
    j = JAnchorGeneratorHBB(strides=(4, 8, 16, 32, 64), ratios=(0.5, 1.0, 2.0), scales=(8,))
    t = AnchorGeneratorHBB((4, 8, 16, 32, 64), (0.5, 1.0, 2.0), (8,))
    for lvl, hw in enumerate((32, 16, 8, 4, 2)):
        np.testing.assert_array_equal(t.grid_anchors((hw, hw + 1), lvl, device="cpu").numpy(),
                                      np.asarray(j.grid_anchors((hw, hw + 1), lvl)))
    full = sum(t.grid_anchors((1024 // s, 1024 // s), lvl, device="cpu").shape[0]
               for lvl, s in enumerate((4, 8, 16, 32, 64)))
    assert full == 261888


def _grid_tie_gts(anchors, rng, B=2, K=10, real=7):
    """hbb gts placed to tie on the anchor grid: copies of anchors, and
    boxes centred halfway between two neighbouring anchors, so that
    several anchors share a gt's best IoU exactly."""
    gts = np.zeros((B, K, 4), np.float32)
    mask = np.zeros((B, K), bool)
    for b in range(B):
        idx = rng.choice(len(anchors), real, replace=False)
        g = anchors[idx].copy()
        g[real // 2:, [0, 2]] += 2.0  # half a stride-4 step
        g[real - 1] = g[0]  # a duplicate gt
        gts[b, :real] = g
        mask[b, :real] = True
    return gts, mask


def test_hbb_overlaps_and_assigner_are_exact_on_grid_ties():
    gen = AnchorGeneratorHBB((4, 8), (0.5, 1.0, 2.0), (8,))
    anchors = torch.cat([gen.grid_anchors((16, 16), 0, device="cpu"),
                         gen.grid_anchors((8, 8), 1, device="cpu")]).numpy()
    gts, mask = _grid_tie_gts(anchors, np.random.RandomState(1))
    labels = np.where(mask, np.arange(1, 11), 0)
    np.testing.assert_array_equal(
        hbb_overlaps(_t(gts), _t(anchors)).numpy(),
        np.stack([np.asarray(j_hbb_overlaps(jnp.asarray(g), jnp.asarray(anchors)))
                  for g in gts]))
    cfg = dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3)
    for low_quality in (True, False):
        want = jax.vmap(lambda g, m, l: j_max_iou_assign_hbb(
            jnp.asarray(anchors), g, m, l, match_low_quality=low_quality, **cfg))(
            jnp.asarray(gts), jnp.asarray(mask), jnp.asarray(labels))
        assert int((np.asarray(want["gt_inds"]) > 0).sum()) > 2 * 7
        for chunk in (None, 3):
            got = max_iou_assign_hbb(_t(anchors), _t(gts), _t(mask), _t(labels),
                                     match_low_quality=low_quality, iou_chunk=chunk, **cfg)
            for k in ("gt_inds", "labels", "max_overlaps"):
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_random_sample_replays_the_reference_exactly():
    rng = np.random.RandomState(2)
    gt_inds = rng.choice([-1, 0, 0, 0, 1, 2, 3], (3, 700)).astype(np.int32)
    gt_inds[2, :] = np.where(gt_inds[2] > 0, -1, gt_inds[2])  # no positive
    key = jax.random.PRNGKey(5)
    for num, frac in ((256, 0.5), (48, 0.25)):
        want = [j_random_sample({"gt_inds": jnp.asarray(g)}, k, num, frac)
                for g, k in zip(gt_inds, jax.random.split(key, 3))]
        got = random_sample({"gt_inds": _t(gt_inds).long()}, num, frac,
                            rand=Replay(sampler_draws(key, 3, 700)))
        for k in ("pos_mask", "neg_mask"):
            np.testing.assert_array_equal(got[k].numpy(), np.stack([np.asarray(w[k])
                                                                    for w in want]))
        assert (got["pos_mask"].sum(-1) <= int(num * frac)).all()
        assert ((got["pos_mask"] | got["neg_mask"]).sum(-1) <= num).all()


def test_hbb_anchor_targets_match():
    gen = AnchorGeneratorHBB((4, 8), (0.5, 1.0, 2.0), (8,))
    anchors = torch.cat([gen.grid_anchors((16, 16), 0, device="cpu"),
                         gen.grid_anchors((8, 8), 1, device="cpu")]).numpy()
    gts, mask = _grid_tie_gts(anchors, np.random.RandomState(3))
    labels = mask.astype(np.int32)
    kw = dict(assigner_cfg=dict(pos_iou_thr=0.7, neg_iou_thr=0.3, min_pos_iou=0.3),
              sampler_cfg=dict(type="random", num=64, pos_fraction=0.5),
              rotated=False, reg_decoded_bbox=True)
    key = jax.random.PRNGKey(1)
    want, wpos, wneg = j_anchor_target_batch(
        jnp.asarray(anchors), jnp.ones(len(anchors), bool), jnp.asarray(gts),
        jnp.asarray(mask), jnp.asarray(labels), keys=jax.random.split(key, 2), **kw)
    got, pos, neg = anchor_target_batch(
        _t(anchors), torch.ones(len(anchors), dtype=torch.bool), _t(gts), _t(mask),
        _t(labels), rand=Replay(sampler_draws(key, 2, len(anchors))), **kw)
    assert (int(pos), int(neg)) == (int(wpos), int(wneg)) and int(pos) > 4
    for k in ("labels", "label_weights", "bbox_targets", "bbox_weights", "pos_mask",
              "neg_mask", "gt_inds"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_nms_matches():
    rng = np.random.RandomState(4)
    xy = rng.uniform(0, 60, (3, 90, 2))
    wh = rng.uniform(4, 30, (3, 90, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    scores = rng.rand(3, 90).astype(np.float32)
    scores[:, 10:20] = scores[:, :10]  # ties
    valid = rng.rand(3, 90) > 0.1
    order, keep = nms(_t(boxes), _t(scores), 0.5, valid=_t(valid), max_pairs=90 * 90)
    for b in range(3):
        wo, wk = j_nms(jnp.asarray(boxes[b]), jnp.asarray(scores[b]), 0.5, jnp.asarray(valid[b]))
        np.testing.assert_array_equal(order[b].numpy(), np.asarray(wo))
        np.testing.assert_array_equal(keep[b].numpy(), np.asarray(wk))
    assert 0 < int(keep.sum()) < int(valid.sum())


def test_cross_entropy_and_bce_match():
    rng = np.random.RandomState(5)
    logits = rng.normal(0, 3, (2, 40, 16)).astype(np.float32)
    labels = rng.randint(0, 16, (2, 40))
    w = (rng.rand(2, 40) > 0.3).astype(np.float32)
    np.testing.assert_allclose(
        cross_entropy_loss(_t(logits), _t(labels), weight=_t(w), avg_factor=7.0).item(),
        float(j_ce(jnp.asarray(logits), jnp.asarray(labels), weight=jnp.asarray(w),
                   avg_factor=7.0)), rtol=1e-6)
    tgt = rng.rand(2, 40, 16) > 0.5
    np.testing.assert_allclose(
        binary_cross_entropy_loss(_t(logits), _t(tgt), weight=_t(w)[..., None],
                                  avg_factor=30.0).item(),
        float(j_bce(jnp.asarray(logits), jnp.asarray(tgt), weight=jnp.asarray(w)[..., None],
                    avg_factor=30.0)), rtol=1e-6)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_linear_matches(dtype):
    """The port's Linear from the reference's kernel (I, O) through
    `params_from_jax`, in float32 and under the bf16 policy."""
    rng = np.random.RandomState(6)
    with j_compute_dtype_scope(jnp.bfloat16 if dtype else None):
        jl = JLinear(300, 20, rngs=nnx.Rngs(0))
    jl.bias.set_value(jnp.asarray(rng.normal(0, 0.5, 20), jnp.float32))
    with tnn.compute_dtype_scope(BF16 if dtype else None):
        tl = Linear(300, 20)
    sd = params_from_jax({"kernel": np.asarray(jl.kernel.get_value()),
                          "bias": np.asarray(jl.bias.get_value())}, tl)
    tl.load_state_dict({k.lstrip("."): v for k, v in sd.items()})
    x = rng.normal(0, 1, (4, 7, 300)).astype(np.float32)
    want = np.asarray(jl(jnp.asarray(x)), np.float32)
    got = tl(_t(x))
    if dtype:
        assert got.dtype == BF16
        np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                                   atol=2 ** -7 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)


def test_params_from_jax_converts_linear_kernels():
    kernel = np.arange(12, dtype=np.float32).reshape(3, 4)
    model = torch.nn.ModuleDict({"fc": Linear(3, 4)})
    sd = params_from_jax({"fc.kernel": kernel, "fc.bias": np.zeros(4, np.float32)}, model)
    assert sd["fc.weight"].shape == (4, 3)
    np.testing.assert_array_equal(sd["fc.weight"].numpy(), kernel.T)
    with pytest.raises(ValueError, match="kernel"):
        params_from_jax({"fc.kernel": np.zeros((2, 3, 4), np.float32)}, model)


@pytest.mark.parametrize("extra", [
    dict(), dict(add_extra_convs="on_input"), dict(add_extra_convs="on_lateral"),
    dict(add_extra_convs="on_output"), dict(add_extra_convs=True, extra_convs_on_inputs=False),
    dict(add_extra_convs="on_output", relu_before_extra_convs=True),
    dict(start_level=1, add_extra_convs="on_input", relu_before_extra_convs=True),
])
def test_fpn_matches_with_each_extra_level_option(extra):
    """Both FPNs from the same weights; every level compared. The
    defaults (no extra convs: 1x1 stride-2 max pools) are the reference's."""
    rng = np.random.RandomState(7)
    chans = (8, 16, 24, 32)
    jfpn = JFPN(chans, 12, num_outs=6, rngs=nnx.Rngs(1), **extra)
    tfpn = FPN(chans, 12, num_outs=6, **extra)
    sd = params_from_jax({k: v for k, v in _numpy_params(jfpn).items()}, tfpn)
    tfpn.load_state_dict(sd, strict=True)
    xs = [rng.normal(0, 1, (2, 32 // 2 ** i, 30 // 2 ** i, c)).astype(np.float32)
          for i, c in enumerate(chans)]
    want = jfpn([jnp.asarray(x) for x in xs])
    got = tfpn([_t(x).permute(0, 3, 1, 2) for x in xs])
    assert len(got) == len(want) == 6
    for lvl, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.detach().permute(0, 2, 3, 1).numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5, err_msg=f"level {lvl}")


def test_train_step_hands_the_model_a_generator_seeded_per_iteration():
    """build_train_step passes model.loss a torch.Generator seeded from
    (seed, it): the same draws for the same iteration, fresh ones for the
    next."""
    class Recorder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.ones(()))
            self.draws = []

        def loss(self, images, targets, generator=None):
            self.draws.append(torch.rand(4, generator=generator))
            return {"loss": self.w * images.float().mean()}

    model = Recorder()
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.0, **SCHED), **OPT_KW)
    images = torch.ones(1, 4, 4, 3, dtype=torch.uint8)
    for it in (3, 3, 4):
        build_train_step(model, opt, seed=11)(images, {}, it)
    build_train_step(model, opt, seed=12)(images, {}, 3)
    a, b, c, d = model.draws
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, d)


def _roi_feats(rng, B=2, C=6):
    return [rng.normal(0, 1, (B, 64 // s, 48 // s, C)).astype(np.float32) for s in (4, 8, 16, 32)]


def test_roi_align_multilevel_and_its_gradient_match():
    """RoIs on every level, some partly and some wholly outside the image,
    tiny ones (w, h < 1 on their level) and invalid ones."""
    rng = np.random.RandomState(8)
    feats = _roi_feats(rng)
    R = 40
    rois = np.stack([rng.uniform(-20, 70, (2, R)), rng.uniform(-20, 90, (2, R)),
                     np.exp(rng.uniform(np.log(0.5), np.log(300), (2, R))),
                     np.exp(rng.uniform(np.log(0.5), np.log(200), (2, R))),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, R))], -1).astype(np.float32)
    lvl = rng.randint(0, 4, (2, R)).astype(np.int32)
    valid = rng.rand(2, R) > 0.15
    cot = rng.normal(0, 1, (2, R, 7, 7, 6)).astype(np.float32)
    strides = (4, 8, 16, 32)

    def j_f(*fs):
        return j_roi_align_ml(list(fs), jnp.asarray(rois), jnp.asarray(lvl), strides, 7, 2,
                              jnp.asarray(valid))

    want, vjp = jax.vjp(j_f, *[jnp.asarray(f) for f in feats])
    want_grads = vjp(jnp.asarray(cot))
    tf = [_t(f).permute(0, 3, 1, 2).requires_grad_() for f in feats]
    got = roi_align_rotated_multilevel(tf, _t(rois), _t(lvl), strides, 7, 2, _t(valid))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.5
    for i, (g, w) in enumerate(zip(tf, want_grads)):
        np.testing.assert_allclose(g.grad.permute(0, 2, 3, 1).numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4, err_msg=f"level {i}")



def test_roi_align_rotated_single_level_matches():
    """One level at spatial_scale 1/8, sampling ratios 1 and 2, 5×5 bins."""
    rng = np.random.RandomState(10)
    feat = rng.normal(0, 1, (2, 12, 10, 3)).astype(np.float32)
    rois = np.stack([rng.uniform(-10, 90, (2, 9)), rng.uniform(-10, 100, (2, 9)),
                     rng.uniform(2, 80, (2, 9)), rng.uniform(2, 60, (2, 9)),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, 9))], -1).astype(np.float32)
    valid = rng.rand(2, 9) > 0.2
    for ratio in (1, 2):
        want = j_roi_align(jnp.asarray(feat), jnp.asarray(rois), 5, 0.125, ratio,
                           jnp.asarray(valid))
        got = roi_align_rotated(_t(feat).permute(0, 3, 1, 2), _t(rois), 5, 0.125, ratio,
                                _t(valid))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


# the model ------------------------------------------------------------------

B, K = 2, 8


def _jax_model(dtype=None):
    """The reference model with random BN statistics and class convs of
    std 0.3 (0.01 at init), so that neither the RPN's top-k nor
    `predict`'s scores tie."""
    with j_compute_dtype_scope(dtype):
        jmodel = j_build_detector(CFG, seed=0)
    _randomize_bn(jmodel, seed=1)
    rng = np.random.RandomState(2)
    for kernel in (jmodel.rpn_head.rpn_cls.kernel, jmodel.bbox_head.fc_cls.kernel):
        kernel.set_value(jnp.asarray(rng.normal(0.0, 0.3, kernel.get_value().shape),
                                     jnp.float32))
    return jmodel


def _port(weights, dtype=None):
    with tnn.compute_dtype_scope(dtype):
        model = build_detector(CFG, device="cpu", load_pretrained=False)
    load_from_jax(model, weights)
    return model


def _draw(seed):
    rng = np.random.RandomState(seed)
    images = rng.rand(B, 128, 128, 3).astype(np.float32)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :3] = True
        gt[b, :3] = _rboxes(rng, 3)
        labels[b, :3] = rng.randint(1, 16, 3)
    return images, {"gt_bboxes": gt, "gt_labels": labels, "gt_mask": mask}


def _margin(iou, thresholds, ties=True):
    """Smallest distance of an IoU matrix (k, n) from the thresholds, and
    (with `ties`) between each gt's best IoU and its best IoU below that:
    on the anchor grid a gt's best IoU is often reached exactly by many
    anchors (all inside the gt, say), which ties alike in any rounding,
    but a near tie does not."""
    iou = iou.double()
    best = iou.amax(1, keepdim=True)
    below = torch.where(iou < best, iou, -1.0).amax(1, keepdim=True)
    return min([(best - below).min().item() if ties else np.inf]
               + [(iou - t).abs().min().item() for t in thresholds])


def _batch(tmodel):
    """Images and padded targets, the first seed whose assignments have no
    near tie (1e-5) in the RPN's hbb IoUs (0.7 / 0.3) and the RoI head's
    rotated IoUs of the proposals (0.5): the jitted reference and the
    port's eager ops round apart by an ulp or two, and the assigners
    compare IoUs with thresholds and with each other."""
    rpn = tmodel.rpn_head
    anchors = torch.cat([rpn.anchor_generator.grid_anchors((128 // s, 128 // s), lvl, "cpu")
                         for lvl, s in enumerate(rpn.anchor_strides)])
    for seed in range(9, 60):
        images, targets = _draw(seed)
        with torch.no_grad():
            proposals = rpn.get_proposals(rpn(tmodel.extract_feat(_t(images))))
        margin = np.inf
        for b in range(B):
            m = targets["gt_mask"][b]
            gts = _t(targets["gt_bboxes"][b][m])
            margin = min(margin, _margin(hbb_overlaps(rbox_to_hbox(gts), anchors), (0.7, 0.3)))
            props = torch.cat([gts, proposals["boxes"][b][proposals["valid"][b]]])
            margin = min(margin, _margin(box_iou_rotated(gts, props), (0.5,), ties=False))
        if margin > 1e-5:
            return images, targets
    raise AssertionError("no tie-free batch")


def _targets(targets, lib):
    return {k: (jnp.asarray(v) if lib == "jax" else _t(v)) for k, v in targets.items()}


def _n_anchors(model):
    return sum(3 * (128 // s) ** 2 for s in model.rpn_head.anchor_strides)


@pytest.fixture(scope="module")
def ref():
    """The reference, jitted as its Runner runs it: the RPN's outputs,
    losses and proposals, the RoI head's sampled RoIs, outputs and losses,
    the model's losses and `predict`, two train steps, and in bf16 the
    network outputs and the losses. Also the weights and the batch."""
    jmodel = _jax_model()
    weights = _numpy_params(jmodel)
    tmodel = _port(weights)
    images, targets = _batch(tmodel)
    ji, jt = jnp.asarray(images), _targets(targets, "jax")
    key = jax.random.PRNGKey(3)
    k1, k2 = jax.random.split(key)

    def outputs(m, rois=None):
        feats = m.extract_feat(ji, train=True)
        outs = m.rpn_head(feats, train=True)
        proposals = m.rpn_head.get_proposals(outs)
        head = m.bbox_head
        t = dict(jt, gt_hboxes=j_rbox_to_hbox(jt["gt_bboxes"]))
        if rois is None:
            rois = jax.vmap(head._sample_rois)(
                proposals["boxes"], proposals["valid"], jt["gt_bboxes"], jt["gt_mask"],
                jt["gt_labels"], jax.random.split(k2, B))[:2]
        return {"rpn_outs": outs, "rpn_losses": m.rpn_head.loss(outs, t, key=k1),
                "proposals": proposals, "rois": rois,
                "head_outs": head._forward_rois(feats, *rois),
                "head_losses": head.loss(feats, proposals, jt, key=k2),
                "losses": m.loss(ji, jt, key=key)}

    def host(tree):
        return jax.tree.map(lambda a: np.asarray(a, np.float32) if a.dtype == jnp.bfloat16
                            else np.asarray(a), tree)

    runs = {"f32": host(nnx.jit(outputs)(jmodel))}
    runs["f32"]["predict"] = host(nnx.jit(lambda m: m.predict(ji))(jmodel))
    rois = tuple(jnp.asarray(r) for r in runs["f32"]["rois"])
    runs["bf16"] = host(nnx.jit(outputs)(_jax_model(jnp.bfloat16), rois))

    @nnx.jit
    def step(m, opt, key):
        (_, log_vars), grads = nnx.value_and_grad(
            lambda m: j_parse_losses(m.loss(ji, jt, key=key)), has_aux=True)(m)
        opt.update(m, grads)

    jopt = j_build_optimizer(jmodel, lr_schedule=j_build_lr_schedule(0.01, **SCHED), **OPT_KW)
    for it in range(2):
        step(jmodel, jopt, jax.random.PRNGKey(100 + it))
    runs["step_params"] = {k: v.numpy() for k, v in params_from_jax(
        {k: v for k, v in _numpy_params(jmodel).items()
         if k.rsplit(".", 1)[-1] in ("kernel", "bias", "scale")}, tmodel).items()}
    return weights, images, targets, runs


def _replayed_loss(model, images, targets, key):
    return model.loss(_t(images), _targets(targets, "torch"),
                      rand=Replay(model_draws(key, B, _n_anchors(model), K + 64)))


def test_params_from_jax_maps_the_two_stage_leaves(ref):
    weights, *_ = ref
    model = _port(weights)
    sd = params_from_jax(weights, model)
    assert sd["bbox_head.shared_fcs.0.weight"].shape == (128, 64 * 49)
    assert sd["bbox_head.fc_cls.weight"].shape == (16, 128)
    assert sd["rpn_head.rpn_reg.weight"].shape == (18, 64, 1, 1)
    assert set(model.state_dict()) == set(sd)


def test_build_detector_builds_the_config_at_full_width():
    cfg = load_cfg_file("configs/oriented_rcnn_r50_fpn_1x_dota.py")
    model = build_detector(cfg["model"], device="cpu", load_pretrained=False)
    assert type(model).__name__ == "OrientedRCNN" and model.backbone.depth == 50
    assert model.neck.out_channels == 256 and len(model.neck.extra_convs) == 0
    rpn, head = model.rpn_head, model.bbox_head
    assert (rpn.nms_pre, rpn.nms_post, rpn.num_anchors) == (2000, 2000, 3)
    assert tuple(head.shared_fcs[0].weight.shape) == (1024, 256 * 49)
    assert tuple(head.fc_cls.weight.shape) == (16, 1024)
    assert tuple(head.fc_reg.weight.shape) == (5, 1024)
    assert head.train_cfg["sampler"]["num"] == 512
    assert head.test_cfg == dict(score_thr=0.05, nms_iou_thr=0.1, max_per_img=2000)


def test_rpn_outputs_losses_and_proposals_match(ref):
    weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    tt = _targets(targets, "torch")
    tt["gt_hboxes"] = rbox_to_hbox(tt["gt_bboxes"])
    k1 = jax.random.split(jax.random.PRNGKey(3))[0]
    with torch.no_grad():
        outs = model.rpn_head(model.extract_feat(_t(images)))
        for lvl, (o, w) in enumerate(zip(outs, want["rpn_outs"])):
            for t, wt in zip(o, w):
                np.testing.assert_allclose(t.permute(0, 2, 3, 1).numpy(), wt, rtol=0,
                                           atol=1e-5, err_msg=f"level {lvl}")
        losses = model.rpn_head.loss(outs, tt, rand=Replay(sampler_draws(k1, B, _n_anchors(model))))
        proposals = model.rpn_head.get_proposals(outs)
    for k, v in want["rpn_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    wp = want["proposals"]
    v = wp["valid"]
    assert v.sum() > 20
    np.testing.assert_array_equal(proposals["valid"].numpy(), v)
    np.testing.assert_allclose(proposals["boxes"].numpy()[v], wp["boxes"][v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(proposals["scores"].numpy()[v], wp["scores"][v], rtol=0,
                               atol=1e-6)


def test_oriented_head_loss_matches_on_the_reference_proposals(ref):
    weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    k2 = jax.random.split(jax.random.PRNGKey(3))[1]
    proposals = {k: _t(v) for k, v in want["proposals"].items()}
    feats = model.extract_feat(_t(images))
    head = model.bbox_head
    rois, valid, *_ = head._sample_rois(
        proposals["boxes"], proposals["valid"], _t(targets["gt_bboxes"]),
        _t(targets["gt_mask"]), _t(targets["gt_labels"]),
        rand=Replay(sampler_draws(k2, B, K + 64)))
    np.testing.assert_array_equal(valid.numpy(), want["rois"][1])
    np.testing.assert_allclose(rois.numpy(), want["rois"][0], rtol=0, atol=1e-6)
    losses = head.loss(feats, proposals, _targets(targets, "torch"),
                       rand=Replay(sampler_draws(k2, B, K + 64)))
    for k, v in want["head_losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
    with torch.no_grad():
        outs = head._forward_rois(feats, rois, valid)
    for o, w in zip(outs, want["head_outs"]):
        np.testing.assert_allclose(o.numpy(), w, rtol=0, atol=1e-5 * np.abs(w).max())


def test_oriented_rcnn_loss_and_predict_match(ref):
    weights, images, targets, runs = ref
    want = runs["f32"]
    model = _port(weights)
    model.train()
    losses = _replayed_loss(model, images, targets, jax.random.PRNGKey(3))
    assert set(losses) == {"loss_rpn_cls", "loss_rpn_bbox", "loss_cls", "loss_bbox"}
    for k, v in want["losses"].items():
        np.testing.assert_allclose(losses[k].item(), v, rtol=1e-5, err_msg=k)
        assert v > 0, k
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
    weights, images, targets, runs = ref
    model = _port(weights)
    opt = build_optimizer(model, lr_schedule=build_lr_schedule(0.01, **SCHED), **OPT_KW)
    step = build_train_step(model, opt)
    loss = model.loss
    n_anchors = _n_anchors(model)
    for it in range(2):
        draws = Replay(model_draws(jax.random.PRNGKey(100 + it), B, n_anchors, K + 64))
        model.loss = lambda images, targets, generator=None: loss(images, targets, rand=draws)
        step(_t(images), _targets(targets, "torch"), it)
    want = runs["step_params"]
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    assert set(got) <= set(want)
    start = {k: v.numpy() for k, v in params_from_jax(weights, model).items()}
    for n, g in got.items():
        w = want[n]
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * max(np.abs(w).max(), 1e-12),
                                   err_msg=n)
        # the 2 steps' change, far below the values: within 1e-2 of the
        # reference change's largest value (exact where it is 0)
        np.testing.assert_allclose(g - start[n], w - start[n], rtol=0,
                                   atol=1e-2 * np.abs(w - start[n]).max(), err_msg=n)
    assert not np.array_equal(got["bbox_head.fc_cls.weight"],
                              start["bbox_head.fc_cls.weight"])


def _rms(a):
    return float(np.sqrt(np.mean(np.square(np.asarray(a, np.float64)))))


def test_bf16_model_within_the_reference_gap(ref):
    """The port built under the bf16 policy: the RPN's outputs per level,
    the RoI head's outputs on the float32 run's RoIs, each the RMS
    distance to the reference's bf16 result over the reference's own bf16
    - f32 gap; and the four losses pooled."""
    weights, images, targets, runs = ref
    model = _port(weights, BF16)
    model.train()
    fracs = {}
    with torch.no_grad():
        feats = model.extract_feat(_t(images))
        outs = model.rpn_head(feats)
        assert outs[0][0].dtype == BF16
        head_outs = model.bbox_head._forward_rois(feats, *map(_t, runs["f32"]["rois"]))
    for lvl, (o, b, f) in enumerate(zip(outs, runs["bf16"]["rpn_outs"], runs["f32"]["rpn_outs"])):
        for name, t, bt, ft in zip(("cls", "reg"), o, b, f):
            fracs[f"rpn level {lvl} {name}"] = (_rms(t.float().permute(0, 2, 3, 1).numpy() - bt)
                                                / _rms(bt - ft))
    for name, t, bt, ft in zip(("cls", "reg"), head_outs, runs["bf16"]["head_outs"],
                               runs["f32"]["head_outs"]):
        assert t.dtype == torch.float32
        fracs[f"roi head {name}"] = _rms(t.numpy() - bt) / _rms(bt - ft)
    worst = max(fracs, key=fracs.get)
    assert fracs[worst] <= NET_GAP, f"{worst} at {fracs[worst]:.3f} of the gap: {fracs}"
    losses = _replayed_loss(model, images, targets, jax.random.PRNGKey(3))
    assert all(v.dtype == torch.float32 for v in losses.values())
    got, bf16, f32 = (np.array([d[k] for k in sorted(losses)]) for d in (
        {k: v.item() for k, v in losses.items()}, runs["bf16"]["losses"], runs["f32"]["losses"]))
    frac = _rms(got - bf16) / _rms(bf16 - f32)
    assert frac <= LOSS_GAP, f"losses at {frac:.3f} of the gap: {got} {bf16} {f32}"
