"""The Rotated RetinaNet family's loss variants in jdet_torch against
jdet_tpu, float32 on the CPU: GWD / KLD / BCD / KFIoU / RSDet / IoU and
the other Gaussian and distillation losses, `points_in_rbox`,
`integral`, the CSL coder, and the ATSS and `fake_rbb` assigners (the
heads are in tests/test_torch_retina_heads.py).

Tolerances: loss values rtol 1e-5 (the same float32 formulas, summed in
another order); their gradients (`jax.grad` against autograd) rtol 1e-4,
atol 1e-6; assignments exact (max_overlaps atol 2e-6: the reference's
differentiable IoU against the rect kernel's plain version)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jdet_tpu.models.losses as JL
import jdet_tpu.ops.box_convert as JB
import jdet_torch.models.losses as TL
import jdet_torch.ops.box_convert as TB
from jdet_tpu.models.boxes.assigner import atss_assign_rotated as j_atss
from jdet_tpu.models.boxes.assigner import max_iou_assign_rotated as j_max_iou
from jdet_tpu.models.boxes.coder import CSLCoder as JCSLCoder
from jdet_torch.models.boxes.anchor_generator import AnchorGeneratorRotated
from jdet_torch.models.boxes.assigner import atss_assign_rotated, max_iou_assign_rotated
from jdet_torch.models.boxes.coder import CSLCoder
from jdet_torch.utils.registry import LOSSES, build_from_cfg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def unfused_jit(fn, *args):
    """fn(*args) compiled once with XLA's fusion passes off, so that each
    primitive computes as eager JAX computes it. Fused, XLA recomputes the
    rotated IoU matrix inside each of its consumers, a few ulp apart, and
    the max-IoU assigner's `overlaps == gt_max` then drops a gt's best
    anchors; eager, it compiles each of a head loss's several hundred
    primitives apart (~20 s where this takes ~2 s). LLVM runs at -O0
    (`UNFUSED_OPTIONS`): the same IEEE arithmetic, in half the compile
    time."""
    return jax.jit(fn).lower(*args).compile(compiler_options=UNFUSED_OPTIONS)(*args)


# XLA's fusion off, LLVM's optimizer off: no fast-math either way, so the
# results are bit for bit those of the default backend level
UNFUSED_OPTIONS = {"xla_disable_hlo_passes": "fusion", "xla_backend_optimization_level": 0}


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _boxes(rng, n, square=False):
    w = rng.uniform(4, 80, n)
    return np.stack([rng.uniform(0, 256, n), rng.uniform(0, 256, n), w,
                     w if square else rng.uniform(4, 80, n),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)


def _loss_inputs(n=48, seed=0):
    """pred, target, weight, anchors: predictions near their targets, a
    third of them "square" (w == h on both sides, where the Gaussians are
    isotropic) and a third "zero rows" (targets all zeros with weight 0,
    as the heads feed the rows of anchors that are not positive)."""
    rng = np.random.RandomState(seed)
    target = _boxes(rng, n)
    third = n // 3
    target[third:2 * third, 3] = target[third:2 * third, 2]
    pred = target.copy()
    pred[:, :2] += rng.normal(0, 4, (n, 2))
    pred[:, 2:4] *= np.exp(rng.normal(0, 0.2, (n, 2)))
    pred[third:2 * third, 3] = pred[third:2 * third, 2]
    pred[:, 4] += rng.normal(0, 0.2, n)
    weight = (rng.rand(n) < 0.8).astype(np.float32)
    target[:third] = 0.0
    weight[:third] = 0.0
    anchors = _boxes(rng, n)
    return pred.astype(np.float32), target, weight, anchors


def _kfiou(L, B, p, t, w, a, **kw):
    # pred and target deltas against the anchors, each decoded for its shape
    deltas_t = B.rbox2delta(a, t)
    return L.kf_iou_loss(p / 100.0, deltas_t, pred_decode=B.delta2rbox(a, p / 100.0),
                         targets_decode=B.delta2rbox(a, deltas_t), weight=w, avg_factor=7.0,
                         **kw)


LOSS_CASES = {
    "gwd": lambda L, B, p, t, w, a: L.gaussian_dist_loss(p, t, loss_type="gwd", weight=w,
                                                         avg_factor=7.0),
    "gwd_sqrt": lambda L, B, p, t, w, a: L.gwd_loss(p, t, weight=w, fun="sqrt", avg_factor=7.0),
    "gwd_none_tau0": lambda L, B, p, t, w, a: L.gwd_loss(p, t, weight=w, fun="none", tau=0.0),
    "gwd_tau2_unnormalized": lambda L, B, p, t, w, a: L.gwd_loss(p, t, weight=w, tau=2.0,
                                                                 normalize=False),
    "kld": lambda L, B, p, t, w, a: L.gaussian_dist_loss(p, t, loss_type="kld", weight=w,
                                                         avg_factor=7.0),
    "kld_compat_ref": lambda L, B, p, t, w, a: L.kld_loss(p, t, weight=w, compat_ref=True,
                                                          avg_factor=7.0),
    "kld_sqrt_fun": lambda L, B, p, t, w, a: L.kld_loss(p, t, weight=w, fun="sqrt"),
    "kld_no_sqrt_tau0": lambda L, B, p, t, w, a: L.kld_loss(p, t, weight=w, sqrt=False,
                                                            fun="none", tau=0.0),
    "bcd": lambda L, B, p, t, w, a: L.gaussian_dist_loss(p, t, loss_type="bcd", weight=w,
                                                         avg_factor=7.0),
    "bcd_none_tau0": lambda L, B, p, t, w, a: L.bcd_loss(p, t, weight=w, fun="none", tau=0.0),
    "kfiou": lambda L, B, p, t, w, a: _kfiou(L, B, p, t, w, a),
    "kfiou_ln": lambda L, B, p, t, w, a: _kfiou(L, B, p, t, w, a, fun="ln"),
    "kfiou_exp": lambda L, B, p, t, w, a: _kfiou(L, B, p, t, w, a, fun="exp"),
    "rsdet": lambda L, B, p, t, w, a: L.rsdet_loss(p / 100.0, B.rbox2delta(a, t), a, weight=w,
                                                   avg_factor=7.0),
    "iou_log": lambda L, B, p, t, w, a: L.rotated_iou_loss(p, t, weight=w, avg_factor=7.0),
    "iou_linear": lambda L, B, p, t, w, a: L.rotated_iou_loss(p, t, weight=w, mode="linear"),
    "iou_square": lambda L, B, p, t, w, a: L.rotated_iou_loss(p, t, weight=w, mode="square"),
    "jd": lambda L, B, p, t, w, a: L.jd_loss(p, t, weight=w, avg_factor=7.0),
    "kld_symmax": lambda L, B, p, t, w, a: L.kld_symmax_loss(p, t, weight=w),
    "kld_symmin": lambda L, B, p, t, w, a: L.kld_symmin_loss(p, t, weight=w, fun="sqrt"),
    "kd_kl_div": lambda L, B, p, t, w, a: L.knowledge_distillation_kl_div_loss(
        p.reshape(-1, 8), t.reshape(-1, 8) / 50.0, T=10.0),
    "im": lambda L, B, p, t, w, a: L.im_loss(p, t, avg_factor=11.0),
    "smooth_focal": lambda L, B, p, t, w, a: L.smooth_focal_loss(
        p[:, :4] / 100.0, (t[:, :4] - t[:, :4].min()) / (t[:, :4].max() - t[:, :4].min() + 1.0),
        weight=w, avg_factor=7.0),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_value_and_gradient_match(case):
    pred, target, weight, anchors = _loss_inputs()
    fn = LOSS_CASES[case]
    jt, jw, ja = (jnp.asarray(x) for x in (target, weight, anchors))
    want, want_grad = jax.value_and_grad(lambda p: fn(JL, JB, p, jt, jw, ja))(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = fn(TL, TB, p, *(torch.from_numpy(x) for x in (target, weight, anchors)))
    got.backward()
    assert np.isfinite(float(want))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_grad = np.asarray(want_grad)
    assert np.isfinite(want_grad).all()
    np.testing.assert_allclose(p.grad.numpy(), want_grad, rtol=1e-4, atol=1e-6)


def test_losses_registry_binds_keywords():
    fn = build_from_cfg(dict(type="GDLoss", loss_type="kld", tau=2.0), LOSSES)
    pred, target, weight, _ = _loss_inputs()
    p, t = torch.from_numpy(pred), torch.from_numpy(target)
    assert fn(p, t).item() == TL.kld_loss(p, t, tau=2.0).item()
    assert build_from_cfg(dict(type="SmoothFocalLoss"), LOSSES) is TL.smooth_focal_loss
    for name in ("FocalLoss", "SmoothL1Loss", "L1Loss", "KFLoss", "IoULoss", "RSDetLoss",
                 "KnowledgeDistillationKLDivLoss", "IMLoss", "GDLoss_v1"):
        assert callable(build_from_cfg(dict(type=name), LOSSES))


# ---------------------------------------------------------------------------
# box ops, coder, assigners
# ---------------------------------------------------------------------------

def test_points_in_rbox_matches():
    rng = np.random.RandomState(3)
    points = rng.uniform(0, 128, (300, 2)).astype(np.float32)
    boxes = _boxes(rng, 12) / np.array([2, 2, 1, 1, 1], np.float32)
    want = np.asarray(JB.points_in_rbox(jnp.asarray(points), jnp.asarray(boxes)))
    got = TB.points_in_rbox(torch.from_numpy(points), torch.from_numpy(boxes)).numpy()
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    # leading dimensions broadcast: per-image boxes against shared points
    got2 = TB.points_in_rbox(torch.from_numpy(points), torch.from_numpy(boxes)[None, :6])
    np.testing.assert_array_equal(got2[0].numpy(), want[:, :6])


def test_integral_matches():
    x = np.random.RandomState(4).normal(0, 3, (10, 5 * 9)).astype(np.float32)
    d = x.reshape(-1, 5, 9)
    want = np.asarray(JB.integral(jnp.asarray(d[:, :4].reshape(-1, 9)), 8))
    got = TB.integral(torch.from_numpy(np.ascontiguousarray(d[:, :4])).reshape(-1, 9), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    want = np.asarray(JB.integral_angle(jnp.asarray(d[:, 4]), 8))
    got = TB.integral_angle(torch.from_numpy(np.ascontiguousarray(d[:, 4])), 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("window,omega,radius", [
    ("gaussian", 4, 3), ("gaussian", 1, 6), ("triangle", 4, 3), ("rect", 4, 2), ("pulse", 2, 1)])
def test_csl_coder_matches(window, omega, radius):
    rng = np.random.RandomState(5)
    # the range's ends and the circular wrap (a bin 0 center sees the last bins)
    edge = np.array([-np.pi / 4, np.nextafter(-np.pi / 4, 1), np.nextafter(3 * np.pi / 4, 0),
                     0.0, np.pi / 2, -np.pi / 2 + 1e-3, 3 * np.pi / 4 - 1e-4, -0.7, 2.3])
    angles = np.concatenate([edge, rng.uniform(-np.pi / 4, 3 * np.pi / 4, 64)]).astype(np.float32)
    jc, tc = JCSLCoder(omega, window, radius), CSLCoder(omega, window, radius)
    want = np.asarray(jc.encode(jnp.asarray(angles)))
    got = tc.encode(torch.from_numpy(angles)).numpy()
    assert got.shape == (len(angles), 180 // omega)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    logits = rng.normal(0, 1, (3, 40, 180 // omega)).astype(np.float32)
    np.testing.assert_allclose(tc.decode(torch.from_numpy(logits)).numpy(),
                               np.asarray(jc.decode(jnp.asarray(logits))), rtol=1e-6, atol=1e-7)
    # decode(encode(a)) is a's bin center
    dec = tc.decode(torch.from_numpy(got)).numpy()
    assert (np.abs(np.rad2deg(dec - angles) + 180) % 180 - 180 <= omega).all()


def _anchors(ratios=(1.0,), scales=1, size=128, strides=(8, 16, 32, 64, 128)):
    """The flat anchors of a 128² image and the count per level."""
    levels = [AnchorGeneratorRotated(s, octave_base_scale=4, scales_per_octave=scales,
                                     ratios=ratios).grid_anchors((size // s, size // s), s, device="cpu")
              for s in strides]
    return torch.cat(levels), [len(lv) for lv in levels]


def _gts(seed, B=2, K=8, real=3):
    rng = np.random.RandomState(seed)
    gt = np.zeros((B, K, 5), np.float32)
    mask = np.zeros((B, K), bool)
    labels = np.zeros((B, K), np.int64)
    for b in range(B):
        mask[b, :real] = True
        gt[b, :real] = np.stack([rng.uniform(20, 108, real), rng.uniform(20, 108, real),
                                 rng.uniform(16, 60, real), rng.uniform(8, 30, real),
                                 rng.uniform(-np.pi / 4, 3 * np.pi / 4, real)], 1)
        labels[b, :real] = rng.randint(1, 16, real)
    return gt, mask, labels


def _assert_same_assignment(got, want_per_image):
    for b, want in enumerate(want_per_image):
        np.testing.assert_array_equal(got["gt_inds"][b].numpy(), np.asarray(want["gt_inds"]))
        np.testing.assert_array_equal(got["labels"][b].numpy(), np.asarray(want["labels"]))
        np.testing.assert_allclose(got["max_overlaps"][b].numpy(),
                                   np.asarray(want["max_overlaps"]), atol=2e-6)


def _atss_both(anchors, gt, mask, labels, num_level, anchor_mask=None, topk=9):
    got = atss_assign_rotated(anchors, torch.from_numpy(gt), torch.from_numpy(mask),
                              torch.from_numpy(labels), num_level_anchors=num_level, topk=topk,
                              anchor_mask=None if anchor_mask is None
                              else torch.from_numpy(anchor_mask))
    want = [j_atss(jnp.asarray(anchors.numpy()), jnp.asarray(gt[b]), jnp.asarray(mask[b]),
                   jnp.asarray(labels[b]), num_level_anchors=num_level, topk=topk,
                   anchor_mask=None if anchor_mask is None else jnp.asarray(anchor_mask))
            for b in range(len(gt))]
    return got, want


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_atss_assign_matches(seed):
    anchors, num_level = _anchors()
    gt, mask, labels = _gts(seed)
    got, want = _atss_both(anchors, gt, mask, labels, num_level)
    _assert_same_assignment(got, want)
    assert (got["gt_inds"] > 0).sum() >= 3


def test_atss_assign_no_gts_and_an_anchor_mask():
    anchors, num_level = _anchors()
    gt, mask, labels = _gts(3)
    mask[1] = False  # image 1: no gts at all
    anchor_mask = np.random.RandomState(6).rand(len(anchors)) < 0.7
    got, want = _atss_both(anchors, gt, mask, labels, num_level, anchor_mask=anchor_mask)
    _assert_same_assignment(got, want)
    assert (got["gt_inds"][1][torch.from_numpy(anchor_mask)] == 0).all()
    assert (got["gt_inds"][:, ~torch.from_numpy(anchor_mask)] == -1).all()


def test_atss_assign_equidistant_anchors():
    """Gts centered between four anchors of every level (anchor centers
    lie at 3.5 + 8i on the first): each level's 9 nearest are the four at
    one distance and 5 of the 8 tied at the next; the stable sort takes
    the lowest indices, as the reference's."""
    anchors, num_level = _anchors()
    gt, mask, labels = _gts(4)
    gt[0, 0] = [63.5, 63.5, 40, 40, 0.0]
    gt[1, 1] = [31.5, 95.5, 52, 20, 0.3]
    got, want = _atss_both(anchors, gt, mask, labels, num_level)
    _assert_same_assignment(got, want)
    assert (got["gt_inds"][0] == 1).sum() >= 4


@pytest.mark.parametrize("seed", [0, 1])
def test_fake_rbb_assign_matches(seed):
    anchors, _ = _anchors(ratios=(1.0, 0.5, 2.0), scales=3)
    gt, mask, labels = _gts(seed)
    got = max_iou_assign_rotated(anchors, torch.from_numpy(gt), torch.from_numpy(mask),
                                 torch.from_numpy(labels), iou_calculator="fake_rbb")
    want = [j_max_iou(jnp.asarray(anchors.numpy()), jnp.asarray(gt[b]), jnp.asarray(mask[b]),
                      jnp.asarray(labels[b]), iou_calculator="fake_rbb") for b in range(2)]
    _assert_same_assignment(got, want)
    rotated = max_iou_assign_rotated(anchors, torch.from_numpy(gt), torch.from_numpy(mask),
                                     torch.from_numpy(labels))
    assert not torch.equal(got["gt_inds"], rotated["gt_inds"])
    with pytest.raises(NotImplementedError, match="iou_calculator"):
        max_iou_assign_rotated(anchors, torch.from_numpy(gt), torch.from_numpy(mask),
                               torch.from_numpy(labels), iou_calculator="poly")
