"""The ReDet slice's ops and bricks in jdet_torch against jdet_tpu, on the
CPU, with the reference run eagerly; and the equivariance properties of
the port's own bricks, as tests/test_redet.py states them for the
reference.

Tolerances:
- the hbb codec: `hbox2delta` atol 1e-5, `delta2hbox` atol 1e-4 px,
  `hbox_to_rbox` exactly;
- `rotation_interp_matrix` and both weight expansions (the ARF gather of
  1x1 and 3x3 filters, the bilinear operators of 5x5 and 7x7 ones, and
  the 7x7 lifting) exactly;
- `REConv2d` (k = 1, 3, 5, strides 1 and 2, with a bias), `REConv2dLift`
  and `InnerBatchNorm` (running statistics, and batch statistics with
  their running update) atol 1e-5 of their output's largest value;
- RiRoIAlign forward atol 1e-5, its gradient against `jax.vjp` atol 1e-4;
  the horizontal `SingleRoIExtractor` atol 1e-5;
- `max_iou_assign_hbb` on per-image candidates with per-image masks (the
  cascade's stage 1) and `rotation_invariant_encoding` (argmax ties
  included) exactly;
- the expansion cache: the cached forward bit-identical to the live one.
"""
import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import nnx

from jdet_tpu.models.boxes.assigner import max_iou_assign_hbb as j_max_iou_assign_hbb
from jdet_tpu.models.equivariant import InnerBatchNorm as JInnerBatchNorm
from jdet_tpu.models.equivariant import REConv2d as JREConv2d
from jdet_tpu.models.equivariant import REConv2dLift as JREConv2dLift
from jdet_tpu.models.equivariant import rotation_interp_matrix as j_rotation_interp_matrix
from jdet_tpu.models.pretrained import flat_paths
from jdet_tpu.models.roi_extractors.single_level import SingleRoIExtractor as JSingleRoIExtractor
from jdet_tpu.ops.box_convert import delta2hbox as j_delta2hbox
from jdet_tpu.ops.box_convert import hbox2delta as j_hbox2delta
from jdet_tpu.ops.box_convert import hbox_to_rbox as j_hbox_to_rbox
from jdet_tpu.ops.orn import rotation_invariant_encoding as j_rotation_invariant_encoding
from jdet_tpu.ops.riroi_align import riroi_align_multilevel as j_riroi_align_ml
from jdet_torch.models.boxes.assigner import max_iou_assign_hbb
from jdet_torch.models.convert import params_from_jax
from jdet_torch.models.equivariant import (
    InnerBatchNorm,
    REConv2d,
    REConv2dLift,
    cache_expanded_weights,
    rotation_interp_matrix,
)
from jdet_torch.models.roi_extractors import SingleRoIExtractor
from jdet_torch.ops import delta2hbox, hbox2delta, hbox_to_rbox
from jdet_torch.ops.orn import ORConv2d, rotation_invariant_encoding
from jdet_torch.ops.riroi_align import riroi_align, riroi_align_multilevel


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _load(module, jmodule):
    _, flat = flat_paths(jmodule)
    flat = {k: np.asarray(v.get_value() if hasattr(v, "get_value") else v)
            for k, v in flat.items()}
    module.load_state_dict(params_from_jax(flat, module), strict=True)
    return module


def _close(got, want, tol=1e-5, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=what)


def _hboxes(rng, shape):
    xy = rng.uniform(0, 100, shape + (2,))
    wh = rng.uniform(2, 60, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


# the hbb codec ----------------------------------------------------------------

def test_hbb_codec_matches():
    rng = np.random.RandomState(0)
    props, gts = _hboxes(rng, (3, 50)), _hboxes(rng, (3, 50))
    gts[0, :5] = props[0, :5]  # zero deltas
    for means, stds in (((0.0,) * 4, (1.0,) * 4), ((0.1, -0.1, 0.0, 0.2), (0.1, 0.1, 0.2, 0.2))):
        want = np.asarray(j_hbox2delta(jnp.asarray(props), jnp.asarray(gts), means, stds))
        got = hbox2delta(_t(props), _t(gts), means, stds).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        # (..., K*4) deltas, and dw, dh beyond the ratio clip
        deltas = rng.normal(0, 1.5, (3, 50, 8)).astype(np.float32)
        want = np.asarray(j_delta2hbox(jnp.asarray(props), jnp.asarray(deltas), means, stds))
        got = delta2hbox(_t(props), _t(deltas), means, stds).numpy()
        assert got.shape == (3, 50, 8)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        got = delta2hbox(_t(props), _t(deltas[..., :4]), means, stds).numpy()
        np.testing.assert_allclose(got, want[..., :4], rtol=0, atol=1e-4)


def test_hbox_to_rbox_matches_for_wide_tall_and_square_boxes():
    rng = np.random.RandomState(1)
    boxes = _hboxes(rng, (4, 30))
    boxes[0, :3, 2:] = boxes[0, :3, :2] + 10.0  # squares
    np.testing.assert_array_equal(hbox_to_rbox(_t(boxes)).numpy(),
                                  np.asarray(j_hbox_to_rbox(jnp.asarray(boxes))))
    r = hbox_to_rbox(_t(boxes))
    assert (r[..., 2] >= r[..., 3]).all()
    a = r[..., 4].numpy()
    assert np.all((a == 0.0) | (np.abs(a - math.pi / 2) < 1e-6))


# the C8 convs -----------------------------------------------------------------

def test_rotation_interp_matrix_is_the_reference():
    for k in (1, 3, 5, 7):
        for r in range(8):
            np.testing.assert_array_equal(rotation_interp_matrix(k, r * math.pi / 4),
                                          j_rotation_interp_matrix(k, r * math.pi / 4))
    np.testing.assert_allclose(rotation_interp_matrix(7, 0.0), np.eye(49), atol=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5, 7])
def test_reconv_expansion_is_exact(k):
    """The expanded OIHW weight is the reference's HWIO one transposed,
    bit for bit: the ARF gather for k = 1, 3, the bilinear operators and
    the orientation roll for k = 5, 7."""
    j = JREConv2d(3, 2, k, rngs=nnx.Rngs(k))
    t = _load(REConv2d(3, 2, k), j)
    want = np.asarray(j._expand()).transpose(3, 2, 0, 1)
    got = t.expanded_weight().detach().numpy()
    assert got.shape == (16, 24, k, k)
    np.testing.assert_array_equal(got, want)


def test_lifting_expansion_is_exact():
    j = JREConv2dLift(3, 4, 7, rngs=nnx.Rngs(2))
    t = _load(REConv2dLift(3, 4, 7), j)
    np.testing.assert_array_equal(t.expanded_weight().detach().numpy(),
                                  np.asarray(j._expand()).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("k,stride,bias", [(1, 1, False), (1, 2, False), (3, 1, True),
                                           (3, 2, False), (5, 1, False), (5, 2, True)])
def test_reconv_forward_matches(k, stride, bias):
    rng = np.random.RandomState(k + stride)
    j = JREConv2d(3, 2, k, stride=stride, use_bias=bias, rngs=nnx.Rngs(0))
    if bias:
        j.bias.set_value(jnp.asarray(rng.normal(0, 0.5, 16), jnp.float32))
    t = _load(REConv2d(3, 2, k, stride=stride, bias=bias), j)
    x = rng.normal(0, 1, (2, 14, 12, 24)).astype(np.float32)
    want = j(jnp.asarray(x))
    _close(_nhwc(t(_nchw(x))), want)


def test_lifting_forward_matches_with_symmetric_padding():
    """7x7/s2 pads (3, 3) on each side, not flax SAME's (2, 3)."""
    rng = np.random.RandomState(3)
    j = JREConv2dLift(3, 4, 7, stride=2, rngs=nnx.Rngs(1))
    t = _load(REConv2dLift(3, 4, 7, stride=2), j)
    x = rng.normal(0, 1, (2, 20, 18, 3)).astype(np.float32)
    want = j(jnp.asarray(x))
    assert want.shape == (2, 10, 9, 32)
    _close(_nhwc(t(_nchw(x))), want)


def test_inner_batchnorm_matches_in_both_modes():
    rng = np.random.RandomState(4)
    j = JInnerBatchNorm(3, rngs=nnx.Rngs(0))
    for v, draw in ((j.bn.scale, rng.uniform(0.5, 1.5, 3)), (j.bn.bias, rng.normal(0, 0.3, 3)),
                    (j.bn.mean, rng.normal(0, 0.3, 3)), (j.bn.var, rng.uniform(0.5, 1.5, 3))):
        v.set_value(jnp.asarray(draw, jnp.float32))
    t = _load(InnerBatchNorm(3), j)
    x = (rng.normal(0, 2, (2, 5, 6, 24)) + 1.0).astype(np.float32)
    t.eval()
    _close(_nhwc(t(_nchw(x))), j(jnp.asarray(x), use_running_average=True), what="eval")
    t.train()
    _close(_nhwc(t(_nchw(x))), j(jnp.asarray(x), use_running_average=False), what="train")
    np.testing.assert_allclose(t.bn.running_mean.numpy(), np.asarray(j.bn.mean.get_value()),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(t.bn.running_var.numpy(), np.asarray(j.bn.var.get_value()),
                               rtol=0, atol=1e-6)


# RiRoIAlign and the horizontal extractor -------------------------------------------

def _feats(rng, C=16, B=2):
    return [rng.normal(0, 1, (B, 64 // s, 48 // s, C)).astype(np.float32) for s in (4, 8, 16, 32)]


def test_riroi_align_multilevel_and_its_gradient_match():
    """RoIs on every level, theta over [-pi/4, 3pi/4) (negative for some:
    the shift index is a floor mod), exact multiples of 45 degrees, tiny
    and invalid RoIs."""
    rng = np.random.RandomState(5)
    feats = _feats(rng)
    R = 40
    theta = rng.uniform(-np.pi / 4, 3 * np.pi / 4, (2, R))
    theta[0, :4] = [-np.pi / 4, 0.0, np.pi / 4, np.pi / 2]
    rois = np.stack([rng.uniform(-10, 60, (2, R)), rng.uniform(-10, 80, (2, R)),
                     np.exp(rng.uniform(np.log(0.5), np.log(200), (2, R))),
                     np.exp(rng.uniform(np.log(0.5), np.log(150), (2, R))),
                     theta], -1).astype(np.float32)
    lvl = rng.randint(0, 4, (2, R)).astype(np.int32)
    valid = rng.rand(2, R) > 0.15
    cot = rng.normal(0, 1, (2, R, 7, 7, 16)).astype(np.float32)
    strides = (4, 8, 16, 32)

    def j_f(*fs):
        return j_riroi_align_ml(list(fs), jnp.asarray(rois), jnp.asarray(lvl), strides, 7, 2,
                                valid=jnp.asarray(valid))

    want, vjp = jax.vjp(j_f, *[jnp.asarray(f) for f in feats])
    want_grads = vjp(jnp.asarray(cot))
    tf = [_nchw(f).requires_grad_() for f in feats]
    got = riroi_align_multilevel(tf, _t(rois), _t(lvl), strides, 7, 2, valid=_t(valid))
    (got * _t(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=1e-5)
    assert np.abs(np.asarray(want)).max() > 0.5
    for i, (g, w) in enumerate(zip(tf, want_grads)):
        np.testing.assert_allclose(_nhwc(g.grad), np.asarray(w), rtol=0, atol=1e-4,
                                   err_msg=f"level {i}")


def test_single_roi_extractor_matches():
    rng = np.random.RandomState(6)
    feats = _feats(rng, C=8)
    rois = _hboxes(rng, (2, 30)) * 1.5 - 10
    rois[0, 0] = [5, 5, 5.5, 30]  # thin
    valid = rng.rand(2, 30) > 0.2
    want = JSingleRoIExtractor()(jnp_list(feats), jnp.asarray(rois), jnp.asarray(valid))
    got = SingleRoIExtractor()([_nchw(f) for f in feats], _t(rois), _t(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def jnp_list(xs):
    return [jnp.asarray(x) for x in xs]


# the cascade's stage-1 assignment -----------------------------------------------------

def test_hbb_assigner_on_per_image_candidates_matches():
    """Each image's gt hbbs prepended to its own proposals, with per-image
    masks: the reference vmaps the assigner over images, the port takes
    the (B, N, 4) candidates at once, in chunks or not."""
    rng = np.random.RandomState(7)
    B, K, P = 3, 6, 80
    gts = _hboxes(rng, (B, K))
    mask = rng.rand(B, K) > 0.3
    mask[2] = False  # an image without gts
    labels = np.where(mask, rng.randint(1, 16, (B, K)), 0)
    props = np.concatenate([gts[:, :3] + rng.normal(0, 3, (B, 3, 4)).astype(np.float32),
                            _hboxes(rng, (B, P - 3))], 1)
    cand = np.concatenate([gts, props], 1)
    cmask = np.concatenate([mask, rng.rand(B, P) > 0.1], 1)
    thr = dict(pos_iou_thr=0.5, neg_iou_thr=0.5, min_pos_iou=0.5, match_low_quality=False)
    want = jax.vmap(lambda c, g, m, l, cm: j_max_iou_assign_hbb(c, g, m, l, anchor_mask=cm,
                                                                **thr))(
        *map(jnp.asarray, (cand, gts, mask, labels, cmask)))
    assert int((np.asarray(want["gt_inds"]) > 0).sum()) > 3
    for chunk in (None, 2):
        got = max_iou_assign_hbb(_t(cand), _t(gts), _t(mask), _t(labels), anchor_mask=_t(cmask),
                                 iou_chunk=chunk, **thr)
        for k in ("gt_inds", "labels", "max_overlaps"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_rotation_invariant_encoding_matches_with_ties():
    rng = np.random.RandomState(8)
    x = rng.normal(0, 1, (6, 24)).astype(np.float32)
    x[0] = 1.0  # every orientation ties
    x[1, 2::8] = x[1, 5::8] = 9.0  # orientations 2 and 5 tie at the top
    x[2] = 0.0
    want_aligned, want_main = j_rotation_invariant_encoding(jnp.asarray(x), 8)
    aligned, main = rotation_invariant_encoding(_t(x), 8)
    np.testing.assert_array_equal(main.numpy(), np.asarray(want_main))
    np.testing.assert_array_equal(aligned.numpy(), np.asarray(want_aligned))
    assert main[:2].tolist() == [0, 2]


# equivariance of the port's bricks ---------------------------------------------------

def _orient_roll(x, k):
    """Roll the orientation channels of NCHW (fields-major, orientation
    fastest) by k."""
    B, C, H, W = x.shape
    return torch.roll(x.reshape(B, C // 8, 8, H, W), k, dims=2).reshape(x.shape)


def _rot90(x):
    return torch.rot90(x, 1, dims=(2, 3))


def test_reconv_rotation_rolls_the_orientations_by_6():
    """A 90-degree input rotation with its orientations rolled by 6 (-2)
    gives the rotated output rolled by 6, away from the border."""
    torch.manual_seed(0)
    conv = REConv2d(2, 3, 3)
    x = torch.rand(1, 16, 12, 12)
    with torch.no_grad():
        got = conv(_orient_roll(_rot90(x), 6))
        want = _orient_roll(_rot90(conv(x)), 6)
    torch.testing.assert_close(got[..., 2:-2, 2:-2], want[..., 2:-2, 2:-2], rtol=0, atol=1e-4)


def test_lifting_rotation_rolls_the_orientations_by_6():
    conv = REConv2dLift(3, 4, 7, stride=1, generator=torch.Generator().manual_seed(1))
    x = torch.rand(1, 3, 16, 16, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = conv(_rot90(x))
        want = _orient_roll(_rot90(conv(x)), 6)
    torch.testing.assert_close(got[..., 4:-4, 4:-4], want[..., 4:-4, 4:-4], rtol=0, atol=1e-4)


def test_inner_batchnorm_commutes_with_an_orientation_roll():
    bn = InnerBatchNorm(4).train()
    x = torch.rand(2, 32, 4, 4, generator=torch.Generator().manual_seed(3))
    out = bn(x)
    torch.testing.assert_close(bn(_orient_roll(x, 3)), _orient_roll(out, 3), rtol=0, atol=1e-5)
    bn.eval()
    torch.testing.assert_close(bn(_orient_roll(x, 3)), _orient_roll(bn(x), 3), rtol=0, atol=1e-6)


def test_riroi_align_at_45_degrees_shifts_the_orientations_by_one():
    f = 2
    feat = torch.zeros(1, f * 8, 16, 16)
    for o in range(8):
        feat[:, o::8] = o
    out0 = riroi_align(feat, torch.tensor([[[8.0, 8.0, 8.0, 8.0, 0.0]]]), 3)[0, 0, 1, 1]
    out45 = riroi_align(feat, torch.tensor([[[8.0, 8.0, 8.0, 8.0, math.pi / 4]]]), 3)[0, 0, 1, 1]
    torch.testing.assert_close(out0.reshape(f, 8)[0], torch.arange(8.0), rtol=0, atol=1e-4)
    torch.testing.assert_close(out45.reshape(f, 8)[0], torch.roll(torch.arange(8.0), -1), rtol=0,
                               atol=1e-4)


# the expansion cache -------------------------------------------------------------

class _Stack(torch.nn.Module):
    def __init__(self):
        super().__init__()
        g = torch.Generator().manual_seed(4)
        self.a = REConv2dLift(3, 4, 7, stride=2, generator=g)
        self.b = REConv2d(4, 8, 3, generator=g)
        self.c = ORConv2d(64, 8, 3, arf_config=(8, 8), generator=g)

    def forward(self, x):
        return self.c(self.b(self.a(x)))


def test_cache_expanded_weights_is_exact_and_drops_its_buffers():
    m = _Stack()
    x = torch.rand(2, 3, 32, 32, generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        y0 = m(x)
        assert cache_expanded_weights(m) == 3
        assert all(mod.wexp.numel() > 0 for mod in (m.a, m.b, m.c))
        assert torch.equal(m(x), y0)
    assert not any("wexp" in k for k in m.state_dict())
    # the cache never stands in for a weight that wants its gradient
    with pytest.raises(RuntimeError, match="gradient"):
        m(x)
    assert cache_expanded_weights(m, enable=False) == 3
    assert all(mod.wexp.numel() == 0 and not mod.cache_on for mod in (m.a, m.b, m.c))
    with torch.no_grad():
        assert torch.equal(m(x), y0)
    # a backward after a cache cycle reaches every base weight
    (m(x) ** 2).sum().backward()
    assert all(mod.weight.grad is not None and mod.weight.grad.abs().sum() > 0
               for mod in (m.a, m.b, m.c))


def test_a_stale_expansion_cache_raises():
    m = _Stack()
    cache_expanded_weights(m)
    with torch.no_grad():
        m.b.weight.mul_(2.0)
        with pytest.raises(RuntimeError, match="stale"):
            m(torch.rand(1, 3, 16, 16))
