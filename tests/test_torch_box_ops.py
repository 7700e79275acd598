"""jdet_torch box codecs and rotated IoU against jdet_tpu, float32 on CPU.

Tolerances: codecs atol 1e-5, on boxes whose coordinates stay below 64
so that one float32 ulp (the two frameworks' sin/cos/log/exp differ by
about one) is below it; IoU atol 2e-5, the Green's-theorem sum being a
difference of ~|p|^2 terms rounded in another order."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jdet_tpu.ops import box_convert as jbc
from jdet_tpu.ops.box_iou_rotated import (
    box_iou_rotated as j_box_iou_rotated,
    box_iou_rotated_aligned as j_box_iou_rotated_aligned,
)
from jdet_torch.ops import box_convert as tbc
from jdet_torch.ops.box_iou_rotated import box_iou_rotated, box_iou_rotated_aligned


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's thread pool made the plain versions'
    many small ops tens of times slower here than one thread (77 s against
    0.34 s for four of the early-out cases of test_torch_iou_kernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rboxes(rng, n, spread=40.0, angle_lo=-2 * np.pi, angle_hi=2 * np.pi,
            max_w=20.0, max_h=12.0):
    return np.stack([
        rng.uniform(0, spread, n), rng.uniform(0, spread, n),
        rng.uniform(2, max_w, n), rng.uniform(2, max_h, n),
        rng.uniform(angle_lo, angle_hi, n),
    ], 1).astype(np.float32)


def _edge_case_boxes(rng, k=10, n=300):
    """Random gts and anchors; anchors 0..k-1 identical to the gts,
    k..2k-1 crossed (turned by pi/2), 2k..3k-1 touching (shifted by w)."""
    kw = dict(spread=500.0, angle_lo=-np.pi, angle_hi=np.pi, max_w=200.0,
              max_h=120.0)
    gts = _rboxes(rng, k, **kw)
    an = _rboxes(rng, n, **kw)
    an[:k] = gts
    an[k:2 * k] = gts
    an[k:2 * k, 4] += np.pi / 2
    an[2 * k:3 * k] = gts
    an[2 * k:3 * k, 0] += gts[:, 2]
    return gts, an


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_norm_angle_matches_across_wrap():
    rng = np.random.RandomState(0)
    a = rng.uniform(-4 * np.pi, 4 * np.pi, 1000).astype(np.float32)
    got = tbc.norm_angle(_t(a)).numpy()
    want = np.asarray(jbc.norm_angle(jnp.asarray(a)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert got.min() >= -np.pi / 4 - 1e-6 and got.max() < 3 * np.pi / 4 + 1e-6


@pytest.mark.parametrize("fn", ["rbox_to_poly", "rbox_to_hbox"])
def test_rbox_geometry_matches(fn):
    rng = np.random.RandomState(1)
    b = _rboxes(rng, 500).reshape(5, 100, 5)
    got = getattr(tbc, fn)(_t(b)).numpy()
    want = np.asarray(getattr(jbc, fn)(jnp.asarray(b)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_rbox2delta_matches_with_angle_wrap():
    rng = np.random.RandomState(2)
    props = _rboxes(rng, 800)
    gt = _rboxes(rng, 800)
    got = tbc.rbox2delta(_t(props), _t(gt)).numpy()
    want = np.asarray(jbc.rbox2delta(jnp.asarray(props), jnp.asarray(gt)))
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("k", [1, 3])
def test_delta2rbox_matches(k):
    rng = np.random.RandomState(3)
    rois = _rboxes(rng, 600).reshape(2, 300, 5)
    deltas = rng.normal(0, 0.5, (2, 300, 5 * k)).astype(np.float32)
    deltas[..., 4::5] = rng.uniform(-2, 2, (2, 300, k))  # across the wrap
    got = tbc.delta2rbox(_t(rois), _t(deltas)).numpy()
    want = np.asarray(jbc.delta2rbox(jnp.asarray(rois), jnp.asarray(deltas)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_box_iou_rotated_matches_xla_path():
    rng = np.random.RandomState(4)
    gts, an = _edge_case_boxes(rng)
    got = box_iou_rotated(_t(gts), _t(an)).numpy()
    want = np.asarray(j_box_iou_rotated(jnp.asarray(gts), jnp.asarray(an), impl="xla"))
    np.testing.assert_allclose(got, want, atol=2e-5)
    k = len(gts)
    np.testing.assert_allclose(got[np.arange(k), np.arange(k)], 1.0, atol=1e-5)


def test_box_iou_rotated_random_and_special_cases():
    rng = np.random.RandomState(5)
    b1 = _rboxes(rng, 40, spread=100.0, max_w=60.0, max_h=60.0)
    b2 = _rboxes(rng, 50, spread=100.0, max_w=60.0, max_h=60.0)
    got = box_iou_rotated(_t(b1), _t(b2)).numpy()
    want = np.asarray(j_box_iou_rotated(jnp.asarray(b1), jnp.asarray(b2), impl="xla"))
    np.testing.assert_allclose(got, want, atol=2e-5)
    # 45-degree cross of unit squares: a regular octagon
    sq = np.array([[0.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    rot = np.array([[0.0, 0.0, 1.0, 1.0, np.pi / 4]], np.float32)
    inter = 2 * (np.sqrt(2) - 1)
    np.testing.assert_allclose(
        box_iou_rotated(_t(sq), _t(rot)).numpy()[0, 0], inter / (2 - inter), atol=1e-5
    )
    # touching squares share an edge and do not overlap
    touch = np.array([[1.0, 0.0, 1.0, 1.0, 0.0]], np.float32)
    assert abs(float(box_iou_rotated(_t(sq), _t(touch))[0, 0])) < 1e-6


def test_box_iou_rotated_batched_chunked_and_aligned():
    rng = np.random.RandomState(6)
    g = _rboxes(rng, 2 * 12, spread=300.0, max_w=80.0, max_h=60.0).reshape(2, 12, 5)
    an = _rboxes(rng, 700, spread=300.0, max_w=80.0, max_h=60.0)
    batched = box_iou_rotated(_t(g), _t(an), chunk=5).numpy()
    assert batched.shape == (2, 12, 700)
    for b in range(2):
        want = np.asarray(j_box_iou_rotated(jnp.asarray(g[b]), jnp.asarray(an), impl="xla"))
        np.testing.assert_allclose(batched[b], want, atol=2e-5)
    a1, a2 = an[:350], an[350:]
    for mode in ("iou", "iof"):
        got = box_iou_rotated_aligned(_t(a1), _t(a2), mode=mode).numpy()
        want = np.asarray(j_box_iou_rotated_aligned(jnp.asarray(a1), jnp.asarray(a2),
                                                    mode=mode))
        np.testing.assert_allclose(got, want, atol=2e-5, err_msg=mode)
    got = box_iou_rotated(_t(g[0]), _t(an), mode="iof").numpy()
    want = np.asarray(j_box_iou_rotated(jnp.asarray(g[0]), jnp.asarray(an), mode="iof",
                                        impl="xla"))
    np.testing.assert_allclose(got, want, atol=2e-5)
