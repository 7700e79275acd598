"""The rotated-IoU kernel's plain version against the Pallas body.

The Pallas kernel runs in interpret mode on the CPU, as the JAX suite runs
it (tests/test_box_iou_rotated.py). Tolerances are the reference's own for
that kernel: identical boxes give 1 within 1e-5, everything else within
atol 2e-4. The tests marked `cuda` hold the CUDA kernels against the plain
versions on the card and skip where there is none. JAX and jdet_tpu are
imported inside the tests that use them, so that on a machine without JAX
the `cuda` tests run with `python -m pytest --noconftest
tests/test_torch_iou_kernel.py -m cuda`."""
import numpy as np
import pytest
import torch

from jdet_torch.ops import rotated_iou_kernel as rik
from jdet_torch.ops.box_iou_rotated import box_iou_rotated


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's thread pool made the plain versions'
    many small ops tens of times slower here than one thread (77 s against
    0.34 s for four of the early-out cases of test_torch_iou_kernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(seed=3, K=10, N=300):
    """The cases of tests/test_box_iou_rotated.py's Pallas parity test:
    identical, crossed and touching anchors beside random ones."""
    rng = np.random.RandomState(seed)
    gts = np.stack([rng.uniform(0, 500, K), rng.uniform(0, 500, K),
                    rng.uniform(8, 200, K), rng.uniform(8, 120, K),
                    rng.uniform(-np.pi, np.pi, K)], 1).astype(np.float32)
    an = np.stack([rng.uniform(0, 500, N), rng.uniform(0, 500, N),
                   rng.uniform(8, 200, N), rng.uniform(8, 120, N),
                   rng.uniform(-np.pi, np.pi, N)], 1).astype(np.float32)
    an[:K] = gts
    an[K:2 * K] = gts
    an[K:2 * K, 4] += np.pi / 2
    an[2 * K:3 * K] = gts
    an[2 * K:3 * K, 0] += gts[:, 2]
    return gts, an


def _pallas(gts, an, **kw):
    import jax.numpy as jnp
    from jdet_tpu.ops.pallas_iou import box_iou_rotated_pallas

    return np.asarray(box_iou_rotated_pallas(jnp.asarray(gts), jnp.asarray(an),
                                             interpret=True, **kw))


def _pallas_vmapped(gts_b, an, **kw):
    import jax
    import jax.numpy as jnp
    from jdet_tpu.ops.pallas_iou import box_iou_rotated_pallas

    return np.asarray(jax.vmap(
        lambda g: box_iou_rotated_pallas(g, jnp.asarray(an), interpret=True, **kw)
    )(jnp.asarray(gts_b)))


def test_reference_matches_pallas_interpret():
    gts, an = _case()
    got = rik.box_iou_rotated_rect_reference(torch.from_numpy(gts),
                                             torch.from_numpy(an)).numpy()
    want = _pallas(gts, an)
    np.testing.assert_allclose(got, want, atol=2e-4)
    K = len(gts)
    np.testing.assert_allclose(got[np.arange(K), np.arange(K)], 1.0, atol=1e-5)


def test_reference_batched_matches_pallas_vmapped():
    gts, an = _case()
    gts_b = np.stack([gts, gts[::-1]]).astype(np.float32)
    want = _pallas_vmapped(gts_b, an)
    got = rik.box_iou_rotated_rect_reference(torch.from_numpy(gts_b),
                                             torch.from_numpy(an)).numpy()
    assert got.shape == want.shape == (2, len(gts), len(an))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_parked_pad_gts():
    import jax.numpy as jnp
    from jdet_tpu.ops.pallas_iou import park_masked_boxes as j_park

    gts, an = _case(seed=7, K=12, N=400)
    mask = np.zeros((2, 12), bool)
    mask[0, :5] = True
    mask[1, :9] = True
    gts_b = np.stack([gts, gts[::-1]]).astype(np.float32)
    parked = rik.park_masked_boxes(torch.from_numpy(gts_b), torch.from_numpy(mask))
    want_parked = np.asarray(j_park(jnp.asarray(gts_b), jnp.asarray(mask)))
    np.testing.assert_array_equal(parked.numpy(), want_parked)
    got = rik.box_iou_rotated_rect_reference(parked, torch.from_numpy(an)).numpy()
    for b in range(2):
        np.testing.assert_allclose(got[b], _pallas(want_parked[b], an), atol=2e-4)
    assert not got[~mask].any()


def test_wrapper_on_cpu_routes_to_plain_version():
    gts, an = _case()
    g, a = torch.from_numpy(gts), torch.from_numpy(an)
    before = rik.LAUNCHES
    got = rik.box_iou_rotated_rect(g, a)
    assert rik.LAUNCHES == before
    torch.testing.assert_close(got, rik.box_iou_rotated_rect_reference(g, a),
                               rtol=0, atol=0)
    # the dispatcher's kernel route takes the wrapper, which on the CPU is
    # the plain version; above the pair bar on the CPU, auto stays plain
    torch.testing.assert_close(box_iou_rotated(g, a, impl="cuda"), got,
                               rtol=0, atol=0)
    big = torch.from_numpy(np.tile(an, (4000, 1)))
    auto = box_iou_rotated(g[:1], big[: (1 << 20) + 7])
    assert auto.shape == (1, (1 << 20) + 7) and rik.LAUNCHES == before


@pytest.mark.parametrize("bad", ["dtype", "gt_shape", "anchor_shape", "strided"])
def test_wrapper_rejects_bad_inputs(bad):
    gts, an = _case()
    g, a = torch.from_numpy(gts), torch.from_numpy(an)
    if bad == "dtype":
        g = g.double()
    elif bad == "gt_shape":
        g = g[:, :4].contiguous()
    elif bad == "anchor_shape":
        a = a[None]
    else:
        a = torch.from_numpy(np.ascontiguousarray(np.tile(an, (1, 2))))[:, ::2]
    with pytest.raises((TypeError, ValueError)):
        rik.box_iou_rotated_rect(g, a)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gts, an = _case()
    g = torch.from_numpy(np.stack([gts, gts[::-1]])).cuda()
    a = torch.from_numpy(an).cuda()
    before = rik.LAUNCHES
    got = rik.box_iou_rotated_rect(g, a)
    torch.cuda.synchronize()
    assert rik.LAUNCHES == before + 1
    want = rik.box_iou_rotated_rect_reference(g, a)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    K = len(gts)
    diag = got[0, torch.arange(K), torch.arange(K)]
    torch.testing.assert_close(diag, torch.ones_like(diag), rtol=0, atol=1e-5)


# K2: the generic kernel (box_iou_rotated_pallas(..., kernel="generic")) ----

def _pallas_generic(gts, an):
    return _pallas(gts, an, kernel="generic")


def test_generic_reference_matches_pallas_interpret():
    gts, an = _case()
    got = rik.box_iou_rotated_generic_reference(torch.from_numpy(gts),
                                                torch.from_numpy(an)).numpy()
    want = _pallas_generic(gts, an)
    np.testing.assert_allclose(got, want, atol=2e-4)
    K = len(gts)
    np.testing.assert_allclose(got[np.arange(K), np.arange(K)], 1.0, atol=1e-5)
    # crossed and touching anchors overlap their gt partly
    assert (got[np.arange(K), K + np.arange(K)] > 0).all()
    assert (got[np.arange(K), 2 * K + np.arange(K)] < 1).all()


def test_generic_reference_batched_matches_pallas_vmapped():
    gts, an = _case(seed=5)
    gts_b = np.stack([gts, gts[::-1]]).astype(np.float32)
    want = _pallas_vmapped(gts_b, an, kernel="generic")
    got = rik.box_iou_rotated_generic_reference(torch.from_numpy(gts_b),
                                                torch.from_numpy(an)).numpy()
    assert got.shape == want.shape == (2, len(gts), len(an))
    np.testing.assert_allclose(got, want, atol=2e-4)
    # the same IoU as the rect kernel's plain version
    rect = rik.box_iou_rotated_rect_reference(torch.from_numpy(gts_b),
                                              torch.from_numpy(an)).numpy()
    np.testing.assert_allclose(got, rect, atol=2e-4)


def test_generic_wrapper_on_cpu_routes_to_plain_version():
    gts, an = _case()
    g, a = torch.from_numpy(gts), torch.from_numpy(an)
    before = rik.GENERIC_LAUNCHES, rik.LAUNCHES
    got = rik.box_iou_rotated_generic(g, a)
    assert (rik.GENERIC_LAUNCHES, rik.LAUNCHES) == before
    torch.testing.assert_close(got, rik.box_iou_rotated_generic_reference(g, a),
                               rtol=0, atol=0)
    got_b = rik.box_iou_rotated_generic(torch.stack([g, g]), a)
    assert got_b.shape == (2, len(gts), len(an))
    torch.testing.assert_close(got_b[1], got, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "gt_shape", "anchor_shape", "strided", "devices"])
def test_generic_wrapper_rejects_bad_inputs(bad):
    gts, an = _case()
    g, a = torch.from_numpy(gts), torch.from_numpy(an)
    if bad == "dtype":
        a = a.half()
    elif bad == "gt_shape":
        g = g[None, None]
    elif bad == "anchor_shape":
        a = a[:, :4].contiguous()
    elif bad == "strided":
        g = torch.from_numpy(np.ascontiguousarray(np.tile(gts, (1, 2))))[:, ::2]
    else:
        g = g.to("meta")
    with pytest.raises((TypeError, ValueError)):
        rik.box_iou_rotated_generic(g, a)


@pytest.mark.cuda
def test_generic_kernel_matches_plain_version_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    gts, an = _case()
    g = torch.from_numpy(np.stack([gts, gts[::-1]])).cuda()
    a = torch.from_numpy(an).cuda()
    before = rik.GENERIC_LAUNCHES
    got = rik.box_iou_rotated_generic(g, a)
    torch.cuda.synchronize()
    assert rik.GENERIC_LAUNCHES == before + 1
    want = rik.box_iou_rotated_generic_reference(g, a)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-4)
    K = len(gts)
    diag = got[0, torch.arange(K), torch.arange(K)]
    torch.testing.assert_close(diag, torch.ones_like(diag), rtol=0, atol=1e-5)
    # the early-out writes exact zeros, which the plain version gives too
    early = rik.generic_early_out_pairs(g, a)
    assert early.any() and not got[early].any() and not want[early].any()


# K2's early-out: the pairs of generic_early_out_pairs, where the kernel
# writes 0 without the clip, must be exact zeros of the plain version ------

def _near_contact(seed, K=24, N=1500):
    """Gts and anchors where most anchors sit just outside some gt's circle
    (|d| = r_g + r_a times 1 to 1.05), the rest overlapping it: sizes
    log-uniform over 2..300 px, one box in ten zero-width, one in ten a
    needle (one side times 1e-4), any angle, centers up to 1e4."""
    rng = np.random.RandomState(seed)

    def boxes(m):
        size = np.exp(rng.uniform(np.log(2), np.log(300), (m, 2)))
        size[rng.rand(m) < 0.1, 0] = 0.0
        size[rng.rand(m) < 0.1, 1] *= 1e-4
        return np.c_[rng.uniform(0, 1e4, (m, 2)), size,
                     rng.uniform(-7, 7, m)].astype(np.float32)

    gts, an = boxes(K), boxes(N)
    j = rng.randint(0, K, N)
    reach = (gts[j, 2] + gts[j, 3] + an[:, 2] + an[:, 3]) / 2
    dist = reach * np.where(rng.rand(N) < 0.8, np.exp(rng.uniform(0, 0.05, N)),
                            rng.uniform(0, 1, N))
    ang = rng.uniform(0, 2 * np.pi, N)
    an[:, 0] = gts[j, 0] + dist * np.cos(ang)
    an[:, 1] = gts[j, 1] + dist * np.sin(ang)
    return torch.from_numpy(gts), torch.from_numpy(an.astype(np.float32))


def _degenerate():
    from jdet_torch.utils.edge_cases import degenerate_boxes

    g, a, checked = degenerate_boxes()
    return torch.from_numpy(g), torch.from_numpy(a), torch.from_numpy(checked)


@pytest.mark.parametrize("case", ["degenerate", "edge", 0, 1, 2, 3])
def test_generic_early_out_pairs_are_zero_in_plain_version(case):
    if case == "degenerate":
        g, a, _ = _degenerate()
    elif case == "edge":
        gts, an = _case(seed=5)
        g, a = torch.from_numpy(np.stack([gts, gts[::-1]])), torch.from_numpy(an)
    else:
        g, a = _near_contact(case)
    early = rik.generic_early_out_pairs(g, a)
    assert early.shape == (*g.shape[:-1], a.shape[0]) and early.dtype == torch.bool
    assert int(early.sum()) >= 1000
    want = rik.box_iou_rotated_generic_reference(g, a)
    assert not want[early].any(), int((want[early] != 0).sum())
    # the trap: a zero-size or needle box far from the other one can be
    # nonzero, and such pairs never take the early-out
    d2 = (a[:, :2] - g[..., None, :2]).square().sum(-1)
    reach = (g[..., None, 2] + g[..., None, 3] + a[:, 2] + a[:, 3]) / 2
    far_nonzero = (d2 >= reach * reach) & (want != 0)
    assert not (far_nonzero & early).any()
    if case in ("degenerate", 0):
        assert far_nonzero.any()


def test_generic_early_out_selects_most_pairs_on_the_main_path():
    """At the main path's operands, cut: synth_batch-like gts (2 images x
    32 real gts over a 1024² tile) against every 16th anchor of the
    config's 1024² grid. The early-out must take at least 90% of the pairs,
    so that the exactness tests above are not vacuous there."""
    from jdet_torch.models.boxes import AnchorGeneratorRotated

    anchors = torch.cat([
        AnchorGeneratorRotated(s, octave_base_scale=4, scales_per_octave=3,
                               ratios=(1.0, 0.5, 2.0)).grid_anchors((1024 // s,) * 2, s, "cpu")
        for s in (8, 16, 32, 64, 128)])[::16].contiguous()
    rng = np.random.RandomState(2)
    gts = np.stack([np.stack([rng.uniform(50, 974, 32), rng.uniform(50, 974, 32),
                              rng.uniform(20, 200, 32), rng.uniform(10, 100, 32),
                              rng.uniform(-np.pi / 4, 3 * np.pi / 4, 32)], 1)
                    for _ in range(2)]).astype(np.float32)
    g = torch.from_numpy(gts)
    early = rik.generic_early_out_pairs(g, anchors)
    assert early.float().mean().item() >= 0.9
    assert not rik.box_iou_rotated_generic_reference(g, anchors)[early].any()


def test_generic_degenerate_rows_match_pallas_interpret():
    """The zero-size gt's and the needles' rows: the Pallas generic body and
    the plain version agree on the compared pairs; the zero-size gt has
    IoU ~1 against every anchor of nonzero area that is compared, and the
    needles small nonzero IoUs."""
    g, a, checked = _degenerate()
    rows, mask = g[0, :3], checked[0, :3]
    got = rik.box_iou_rotated_generic_reference(rows, a).numpy()
    want = _pallas_generic(rows.numpy(), a.numpy())
    np.testing.assert_allclose(got[mask.numpy()], want[mask.numpy()], atol=2e-4)
    sized = mask[0] & (a[:, 2] * a[:, 3] > 0)
    assert int(sized.sum()) >= 200 and (got[0][sized.numpy()] > 0.999).all()
    needles = got[1:][mask[1:].numpy()]
    assert (needles > 0).any() and (needles < 1e-4).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["degenerate", 0, 1])
def test_generic_kernel_keeps_values_on_degenerate_operands(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if case == "degenerate":
        g, a, checked = _degenerate()
    else:
        g, a = _near_contact(case)
        checked = torch.ones(g.shape[0], a.shape[0], dtype=torch.bool)
    g, a, checked = g.cuda(), a.cuda(), checked.cuda()
    before = rik.GENERIC_LAUNCHES
    got = rik.box_iou_rotated_generic(g, a)
    torch.cuda.synchronize()
    assert rik.GENERIC_LAUNCHES == before + 1
    want = rik.box_iou_rotated_generic_reference(g, a)
    if case == "degenerate":
        torch.testing.assert_close(got[checked], want[checked], rtol=0, atol=2e-4)
    early = rik.generic_early_out_pairs(g, a)
    assert int(early.sum()) >= 1000
    assert not got[early].any() and not want[early].any()
