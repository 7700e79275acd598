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
