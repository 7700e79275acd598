"""The heads' per-level `nms_pre` cut in jdet_torch against jdet_tpu, on
tied scores.

`jax.lax.top_k` keeps equal scores lower index first; `torch.topk` orders
them one way on the CPU and another on the card. The class logits here are
quantized to a few values, so that thousands of anchors of a level tie
across the `nms_pre` boundary. The port's cut (`ops/topk.py::stable_topk`)
must keep the reference's indices, and `RotatedRetinaHead.predict` then
gives the reference's detections: boxes atol 1e-4, scores atol 1e-6 on
valid rows, labels and the valid mask equal. `torch.topk` on the CPU
keeps another set of the tied anchors at these shapes. The test marked
`cuda` holds the cut on the card to the CPU's indices at RetinaNet's
level-0 size. JAX and jdet_tpu are imported inside the tests that use them,
so that on a machine without JAX `python -m pytest --noconftest
tests/test_torch_topk.py -m cuda` runs.
"""
import numpy as np
import pytest
import torch

import jdet_torch.models.heads  # noqa: F401  (registers the port's heads)
from jdet_torch.ops.topk import stable_topk
from jdet_torch.utils.registry import HEADS, build_from_cfg

HEAD = dict(type="RotatedRetinaHead", num_classes=4, in_channels=8, feat_channels=8,
            stacked_convs=1, test_cfg=dict(nms_pre=150, score_thr=0.05, max_per_img=300))
SIZE = 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_outs(seed=0, B=2, A=9, C=3):
    """NHWC head outputs of 5 levels at 128²: class logits on a grid of
    0.5 (few distinct values, so the per-anchor maxima tie by the
    thousand), random regression deltas."""
    rng = np.random.RandomState(seed)
    outs = []
    for s in (8, 16, 32, 64, 128):
        h = SIZE // s
        cls = (np.round(rng.normal(-2.0, 1.0, (B, h, h, A * C)) * 2) / 2).astype(np.float32)
        reg = rng.normal(0, 0.3, (B, h, h, A * 5)).astype(np.float32)
        outs.append((cls, reg))
    return outs


def test_nms_pre_cut_keeps_the_reference_indices_and_detections():
    import jax
    import jax.numpy as jnp
    from flax import nnx

    import jdet_tpu.models.heads  # noqa: F401  (registers the reference's heads)
    from jdet_tpu.utils.registry import HEADS as JHEADS

    outs = _tied_outs()
    nms_pre = HEAD["test_cfg"]["nms_pre"]
    cut = 0
    for cls, _ in outs:
        b = cls.shape[0]
        scores = 1 / (1 + np.exp(-cls.reshape(b, -1, 3).astype(np.float64)))
        mx = torch.sigmoid(torch.from_numpy(cls).reshape(b, -1, 3)).amax(-1)
        if mx.shape[1] <= nms_pre:
            continue
        cut += 1
        kth = np.sort(scores.max(-1), -1)[:, ::-1][:, nms_pre - 1]
        # the boundary runs through a block of ties
        assert ((scores.max(-1) == kth[:, None]).sum(-1) > 20).all()
        _, want = jax.lax.top_k(jnp.asarray(mx.numpy()), nms_pre)
        _, got = stable_topk(mx, nms_pre)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cut == 2

    cfg = dict(HEAD)
    jhead = JHEADS.get(cfg.pop("type"))(rngs=nnx.Rngs(0), **cfg)
    want = {k: np.asarray(v) for k, v in jax.jit(jhead.predict)(
        [tuple(jnp.asarray(t) for t in lvl) for lvl in outs]).items()}
    thead = build_from_cfg(dict(HEAD), HEADS, generator=torch.Generator().manual_seed(0))
    got = {k: v.numpy() for k, v in thead.predict(
        [tuple(torch.from_numpy(t).permute(0, 3, 1, 2).contiguous() for t in lvl)
         for lvl in outs]).items()}
    v = want["valid"]
    assert v.sum() > 100
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_allclose(got["scores"][v], want["scores"][v], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["boxes"][v], want["boxes"][v], rtol=0, atol=1e-4)


def test_stable_topk_orders_ties_lower_index_first():
    x = torch.tensor([[0.5, 0.75, 0.5, 0.75, 0.25, 0.5]])
    s, i = stable_topk(x, 4)
    assert i.tolist() == [[1, 3, 0, 2]] and s.tolist() == [[0.75, 0.75, 0.5, 0.5]]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_stable_topk_matches_a_stable_descending_sort(dtype):
    rng = np.random.RandomState(2)
    # few distinct values of either sign, with -0.0, +-inf and -inf ties
    x = torch.from_numpy(np.round(rng.normal(0, 2, (3, 4000))) / 4).to(dtype)
    x[0, :50] = -0.0
    x[1, ::7] = float("-inf")
    x[2, 3::11] = float("inf")
    want_s, want_i = torch.sort(x, dim=-1, descending=True, stable=True)
    for k in (1, 999, 4000, 5000):
        s, i = stable_topk(x, k)
        assert torch.equal(i, want_i[:, :k]) and torch.equal(s, want_s[:, :k])


@pytest.mark.cuda
def test_stable_topk_on_card_gives_the_cpu_indices_on_ties():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.RandomState(1)
    # RetinaNet's level 0 at 1024²: 128 * 128 * 9 anchors per image
    x = torch.from_numpy((np.round(rng.normal(0, 1, (4, 147456)) * 4) / 4).astype(np.float32))
    want_s, want_i = stable_topk(x, 2000)
    got_s, got_i = stable_topk(x.cuda(), 2000)
    torch.cuda.synchronize()
    assert torch.equal(got_i.cpu(), want_i) and torch.equal(got_s.cpu(), want_s)
