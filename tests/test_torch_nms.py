"""jdet_torch rotated NMS against jdet_tpu, float32 on CPU.

Scores are well separated (distinct multiples of 1/(n*C+1)), so the keep
set is decided by the boxes alone and must be exactly the reference's.
Only valid slots are compared: the order of the -inf tail of a top-k is
not part of the contract."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from jdet_tpu.ops.nms_rotated import multiclass_nms_rotated as j_mc_nms
from jdet_tpu.ops.nms_rotated import nms_rotated as j_nms
from jdet_torch.ops.nms_rotated import _greedy_sweep, multiclass_nms_rotated, nms_rotated


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's thread pool made the plain versions'
    many small ops tens of times slower here than one thread (77 s against
    0.34 s for four of the early-out cases of test_torch_iou_kernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clustered(seed, n_clusters=30, per=8, num_classes=3):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(0, 600, (n_clusters, 2))
    boxes = []
    for c in centers:
        w, h = rng.uniform(20, 80), rng.uniform(10, 40)
        a = rng.uniform(-np.pi / 4, 3 * np.pi / 4)
        jit = rng.normal(0, [6, 6, 5, 3, 0.2], (per, 5))
        boxes.append(np.array([c[0], c[1], w, h, a]) + jit)
    boxes = np.concatenate(boxes).astype(np.float32)
    boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 2
    n = len(boxes)
    scores = (rng.permutation(n * num_classes) + 1) / (n * num_classes + 1)
    return boxes, scores.reshape(n, num_classes).astype(np.float32)


def _sequential_greedy(over, valid):
    n = len(valid)
    keep = np.zeros(n, bool)
    for i in range(n):
        if valid[i] and not any(keep[j] and over[j, i] for j in range(i)):
            keep[i] = True
    return keep


def test_greedy_sweep_is_exact_greedy():
    rng = np.random.RandomState(0)
    over = rng.rand(4, 60, 60) < 0.15
    valid = rng.rand(4, 60) < 0.9
    got = _greedy_sweep(torch.from_numpy(over), torch.from_numpy(valid)).numpy()
    for b in range(4):
        np.testing.assert_array_equal(got[b], _sequential_greedy(over[b], valid[b]))


def test_nms_rotated_matches():
    boxes, scores = _clustered(1)
    order, keep = nms_rotated(torch.from_numpy(boxes), torch.from_numpy(scores[:, 0]), 0.3)
    j_order, j_keep = j_nms(jnp.asarray(boxes), jnp.asarray(scores[:, 0]), 0.3)
    np.testing.assert_array_equal(order.numpy(), np.asarray(j_order))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(j_keep))
    assert 0 < keep.sum() < len(boxes)


@pytest.mark.parametrize("seed,class_cap,iou_thr,max_per_img", [
    (2, None, 0.1, 100),
    (3, 64, 0.3, 50),
    (4, None, 0.5, 1000),
])
def test_multiclass_nms_matches_on_valid_slots(seed, class_cap, iou_thr, max_per_img):
    boxes, scores = _clustered(seed)
    kw = dict(score_thr=0.05, nms_iou_thr=iou_thr, max_per_img=max_per_img)
    if class_cap is not None:
        kw["class_cap"] = class_cap
    got = multiclass_nms_rotated(torch.from_numpy(boxes)[None],
                                 torch.from_numpy(scores)[None], **kw)
    want = {k: np.asarray(v) for k, v in
            j_mc_nms(jnp.asarray(boxes), jnp.asarray(scores), **kw).items()}
    got = {k: v[0].numpy() for k, v in got.items()}
    for k in ("boxes", "scores", "labels", "valid"):
        assert got[k].shape == want[k].shape, k
    v = want["valid"]
    assert 0 < v.sum() < len(boxes) * scores.shape[1]
    np.testing.assert_array_equal(got["valid"], v)
    np.testing.assert_array_equal(got["scores"][v], want["scores"][v])
    np.testing.assert_array_equal(got["labels"][v], want["labels"][v])
    np.testing.assert_array_equal(got["boxes"][v], want["boxes"][v])
    assert (got["labels"][~v] == -1).all() and not got["scores"][~v].any()
