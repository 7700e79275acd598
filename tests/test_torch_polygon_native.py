"""The port's native polygon library (`jdet_torch/csrc/polygon.cpp`, built
with g++ by `jdet_torch/ops/polygon_native.py`) against its numpy plain
versions (`jdet_torch/data/devkits/polygon.py`), on the CPU: IoUs within
1e-9 and identical kept indices, on random rotated rectangles and on
nested, disjoint, touching, duplicate, clockwise and degenerate quads.
The library builds from the port's own source, and a failed build raises
with the compiler's output."""
import hashlib
from pathlib import Path

import numpy as np
import pytest

from jdet_torch.data.devkits import polygon
from jdet_torch.data.transforms import rbox_to_poly_np
from jdet_torch.ops import polygon_native

ROOT = Path(__file__).resolve().parents[1]


def _quads(rng, n, size=300):
    rb = np.stack([rng.uniform(0, size, n), rng.uniform(0, size, n),
                   rng.uniform(5, 80, n), rng.uniform(3, 40, n),
                   rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
    q = rbox_to_poly_np(rb).astype(np.float64)
    square = np.array([0, 0, 40, 0, 40, 40, 0, 40], np.float64)
    special = np.array([
        square,
        square * 0.5 + 10,                            # nested inside it
        square + 200,                                 # disjoint
        square + [40, 0] * 4,                         # shares an edge
        square + [40, 40] * 4,                        # touches at a corner
        square[[6, 7, 4, 5, 2, 3, 0, 1]],             # clockwise duplicate
        [7, 7] * 4,                                   # a point
        [0, 0, 40, 0, 40, 0, 0, 0],                   # a segment
        q[0],                                         # a duplicate of a random one
    ], np.float64)
    return np.concatenate([q, special])


def test_iou_matrix_matches_the_numpy_path():
    rng = np.random.default_rng(0)
    p1, p2 = _quads(rng, 60), _quads(rng, 45)
    got = polygon.poly_iou(p1, p2)
    want = polygon.poly_iou_plain(p1, p2)
    assert got.shape == want.shape == (len(p1), len(p2)) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    assert (want > 0).sum() > 50 and (want == 0).sum() > 50 and np.isclose(want, 1).sum() >= 3
    assert polygon.poly_iou(p1[:0], p2).shape == (0, len(p2))
    assert polygon.poly_iou(p1, p2[:0]).shape == (len(p1), 0)


@pytest.mark.parametrize("thr", [0.05, 0.1, 0.3, 0.7])
def test_nms_keeps_the_numpy_path_indices(thr):
    rng = np.random.default_rng(1)
    # clusters of overlapping boxes, so that every threshold suppresses
    centres = np.repeat(rng.uniform(0, 300, (12, 2)), 8, 0) + rng.normal(0, 6, (96, 2))
    rb = np.concatenate([centres, rng.uniform(20, 60, (96, 1)), rng.uniform(8, 20, (96, 1)),
                         rng.uniform(-0.3, 0.3, (96, 1))], 1).astype(np.float32)
    polys = np.concatenate([rbox_to_poly_np(rb).astype(np.float64), _quads(rng, 10)])
    scores = rng.permutation(len(polys)) / len(polys)  # distinct: no tie to order
    got = polygon.nms_poly_np(polys, scores, thr)
    want = polygon.nms_poly_plain(polys, scores, thr)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert 0 < len(got) < len(polys)
    assert len(polygon.nms_poly_np(polys[:0], scores[:0], thr)) == 0


def test_library_builds_from_the_ports_source(tmp_path, monkeypatch):
    lib = polygon_native.build()
    assert polygon_native.SOURCE == ROOT / "jdet_torch" / "csrc" / "polygon.cpp"
    assert Path(lib._name).parent == ROOT / "build"
    # the library's name is the hash of the port's source and flags
    key = hashlib.sha256((ROOT / "jdet_torch" / "csrc" / "polygon.cpp").read_bytes()
                         + " ".join(polygon_native.GXX_FLAGS).encode()).hexdigest()[:16]
    assert Path(lib._name).name == f"polygon_{key}.so"

    bad = tmp_path / "polygon.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(polygon_native, "_lib", None)
    monkeypatch.setattr(polygon_native, "SOURCE", bad)
    monkeypatch.setattr(polygon_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match=r"g\+\+ failed on .*polygon.cpp:\n.*error"):
        polygon_native.build()
    with pytest.raises(ValueError, match=r"\(n, 8\)"):
        polygon_native.poly_iou_matrix(np.zeros((3, 6)), np.zeros((2, 8)))
