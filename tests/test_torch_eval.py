"""Evaluation and tile merging of jdet_torch against jdet_tpu, on the CPU.

Polygon IoU and NMS, `voc_eval_dota`, `DOTADataset.evaluate`, the
submission text of `save_submission`, `merge_results` and its CLI agree
with the reference: floats within 1e-12, kept indices and text identical.
Both packages take their native polygon library here (the port's is held
against its numpy path in tests/test_torch_polygon_native.py).
"""
import os
import pickle
import zipfile

import numpy as np
import pytest

from jdet_tpu.data.devkits import polygon as jpoly
from jdet_tpu.data.devkits import result_merge as jmerge
from jdet_tpu.data.devkits.voc_eval import voc_ap as j_voc_ap
from jdet_tpu.data.devkits.voc_eval import voc_eval_dota as j_voc_eval_dota
from jdet_tpu.data.dota import DOTADataset as JDOTADataset
from jdet_torch.config.constants import DOTA1_CLASSES
from jdet_torch.data.devkits import polygon as tpoly
from jdet_torch.data.devkits import result_merge as tmerge
from jdet_torch.data.devkits.voc_eval import voc_ap, voc_eval_dota
from jdet_torch.data.dota import DOTADataset
from jdet_torch.data.transforms import rbox_to_poly_np
from jdet_torch.tools import merge_results as merge_cli

TOL = 1e-12


def _rboxes(rng, n, size=200):
    return np.stack([rng.uniform(0, size, n), rng.uniform(0, size, n),
                     rng.uniform(5, 60, n), rng.uniform(3, 30, n),
                     rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)


def _quads(rng, n, size=200):
    """Rotated rectangles, plus a duplicate, a touching pair, a zero-area
    quad and a clockwise one."""
    q = rbox_to_poly_np(_rboxes(rng, n, size)).astype(np.float64)
    extra = np.array([q[0], [0, 0, 10, 0, 10, 10, 0, 10], [10, 0, 20, 0, 20, 10, 10, 10],
                      [5, 5, 5, 5, 5, 5, 5, 5], q[1].reshape(4, 2)[::-1].reshape(8)])
    return np.concatenate([q, extra])


def test_polygon_iou_and_nms_match_the_reference():
    rng = np.random.default_rng(0)
    p1, p2 = _quads(rng, 40), _quads(rng, 30)
    np.testing.assert_allclose(tpoly.poly_iou(p1, p2), jpoly.poly_iou(p1, p2), rtol=0, atol=TOL)
    np.testing.assert_allclose(tpoly.poly_iou_aligned(p1[:35], p2[:35]),
                               jpoly.poly_iou_aligned(p1[:35], p2[:35]), rtol=0, atol=TOL)
    assert tpoly.poly_iou(p1[:0], p2).shape == (0, len(p2))
    scores = rng.uniform(0, 1, len(p1))
    for thr in (0.1, 0.3, 0.7):
        np.testing.assert_array_equal(tpoly.nms_poly_np(p1, scores, thr),
                                      jpoly.nms_poly_np(p1, scores, thr))


def _dets_and_gts(rng, n_img=5):
    dets, gts = {}, {}
    for i in range(n_img):
        g = _quads(rng, 6)[:8]
        difficult = rng.uniform(0, 1, len(g)) < 0.2
        jitter = g[rng.integers(0, len(g), 9)] + rng.normal(0, 2, (9, 8))
        d = np.concatenate([jitter, _quads(rng, 4)[:4]])
        dets[i] = np.concatenate([d, rng.uniform(0, 1, (len(d), 1))], 1)
        gts[i] = {"polys": g, "difficult": difficult}
    gts[n_img] = {"polys": np.zeros((0, 8)), "difficult": np.zeros(0, bool)}
    return dets, gts


@pytest.mark.parametrize("use_07", [True, False])
def test_voc_eval_matches_the_reference(use_07):
    rng = np.random.default_rng(1)
    dets, gts = _dets_and_gts(rng)
    got = voc_eval_dota(dets, gts, ovthresh=0.5, use_07_metric=use_07)
    want = j_voc_eval_dota(dets, gts, ovthresh=0.5, use_07_metric=use_07)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert 0 < got[2] <= 1
    rec, prec = np.sort(rng.uniform(0, 1, 20)), rng.uniform(0, 1, 20)
    assert abs(voc_ap(rec, prec, use_07) - j_voc_ap(rec, prec, use_07)) <= TOL
    assert voc_eval_dota({}, gts)[2] == 0.0


def _results(rng, n_img=4, tile_names=False):
    """(det, meta) pairs as the Runner makes them: fixed-size detection
    slots with a valid mask, and each tile's gts in its meta."""
    out = []
    for i in range(n_img):
        rb = _rboxes(rng, 6, size=1000)
        polys = rbox_to_poly_np(rb)
        labels = rng.integers(1, 16, 6)
        det_polys = np.concatenate([polys + rng.normal(0, 3, polys.shape),
                                    rbox_to_poly_np(_rboxes(rng, 6, size=1000))]).astype(np.float32)
        det = {
            "polys": det_polys,
            "scores": rng.uniform(0, 1, 12).astype(np.float32),
            "labels": np.concatenate([labels - 1, rng.integers(0, 15, 6)]),
            "valid": rng.uniform(0, 1, 12) < 0.8,
        }
        name = f"P{i % 2:04d}__1.0__{512 * (i // 2)}___{256 * (i % 2)}.png" if tile_names \
            else f"img_{i}.png"
        out.append((det, {"img_id": i, "filename": name, "polys": polys, "labels": labels,
                          "polys_ignore": polys[:1] if i == 2 else np.zeros((0, 8), np.float32)}))
    return out


def test_dota_evaluate_and_submission_match_the_reference(tmp_path):
    rng = np.random.default_rng(2)
    results = _results(rng)
    mine, ref = DOTADataset(), JDOTADataset()
    got, want = mine.evaluate(results), ref.evaluate(results)
    assert list(got) == list(want) and len(got) == 16
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL, k
    assert got["eval/1_plane_AP"] is not None and 0 <= got["eval/0_meanAP"] <= 1
    mine.save_submission(results, str(tmp_path / "mine"))
    ref.save_submission(results, str(tmp_path / "ref"))
    names = sorted(os.listdir(tmp_path / "ref"))
    assert sorted(os.listdir(tmp_path / "mine")) == names and len(names) == 15
    for n in names:
        assert (tmp_path / "mine" / n).read_text() == (tmp_path / "ref" / n).read_text(), n


def test_merge_results_and_cli_match_the_reference(tmp_path):
    rng = np.random.default_rng(3)
    assert tmerge.parse_tile_name("P0001__0.5__512___1024") == \
        jmerge.parse_tile_name("P0001__0.5__512___1024") == ("P0001", 0.5, 512, 1024)
    assert tmerge.parse_tile_name("plain") == ("plain", 1.0, 0, 0)
    polys = rng.uniform(0, 100, (5, 8))
    np.testing.assert_array_equal(tmerge.tile_to_original(polys, 0.5, 3, 4),
                                  jmerge.tile_to_original(polys, 0.5, 3, 4))
    results = _results(rng, n_img=6, tile_names=True)
    for thr in (0.1, {"plane": 0.3}):
        kw = dict(per_class_thr=thr) if isinstance(thr, dict) else dict(iou_thr=thr)
        got = tmerge.merge_results(results, DOTA1_CLASSES, **kw)
        want = jmerge.merge_results(results, DOTA1_CLASSES, **kw)
        assert got.keys() == want.keys() == {"P0000", "P0001"}
        for img in want:
            assert got[img].keys() == want[img].keys()
            for c in want[img]:
                np.testing.assert_allclose(got[img][c], want[img][c], rtol=0, atol=TOL)
    files = tmerge.write_dota_submission(got, DOTA1_CLASSES, str(tmp_path / "mine"),
                                         zip_path=str(tmp_path / "mine.zip"))
    jmerge.write_dota_submission(want, DOTA1_CLASSES, str(tmp_path / "ref"))
    assert len(files) == 15 and os.path.exists(tmp_path / "mine.zip")
    for f in files:
        name = os.path.basename(f)
        assert open(f).read() == (tmp_path / "ref" / name).read_text(), name

    pkl = tmp_path / "test_1.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(results, f)
    out = merge_cli.main(["--results", str(pkl), "--out-dir", str(tmp_path / "cli"),
                          "--zip", str(tmp_path / "cli.zip")])
    assert len(out) == 15 and os.path.exists(tmp_path / "cli.zip")
    jmerge.write_dota_submission(jmerge.merge_results(results, DOTA1_CLASSES),
                                 DOTA1_CLASSES, str(tmp_path / "ref_cli"))
    for f in out:
        assert open(f).read() == (tmp_path / "ref_cli" / os.path.basename(f)).read_text()
    # FAIR: the submission converted to per-image XML and zipped, as the
    # reference's tools/merge_results.py does (`finalize_submission`)
    from jdet_tpu.config.constants import FAIR_CLASSES
    from jdet_tpu.data.devkits.converters import finalize_submission

    merge_cli.main(["--results", str(pkl), "--out-dir", str(tmp_path / "fair"),
                    "--dataset-type", "FAIR", "--zip", str(tmp_path / "fair.zip")])
    jmerge.write_dota_submission(jmerge.merge_results(results, FAIR_CLASSES), FAIR_CLASSES,
                                 str(tmp_path / "ref_fair"))
    finalize_submission(str(tmp_path / "ref_fair"), str(tmp_path / "ref_fair"), "submission",
                        "FAIR", zip_path=str(tmp_path / "ref_fair.zip"))
    with zipfile.ZipFile(tmp_path / "fair.zip") as a, \
            zipfile.ZipFile(tmp_path / "ref_fair.zip") as b:
        assert a.namelist() == b.namelist() and len(b.namelist()) > 0
        assert all(a.read(n) == b.read(n) for n in b.namelist())
