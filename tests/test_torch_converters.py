"""The SSDD+ / FAIR1M converters and their CLIs against jdet_tpu's, on the
CPU.

Source trees are written around the committed codec fixtures
(`tests/data/torch_codecs/`: JPEG scenes for SSDD, TIFF scenes for FAIR)
by `jdet_torch/data/synthetic.py`. The reference's converters
(`jdet_tpu/data/devkits/converters.py`, cv2) and the port's
(`jdet_torch/data/devkits/converters.py`, its own decoders and
`resize_linear`) must write label files equal byte for byte and PNGs
that decode to the same pixels; `ssdd_to_dota` with `plus` on and off.
The submission converters (`dota_to_fair`, `dota_to_fair1m_1_5`,
`finalize_submission`) must write the same XML, csv and zip entries.
`python -m jdet_torch.tools.preprocess` runs the `convert` step of
`configs/s2anet_r50_fpn_1x_ssdd_plus.py` and
`configs/s2anet_r50_fpn_1x_fair1m_1_5.py` with only their paths pointed at
the synthetic trees (then FAIR1M's tiling): the labels.pkl records, label
files and images equal the reference's steps (`tools/preprocess.py:36-59`),
and `python -m jdet_torch.tools.merge_results --dataset-type FAIR1M_1_5`
writes the reference's csv.
"""
import os
import pickle
import zipfile

import cv2
import numpy as np
import pytest
import torch

from jdet_tpu.config.constants import get_classes_by_name as j_classes
from jdet_tpu.data.devkits import converters as jconv
from jdet_tpu.data.devkits import result_merge as jmerge
from jdet_tpu.data.devkits import tiling as jtiling
from jdet_torch.data.devkits import converters as conv
from jdet_torch.data.synthetic import make_fair_tree, make_ssdd_tree
from jdet_torch.tools import merge_results, preprocess
from make_codec_fixtures import OUT as FIXTURES

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JPEGS = [os.path.join(FIXTURES, n) for n in (
    "baseline_420_640x480.jpg", "progressive_422_333x217.jpg", "restart_440_301x203.jpg",
    "gray_progressive_211x97.jpg", "exif6_420_160x96.jpg")]
TIFFS = [os.path.join(FIXTURES, n) for n in (
    "lzw_predictor_1000x1000.tif", "tiled_planar_deflate_150x100.tif",
    "deflate_gray_201x121.tif", "packbits_101x63.tif")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _files(d):
    return sorted(os.listdir(d))


def assert_same_trees(got, want):
    """Equal label files byte for byte, PNGs of equal pixels (cv2 reads
    both), and equal labels.pkl records where the reference wrote one."""
    for sub in ("labelTxt", "images"):
        assert _files(os.path.join(got, sub)) == _files(os.path.join(want, sub)), sub
    for name in _files(os.path.join(want, "labelTxt")):
        with open(os.path.join(got, "labelTxt", name), "rb") as a, \
                open(os.path.join(want, "labelTxt", name), "rb") as b:
            assert a.read() == b.read(), name
    for name in _files(os.path.join(want, "images")):
        a = cv2.imread(os.path.join(got, "images", name), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(os.path.join(want, "images", name), cv2.IMREAD_UNCHANGED)
        assert a.shape == b.shape and np.array_equal(a, b), name
    pkl = os.path.join(want, "labels.pkl")
    if os.path.exists(pkl):
        with open(os.path.join(got, "labels.pkl"), "rb") as f:
            records = pickle.load(f)
        with open(pkl, "rb") as f:
            ref = pickle.load(f)
        assert [r["filename"] for r in records] == [r["filename"] for r in ref]
        for r, w in zip(records, ref):
            assert (r["height"], r["width"]) == (w["height"], w["width"])
            for k, v in w["ann"].items():
                assert r["ann"][k].dtype == v.dtype, k
                np.testing.assert_array_equal(r["ann"][k], v, err_msg=f"{r['filename']} {k}")


@pytest.mark.parametrize("plus", [False, True])
def test_ssdd_to_dota_matches_the_reference(tmp_path, plus):
    img_dir, ann_dir = make_ssdd_tree(str(tmp_path / "ssdd"), JPEGS, seed=int(plus))
    jconv.ssdd_to_dota(img_dir, ann_dir, str(tmp_path / "want"), resize=512, plus=plus)
    conv.ssdd_to_dota(img_dir, ann_dir, str(tmp_path / "got"), resize=512, plus=plus)
    assert len(_files(tmp_path / "got" / "images")) == len(JPEGS)
    assert_same_trees(str(tmp_path / "got"), str(tmp_path / "want"))


def test_fair_to_dota_matches_the_reference(tmp_path):
    src = str(tmp_path / "fair")
    make_fair_tree(src, TIFFS, dataset_type="FAIR1M_1_5", seed=3)
    jconv.fair_to_dota(src, str(tmp_path / "want"))
    conv.fair_to_dota(src, str(tmp_path / "got"))
    assert _files(tmp_path / "got" / "images") == [f"P{i:04d}.png" for i in range(1, 5)]
    assert_same_trees(str(tmp_path / "got"), str(tmp_path / "want"))


def _submission_txts(root, classes, seed=0):
    """Merged per-class DOTA submission files (`Task1_<class>.txt`), some
    images without any detection."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for c in classes:
        lines = []
        for img in ("P0001", "P0003", "P0012"):
            for _ in range(int(rng.integers(0, 4))):
                pts = " ".join(f"{v:.2f}" for v in rng.uniform(0, 1000, 8))
                lines.append(f"{img} {rng.random():.4f} {pts}")
        with open(os.path.join(root, f"Task1_{c}.txt"), "w") as f:
            f.write("\n".join(lines))


@pytest.mark.parametrize("dataset_type", ["FAIR", "FAIR1M_1_5", "DOTA"])
def test_submission_converters_match_the_reference(tmp_path, dataset_type):
    classes = j_classes(dataset_type)
    txt = str(tmp_path / "txt")
    _submission_txts(txt, classes, seed=len(dataset_type))
    images = tmp_path / "images"
    images.mkdir()
    for name in ("P0001__1.0__0___0.png", "P0002__1.0__0___0.png", "P0012.png"):
        (images / name).write_bytes(b"")
    got = conv.finalize_submission(txt, str(tmp_path / "got"), "sub", dataset_type,
                                   images_dir=str(images))
    want = jconv.finalize_submission(txt, str(tmp_path / "want"), "sub", dataset_type,
                                     images_dir=str(images))
    assert os.path.basename(got) == os.path.basename(want)
    if got.endswith(".zip"):
        with zipfile.ZipFile(got) as a, zipfile.ZipFile(want) as b:
            assert a.namelist() == b.namelist()
            for n in b.namelist():
                assert a.read(n) == b.read(n), n
    else:
        assert open(got, "rb").read() == open(want, "rb").read()
    if dataset_type == "FAIR":
        assert _files(tmp_path / "got" / "final_fair" / "test") == \
            ["1.xml", "12.xml", "2.xml", "3.xml"]
    # the two lower-level converters on their own
    conv.dota_to_fair(txt, str(tmp_path / "fair_got"), str(images))
    jconv.dota_to_fair(txt, str(tmp_path / "fair_want"), str(images))
    for n in _files(tmp_path / "fair_want"):
        assert (tmp_path / "fair_got" / n).read_bytes() == (tmp_path / "fair_want" / n).read_bytes()
    a = conv.dota_to_fair1m_1_5(txt, str(tmp_path / "c_got"), str(images), "x")
    b = jconv.dota_to_fair1m_1_5(txt, str(tmp_path / "c_want"), str(images), "x")
    assert open(a, "rb").read() == open(b, "rb").read()


def _config_pointing_at(tmp_path, committed, body):
    cfg = tmp_path / "cfg.py"
    cfg.write_text(f"_base_ = [{os.path.join(ROOT, 'configs', committed)!r}]\n" + body)
    return str(cfg)


def test_preprocess_converts_the_ssdd_plus_config(tmp_path):
    img_dir, ann_dir = make_ssdd_tree(str(tmp_path / "ssdd_plus"), JPEGS, seed=5)
    got, want = str(tmp_path / "got"), str(tmp_path / "want")
    # the committed config inherits the DOTA base's tiling tasks, which
    # SSDD does not need (its converter resizes to 512): they are emptied
    cfg = _config_pointing_at(tmp_path, "s2anet_r50_fpn_1x_ssdd_plus.py", (
        "preprocess = dict(convert=dict(tasks=[\n"
        f"    dict(image_dir={img_dir!r}, label_dir={ann_dir!r}, out_dir={got!r})]),\n"
        "    tasks=[])\n"))
    preprocess.main(["--config-file", cfg])
    # the reference's steps (tools/preprocess.py:36-50) for type SSDD+, resize 512
    jconv.ssdd_to_dota(img_dir, ann_dir, want, resize=512, plus=True)
    jtiling.convert_to_pkl(want, os.path.join(want, "labels.pkl"), j_classes("SSDD+"),
                           trainval=True, filter_empty_gt=True)
    assert_same_trees(got, want)


def test_preprocess_converts_and_tiles_the_fair1m_config(tmp_path):
    src = str(tmp_path / "fair1m")
    make_fair_tree(src, TIFFS[:2], dataset_type="FAIR1M_1_5", seed=6)
    dota, tiles = str(tmp_path / "dota"), str(tmp_path / "tiles")
    cfg = _config_pointing_at(tmp_path, "s2anet_r50_fpn_1x_fair1m_1_5.py", (
        f"preprocess = dict(convert=dict(tasks=[dict(in_dir={src!r}, out_dir={dota!r})]),\n"
        f"    tasks=[dict(image_dir={dota + '/images'!r}, label_dir={dota + '/labelTxt'!r},\n"
        f"                out_dir={tiles!r})])\n"))
    preprocess.main(["--config-file", cfg])
    want_dota, want_tiles = str(tmp_path / "want_dota"), str(tmp_path / "want_tiles")
    jconv.fair_to_dota(src, want_dota)
    jtiling.process(want_dota + "/images", want_dota + "/labelTxt", want_tiles,
                    subsize=1024, gap=200, rates=(1.0,), thresh=0.7)
    jtiling.convert_to_pkl(want_tiles, os.path.join(want_tiles, "labels.pkl"),
                           j_classes("FAIR1M_1_5"), trainval=True, filter_empty_gt=True)
    assert_same_trees(dota, want_dota)
    assert_same_trees(tiles, want_tiles)


def test_merge_results_writes_the_fair1m_csv(tmp_path):
    classes = j_classes("FAIR1M_1_5")
    rng = np.random.default_rng(2)
    results = []
    for tile in ("P0001__1.0__0___0", "P0001__1.0__824___0", "P0002__1.0__0___0"):
        n = 12
        polys = rng.uniform(0, 1024, (n, 8)).astype(np.float32)
        results.append(({"polys": polys, "scores": rng.random(n).astype(np.float32),
                         "labels": rng.integers(0, len(classes), n),
                         "valid": rng.random(n) < 0.8}, {"filename": tile + ".png"}))
    pkl = tmp_path / "test_1.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(results, f)
    out = str(tmp_path / "got")
    merge_results.main(["--results", str(pkl), "--out-dir", out,
                        "--dataset-type", "FAIR1M_1_5", "--name", "fair1m"])
    # the reference tool (tools/merge_results.py:40-56)
    want = str(tmp_path / "want")
    jmerge.write_dota_submission(jmerge.merge_results(results, classes, iou_thr=0.1),
                                 classes, want)
    csv = jconv.finalize_submission(want, want, "fair1m", "FAIR1M_1_5")
    got = os.path.join(out, "fair1m.csv")
    assert open(got, "rb").read() == open(csv, "rb").read()
    assert os.path.getsize(got) > 0
