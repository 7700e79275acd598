"""DOTA tiling and `python -m jdet_torch.tools.preprocess` against jdet_tpu's
tiler (`jdet_tpu/data/devkits/tiling.py`, cv2), on the CPU.

At rate 1.0: two synthetic raw scenes (`data/synthetic.py::make_synthetic_raw_dota`:
2000 x 1500 with 40-80 rectangles, many cut by the windows, and
2100 x 900 with its objects in one corner, so that some windows hold
none; difficult flags 0, 1 and 2; DOTA's header lines) are tiled at
subsize 1024, gap 200 by both packages. Exact checks: the same tile
names, the same decoded pixels, labelTxt files equal byte for byte, the
same labels.pkl records, and every row of every port tile written with
the Sub filter, as cv2 writes them.

At rates 0.5 and 1.5 (the multi-scale configs' `rates=[0.5, 1.0, 1.5]`):
`resize_cubic` equal byte for byte to `cv2.resize(..., INTER_CUBIC)` on
odd sizes, OpenCV's own implementation: with Intel IPP on, which a cv2
built with IPP takes for INTER_CUBIC, IPP's float arithmetic differs by
1 in about 8% of the values at rate 1.5 (a difference of 1 at most is
asserted); the reference tiler (cv2, IPP off) and the port then give
equal tiles and label files, `preprocess` tiles at all three rates, and
the merge of `name__rate__left___up` tiles maps each tile's objects back
to the scene as the reference's merge does.
"""
import contextlib
import os
import pickle

import cv2
import numpy as np
import pytest

from jdet_tpu.config.constants import get_classes_by_name as j_get_classes_by_name
from jdet_tpu.data.devkits import result_merge as jmerge
from jdet_tpu.data.devkits import tiling as jtiling
from jdet_torch.data import image_io
from jdet_torch.data.devkits import result_merge, tiling
from jdet_torch.data.synthetic import make_synthetic_raw_dota
from jdet_torch.tools import preprocess


@pytest.fixture(scope="module")
def tiled(tmp_path_factory):
    root = tmp_path_factory.mktemp("tiling")
    img_dir, label_dir = make_synthetic_raw_dota(str(root / "raw"))
    want = root / "reference"
    jtiling.process(img_dir, label_dir, str(want / "trainval"), subsize=1024, gap=200)
    jtiling.convert_to_pkl(str(want / "trainval"), str(want / "trainval" / "labels.pkl"),
                           j_get_classes_by_name("DOTA"))
    jtiling.process(img_dir, None, str(want / "test"), subsize=1024, gap=200)
    got = root / "port"
    cfg = root / "preprocess_cfg.py"
    cfg.write_text(
        "preprocess = dict(\n"
        "    dataset_type='DOTA', subsize=1024, gap=200, rates=[1.0],\n"
        f"    tasks=[dict(image_dir={img_dir!r}, label_dir={label_dir!r},\n"
        f"                out_dir={str(got / 'trainval')!r}),\n"
        f"           dict(image_dir={img_dir!r}, label_dir=None,\n"
        f"                out_dir={str(got / 'test')!r})],\n"
        ")\n")
    os.makedirs(got / "trainval" / "images")
    (got / "trainval" / "images" / "stale__1.0__0___0.png").write_bytes(b"old")
    written = preprocess.main(["--config-file", str(cfg), "--clear"])
    return root, want, got, written


def test_tiles_labels_and_pkl_match_the_reference(tiled):
    root, want, got, written = tiled
    for task in ("trainval", "test"):
        names = sorted(os.listdir(want / task / "images"))
        assert sorted(os.listdir(got / task / "images")) == names
        assert len(names) == 6 + 3  # 3 x 2 windows of the first scene, 3 x 1 of the second
        for name in names:
            ref_file, port_file = str(want / task / "images" / name), str(got / task / "images" / name)
            tile = image_io.imread(port_file)
            # both files hold the source's channel order
            np.testing.assert_array_equal(tile, image_io.imread(ref_file), err_msg=name)
            np.testing.assert_array_equal(tile, cv2.imread(port_file, cv2.IMREAD_COLOR)[..., ::-1])
            assert (image_io.png_row_filters(port_file) == 1).all(), name
            assert image_io.png_size(port_file) == (1024, 1024)
    assert sorted(written[0]) == sorted(os.path.splitext(n)[0] for n in names)

    labels = sorted(os.listdir(want / "trainval" / "labelTxt"))
    assert sorted(os.listdir(got / "trainval" / "labelTxt")) == labels
    diffs, empty = set(), 0
    for name in labels:
        text = (want / "trainval" / "labelTxt" / name).read_bytes()
        assert (got / "trainval" / "labelTxt" / name).read_bytes() == text, name
        diffs |= {line.split()[-1] for line in text.decode().splitlines()}
        empty += not text
    assert diffs == {"0", "1", "2"} and empty >= 2

    with open(want / "trainval" / "labels.pkl", "rb") as f:
        ref_records = pickle.load(f)
    with open(got / "trainval" / "labels.pkl", "rb") as f:
        records = pickle.load(f)
    assert [r["filename"] for r in records] == [r["filename"] for r in ref_records]
    assert 0 < len(records) < len(labels)  # tiles with no gt are filtered out
    for r, w in zip(records, ref_records):
        assert (r["height"], r["width"]) == (w["height"], w["width"]) == (1024, 1024)
        for k, v in w["ann"].items():
            assert r["ann"][k].dtype == v.dtype, k
            np.testing.assert_array_equal(r["ann"][k], v, err_msg=f"{r['filename']} {k}")
    assert not (got / "test" / "labels.pkl").exists()


def test_what_the_tiler_refuses(tmp_path):
    img = np.zeros((64, 64, 4), np.uint8)
    src = tmp_path / "src"
    src.mkdir()
    # cv2 writes 4 channels as a BI_BITFIELDS BMP, which the port refuses
    cv2.imwrite(str(src / "scene.bmp"), img)
    with pytest.raises(ValueError, match="scene.bmp"):
        tiling.process(str(src), None, str(tmp_path / "out"), subsize=32, gap=8)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("preprocess = dict(convert=dict(type='VOC', tasks=[]), tasks=[])\n")
    with pytest.raises(ValueError, match="VOC"):
        preprocess.main(["--config-file", str(cfg)])


# other rates -----------------------------------------------------------------------

@contextlib.contextmanager
def _opencv_without_ipp():
    """cv2's own INTER_CUBIC (the one without Intel IPP) for the block."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        yield
    finally:
        cv2.ipp.setUseIPP(was)


@pytest.mark.parametrize("rate", [0.5, 0.75, 1.5, 2.0])
def test_resize_cubic_matches_opencv(rate):
    rng = np.random.RandomState(0)
    for img in (rng.randint(0, 256, (301, 517, 3), dtype=np.uint8),
                rng.randint(0, 256, (33, 47), dtype=np.uint8)):
        got = tiling.resize_cubic(img, rate)
        with _opencv_without_ipp():
            want = cv2.resize(img, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        with_ipp = cv2.resize(img, None, fx=rate, fy=rate, interpolation=cv2.INTER_CUBIC)
        assert np.abs(got.astype(int) - with_ipp).max() <= 1


@pytest.fixture(scope="module")
def multi_rate(tmp_path_factory):
    """The second synthetic scene tiled by both packages at rates 0.5 and
    1.5 (the reference without IPP), and by `preprocess` at the three
    rates of the multi-scale configs."""
    root = tmp_path_factory.mktemp("rates")
    img_dir, label_dir = make_synthetic_raw_dota(str(root / "raw"), sizes=((2100, 900),),
                                                 corner_only=(False,), seed=3)
    name = "scene_0000"
    img = image_io.imread(os.path.join(img_dir, name + ".png"))
    polys, names, diffs = tiling.parse_dota_label(os.path.join(label_dir, name + ".txt"))
    out = {}
    for rate in (0.5, 1.5):
        # the reference reads and writes BGR through cv2
        for side, mod, scene in (("reference", jtiling, img[..., ::-1]), ("port", tiling, img)):
            d = root / f"{side}_{rate}"
            with _opencv_without_ipp():
                out[side, rate] = (d, mod.split_single_image(
                    scene, polys, names, diffs, name, str(d / "images"), str(d / "labelTxt"),
                    subsize=1024, gap=200, rate=rate))
    cfg = root / "ms_cfg.py"
    cfg.write_text(
        "preprocess = dict(\n"
        "    dataset_type='DOTA', subsize=1024, gap=200, rates=[0.5, 1.0, 1.5],\n"
        f"    tasks=[dict(image_dir={img_dir!r}, label_dir={label_dir!r},\n"
        f"                out_dir={str(root / 'ms')!r})],\n"
        ")\n")
    ms = preprocess.main(["--config-file", str(cfg)])
    return root, name, (polys, names), out, ms


@pytest.mark.parametrize("rate", [0.5, 1.5])
def test_tiles_at_other_rates_match_the_reference(multi_rate, rate):
    _, _, _, out, _ = multi_rate
    (want_dir, want_names), (got_dir, got_names) = out["reference", rate], out["port", rate]
    assert got_names == want_names and all(f"__{rate}__" in n for n in got_names)
    assert len(got_names) == {0.5: 2, 1.5: 8}[rate]
    for n in got_names:
        got = image_io.imread(str(got_dir / "images" / (n + ".png")))
        np.testing.assert_array_equal(got, image_io.imread(str(want_dir / "images" / (n + ".png"))),
                                      err_msg=n)
        assert ((got_dir / "labelTxt" / (n + ".txt")).read_bytes()
                == (want_dir / "labelTxt" / (n + ".txt")).read_bytes()), n


def test_multi_rate_preprocess_and_merge(multi_rate):
    root, name, (polys, names), out, ms = multi_rate
    tiles = sorted(ms[0])
    for rate in (0.5, 1.0, 1.5):
        assert any(f"__{rate}__" in n for n in tiles), rate
    assert sorted(os.listdir(root / "ms" / "images")) == sorted(n + ".png" for n in tiles)
    # each tile's objects, as detections at tile coordinates, merge back
    # to the scene as the reference's merge merges them
    classes = j_get_classes_by_name("DOTA")
    results, back = [], []
    for n in tiles:
        tp, tn, _ = tiling.parse_dota_label(str(root / "ms" / "labelTxt" / (n + ".txt")))
        det = {"polys": tp, "scores": np.linspace(1.0, 0.5, len(tp), dtype=np.float32),
               "labels": np.array([classes.index(c) for c in tn]), "valid": np.ones(len(tp), bool)}
        results.append((det, {"filename": n + ".png"}))
        orig, rate, left, up = result_merge.parse_tile_name(n)
        assert orig == name and f"__{rate}__{left}___{up}" in n
        if rate == 0.5:
            back.append(result_merge.tile_to_original(tp, rate, left, up))
    got = result_merge.merge_results(results, classes)
    want = jmerge.merge_results(results, classes)
    assert sorted(got) == sorted(want) == [name]
    assert sorted(got[name]) == sorted(want[name])
    for c in want[name]:
        np.testing.assert_array_equal(got[name][c], want[name][c], err_msg=c)
    # at rate 0.5 the scene (1050 x 450) lies in two overlapping windows:
    # each quad inside it comes back from a tile within rounding
    back = np.concatenate(back)
    inside = (polys[:, 0::2].min(1) >= 0) & (polys[:, 0::2].max(1) <= 2100) & (
        polys[:, 1::2].min(1) >= 0) & (polys[:, 1::2].max(1) <= 900)
    assert inside.sum() > 20
    for poly in polys[inside]:
        assert np.abs(back - poly).max(1).min() < 1e-3
