"""DOTA tiling and `python -m jdet_torch.tools.preprocess` against jdet_tpu's
tiler (`jdet_tpu/data/devkits/tiling.py`, cv2), on the CPU.

Two synthetic raw scenes (`data/synthetic.py::make_synthetic_raw_dota`:
2000 x 1500 with 40-80 rectangles, many cut by the windows, and
2100 x 900 with its objects in one corner, so that some windows hold
none; difficult flags 0, 1 and 2; DOTA's header lines) are tiled at
subsize 1024, gap 200 by both packages. Exact checks: the same tile
names, the same decoded pixels, labelTxt files equal byte for byte, the
same labels.pkl records, and every row of every port tile written with
the Sub filter, as cv2 writes them.
"""
import os
import pickle

import cv2
import numpy as np
import pytest

from jdet_tpu.config.constants import get_classes_by_name as j_get_classes_by_name
from jdet_tpu.data.devkits import tiling as jtiling
from jdet_torch.data import image_io
from jdet_torch.data.devkits import tiling
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
    img = np.zeros((64, 64, 3), np.uint8)
    poly = np.zeros((0, 8), np.float32)
    with pytest.raises(NotImplementedError, match="rate 0.5"):
        tiling.split_single_image(img, poly, [], [], "s", str(tmp_path), str(tmp_path),
                                  subsize=32, gap=8, rate=0.5)
    src = tmp_path / "src"
    src.mkdir()
    cv2.imwrite(str(src / "scene.jpg"), img)
    with pytest.raises(ValueError, match="scene.jpg"):
        tiling.process(str(src), None, str(tmp_path / "out"), subsize=32, gap=8)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("preprocess = dict(convert=dict(type='SSDD', tasks=[]), tasks=[])\n")
    with pytest.raises(NotImplementedError, match="SSDD"):
        preprocess.main(["--config-file", str(cfg)])
