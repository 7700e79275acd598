"""YOLO's data path against jdet_tpu and cv2 5.0, on the CPU, with cv2's
IPP off (`cv2.ipp.setUseIPP(False)`, the port's contract): pixel for
pixel and box for box.

- `letterbox`, `augment_hsv`, `get_rotation_matrix_2d`, `random_affine`
  equal to the reference's on the same seeds;
- `warp_affine` (the g++ library's) and `warp_affine_plain` (numpy) equal
  to `cv2.warpAffine` on float32 images of 1, 3 and 4 channels: rotations,
  scales, translations, constant borders, non-square canvases, a 1280²
  mosaic canvas;
- `YoloDataset`: whole collated batches (mosaic with the affine, HSV and
  flip; letterbox for eval; letterbox with augmentation) equal to the
  reference's, metas included, on a `make_yolo_tree` of the JPEG
  fixtures; the `labels.pkl` route with rotated boxes; `evaluate` equal;
- BMP: files cv2 reads (24-, 32- and 8-bit, bottom-up and top-down,
  palettes) decode to its pixels; others are refused by name.
"""
import os
import pickle

import cv2
import jax  # noqa: F401 -- tests/conftest.py pins JAX to the CPU first
import numpy as np
import pytest
import torch

from jdet_tpu.data import yolo as J
from jdet_torch.data import image_io
from jdet_torch.data import yolo as T
from jdet_torch.data.synthetic import make_yolo_tree
from make_codec_fixtures import OUT as FIXTURES
from make_codec_fixtures import smooth_image, write_bmp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def _ipp_off():
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    yield
    cv2.ipp.setUseIPP(was)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    jpegs = sorted(os.path.join(FIXTURES, n) for n in os.listdir(FIXTURES) if n.endswith(".jpg"))
    return make_yolo_tree(str(tmp_path_factory.mktemp("yolo")), jpegs, n_classes=10, seed=0)


def _image(h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.float32)


# the transforms -------------------------------------------------------------------

@pytest.mark.parametrize("size,scaleup", [(64, True), (128, True), (200, False), (200, True)])
def test_letterbox_matches_the_reference(size, scaleup):
    img = _image(97, 131)
    got, want = T.letterbox(img, size, scaleup=scaleup), J.letterbox(img, size, scaleup=scaleup)
    assert got[1:] == want[1:]
    np.testing.assert_array_equal(got[0], want[0])


def test_augment_hsv_matches_the_reference():
    img = _image(61, 90, 1)
    img[:5] = 255.0  # saturated rows
    img[5:9] = 0.0
    for seed in range(6):
        got = T.augment_hsv(img, np.random.default_rng(seed))
        want = J.augment_hsv(img, np.random.default_rng(seed))
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_rotation_matrix_matches_cv2():
    for center in ((30, 40), (1, 1), (0.5, 77), (640, 640)):
        for angle in (0, 13.3, -170, 90, 1e-3):
            for scale in (0.5, 1.0, 1.7):
                np.testing.assert_array_equal(T.get_rotation_matrix_2d(center, angle, scale),
                                              cv2.getRotationMatrix2D(center, angle, scale))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_warp_affine_matches_cv2(channels):
    rng = np.random.default_rng(channels)
    for case in range(25):
        H, W, h, w = (int(v) for v in rng.integers(1, 90, 4))
        img = rng.uniform(0, 255, (H, W, channels) if channels > 1 else (H, W)).astype(np.float32)
        M = cv2.getRotationMatrix2D((W / 2, H / 2), rng.uniform(-180, 180), rng.uniform(0.3, 2.5))
        M[:, 2] += rng.uniform(-20, 20, 2)
        fill = float(rng.choice([0.0, 114.0, 7.5]))
        want = cv2.warpAffine(img, M, (w, h), borderValue=(fill,) * 4)
        for fn in (T.warp_affine, T.warp_affine_plain):
            got = fn(img, M, (w, h), border_value=fill)
            assert got.shape == want.shape, (case, fn.__name__)
            np.testing.assert_array_equal(got, want, err_msg=f"case {case}, {fn.__name__}")


def test_warp_affine_on_a_mosaic_canvas_matches_cv2():
    canvas = np.full((1280, 1280, 3), 114.0, np.float32)
    canvas[200:1100, 100:900] = _image(900, 800, 2)
    M = T.get_rotation_matrix_2d((640, 640), 7.0, 1.31)
    M[:, 2] += (45.5, -63.0)
    np.testing.assert_array_equal(T.warp_affine(canvas, M, (1280, 1280), 114),
                                  cv2.warpAffine(canvas, M, (1280, 1280),
                                                 borderValue=(114, 114, 114)))


def test_random_affine_matches_the_reference():
    img = _image(97, 131, 3)
    boxes = np.array([[10, 10, 50, 40], [60, 20, 120, 90], [0, 0, 5, 5], [100, 80, 131, 97]],
                     np.float64)
    labels = np.arange(1, 5)
    for seed in range(4):
        for degrees in (0.0, 30.0):
            got = T.random_affine(img, boxes, labels, np.random.default_rng(seed), degrees=degrees)
            want = J.random_affine(img, boxes, labels, np.random.default_rng(seed),
                                   degrees=degrees)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


# the dataset ------------------------------------------------------------------------

SPLITS = {
    "mosaic": dict(img_size=128, augment=True, mosaic=True, degrees=10.0),
    "eval": dict(img_size=160, augment=False, mosaic=False),
    "letterbox_augmented": dict(img_size=96, augment=True, mosaic=False),
}


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_batches_match_the_reference(tree, split):
    img_dir, _ = tree
    kw = dict(images_dir=img_dir, batch_size=3, num_workers=0, max_gt=16, **SPLITS[split])
    ours, ref = T.YoloDataset(**kw), J.YoloDataset(**kw)
    assert [i["filename"] for i in ours.img_infos] == [i["filename"] for i in ref.img_infos]
    for work in ((np.array([0, 3, 5]), 0, 7), (np.array([1, 2, 6]), 1, 3)):
        (got, got_metas), (want, want_metas) = ours._load_batch(work), ref._load_batch(work)
        np.testing.assert_array_equal(got["images"], want["images"])
        assert got["targets"].keys() == want["targets"].keys()
        for k in want["targets"]:
            np.testing.assert_array_equal(got["targets"][k], want["targets"][k], err_msg=k)
        for g, w in zip(got_metas, want_metas):
            assert g.keys() == w.keys()
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert want["targets"]["gt_mask"].any()


def test_the_labels_pkl_route_matches_the_reference(tree, tmp_path):
    """Records with rotated (n, 5) boxes (their hull) and with hbbs."""
    img_dir, _ = tree
    rng = np.random.default_rng(3)
    infos = []
    for i, name in enumerate(sorted(os.listdir(img_dir))[:3]):
        n = 4
        if i == 1:
            boxes = np.stack([rng.uniform(50, 300, n), rng.uniform(50, 200, n),
                              rng.uniform(10, 60, n), rng.uniform(10, 60, n),
                              rng.uniform(-1.5, 1.5, n)], 1)
            ann = {"bboxes": boxes.astype(np.float32)}
        else:
            xy = rng.uniform(0, 200, (n, 2))
            ann = {"hboxes": np.concatenate([xy, xy + rng.uniform(5, 80, (n, 2))], 1)}
        ann["labels"] = rng.integers(1, 11, n)
        infos.append({"filename": name, "ann": ann})
    pkl = tmp_path / "labels.pkl"
    with open(pkl, "wb") as f:
        pickle.dump(infos, f)
    kw = dict(images_dir=img_dir, annotations_file=str(pkl), batch_size=3, num_workers=0,
              img_size=128)
    got, _ = T.YoloDataset(**kw)._load_batch((np.arange(3), 0, 1))
    want, _ = J.YoloDataset(**kw)._load_batch((np.arange(3), 0, 1))
    np.testing.assert_array_equal(got["images"], want["images"])
    for k in want["targets"]:
        np.testing.assert_array_equal(got["targets"][k], want["targets"][k], err_msg=k)


def test_evaluate_matches_the_reference(tree):
    img_dir, _ = tree
    kw = dict(images_dir=img_dir, batch_size=4, num_workers=0, img_size=160, augment=False,
              mosaic=False, drop_last=False)
    ours, ref = T.YoloDataset(**kw), J.YoloDataset(**kw)
    rng = np.random.default_rng(4)
    results = []
    for work in ((np.arange(4), 0, 0), (np.arange(4, 7), 0, 0)):
        _, metas = ours._load_batch(work)
        for meta in metas:
            n = 30
            # detections near the gts and elsewhere
            gts = np.asarray(meta["hboxes"]).reshape(-1, 4)
            boxes = rng.uniform(0, 160, (n, 4))
            boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 60, (n, 2))
            k = min(len(gts), n // 2)
            boxes[:k] = gts[:k] + rng.normal(0, 2, (k, 4))
            labels = rng.integers(0, 10, n)
            labels[:k] = np.asarray(meta["labels"])[:k] - 1
            results.append(({"boxes": boxes.astype(np.float32),
                             "scores": rng.uniform(0, 1, n).astype(np.float32),
                             "labels": labels, "valid": rng.uniform(0, 1, n) < 0.9}, meta))
    got, want = ours.evaluate(results), ref.evaluate(results)
    assert got == want and 0 < got["eval/coco_mAP50"] <= 1


def test_the_tree_has_empty_label_files_and_one_based_labels(tree):
    img_dir, lab_dir = tree
    sizes = [os.path.getsize(os.path.join(lab_dir, n)) for n in sorted(os.listdir(lab_dir))]
    assert len(sizes) == len(os.listdir(img_dir)) == 7
    assert [s == 0 for s in sizes] == [i % 5 == 4 for i in range(7)]
    ds = T.YoloDataset(images_dir=img_dir, num_workers=0, img_size=64)
    _, hb, labels = ds._load_raw(0)
    assert len(hb) == len(labels) > 0 and labels.min() >= 1
    assert len(ds._load_raw(4)[1]) == 0


# BMP ----------------------------------------------------------------------------------

@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("size", [(5, 7), (13, 1), (1, 13), (33, 18)])
def test_bmp_matches_cv2(tmp_path, size, top_down):
    rng = np.random.default_rng(size[0] * 100 + size[1])
    path = str(tmp_path / "a.bmp")
    palette = np.zeros((int(rng.integers(2, 257)), 4), np.uint8)
    palette[:, :3] = rng.integers(0, 256, (len(palette), 3))
    for args in ((smooth_image(*size, 1), 24), (smooth_image(*size, 2, 4), 32),
                 (rng.integers(0, 256, size), 8, palette)):
        write_bmp(path, args[0], args[1], top_down, *args[2:])
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(image_io.imread(path), want[..., ::-1])


def test_bmp_refusals_name_the_file(tmp_path):
    bitfields = str(tmp_path / "bgra_bitfields.bmp")
    assert cv2.imwrite(bitfields, smooth_image(9, 11, 3, 4))  # cv2 writes BI_BITFIELDS
    rle = str(tmp_path / "rle8.bmp")
    write_bmp(rle, np.zeros((4, 4), np.uint8), 8, palette=np.zeros((2, 4)), compression=1)
    truncated = str(tmp_path / "truncated.bmp")
    write_bmp(truncated, smooth_image(8, 8, 4), 24)
    with open(truncated, "r+b") as f:
        f.truncate(100)
    for path in (bitfields, rle, truncated):
        with pytest.raises(ValueError, match=os.path.basename(path)):
            image_io.imread(path)
