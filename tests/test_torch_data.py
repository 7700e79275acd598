"""The data pipeline of jdet_torch against jdet_tpu, on the CPU.

- PNG reader: exact against `cv2.imread(IMREAD_COLOR)[..., ::-1]` on files
  written by cv2 and PIL (RGB, gray, palette, RGBA, gray+alpha, 16-bit,
  1-bit) and by the port's writer with each of the five row filters; the
  unfilter exact against a per-byte loop.
- Transforms: boxes within 1e-5 of the JAX transforms; images exact,
  after a real resize too (`resize_linear` is cv2's fixed point). SSD's
  augmentations (`PhotoMetricDistortion`, `Expand`, `MinIoURandomCrop`
  and the config's whole train stack) exact, with the same number of
  draws from one seed; `resize_linear` and the uint8 HSV conversions
  exact against cv2.
- Datasets: the same planned order, gts, metas and uint8 images as the
  reference's, with and without the tile cache and spawned workers.
"""
import os
import pickle

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

import jdet_tpu.data.transforms as jt
from jdet_tpu.data.dota import DOTADataset as JDOTADataset
from jdet_tpu.data.dota import ImageDataset as JImageDataset
from jdet_torch.config import load_cfg_file
from jdet_torch.data import image_io
from jdet_torch.data import transforms as tt
from jdet_torch.data.dota import DOTADataset, ImageDataset
from jdet_torch.data.synthetic import make_synthetic_dota


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: torch's thread pool made the plain versions'
    many small ops tens of times slower here than one thread (77 s against
    0.34 s for four of the early-out cases of test_torch_iou_kernel.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _content(h, w, seed=0):
    """Noise, a flat block and gradients, so that an adaptive encoder
    picks several row filters."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.zeros((h, w, 3), np.uint8)
    img[..., 0] = xx * 255 // (w - 1)
    img[..., 1] = (yy * 3 + xx) % 256
    img[: h // 2, : w // 3, 2] = rng.integers(0, 256, (h // 2, w // 3))
    img[h // 2:, w // 2:] = 77
    img[h // 3: h // 2] = rng.integers(0, 256, (h // 2 - h // 3, w, 3))
    return img


def _unfilter_loop(ftypes, filtered, bpp):
    """PNG unfiltering as the specification writes it, one byte at a time."""
    h, s = filtered.shape
    out = np.zeros((h, s), np.int64)
    for y in range(h):
        for i in range(s):
            a = out[y, i - bpp] if i >= bpp else 0
            b = out[y - 1, i] if y else 0
            c = out[y - 1, i - bpp] if y and i >= bpp else 0
            t = ftypes[y]
            if t == 0:
                pred = 0
            elif t == 1:
                pred = a
            elif t == 2:
                pred = b
            elif t == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[y, i] = (int(filtered[y, i]) + pred) % 256
    return out.astype(np.uint8)


@pytest.mark.parametrize("bpp", [1, 3, 4, 6])
def test_unfilter_matches_the_specification(bpp):
    rng = np.random.default_rng(bpp)
    ftypes = np.concatenate([np.arange(5), rng.integers(0, 5, 12), [0, 1, 2, 1, 0]])
    filtered = rng.integers(0, 256, (len(ftypes), 7 * bpp)).astype(np.uint8)
    np.testing.assert_array_equal(image_io.unfilter(ftypes, filtered, bpp),
                                  _unfilter_loop(ftypes, filtered, bpp))


def _pil_image(mode, img):
    if mode == "P":
        return Image.fromarray(img).quantize(64)
    if mode == "I;16":
        wide = img[..., 0].astype(np.uint16) * 257 + np.arange(img.shape[1], dtype=np.uint16)
        return Image.fromarray(wide)
    return Image.fromarray(img).convert(mode)


def test_png_reader_matches_cv2_on_cv2_and_pil_files(tmp_path):
    img = _content(67, 91)
    files = {}
    cv2.imwrite(str(tmp_path / "cv2_rgb.png"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "cv2_gray.png"), img[..., 1])
    cv2.imwrite(str(tmp_path / "cv2_rgba.png"),
                np.dstack([img[..., ::-1], img[..., 0]]))
    cv2.imwrite(str(tmp_path / "cv2_rgb16.png"),
                img[..., ::-1].astype(np.uint16) * 251)
    files.update({p.stem: str(p) for p in tmp_path.glob("cv2_*.png")})
    for mode in ("RGB", "L", "P", "RGBA", "LA", "1", "I;16"):
        p = str(tmp_path / f"pil_{mode.replace(';', '')}.png")
        _pil_image(mode, img).save(p)
        files[f"pil_{mode}"] = p
    seen = {}
    for name, path in sorted(files.items()):
        want = cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]
        got = image_io.imread(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, want, err_msg=name)
        seen[name] = sorted(set(image_io.png_row_filters(path).tolist()))
    print("row filters in the cv2 and PIL files:", seen)
    types = set().union(*seen.values())
    assert {1, 2, 4} <= types, seen


@pytest.mark.parametrize("ftype", range(5))
def test_png_writer_round_trips_each_filter(tmp_path, ftype):
    """The port's writer covers the filters the cv2 and PIL files lack
    (None and Average): reader and cv2 both read back the exact pixels."""
    img = _content(53, 70, seed=ftype)
    for name, arr in (("rgb", img), ("gray", img[..., 0])):
        path = str(tmp_path / f"{name}.png")
        image_io.imwrite(path, arr, filter_type=ftype)
        assert set(image_io.png_row_filters(path).tolist()) == {ftype}
        want = arr if arr.ndim == 3 else np.repeat(arr[..., None], 3, 2)
        np.testing.assert_array_equal(image_io.imread(path), want)
        np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1], want)


def test_png_writer_mixed_filters_and_reader_errors(tmp_path):
    img = _content(40, 33, seed=5)
    ftypes = np.random.default_rng(0).integers(0, 5, 40)
    path = str(tmp_path / "mixed.png")
    image_io.imwrite(path, img, filter_type=ftypes)
    np.testing.assert_array_equal(image_io.png_row_filters(path), ftypes)
    np.testing.assert_array_equal(image_io.imread(path), img)
    # an interlaced header: the reader refuses it and names the file
    data = bytearray(open(path, "rb").read())
    data[28] = 1
    data[29:33] = __import__("zlib").crc32(bytes(data[12:29])).to_bytes(4, "big")
    bad = tmp_path / "interlaced.png"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="interlaced.png.*interlaced"):
        image_io.imread(str(bad))
    data[20] ^= 1  # a corrupt IHDR
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="corrupt"):
        image_io.imread(str(bad))
    # a JPEG and a BMP go to the port's decoders (tests/test_torch_codecs.py
    # and tests/test_torch_yolo_data.py hold them to cv2); an extension the
    # port cannot read is refused by name
    for ext in ("jpg", "bmp"):
        cv2.imwrite(str(tmp_path / f"t.{ext}"), img)
        np.testing.assert_array_equal(image_io.imread(str(tmp_path / f"t.{ext}")),
                                      cv2.imread(str(tmp_path / f"t.{ext}"))[..., ::-1])
    cv2.imwrite(str(tmp_path / "t.ppm"), img)
    with pytest.raises(ValueError, match="t.ppm"):
        image_io.imread(str(tmp_path / "t.ppm"))
    np.save(tmp_path / "t.npy", img)
    np.testing.assert_array_equal(image_io.imread(str(tmp_path / "t.npy")), img)


# transforms --------------------------------------------------------------

def _target(rng, w, h, n=7):
    rb = np.stack([rng.uniform(40, w - 40, n), rng.uniform(40, h - 40, n),
                   rng.uniform(20, 80, n), rng.uniform(8, 20, n),
                   rng.uniform(-np.pi / 4, 3 * np.pi / 4, n)], 1).astype(np.float32)
    polys = tt.rbox_to_poly_np(rb)
    return {
        "rboxes": rb, "polys": polys, "labels": np.arange(1, n + 1, dtype=np.int32),
        "rboxes_ignore": rb[:2].copy(), "polys_ignore": polys[:2].copy(),
        "hboxes": np.stack([polys[:, 0::2].min(1), polys[:, 1::2].min(1),
                            polys[:, 0::2].max(1), polys[:, 1::2].max(1)], 1),
        "img_size": (w, h), "scale_factor": 1.0,
    }


def _copy(target):
    return {k: (v.copy() if isinstance(v, np.ndarray) else v) for k, v in target.items()}


PIPELINES = {
    "unit_resize": ([dict(type="RotatedResize", min_size=600, max_size=1024)], (800, 600)),
    "real_resize": ([dict(type="RotatedResize", min_size=768, max_size=1024)], (800, 600)),
    "multiscale": ([dict(type="Resize", min_size=[480, 600, 720], max_size=1333)], (800, 600)),
    "flips": ([dict(type="RotatedRandomFlip", prob=1.0),
               dict(type="RotatedRandomFlip", prob=1.0, direction="vertical"),
               dict(type="RandomFlip", prob=0.5)], (320, 200)),
    "rotate": ([dict(type="RandomRotateAug", rotate_ratio=1.0)], (256, 256)),
    "pad_normalize": ([dict(type="Pad", size_divisor=32),
                       dict(type="Normalize", mean=[123.675, 116.28, 103.53],
                            std=[58.395, 57.12, 57.375], to_bgr=True)], (300, 210)),
}


@pytest.mark.parametrize("name", sorted(PIPELINES))
def test_transforms_match_the_reference(name):
    cfg, (w, h) = PIPELINES[name]
    mine, ref = tt.Compose(cfg), jt.Compose(cfg)
    for seed in range(4):
        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        target = _target(rng, w, h)
        got_img, got = mine(img.copy(), _copy(target), rng=np.random.default_rng(seed + 10))
        want_img, want = ref(img.copy(), _copy(target), rng=np.random.default_rng(seed + 10))
        assert got_img.shape == want_img.shape and got_img.dtype == want_img.dtype
        if name == "pad_normalize":
            np.testing.assert_allclose(got_img, want_img, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got_img, want_img)
        assert got.keys() == want.keys()
        for k, v in want.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-5, err_msg=k)
            else:
                assert got[k] == v, k
    if name == "real_resize":
        assert got_img.shape == (768, 1024, 3)


# SSD's augmentations ----------------------------------------------------------

class _CountingRng:
    """A `np.random.Generator` that counts the values it draws."""

    def __init__(self, seed):
        self.rng, self.draws = np.random.default_rng(seed), 0

    def __getattr__(self, name):
        fn = getattr(self.rng, name)

        def draw(*a, **kw):
            out = fn(*a, **kw)
            self.draws += int(np.size(out))
            return out
        return draw


SSD_TRAIN = load_cfg_file(os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs", "ssd300_coco.py"))["dataset"]["train"]["transforms"]


@pytest.mark.parametrize("part", ["PhotoMetricDistortion", "Expand", "MinIoURandomCrop",
                                  "train_pipeline"])
def test_ssd_transforms_match_the_reference(part):
    """SSD's train stack (`configs/ssd300_coco.py`) and each of its random
    transforms: the same draws from one seed (counted), images and boxes
    equal. cv2's float INTER_LINEAR, which the stack's `Resize` runs on the
    float images of `PhotoMetricDistortion`, is held with IPP off: with IPP
    on (cv2's default) IPP's float resize differs by up to ~0.007."""
    cfg = SSD_TRAIN if part == "train_pipeline" else [
        t for t in SSD_TRAIN if t["type"] == part]
    mine, ref = tt.Compose(cfg), jt.Compose(cfg)
    use_ipp = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        for seed in range(24):
            rng = np.random.default_rng(seed)
            w, h = (int(v) for v in rng.integers(160, 420, 2))
            img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            target = _target(rng, w, h)
            a, b = _CountingRng(seed + 100), _CountingRng(seed + 100)
            got_img, got = mine(img.copy(), _copy(target), rng=a)
            want_img, want = ref(img.copy(), _copy(target), rng=b)
            assert a.draws == b.draws > 0
            assert got_img.dtype == want_img.dtype
            np.testing.assert_array_equal(got_img, want_img)
            assert got.keys() == want.keys()
            for k, v in want.items():
                if isinstance(v, np.ndarray):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    assert got[k] == v, k
    finally:
        cv2.ipp.setUseIPP(use_ipp)


@pytest.mark.parametrize("width", [300, 64, 17])
def test_hsv_round_trip_matches_cv2(width):
    """`rgb_to_hsv_u8` and `hsv_to_rgb_u8` (hue 0..179) against
    cv2.cvtColor on rows of `width` pixels: cv2 runs a row's first multiple
    of 32 pixels in vector code and the rest in scalar code. At width 300
    every uint8 RGB and every HSV, at the others 300,000 drawn ones."""
    rgb = np.stack(np.meshgrid(np.arange(256), np.arange(256), np.arange(256),
                               indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    hsv = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                               indexing="ij"), -1).reshape(-1, 3).astype(np.uint8)
    if width != 300:
        rng = np.random.default_rng(width)
        rgb, hsv = (a[rng.integers(0, len(a), 300_000)] for a in (rgb, hsv))
    rgb = rgb[:len(rgb) // width * width].reshape(-1, width, 3)
    hsv = hsv[:len(hsv) // width * width].reshape(-1, width, 3)
    np.testing.assert_array_equal(tt.rgb_to_hsv_u8(rgb), cv2.cvtColor(rgb, cv2.COLOR_RGB2HSV))
    np.testing.assert_array_equal(tt.hsv_to_rgb_u8(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_resize_linear_matches_cv2(channels):
    """uint8 with IPP on and off (the same bytes), and float32 with IPP off,
    on random sizes, exact 2x reductions (INTER_AREA's mean) included."""
    rng = np.random.default_rng(channels)
    use_ipp = cv2.ipp.useIPP()
    try:
        for i in range(40):
            h, w = (int(v) for v in rng.integers(1, 160, 2))
            nh, nw = ((max(h // 2, 1), max(w // 2, 1)) if i % 5 == 0
                      else tuple(int(v) for v in rng.integers(1, 330, 2)))
            shape = (h, w, channels) if channels > 1 else (h, w)
            img = rng.integers(0, 256, shape).astype(np.uint8)
            for ipp in (True, False):
                cv2.ipp.setUseIPP(ipp)
                np.testing.assert_array_equal(
                    tt.resize_linear(img, (nw, nh)),
                    cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR))
            f = img.astype(np.float32) * np.float32(1.37) + np.float32(0.123)
            np.testing.assert_array_equal(
                tt.resize_linear(f, (nw, nh)),
                cv2.resize(f, (nw, nh), interpolation=cv2.INTER_LINEAR))
    finally:
        cv2.ipp.setUseIPP(use_ipp)


# datasets ----------------------------------------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A mini DOTA tree of 7 tiles at 128², one of them without gts."""
    root = str(tmp_path_factory.mktemp("mini_dota"))
    img_dir, ann = make_synthetic_dota(root, n_images=7, size=128, n_obj=(2, 6), seed=3)
    with open(ann, "rb") as f:
        infos = pickle.load(f)
    infos[4]["ann"]["bboxes"] = np.zeros((0, 5), np.float32)
    infos[4]["ann"]["labels"] = np.zeros((0,), np.int32)
    with open(ann, "wb") as f:
        pickle.dump(infos, f)
    return img_dir, ann


def _ds_cfg(tree, **kw):
    img_dir, ann = tree
    return dict(annotations_file=ann, images_dir=img_dir, image_size=(128, 128), max_gt=8,
                transforms=[dict(type="RotatedResize", min_size=128, max_size=128),
                            dict(type="RotatedRandomFlip", prob=0.5)],
                batch_size=2, shuffle=True, image_dtype="uint8", num_workers=0, **kw)


def _assert_batches_equal(got, want):
    (gb, gm), (wb, wm) = got, want
    np.testing.assert_array_equal(gb["images"].numpy(), wb["images"])
    assert gb["images"].dtype == torch.uint8
    for k, v in wb["targets"].items():
        np.testing.assert_array_equal(gb["targets"][k].numpy(), v, err_msg=k)
    assert len(gm) == len(wm)
    for g, w in zip(gm, wm):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(g[k], v, err_msg=k)
            else:
                assert g[k] == v, k


@pytest.mark.parametrize("balance", [False, True])
def test_dataset_batches_match_the_reference(tree, balance):
    mine = DOTADataset(**_ds_cfg(tree, balance_category=balance))
    ref = JDOTADataset(**_ds_cfg(tree, balance_category=balance))
    assert [a["filename"] for a in mine.img_infos] == [a["filename"] for a in ref.img_infos]
    assert len(mine) == (6 if not balance else len(ref)) and mine.num_batches == ref.num_batches
    for epoch in (0, 1):
        plan = mine._plan_batches(epoch, seed=5)
        want_plan = ref._plan_batches(epoch, seed=5)
        assert [b.tolist() for b in plan] == [b.tolist() for b in want_plan]
        got, want = list(mine.batches(epoch=epoch, seed=5)), list(ref.batches(epoch=epoch, seed=5))
        assert len(got) == len(want) == mine.num_batches
        for g, w in zip(got, want):
            _assert_batches_equal(g, w)


def test_tile_cache_and_spawned_workers_keep_the_batches(tree, tmp_path):
    """Epoch 1 reads the tiles epoch 0 cached; two spawned workers give the
    batches of the main process, in order."""
    img_dir, ann = tree
    local_ann = str(tmp_path / "labels.pkl")
    os.symlink(ann, local_ann)
    cfg = dict(_ds_cfg(tree), annotations_file=local_ann)
    mine = DOTADataset(**dict(cfg, image_cache="auto", num_workers=2))
    ref = JDOTADataset(**_ds_cfg(tree))
    try:
        for epoch in (0, 1):
            got, want = list(mine.batches(epoch=epoch)), list(ref.batches(epoch=epoch))
            for g, w in zip(got, want):
                _assert_batches_equal(g, w)
            if epoch == 0:
                assert mine._cache_valid.sum() == 2 * len(got)
    finally:
        mine.close()
    assert mine.image_cache_path.startswith(local_ann) and os.path.exists(mine.image_cache_path)
    # val of the same pkl keeps the empty tile, so its cache is another file
    val = DOTADataset(**dict(cfg, image_cache="auto", filter_empty_gt=False))
    assert val.image_cache_path != mine.image_cache_path


def test_image_dataset_matches_the_reference(tree):
    img_dir, _ = tree
    kw = dict(images_dir=img_dir, image_size=(128, 128), batch_size=3, drop_last=False,
              image_dtype="uint8", num_workers=0,
              transforms=[dict(type="RotatedResize", min_size=128, max_size=128)])
    mine, ref = ImageDataset(**kw), JImageDataset(**kw)
    assert mine.CLASSES == ref.CLASSES and len(mine) == len(ref) == 7
    got, want = list(mine.batches()), list(ref.batches())
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    with pytest.raises(NotImplementedError, match="one card"):
        ImageDataset(**kw, shard_by_process=True)
