"""The port's JPEG and TIFF decoders against cv2, on the CPU.

`jdet_torch/data/jpeg.py` and `tiff.py` (on `csrc/image_codecs.cpp`) must
give `cv2.imread(path, IMREAD_COLOR)[..., ::-1]` pixel for pixel:

- JPEG, written by cv2 (libjpeg-turbo) at every sampling factor it offers
  (4:1:1, 4:2:0, 4:2:2, 4:4:0, 4:4:4), baseline and progressive,
  qualities 10-100, with and without a restart interval, on odd sizes
  down to 1x1 and 3x2 (the upsamplers' edge columns, and the plain
  replication for chroma at most 2 samples wide), gray, RGB (components
  'R', 'G', 'B' or an Adobe marker with transform 0), and with an EXIF
  orientation 1-8 spliced in (both byte orders);
- TIFF, written by cv2 (libtiff) with no compression, LZW, Deflate and
  PackBits, with and without the horizontal predictor and with several
  strips, at 8 and 16 bits, gray, RGB and RGBA; and by the test writer
  (`make_codec_fixtures.write_tiff`) tiled, planar (2), big-endian,
  palette (8- and 16-bit maps) and with unassociated alpha, which libtiff
  premultiplies.

Refused files raise an error that names the file and the reason. The
fixtures of `tests/data/torch_codecs/` decode to the digests that
`tests/make_codec_fixtures.py` took from cv2: those tests need neither
cv2 nor JAX and run on a machine without them
(`python -m pytest --noconftest tests/test_torch_codecs.py`), where the
cv2 comparisons skip.
"""
import hashlib
import json
import os
import struct

import numpy as np
import pytest
import torch

from jdet_torch.data import image_io
from jdet_torch.data.jpeg import read_jpeg
from jdet_torch.data.tiff import read_tiff
from make_codec_fixtures import DIGESTS, OUT, add_exif_orientation, smooth_image, write_tiff

try:
    import cv2
except ImportError:  # the GPU machine: the fixture digests stand in for cv2
    cv2 = None

needs_cv2 = pytest.mark.skipif(cv2 is None, reason="cv2 is the oracle of this test")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cv2_rgb(path):
    image = cv2.imread(str(path), cv2.IMREAD_COLOR)
    assert image is not None, path
    return image[..., ::-1]


def _assert_same(got, want, what):
    assert got.shape == want.shape and got.dtype == np.uint8, (what, got.shape, want.shape)
    if not np.array_equal(got, want):
        diff = np.abs(got.astype(int) - want.astype(int))
        raise AssertionError(f"{what}: {(diff > 0).sum()} values differ, up to {diff.max()}")


# the fixtures ------------------------------------------------------------------------

with open(DIGESTS) as f:
    FIXTURES = json.load(f)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_decodes_to_its_cv2_digest(name):
    image = image_io.imread(os.path.join(OUT, name))
    assert list(image.shape) == FIXTURES[name]["shape"]
    assert hashlib.sha256(np.ascontiguousarray(image).tobytes()).hexdigest() == \
        FIXTURES[name]["sha256"]


def test_fixtures_fit_their_budget():
    assert sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT)) <= 400_000


# JPEG ---------------------------------------------------------------------------------

SAMPLINGS = ("411", "420", "422", "440", "444")
SIZES = ((217, 333), (1, 1), (3, 2), (17, 9), (16, 33), (480, 64))


@needs_cv2
@pytest.mark.parametrize("progressive", [0, 1])
@pytest.mark.parametrize("sampling", SAMPLINGS)
def test_jpeg_matches_cv2(tmp_path, sampling, progressive):
    factor = getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{sampling}")
    for i, (h, w) in enumerate(SIZES):
        for quality, rst in ((10, 0), (50, 2), (75, 0), (93, 7), (100, 0)):
            path = tmp_path / f"{h}x{w}_{quality}.jpg"
            cv2.imwrite(str(path), smooth_image(h, w, i * 7 + quality), [
                cv2.IMWRITE_JPEG_QUALITY, quality, cv2.IMWRITE_JPEG_PROGRESSIVE, progressive,
                cv2.IMWRITE_JPEG_RST_INTERVAL, rst, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, factor])
            _assert_same(read_jpeg(str(path)), _cv2_rgb(path), path.name)


@needs_cv2
@pytest.mark.parametrize("progressive", [0, 1])
def test_gray_jpeg_matches_cv2(tmp_path, progressive):
    for i, (h, w) in enumerate(SIZES):
        path = tmp_path / f"{h}x{w}.jpeg"
        cv2.imwrite(str(path), smooth_image(h, w, i, channels=1)[..., 0],
                    [cv2.IMWRITE_JPEG_PROGRESSIVE, progressive, cv2.IMWRITE_JPEG_QUALITY, 60])
        got = image_io.imread(str(path))
        _assert_same(got, _cv2_rgb(path), path.name)
        assert (got == got[..., :1]).all()


def _exif_le_or_be(jpeg, orientation, order):
    if order == "<":
        return add_exif_orientation(jpeg, orientation)
    tiff = (b"MM" + struct.pack(">HI", 42, 8) + struct.pack(">H", 1)
            + struct.pack(">HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack(">I", 0))
    payload = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + jpeg[2:]


@needs_cv2
@pytest.mark.parametrize("order", ["<", ">"])
def test_jpeg_exif_orientation_matches_cv2(tmp_path, order):
    ok, buf = cv2.imencode(".jpg", smooth_image(37, 53, 1))
    assert ok
    for orientation in range(0, 10):
        path = tmp_path / f"o{orientation}.jpg"
        path.write_bytes(_exif_le_or_be(buf.tobytes(), orientation, order))
        got = read_jpeg(str(path))
        _assert_same(got, _cv2_rgb(path), path.name)
        assert got.shape[:2] == ((53, 37) if 5 <= orientation <= 8 else (37, 53))


@needs_cv2
@pytest.mark.parametrize("adobe", [False, True])
def test_rgb_jpeg_matches_cv2(tmp_path, adobe):
    """A 3-component JPEG that libjpeg takes as RGB, not YCbCr (its
    default_decompress_parms): no JFIF marker and components 'R', 'G',
    'B', or an Adobe APP14 marker with transform 0."""
    ok, buf = cv2.imencode(".jpg", smooth_image(37, 53, 4), [
        cv2.IMWRITE_JPEG_SAMPLING_FACTOR, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444])
    data = bytearray(buf.tobytes())
    app0 = data.index(b"\xff\xe0")
    data = data[:app0] + data[app0 + 2 + int.from_bytes(data[app0 + 2:app0 + 4], "big"):]
    if adobe:
        payload = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
        data = data[:2] + b"\xff\xee" + (len(payload) + 2).to_bytes(2, "big") + payload + data[2:]
    else:
        sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
        for k, cid in zip((10, 13, 16), b"RGB"):
            data[sof + k] = cid
        for k, cid in zip((5, 7, 9), b"RGB"):
            data[sos + k] = cid
    path = tmp_path / "rgb.jpg"
    path.write_bytes(bytes(data))
    _assert_same(read_jpeg(str(path)), _cv2_rgb(path), path.name)


def _sof(data):
    """Offset of the SOF0/SOF2 marker of a cv2 JPEG."""
    for marker in (b"\xff\xc0", b"\xff\xc2"):
        if marker in data:
            return data.index(marker)
    raise AssertionError("no SOF")


def test_jpeg_refusals_name_the_file(tmp_path):
    data = open(os.path.join(OUT, "baseline_420_640x480.jpg"), "rb").read()
    sof = _sof(data)
    cases = {
        "truncated.jpg": (data[:len(data) // 2], "truncated"),
        "arithmetic.jpg": (data[:sof + 1] + b"\xc9" + data[sof + 2:], "arithmetic"),
        "lossless.jpg": (data[:sof + 1] + b"\xc3" + data[sof + 2:], "lossless"),
        "twelve_bit.jpg": (data[:sof + 4] + b"\x0c" + data[sof + 5:], "12-bit"),
        "cmyk.jpg": (data[:sof + 9] + b"\x04" + data[sof + 10:], "CMYK"),
        "not_a_jpeg.jpg": (b"GIF89a" + data[6:], "not a JPEG"),
    }
    for name, (payload, reason) in cases.items():
        (tmp_path / name).write_bytes(payload)
        with pytest.raises(ValueError, match=f"{name}.*{reason}"):
            image_io.imread(str(tmp_path / name))


# TIFF ---------------------------------------------------------------------------------

COMPRESSIONS = ("NONE", "LZW", "ADOBE_DEFLATE", "PACKBITS")


@needs_cv2
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
@pytest.mark.parametrize("compression", COMPRESSIONS)
def test_tiff_matches_cv2(tmp_path, compression, dtype):
    rng = np.random.default_rng(0)
    top = 256 if dtype == np.uint8 else 65536
    for channels in (1, 3, 4):
        for h, w in ((121, 203), (1, 1), (5, 300)):
            image = rng.integers(0, top, (h, w, channels)).astype(dtype)
            for predictor, rows in ((1, 0), (2, 0), (2, 7)):
                path = tmp_path / f"{channels}_{h}x{w}_{predictor}_{rows}.tif"
                params = [cv2.IMWRITE_TIFF_COMPRESSION,
                          getattr(cv2, f"IMWRITE_TIFF_COMPRESSION_{compression}"),
                          cv2.IMWRITE_TIFF_PREDICTOR, predictor]
                if rows:
                    params += [cv2.IMWRITE_TIFF_ROWSPERSTRIP, rows]
                assert cv2.imwrite(str(path), image if channels > 1 else image[..., 0], params)
                _assert_same(read_tiff(str(path)), _cv2_rgb(path), path.name)


WRITER_CASES = {
    "tiled_deflate_predictor": dict(compression="deflate", predictor=2, tile=(32, 16)),
    "tiled_planar_packbits": dict(compression="packbits", tile=(48, 32), planar=2),
    "planar_strips_none": dict(planar=2, rows_per_strip=5),
    "packbits_predictor_ignored": dict(compression="packbits", predictor=2,
                                       rows_per_strip=9),
    "big_endian_16bit_tiled": dict(order=">", dtype=np.uint16, tile=(16, 16),
                                   compression="deflate", predictor=2),
    "big_endian_16bit_gray": dict(order=">", dtype=np.uint16, channels=1, planar=2),
    "unassociated_alpha": dict(channels=4, extra_samples=(2,)),
    "unassociated_alpha_16bit": dict(channels=4, extra_samples=(2,), dtype=np.uint16),
    "associated_alpha_planar": dict(channels=4, extra_samples=(1,), planar=2),
    "gray_alpha": dict(channels=2, extra_samples=(0,)),
    "palette_16bit_map": dict(channels=1, photometric=3, colormap=16),
    "palette_8bit_map": dict(channels=1, photometric=3, colormap=8),
}


@needs_cv2
@pytest.mark.parametrize("case", sorted(WRITER_CASES))
def test_tiff_files_cv2_cannot_write_match_cv2(tmp_path, case):
    kw = dict(WRITER_CASES[case])
    rng = np.random.default_rng(len(case))
    dtype, channels = kw.pop("dtype", np.uint8), kw.pop("channels", 3)
    image = rng.integers(0, 256 if dtype == np.uint8 else 65536, (45, 70, channels)).astype(dtype)
    bits = kw.pop("colormap", None)
    if bits:
        cmap = rng.integers(0, 2 ** bits, (3, 256))
        kw["colormap"] = cmap
    path = tmp_path / f"{case}.tif"
    write_tiff(str(path), image, **kw)
    _assert_same(read_tiff(str(path)), _cv2_rgb(path), case)


def test_tiff_refusals_name_the_file(tmp_path):
    image = smooth_image(20, 30, 0)
    cases = {
        "bigtiff.tif": (lambda p: p.write_bytes(b"II+\x00" + bytes(12)), "BigTIFF"),
        "min_is_white.tif": (lambda p: write_tiff(str(p), image[..., :1], photometric=0),
                             "photometric interpretation 0"),
        "ycbcr.tif": (lambda p: write_tiff(str(p), image, photometric=6),
                      "photometric interpretation 6"),
        "not_a_tiff.tif": (lambda p: p.write_bytes(b"\x89PNG\r\n\x1a\n" + bytes(8)),
                           "not a TIFF"),
    }
    path = tmp_path / "rotated.tif"
    write_tiff(str(path), image)
    data = bytearray(path.read_bytes())
    # append an Orientation entry (tag 274 = 3) to the IFD of a copy
    (ifd,) = struct.unpack("<I", data[4:8])
    (count,) = struct.unpack("<H", data[ifd:ifd + 2])
    entries = [data[ifd + 2 + 12 * i:ifd + 14 + 12 * i] for i in range(count)]
    entries.append(struct.pack("<HHIHH", 274, 3, 1, 3, 0))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])
    rotated = bytes(data[:ifd]) + struct.pack("<H", count + 1) + b"".join(entries) + bytes(4)
    cases["rotated.tif"] = (lambda p: p.write_bytes(rotated), "orientation 3")
    for name, (make, reason) in cases.items():
        make(tmp_path / name)
        with pytest.raises(ValueError, match=f"{name}.*{reason}"):
            image_io.imread(str(tmp_path / name))
    if cv2 is not None:
        for name, comp, reason in (("jpeg.tif", "JPEG", "compression 7"),):
            cv2.imwrite(str(tmp_path / name), image,
                        [cv2.IMWRITE_TIFF_COMPRESSION, getattr(cv2, f"IMWRITE_TIFF_COMPRESSION_{comp}")])
            with pytest.raises(ValueError, match=f"{name}.*{reason}"):
                image_io.imread(str(tmp_path / name))
        cv2.imwrite(str(tmp_path / "float.tif"), image.astype(np.float32))
        with pytest.raises(ValueError, match="float.tif.*32-bit"):
            image_io.imread(str(tmp_path / "float.tif"))
