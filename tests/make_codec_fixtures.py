"""Write the JPEG and TIFF fixtures of `tests/data/torch_codecs/` and the
digests of cv2's decoding of each.

    python tests/make_codec_fixtures.py

Every image is smooth synthetic content drawn from a seed (a sum of
waves, a little noise). JPEGs are written by cv2 (libjpeg-turbo): baseline
4:2:0 at 640x480, progressive 4:2:2 at 333x217, 4:4:4 at quality 100, 4:1:1
at quality 10, gray, one with a restart interval, and one with an EXIF
orientation (6, a quarter turn) spliced in as an APP1 segment. TIFFs are
written by cv2 (libtiff) without compression, with LZW and the horizontal
predictor at 1000x1000 (a FAIR1M-sized scene; long waves in steps of 8,
so that it compresses to ~120 KB), with Deflate and with
PackBits, and by `write_tiff` below as a tiled, planar (2) file with
Deflate and the predictor, which cv2 cannot write. BMPs: 24-bit and
8-bit gray written by cv2, and by `write_bmp` a top-down 32-bit BI_RGB
file and a top-down 8-bit file with a 40-colour palette (indices past
it read black), which cv2 reads but does not write. `digests.json` holds,
for each file, the SHA-256 of `cv2.imread(path, IMREAD_COLOR)[..., ::-1]`
(RGB, C order) and its shape: `tests/test_torch_codecs.py` and
`chip_smoke.py` hold the port's decoders to them where cv2 is absent.
"""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_codecs")
DIGESTS = os.path.join(OUT, "digests.json")


def smooth_image(h, w, seed, channels=3, noise=4.0, scale=(8, 40), step=1):
    """uint8 (h, w, channels) waves of period `scale` px with mild noise,
    quantized to multiples of `step`."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w].astype(np.float64)
    out = []
    for c in range(channels):
        fx, fy, ph = rng.uniform(*scale), rng.uniform(*scale), rng.uniform(0, 6.3)
        out.append(128 + 90 * np.sin(x / fx + ph) * np.cos(y / fy - c)
                   + rng.normal(0, noise, (h, w)))
    image = np.clip(np.stack(out, -1), 0, 255)
    return (image // step * step).astype(np.uint8)


def add_exif_orientation(jpeg, orientation):
    """The JPEG bytes with an APP1 Exif segment (little-endian, one IFD0
    entry: Orientation) spliced in after SOI."""
    tiff = (b"II" + struct.pack("<HI", 42, 8) + struct.pack("<H", 1)
            + struct.pack("<HHIHH", 0x0112, 3, 1, orientation, 0) + struct.pack("<I", 0))
    payload = b"Exif\x00\x00" + tiff
    return jpeg[:2] + b"\xff\xe1" + struct.pack(">H", len(payload) + 2) + payload + jpeg[2:]


def packbits(data):
    """PackBits-encode bytes: runs of 3 or more repeat, the rest literal."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1)]) + data[i:i + 1]
            i = j + 1
            continue
        k = i
        while k < n and k - i < 128 and not (k + 2 < n and data[k] == data[k + 1] == data[k + 2]):
            k += 1
        out += bytes([k - i - 1]) + data[i:k]
        i = k
    return bytes(out)


def write_bmp(path, pixels, bpp, top_down=False, palette=None, compression=0):
    """A BMP with a 40-byte header: `pixels` (H, W, 3) BGR for 24 bits,
    (H, W, 4) BGRX for 32, (H, W) palette indices for 8 with `palette`
    (n, 4) BGRX; rows padded to 4 bytes, bottom-up unless `top_down`."""
    h, w = pixels.shape[:2]
    stride = (w * bpp // 8 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * bpp // 8] = np.asarray(pixels, np.uint8).reshape(h, -1)
    if not top_down:
        rows = rows[::-1]
    pal = b"" if palette is None else np.asarray(palette, np.uint8).tobytes()
    offset = 14 + 40 + len(pal)
    dib = struct.pack("<IiiHHIIiiII", 40, w, -h if top_down else h, 1, bpp, compression,
                      stride * h, 2835, 2835, 0 if palette is None else len(palette), 0)
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", offset + stride * h, 0, 0, offset) + dib + pal
                + rows.tobytes())


def write_tiff(path, image, compression="none", predictor=1, tile=None, rows_per_strip=None,
               planar=1, order="<", photometric=None, colormap=None, extra_samples=None):
    """A minimal baseline TIFF writer for (H, W, C) uint8 or uint16 arrays:
    strips or tiles, planar configuration 1 or 2, no compression, Deflate
    or PackBits, the horizontal predictor, either byte order."""
    image = np.ascontiguousarray(image if image.ndim == 3 else image[..., None])
    h, w, spp = image.shape
    bits = image.dtype.itemsize * 8
    if photometric is None:
        photometric = 2 if spp >= 3 else 1
    planes = [image[..., c:c + 1] for c in range(spp)] if planar == 2 else [image]
    cw, ch = tile if tile else (w, rows_per_strip or h)
    chunks = []
    for plane in planes:
        for y0 in range(0, h, ch):
            for x0 in range(0, w, cw):
                block = np.zeros((ch if tile else min(ch, h - y0), cw, plane.shape[2]),
                                 image.dtype)
                part = plane[y0:y0 + ch, x0:x0 + cw]
                block[:part.shape[0], :part.shape[1]] = part
                if predictor == 2:
                    block = block.copy()
                    block[:, 1:] = block[:, 1:] - block[:, :-1]
                raw = block.astype(block.dtype.newbyteorder(order)).tobytes()
                if compression == "deflate":
                    raw = zlib.compress(raw)
                elif compression == "packbits":
                    raw = packbits(raw)
                chunks.append(raw)
    comp = {"none": 1, "deflate": 8, "packbits": 32773}[compression]
    entries = [(256, 4, [w]), (257, 4, [h]), (258, 3, [bits] * spp), (259, 3, [comp]),
               (262, 3, [photometric]), (277, 3, [spp]), (284, 3, [planar]),
               (317, 3, [predictor])]
    if colormap is not None:
        entries.append((320, 3, list(np.asarray(colormap, np.int64).reshape(-1))))
    if extra_samples is not None:
        entries.append((338, 3, list(extra_samples)))
    offsets_tag, counts_tag = (324, 325) if tile else (273, 279)
    if tile:
        entries += [(322, 4, [cw]), (323, 4, [ch])]
    else:
        entries.append((278, 4, [ch]))
    entries += [(offsets_tag, 4, [0] * len(chunks)), (counts_tag, 4, [len(c) for c in chunks])]
    entries.sort()
    # layout: header, chunk data, out-of-line tag values, IFD
    data = bytearray(b"II" if order == "<" else b"MM")
    data += struct.pack(order + "HI", 42, 0)
    offsets = []
    for c in chunks:
        offsets.append(len(data))
        data += c
    entries = [(t, k, offsets if t == offsets_tag else v) for t, k, v in entries]
    blobs = {}
    for t, k, v in entries:
        fmt = "H" if k == 3 else "I"
        if len(v) * struct.calcsize(fmt) > 4:
            blobs[t] = len(data)
            data += struct.pack(order + fmt * len(v), *v)
            if len(data) % 2:
                data += b"\0"
    ifd = len(data)
    data[4:8] = struct.pack(order + "I", ifd)
    data += struct.pack(order + "H", len(entries))
    for t, k, v in entries:
        fmt = "H" if k == 3 else "I"
        if t in blobs:
            value = struct.pack(order + "I", blobs[t])
        else:
            value = struct.pack(order + fmt * len(v), *v).ljust(4, b"\0")
        data += struct.pack(order + "HHI", t, k, len(v)) + value
    data += struct.pack(order + "I", 0)
    with open(path, "wb") as f:
        f.write(bytes(data))


def _cv2_jpeg(cv2, image, **params):
    flags = []
    for key, value in params.items():
        flags += [getattr(cv2, "IMWRITE_JPEG_" + key.upper()), value]
    ok, buf = cv2.imencode(".jpg", image, flags)
    assert ok
    return buf.tobytes()


def fixtures(cv2):
    """{file name: bytes} of every fixture."""
    s = cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420
    files = {
        "baseline_420_640x480.jpg": _cv2_jpeg(cv2, smooth_image(480, 640, 1), quality=90,
                                              sampling_factor=s),
        "progressive_422_333x217.jpg": _cv2_jpeg(
            cv2, smooth_image(217, 333, 2), quality=75, progressive=1,
            sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422),
        "baseline_444_q100_121x73.jpg": _cv2_jpeg(
            cv2, smooth_image(73, 121, 3), quality=100,
            sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444),
        "progressive_411_q10_199x101.jpg": _cv2_jpeg(
            cv2, smooth_image(101, 199, 4), quality=10, progressive=1,
            sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411),
        "gray_progressive_211x97.jpg": _cv2_jpeg(cv2, smooth_image(97, 211, 5, 1)[..., 0],
                                                 quality=85, progressive=1),
        "restart_440_301x203.jpg": _cv2_jpeg(
            cv2, smooth_image(203, 301, 6), quality=80, rst_interval=5,
            sampling_factor=cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440),
        "exif6_420_160x96.jpg": add_exif_orientation(
            _cv2_jpeg(cv2, smooth_image(96, 160, 7), quality=90, sampling_factor=s), 6),
    }
    tmp = os.path.join(OUT, ".tmp.tif")
    for name, image, comp, pred in (
            ("none_80x60.tif", smooth_image(60, 80, 8), "NONE", 1),
            ("lzw_predictor_1000x1000.tif",
             smooth_image(1000, 1000, 9, noise=0, scale=(200, 400), step=8), "LZW", 2),
            ("deflate_gray_201x121.tif", smooth_image(121, 201, 10, 1)[..., 0], "ADOBE_DEFLATE", 2),
            ("packbits_101x63.tif", smooth_image(63, 101, 11, noise=0), "PACKBITS", 1)):
        assert cv2.imwrite(tmp, image, [
            cv2.IMWRITE_TIFF_COMPRESSION, getattr(cv2, "IMWRITE_TIFF_COMPRESSION_" + comp),
            cv2.IMWRITE_TIFF_PREDICTOR, pred])
        with open(tmp, "rb") as f:
            files[name] = f.read()
    write_tiff(tmp, smooth_image(100, 150, 12), compression="deflate", predictor=2,
               tile=(64, 48), planar=2)
    with open(tmp, "rb") as f:
        files["tiled_planar_deflate_150x100.tif"] = f.read()
    os.remove(tmp)
    # BMP: cv2's own 24-bit and 8-bit gray-palette files, and what cv2
    # reads but does not write: 32-bit BI_RGB and a colour palette, top-down
    for name, image in (("rgb24_37x23.bmp", smooth_image(23, 37, 13)),
                        ("gray8_29x17.bmp", smooth_image(17, 29, 14, 1)[..., 0])):
        ok, buf = cv2.imencode(".bmp", image)
        assert ok
        files[name] = buf.tobytes()
    tmp = os.path.join(OUT, ".tmp.bmp")
    rng = np.random.default_rng(15)
    palette = np.zeros((40, 4), np.uint8)
    palette[:, :3] = rng.integers(0, 256, (40, 3))
    for name, args in (
            ("bgrx32_top_down_21x13.bmp", (smooth_image(13, 21, 16, 4), 32, True)),
            ("palette8_top_down_25x19.bmp",
             (rng.integers(0, 48, (19, 25)), 8, True, palette))):
        write_bmp(tmp, *args)
        with open(tmp, "rb") as f:
            files[name] = f.read()
    os.remove(tmp)
    return files


def rgb_digest(image):
    """(SHA-256 hex of the C-order RGB bytes, shape list)."""
    image = np.ascontiguousarray(image)
    return hashlib.sha256(image.tobytes()).hexdigest(), list(image.shape)


def main():
    import cv2

    os.makedirs(OUT, exist_ok=True)
    digests = {}
    for name, data in fixtures(cv2).items():
        path = os.path.join(OUT, name)
        with open(path, "wb") as f:
            f.write(data)
        decoded = cv2.imread(path, cv2.IMREAD_COLOR)
        assert decoded is not None, path
        sha, shape = rgb_digest(decoded[..., ::-1])
        digests[name] = {"sha256": sha, "shape": shape}
    with open(DIGESTS, "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")
    total = sum(os.path.getsize(os.path.join(OUT, n)) for n in os.listdir(OUT))
    print(f"wrote {len(digests)} fixtures and {DIGESTS}: {total} bytes in all")


if __name__ == "__main__":
    main()
