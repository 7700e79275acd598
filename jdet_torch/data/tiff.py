"""TIFF files to RGB uint8, pixel for pixel as `cv2.imread(path,
IMREAD_COLOR)[..., ::-1]`.

cv2 reads an 8-bit-output TIFF through libtiff's RGBA interface
(`TIFFReadRGBAStrip` / `TIFFReadRGBATile`), and so does this reader's
arithmetic: 16-bit RGB samples become `(v + 128) // 257`, 16-bit gray
samples keep their high byte, a palette's 16-bit entries keep their high
byte unless every entry is below 256 (libtiff then takes the map as 8-bit),
unassociated alpha premultiplies the colour as `(v * a + 127) // 255`, and
the other extra samples are dropped. Gray is replicated to three channels.

Python parses the first page's IFD; the inner loops of LZW and PackBits run
in `csrc/image_codecs.cpp` (see `image_codecs.py`), Deflate in `zlib`. It
reads strips and tiles, planar configurations 1 and 2, no compression,
LZW, Deflate and PackBits, horizontal predictor 2 (with LZW and Deflate;
libtiff ignores the tag with the others), RGB, gray (min-is-black)
and palette photometrics, and 8- and 16-bit unsigned samples. Everything
else (BigTIFF, JPEG or other compressions, min-is-white, YCbCr, CMYK,
float or signed samples, other bit depths, an orientation other than
top-left) raises an error that names the file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

from . import image_codecs

_TYPES = {1: ("B", 1), 2: ("c", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1), 8: ("h", 2),
          9: ("i", 4), 16: ("Q", 8)}
_COMPRESSION = {1: "none", 5: "lzw", 8: "deflate", 32946: "deflate", 32773: "packbits"}


def read_tiff(path):
    """RGB uint8 (H, W, 3) of the first page of a TIFF file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_tiff(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _tags(data):
    """{tag: tuple of values} of the first IFD, and the byte order."""
    order = {b"II": "<", b"MM": ">"}.get(data[:2])
    if order is None:
        raise ValueError("not a TIFF file")
    (magic,) = struct.unpack(order + "H", data[2:4])
    if magic == 43:
        raise ValueError("BigTIFF is not supported")
    if magic != 42:
        raise ValueError("not a TIFF file")
    try:
        (ifd,) = struct.unpack(order + "I", data[4:8])
        (count,) = struct.unpack(order + "H", data[ifd:ifd + 2])
        tags = {}
        for i in range(count):
            entry = data[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
            tag, kind, n = struct.unpack(order + "HHI", entry[:8])
            if kind not in _TYPES:
                continue
            fmt, size = _TYPES[kind]
            raw = entry[8:12]
            if n * size > 4:
                (off,) = struct.unpack(order + "I", raw)
                raw = data[off:off + n * size]
            if len(raw) < n * size:
                raise ValueError(f"tag {tag} lies outside the file")
            tags[tag] = struct.unpack(order + fmt * n, raw[:n * size])
    except struct.error:
        raise ValueError("truncated TIFF header") from None
    return tags, order


def _one(tags, tag, default=None):
    v = tags.get(tag)
    if v is None:
        if default is None:
            raise ValueError(f"missing TIFF tag {tag}")
        return default
    return v[0]


def decode_tiff(data):
    """TIFF bytes -> RGB uint8 (H, W, 3)."""
    tags, order = _tags(data)
    width, height = _one(tags, 256), _one(tags, 257)
    spp = _one(tags, 277, 1)
    bps = tags.get(258, (1,) * spp)
    if len(set(bps)) != 1 or bps[0] not in (8, 16):
        raise ValueError(f"{bps[0]}-bit samples are not supported")
    bits = bps[0]
    if set(tags.get(339, (1,))) != {1}:
        raise ValueError("only unsigned integer samples are supported")
    compression = _COMPRESSION.get(_one(tags, 259, 1))
    if compression is None:
        raise ValueError(f"compression {_one(tags, 259)} is not supported")
    photometric = _one(tags, 262)
    if photometric not in (1, 2, 3):
        raise ValueError(f"photometric interpretation {photometric} is not supported")
    if _one(tags, 274, 1) != 1:
        raise ValueError(f"orientation {_one(tags, 274)} is not supported")
    # libtiff applies a predictor only with the codecs that register one
    # (LZW and Deflate here); with PackBits or none the tag is ignored
    predictor = _one(tags, 317, 1) if compression in ("lzw", "deflate") else 1
    if predictor not in (1, 2):
        raise ValueError(f"predictor {predictor} is not supported")
    planar = _one(tags, 284, 1)
    if planar not in (1, 2):
        raise ValueError(f"planar configuration {planar} is not supported")
    colours = 3 if photometric == 2 else 1
    if spp < colours:
        raise ValueError(f"{spp} samples per pixel do not fit photometric {photometric}")
    # samples beyond the colours without an ExtraSamples tag are unspecified
    # extra samples, as libtiff's TIFFReadDirectory defines them
    extra = tags.get(338, (0,) * (spp - colours))
    if photometric == 3 and (bits != 8 or spp != 1 or 320 not in tags):
        raise ValueError("only 8-bit palette images with a colour map are supported")

    pixels = _read_samples(data, tags, order, width, height, spp, bits, compression,
                           predictor, planar)
    return _to_rgb(pixels, tags, photometric, bits, extra)


def _read_samples(data, tags, order, width, height, spp, bits, compression, predictor, planar):
    """The (H, W, spp) samples, uint8 or native uint16."""
    dtype = np.dtype(np.uint8) if bits == 8 else np.dtype(order + "u2")
    planes = spp if planar == 2 else 1
    per_chunk = 1 if planar == 2 else spp
    if 322 in tags:
        cw, ch = _one(tags, 322), _one(tags, 323)
        offsets, counts = tags.get(324), tags.get(325)
        across, down = -(-width // cw), -(-height // ch)
        grid = [(x * cw, y * ch) for y in range(down) for x in range(across)]
    else:
        ch = min(_one(tags, 278, 2**32 - 1), height)
        cw = width
        offsets, counts = tags.get(273), tags.get(279)
        grid = [(0, y) for y in range(0, height, ch)]
    if offsets is None or counts is None or len(offsets) != len(counts) or (
            len(offsets) != len(grid) * planes):
        raise ValueError("strip or tile offsets do not match the image")
    out = np.zeros((height, width, spp), dtype.newbyteorder("="))
    for plane in range(planes):
        for i, (x0, y0) in enumerate(grid):
            k = plane * len(grid) + i
            raw = data[offsets[k]:offsets[k] + counts[k]]
            if len(raw) < counts[k]:
                raise ValueError("a strip or tile lies outside the file")
            rows = ch if 322 in tags else min(ch, height - y0)
            size = rows * cw * per_chunk * dtype.itemsize
            buf = _decompress(raw, compression, size)
            chunk = buf.view(dtype).reshape(rows, cw, per_chunk).astype(out.dtype)
            if predictor == 2:
                chunk = np.cumsum(chunk, axis=1, dtype=out.dtype)
            h, w = min(rows, height - y0), min(cw, width - x0)
            sl = slice(plane, plane + 1) if planar == 2 else slice(None)
            out[y0:y0 + h, x0:x0 + w, sl] = chunk[:h, :w]
    return out


def _decompress(raw, compression, size):
    if compression == "none":
        buf, n = np.frombuffer(raw, np.uint8)[:size].copy(), min(len(raw), size)
    elif compression == "deflate":
        try:
            out = zlib.decompressobj().decompress(raw, size)
        except zlib.error as e:
            raise ValueError(f"corrupt Deflate data: {e}") from None
        buf, n = np.frombuffer(out, np.uint8).copy(), len(out)
    elif compression == "lzw":
        buf, n = image_codecs.lzw_decode(raw, size)
    else:
        buf, n = image_codecs.packbits_decode(raw, size)
    if n < size:
        raise ValueError(f"a strip or tile holds {n} bytes, not {size}")
    return buf[:size]


def _to_rgb(pixels, tags, photometric, bits, extra):
    """libtiff's RGBA conversion of the samples, alpha dropped."""
    if photometric == 3:
        cmap = np.asarray(tags[320], np.int64).reshape(3, -1)
        if cmap.shape[1] < 256:
            cmap = np.pad(cmap, ((0, 0), (0, 256 - cmap.shape[1])))
        if (cmap >= 256).any():
            cmap = cmap >> 8
        return np.ascontiguousarray(cmap.T.astype(np.uint8)[pixels[..., 0]])
    if photometric == 1:
        gray = pixels[..., 0]
        gray = (gray >> 8).astype(np.uint8) if bits == 16 else gray
        return np.ascontiguousarray(np.repeat(gray[..., None], 3, axis=2))
    rgb = pixels[..., :3].astype(np.int64)
    if bits == 16:
        rgb = (rgb + 128) // 257
    if extra and extra[0] == 2:
        alpha = pixels[..., 3:4].astype(np.int64)
        if bits == 16:
            alpha = (alpha + 128) // 257
        rgb = (rgb * alpha + 127) // 255
    return np.ascontiguousarray(rgb.astype(np.uint8))
