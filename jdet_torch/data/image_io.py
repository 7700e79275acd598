"""Images to RGB uint8: PNG with `zlib` and numpy, JPEG and TIFF through
`jpeg.py` and `tiff.py`; and a PNG writer.

The counterpart of `jdet_tpu/data/custom.py::_imread` (:43-50), which
returns `cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1]`. The GPU machine
has neither cv2 nor PIL, so the port decodes PNG itself, to the same
pixels as cv2 (libpng under IMREAD_COLOR):

- colour types 0 (gray), 2 (RGB), 3 (palette), 4 (gray + alpha) and
  6 (RGBA) at every bit depth PNG allows. Alpha channels and `tRNS` are
  dropped and gray is replicated to three channels;
- 16-bit samples keep their high byte (libpng's `png_set_strip_16`);
  gray below 8 bits is scaled to 0..255 and palette indices beyond the
  palette read black, as libpng's expansion does;
- all five row filters (None, Sub, Up, Average, Paeth). None, Sub and Up
  are whole-row numpy operations. Average and Paeth depend on the
  reconstructed left neighbour, so the rows from the first to the last
  such row are reconstructed as a wavefront: step d takes the pixel
  (y, d - y) of every row at once, H + W steps for a tile instead of one
  numpy call per pixel.

Interlaced (Adam7) files and corrupt chunks raise an error that names the
file. BMP (`read_bmp`) is read as cv2 reads it: uncompressed (BI_RGB)
24- and 32-bit pixels (the fourth byte dropped) and 8-bit palette
indices, bottom-up or top-down; any other depth or compression raises. `imread` sends `.jpg`/`.jpeg` to `jpeg.py` and `.tif`/`.tiff` to
`tiff.py` (the same pixels as cv2, on a g++ library), loads `.npy` tiles
with `np.load`, and refuses every other extension. No other decoder is
ever tried.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .jpeg import read_jpeg
from .tiff import read_tiff

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
FILTER_NAMES = ("none", "sub", "up", "average", "paeth")


def imread(path):
    """RGB uint8 (H, W, 3) of a `.png`, `.jpg`/`.jpeg`, `.tif`/`.tiff` or
    `.bmp` image (`jpeg.py`, `tiff.py`, `read_bmp`), or the array of a
    `.npy` tile; any other extension raises."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        return np.load(path)
    if ext in (".jpg", ".jpeg"):
        return read_jpeg(path)
    if ext in (".tif", ".tiff"):
        return read_tiff(path)
    if ext == ".bmp":
        return read_bmp(path)
    if ext != ".png":
        raise ValueError(f"{path}: only .png, .jpg, .jpeg, .tif, .tiff, .bmp and .npy "
                         f"images can be read, not {ext!r}")
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def _chunks(data):
    """(type, payload) of each chunk up to IEND, CRCs checked."""
    if data[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while True:
        if pos + 12 > len(data):
            raise ValueError("truncated PNG")
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if len(payload) != n or zlib.crc32(kind + payload) != crc:
            raise ValueError(f"corrupt {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + n


def _parse(data):
    """Header fields, palette and the decompressed scanlines."""
    header, palette, idat = None, None, []
    for kind, payload in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise ValueError("no IHDR or IDAT chunk")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"invalid colour type {ctype} at bit depth {depth}")
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if ctype == 3 and palette is None:
        raise ValueError("palette image without a PLTE chunk")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"bad image data: {e}") from None
    bits = depth * _CHANNELS[ctype]
    stride = (width * bits + 7) // 8
    if len(raw) < height * (stride + 1):
        raise ValueError("image data shorter than the header says")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(height, stride + 1)
    return width, height, depth, ctype, palette, rows, max(bits // 8, 1)


def png_size(path):
    """(height, width) of a PNG file, read from its IHDR chunk alone."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != _SIGNATURE or head[12:16] != b"IHDR":
        raise ValueError(f"{path}: not a PNG file")
    width, height = struct.unpack(">II", head[16:24])
    return height, width


def png_row_filters(path):
    """The filter type (0..4) of each row of a PNG file."""
    with open(path, "rb") as f:
        return _parse(f.read())[5][:, 0].copy()


def decode_png(data):
    """PNG bytes -> RGB uint8 (H, W, 3), as cv2.imread(IMREAD_COLOR)
    followed by BGR -> RGB."""
    width, height, depth, ctype, palette, rows, bpp = _parse(data)
    px = unfilter(rows[:, 0], rows[:, 1:], bpp)
    channels = _CHANNELS[ctype]
    if depth == 16:
        px = px.reshape(height, width * channels, 2)[..., 0]
    elif depth < 8:
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = (px[..., None] >> shifts) & ((1 << depth) - 1)
        px = px.reshape(height, -1)[:, :width]
        if ctype == 0:
            px = px * np.uint8(255 // ((1 << depth) - 1))
    px = px.reshape(height, width, channels)
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[:len(palette)] = palette[:256]
        return lut[px[..., 0]]
    if ctype in (0, 4):
        return np.ascontiguousarray(np.repeat(px[..., :1], 3, axis=2))
    return np.ascontiguousarray(px[..., :3])


def _paeth(a, b, c):
    pa = np.abs(b - c)
    pb = np.abs(a - c)
    pc = np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def unfilter(ftypes, filtered, bpp):
    """Reconstruct PNG scanlines: ftypes (H,) in 0..4, filtered (H, S)
    uint8 bytes, bpp bytes per complete pixel (at least 1). Returns
    (H, S) uint8."""
    height, stride = filtered.shape
    if height and int(ftypes.max()) > 4:
        raise ValueError(f"unknown row filter {int(ftypes.max())}")
    out = np.empty((height, stride), np.uint8)
    width = stride // bpp
    slow = np.flatnonzero(ftypes >= 3)
    first, last = (slow[0], slow[-1] + 1) if len(slow) else (height, height)
    prev = np.zeros(stride, np.uint8)
    y = 0
    while y < height:
        if y == first:
            out[first:last] = _unfilter_wavefront(
                ftypes[first:last], filtered[first:last].reshape(-1, width, bpp),
                prev.reshape(width, bpp)).reshape(last - first, stride)
            y = last
        else:
            t, f = ftypes[y], filtered[y]
            if t == 0:
                out[y] = f
            elif t == 1:
                out[y] = np.cumsum(f.reshape(width, bpp), axis=0, dtype=np.uint8).reshape(-1)
            else:
                out[y] = prev + f
            y += 1
        prev = out[y - 1]
    return out


def _unfilter_wavefront(ftypes, filtered, above):
    """Rows of any filter type, reconstructed along anti-diagonals.

    filtered (n, W, bpp), above (W, bpp) the reconstructed row before the
    first. Pixel (y, x) depends on (y, x-1), (y-1, x) and (y-1, x-1), all
    on earlier diagonals, so diagonal d = y + x is one vector step over
    its rows. The values live skewed, q[y + x + 2, y + 1] = recon(y, x),
    so each step reads contiguous slices: q[d + 1] holds the left and up
    neighbours, q[d] the up-left one; row -1 is `above`, column -1 zero.
    """
    n, width, bpp = filtered.shape
    ys = np.arange(n)[:, None]
    xs = np.arange(width)[None, :]
    skewed = np.zeros((n + width - 1, n, bpp), np.int16)
    skewed[ys + xs, ys] = filtered
    q = np.zeros((n + width + 1, n + 1, bpp), np.int16)
    q[np.arange(width) + 1, 0] = above
    t = ftypes.astype(np.int16)[:, None]
    masks = [(t == k).astype(np.int16) for k in range(1, 5)]
    for d in range(n + width - 1):
        y0, y1 = max(0, d - width + 1), min(n - 1, d) + 1
        a = q[d + 1, y0 + 1:y1 + 1]
        b = q[d + 1, y0:y1]
        c = q[d, y0:y1]
        m1, m2, m3, m4 = (m[y0:y1] for m in masks)
        pred = m1 * a + m2 * b + m3 * ((a + b) >> 1) + m4 * _paeth(a, b, c)
        q[d + 2, y0 + 1:y1 + 1] = (skewed[d, y0:y1] + pred) & 255
    return q[ys + xs + 2, ys + 1].astype(np.uint8)


def _filter_rows(rows, ftypes, bpp):
    """The inverse of `unfilter`: raw scanlines (H, S) uint8 -> filtered."""
    x = rows.astype(np.int16)
    a = np.zeros_like(x)
    a[:, bpp:] = x[:, :-bpp]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    c = np.zeros_like(x)
    c[1:, bpp:] = x[:-1, :-bpp]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, c)])
    pred = preds[ftypes, np.arange(len(rows))]
    return ((x - pred) & 255).astype(np.uint8)


def encode_png(image, filter_type=0, level=6):
    """uint8 (H, W, 3) RGB or (H, W) gray -> PNG bytes, 8 bits per sample.
    filter_type: one filter (0..4) for every row, or one per row."""
    image = np.ascontiguousarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"expected uint8 (H, W, 3) or (H, W), got {image.dtype} {image.shape}")
    height, width = image.shape[:2]
    bpp = 3 if image.ndim == 3 else 1
    ftypes = np.broadcast_to(np.asarray(filter_type, np.int64), (height,))
    if ftypes.min() < 0 or ftypes.max() > 4:
        raise ValueError(f"PNG filter types are 0..4, got {filter_type}")
    rows = _filter_rows(image.reshape(height, width * bpp), ftypes, bpp)
    raw = np.concatenate([ftypes.astype(np.uint8)[:, None], rows], 1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2 if bpp == 3 else 0, 0, 0, 0)
    return (_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), level)) + chunk(b"IEND", b""))


def imwrite(path, image, filter_type=0, level=6):
    """Write `image` (see `encode_png`) to `path` as a PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(image, filter_type, level))


def read_bmp(path):
    """RGB uint8 (H, W, 3) of an uncompressed BMP, the pixels of
    `cv2.imread(path, IMREAD_COLOR)[..., ::-1]`: 24-bit BGR, 32-bit BGRX
    (the fourth byte dropped) or 8-bit indices into a palette of
    `clrUsed` (or 256) BGRX entries, zeros past its end; rows padded to 4
    bytes, bottom-up for a positive height and top-down for a negative
    one. Other depths, compressions and truncated files raise an error
    that names the file."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        if len(data) < 54 or data[:2] != b"BM":
            raise ValueError("not a BMP file")
        (offset,) = struct.unpack_from("<I", data, 10)
        (hsize,) = struct.unpack_from("<I", data, 14)
        if hsize < 40:
            raise ValueError(f"a {hsize}-byte DIB header is not supported")
        width, height, _, bpp, compression, _, _, _, clr_used = struct.unpack_from(
            "<iiHHIIiiI", data, 18)
        if compression != 0 or bpp not in (8, 24, 32):
            raise ValueError(f"only uncompressed 8-, 24- and 32-bit BMPs are supported, "
                             f"not {bpp}-bit with compression {compression}")
        if width <= 0 or height == 0:
            raise ValueError(f"invalid size {width}x{height}")
        h = abs(height)
        stride = (width * bpp // 8 + 3) // 4 * 4
        if offset + stride * h > len(data):
            raise ValueError("pixel data shorter than the header says")
        rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h, stride)
        if height > 0:
            rows = rows[::-1]
        if bpp == 8:
            n = clr_used or 256
            if n > 256 or 14 + hsize + 4 * n > len(data):
                raise ValueError(f"invalid palette of {n} colours")
            palette = np.zeros((256, 4), np.uint8)
            palette[:n] = np.frombuffer(data, np.uint8, 4 * n, 14 + hsize).reshape(n, 4)
            bgr = palette[rows[:, :width], :3]
        else:
            bgr = rows[:, :width * bpp // 8].reshape(h, width, bpp // 8)[..., :3]
    except (ValueError, struct.error) as e:
        raise ValueError(f"{path}: {e}") from None
    return np.ascontiguousarray(bgr[..., ::-1])
