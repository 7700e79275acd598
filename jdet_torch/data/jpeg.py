"""JPEG files to RGB uint8, pixel for pixel as `cv2.imread(path,
IMREAD_COLOR)[..., ::-1]`.

cv2 decodes JPEG with libjpeg-turbo (3.1 in OpenCV 5.0) at its defaults:
the integer slow IDCT, fancy upsampling and fixed-point YCbCr->RGB; gray
files come out as three equal channels; and `IMREAD_COLOR` then applies
the EXIF orientation (tag 0x0112 of the first APP1 "Exif" segment). The
decoding runs in `csrc/image_codecs.cpp` (see `image_codecs.py`), the
orientation here with numpy, as OpenCV's `ExifTransform`.

Refused with an error that names the file: arithmetic coding, 12-bit
samples, lossless and hierarchical files, CMYK/YCCK (4 components), and
corrupt or truncated streams, where libjpeg would warn and fill grey.
"""
from __future__ import annotations

import struct

import numpy as np

from . import image_codecs


def read_jpeg(path):
    """RGB uint8 (H, W, 3) of a JPEG file, oriented as its EXIF says."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        image = image_codecs.jpeg_decode(data)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
    return apply_orientation(image, exif_orientation(data))


def _segments(data):
    """(marker, payload) of each segment before the first scan."""
    pos = 2
    while pos + 4 <= len(data):
        if data[pos] != 0xFF:
            return
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        if marker == 0xDA or marker == 0xD9:
            return
        (length,) = struct.unpack(">H", data[pos + 2:pos + 4])
        yield marker, data[pos + 4:pos + 2 + length]
        pos += 2 + length


def exif_orientation(data):
    """The orientation (1..8) of the first APP1 Exif segment's IFD0, or 1
    when there is none or it cannot be read (OpenCV's ExifReader ignores a
    malformed block)."""
    for marker, payload in _segments(data):
        if marker != 0xE1 or payload[:6] != b"Exif\x00\x00":
            continue
        tiff = payload[6:]
        try:
            order = {b"II": "<", b"MM": ">"}[tiff[:2]]
            (ifd,) = struct.unpack(order + "I", tiff[4:8])
            (count,) = struct.unpack(order + "H", tiff[ifd:ifd + 2])
            for i in range(count):
                entry = tiff[ifd + 2 + 12 * i:ifd + 14 + 12 * i]
                tag, kind = struct.unpack(order + "HH", entry[:4])
                if tag == 0x0112 and kind == 3:
                    (value,) = struct.unpack(order + "H", entry[8:10])
                    return value if 1 <= value <= 8 else 1
        except (KeyError, struct.error):
            return 1
        return 1
    return 1


def apply_orientation(image, orientation):
    """OpenCV's ExifTransform: 2 flips left-right, 3 rotates 180, 4 flips
    up-down, 5 transposes, 6 rotates 90 clockwise, 7 transverses, 8
    rotates 90 counter-clockwise."""
    if orientation in (5, 6, 7, 8):
        image = image.transpose(1, 0, 2)
        orientation = {5: 1, 6: 2, 7: 3, 8: 4}[orientation]
    if orientation == 2:
        image = image[:, ::-1]
    elif orientation == 3:
        image = image[::-1, ::-1]
    elif orientation == 4:
        image = image[::-1]
    return np.ascontiguousarray(image)
