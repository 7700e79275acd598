"""The host codec library: `csrc/image_codecs.cpp`, built with g++ and
bound with ctypes.

It is compiled with `g++ -O3 -shared -fPIC` at first use into `build/` at
the repository root, keyed by a hash of the source and flags, as
`ops/polygon_native.py` builds `polygon.cpp`. A failed build raises with
the compiler's output; no other decoder is ever tried. `jpeg.py`,
`tiff.py` and `yolo.py` call the functions below.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from ..ops.rotated_iou_kernel import BUILD_DIR

SOURCE = BUILD_DIR.parent / "jdet_torch" / "csrc" / "image_codecs.cpp"
# no contraction into fused multiply-adds: the warp rounds each step where
# its numpy form does
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_ERRLEN = 512

_lib = None
_lock = threading.Lock()


def build():
    """Compile `csrc/image_codecs.cpp` (once per source hash) and load it."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
        so = BUILD_DIR / f"image_codecs_{key}.so"
        if not so.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError("g++ not found: the image codecs need a C++ compiler")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.jpeg_probe.argtypes = [ptr, i64, ptr, ctypes.c_char_p, i32]
        lib.jpeg_probe.restype = i32
        lib.jpeg_decode.argtypes = [ptr, i64, ptr, ctypes.c_char_p, i32]
        lib.jpeg_decode.restype = i32
        for name in ("tiff_lzw_decode", "tiff_packbits_decode"):
            fn = getattr(lib, name)
            fn.argtypes = [ptr, i64, ptr, i64, ctypes.c_char_p, i32]
            fn.restype = i64
        lib.warp_affine_f32.argtypes = [ptr, i64, i64, i64, ptr, i64, i64, ptr,
                                        ctypes.c_float]
        lib.warp_affine_f32.restype = None
        _lib = lib
        return lib


def _buffer(data):
    """bytes -> a uint8 array that stays alive while the call runs."""
    return np.frombuffer(data, np.uint8)


def jpeg_decode(data):
    """JPEG bytes -> RGB uint8 (H, W, 3), before any EXIF orientation.
    Raises ValueError with the decoder's message."""
    lib = build()
    src = _buffer(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    info = np.zeros(3, np.int32)
    if lib.jpeg_probe(src.ctypes.data, len(src), info.ctypes.data, err, _ERRLEN):
        raise ValueError(err.value.decode())
    width, height = int(info[0]), int(info[1])
    out = np.empty((height, width, 3), np.uint8)
    if lib.jpeg_decode(src.ctypes.data, len(src), out.ctypes.data, err, _ERRLEN):
        raise ValueError(err.value.decode())
    return out


def _inflate(fn, data, size):
    src = _buffer(data)
    out = np.zeros(size, np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    n = fn(src.ctypes.data, len(src), out.ctypes.data, size, err, _ERRLEN)
    if n < 0:
        raise ValueError(err.value.decode())
    return out, n


def lzw_decode(data, size):
    """TIFF LZW bytes -> (uint8 (size,) buffer, bytes decoded)."""
    return _inflate(build().tiff_lzw_decode, data, size)


def packbits_decode(data, size):
    """TIFF PackBits bytes -> (uint8 (size,) buffer, bytes decoded)."""
    return _inflate(build().tiff_packbits_decode, data, size)


def warp_affine_f32(src, inverse_map, dsize, fill):
    """float32 (H, W, C) -> (h, w, C) through `inverse_map` (6 float32s),
    the compiled form of `yolo.py::warp_affine_plain`."""
    lib = build()
    src = np.ascontiguousarray(src, np.float32)
    H, W, C = src.shape
    w, h = dsize
    m = np.ascontiguousarray(inverse_map, np.float32).reshape(6)
    out = np.empty((h, w, C), np.float32)
    lib.warp_affine_f32(src.ctypes.data, H, W, C, out.ctypes.data, h, w, m.ctypes.data,
                        float(np.float32(fill)))
    return out
