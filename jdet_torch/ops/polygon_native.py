"""The host-side polygon library: quad IoU matrices and greedy polygon
NMS in C++, for evaluation and tile merging.

Port of `jdet_tpu/csrc/__init__.py`'s loader for `csrc/polygon.cpp` (a
copy of `jdet_tpu/csrc/polygon.cpp`). It is compiled with
`g++ -O3 -shared -fPIC` at first use into `build/` at the repository
root, keyed by a hash of the source and flags, as `rotated_iou_kernel.py`
builds the CUDA kernels, and loaded with ctypes. Unlike the reference,
which prints and falls back to numpy, a failed build raises with the
compiler's output. The plain versions of both functions are the numpy
paths of `data/devkits/polygon.py`.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

from .rotated_iou_kernel import BUILD_DIR

SOURCE = BUILD_DIR.parent / "jdet_torch" / "csrc" / "polygon.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None


def build():
    """Compile `csrc/polygon.cpp` (once per source hash) and load it."""
    global _lib
    if _lib is not None:
        return _lib
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"polygon_{key}.so"
    if not so.exists():
        gxx = shutil.which("g++")
        if gxx is None:
            raise RuntimeError("g++ not found: the polygon library needs a C++ compiler")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        proc = subprocess.run([gxx, *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SOURCE}:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    ptr, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.poly_iou_matrix.argtypes = [ptr, i64, ptr, i64, ptr]
    lib.poly_iou_matrix.restype = None
    lib.poly_nms.argtypes = [ptr, ptr, i64, ctypes.c_double, ptr]
    lib.poly_nms.restype = i64
    _lib = lib
    return lib


def _quads(polys, what):
    p = np.ascontiguousarray(polys, np.float64)
    if p.ndim != 2 or p.shape[1] != 8:
        raise ValueError(f"{what}: expected (n, 8) quads, got {p.shape}")
    return p


def poly_iou_matrix(polys1, polys2):
    """(n, 8) x (m, 8) quads -> (n, m) float64 IoU."""
    p1, p2 = _quads(polys1, "polys1"), _quads(polys2, "polys2")
    out = np.zeros((len(p1), len(p2)), np.float64)
    if out.size:
        build().poly_iou_matrix(p1.ctypes.data, len(p1), p2.ctypes.data, len(p2),
                                out.ctypes.data)
    return out


def poly_nms(polys, scores, iou_thr):
    """Greedy polygon NMS with the hbb prefilter: the kept indices in
    descending score order, int64."""
    p = _quads(polys, "polys")
    s = np.ascontiguousarray(scores, np.float64)
    if s.shape != (len(p),):
        raise ValueError(f"scores: expected ({len(p)},), got {s.shape}")
    keep = np.zeros(len(p), np.int64)
    if not len(p):
        return keep
    n = build().poly_nms(p.ctypes.data, s.ctypes.data, len(p), float(iou_thr), keep.ctypes.data)
    return keep[:n].copy()
