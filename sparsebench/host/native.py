"""ctypes bindings for the native host library (native/ingest.cc).

Loads ``libsbhost.so``, building it on first use if a toolchain is present.
Every entry point has a numpy fallback (the modules in this package), so
the framework works without a compiler — the native paths are pure
speedups for benchmark-scale ingest (the reference's host layer is all C;
ours is C++ behind the same Python API).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "..", "native")
_SO = os.path.join(_DIR, "libsbhost.so")

_lib: Optional[ctypes.CDLL] = None
_tried = False

_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")


def _build() -> bool:
    try:
        subprocess.run(
            ["make", "-C", _DIR, "-s"],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return os.path.exists(_SO)
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO) and not _build():
        return None
    try:
        lib = ctypes.CDLL(_SO)
    except OSError:
        return None

    lib.sb_generate_stencil.restype = ctypes.c_int64
    lib.sb_generate_stencil.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, _i64p, _i32p,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.sb_mm_parse_body.restype = ctypes.c_int64
    lib.sb_mm_parse_body.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, _i64p, _i64p, _f64p,
    ]
    lib.sb_coo_sort.restype = None
    lib.sb_coo_sort.argtypes = [ctypes.c_int64, _i64p, _i64p, _f64p]
    lib.sb_sell_fill.restype = None
    lib.sb_sell_fill.argtypes = [
        ctypes.c_int64, _i64p, _i64p, _f64p, _i64p, _i64p, ctypes.c_int64,
        _i64p, _f64p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return get_lib() is not None


# ---------------------------------------------------------------- wrappers
def generate_stencil_native(
    nx: int, ny: int, nz: int, rank: int, size: int, use_7pt: bool, dtype
):
    """Returns (row_ptr, col, val) or None if the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    local_nrow = nx * ny * nz
    cap = 27 * local_nrow
    row_ptr = np.empty(local_nrow + 1, dtype=np.int64)
    col = np.empty(cap, dtype=np.int32)
    dtype = np.dtype(dtype)
    if dtype == np.float32:
        val = np.empty(cap, dtype=np.float32)
        v32, v64 = val.ctypes.data_as(ctypes.c_void_p), None
    else:
        val = np.empty(cap, dtype=np.float64)
        v32, v64 = None, val.ctypes.data_as(ctypes.c_void_p)
    nnz = lib.sb_generate_stencil(
        nx, ny, nz, rank, size, int(use_7pt), row_ptr, col, v32, v64
    )
    out_val = val[:nnz]
    if dtype not in (np.float32, np.float64):
        out_val = out_val.astype(dtype)
    return row_ptr, col[:nnz].astype(np.int64), out_val


def mm_parse_body_native(
    path: str, body_offset: int, nz: int, pattern: bool, symmetric: bool
):
    """Returns (row, col, val) int64/int64/float64 arrays, or None."""
    lib = get_lib()
    if lib is None:
        return None
    cap = 2 * nz if symmetric else nz
    row = np.empty(cap, dtype=np.int64)
    col = np.empty(cap, dtype=np.int64)
    val = np.empty(cap, dtype=np.float64)
    n = lib.sb_mm_parse_body(
        path.encode(), body_offset, nz, int(pattern), int(symmetric),
        row, col, val,
    )
    if n < 0:
        return None
    lib.sb_coo_sort(n, row[:n], col[:n], val[:n])
    return row[:n], col[:n], val[:n]
