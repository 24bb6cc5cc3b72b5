"""Native (C++) host-side kernels, loaded via ctypes.

``fastmesh.cpp`` provides the setup-time topology kernels (row
deduplication for facet/edge extraction, ELL transpose-table builds) that
the reference gets from the dolfin C++ core.  The shared library is built
with g++ on first use and cached next to the source; every entry point has
a NumPy fallback, so the package works without a compiler.

Set ``NS_NO_NATIVE=1`` to force the NumPy fallbacks.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastmesh.cpp")
_LIB_PATH = os.path.join(_HERE, "_fastmesh.so")

_lib = None
_load_attempted = False


def _build_library() -> bool:
    cxx = os.environ.get("CXX", "g++")
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", _SRC,
           "-o", _LIB_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_library():
    """The loaded ctypes library, or None if unavailable."""
    global _lib, _load_attempted
    if _load_attempted:
        return _lib
    _load_attempted = True
    if os.environ.get("NS_NO_NATIVE", "") == "1":
        return None
    if not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC)):
        if not _build_library():
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:  # pragma: no cover
        return None

    lib.unique_rows_i32.restype = ctypes.c_longlong
    lib.unique_rows_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_longlong),
        ctypes.POINTER(ctypes.c_longlong)]
    lib.build_transpose_i32.restype = ctypes.c_longlong
    lib.build_transpose_i32.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_int32)]
    _lib = lib
    return _lib


def _i32ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64ptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def unique_rows(rows: np.ndarray):
    """np.unique(rows, axis=0, return_inverse=True, return_counts=True)
    with a native fast path (rows: (n, w) int32)."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, w = rows.shape
    lib = get_library()
    if lib is None or n == 0:
        uniq, inverse, counts = np.unique(rows, axis=0, return_inverse=True,
                                          return_counts=True)
        return uniq, inverse.astype(np.int64), counts.astype(np.int64)
    out_unique = np.empty_like(rows)
    out_inverse = np.empty(n, dtype=np.int64)
    out_counts = np.empty(n, dtype=np.int64)
    n_unique = lib.unique_rows_i32(_i32ptr(rows), n, w, _i32ptr(out_unique),
                                   _i64ptr(out_inverse),
                                   _i64ptr(out_counts))
    return (out_unique[:n_unique].copy(), out_inverse,
            out_counts[:n_unique].copy())


def build_transpose(flat_nodes: np.ndarray, n_nodes: int, k_pad=None):
    """ELL transpose table (native counting sort; NumPy fallback).

    Semantics of parallel.sharded.build_scatter_transpose.
    """
    flat_nodes = np.ascontiguousarray(flat_nodes, dtype=np.int32).ravel()
    n_flat = len(flat_nodes)
    lib = get_library()
    if lib is None:
        from navierstokes_tpu.parallel.sharded import \
            _numpy_scatter_transpose

        return _numpy_scatter_transpose(flat_nodes, n_nodes, k_pad)
    K = lib.build_transpose_i32(_i32ptr(flat_nodes), n_flat, n_nodes, 0,
                                None)
    if k_pad is not None:
        K = max(K, int(k_pad))
    K = max(K, 1)
    table = np.empty((n_nodes, K), dtype=np.int32)
    res = lib.build_transpose_i32(_i32ptr(flat_nodes), n_flat, n_nodes, K,
                                  _i32ptr(table))
    assert res >= 0
    return table, int(K)
