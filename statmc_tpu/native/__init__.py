"""Native (C++) runtime components, loaded via ctypes.

The reference's runtime is C++ throughout; here the device compute path is
JAX/XLA/Pallas, and the host-side runtime pieces that remain hot --
currently the BVH builder -- are C++ compiled on demand with g++ into a
cached shared library (no pybind11; plain C ABI + ctypes).  Everything
has a pure-numpy fallback so the framework works without a toolchain.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_LIB = None
_TRIED = False


def _build_library() -> str | None:
    src = os.path.join(_DIR, "bvh_builder.cpp")
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    out = os.path.join(_DIR, f"_statmc_native_{digest}.so")
    if os.path.exists(out):
        return out
    cmd = [
        "g++", "-O3", "-march=native", "-shared", "-fPIC",
        "-std=c++17", src, "-o", out,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return out
    except (subprocess.CalledProcessError, FileNotFoundError,
            subprocess.TimeoutExpired) as e:
        print(f"statmc native build failed ({e}); using numpy fallback",
              file=sys.stderr)
        return None


def get_library():
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        path = _build_library()
        if path is not None:
            lib = ctypes.CDLL(path)
            lib.statmc_bvh_build.restype = ctypes.c_void_p
            lib.statmc_bvh_build.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, ctypes.c_int,
            ]
            lib.statmc_bvh_num_nodes.restype = ctypes.c_int
            lib.statmc_bvh_num_nodes.argtypes = [ctypes.c_void_p]
            lib.statmc_bvh_num_slots.restype = ctypes.c_int
            lib.statmc_bvh_num_slots.argtypes = [ctypes.c_void_p]
            lib.statmc_bvh_export.restype = None
            lib.statmc_bvh_export.argtypes = [ctypes.c_void_p] + [
                ctypes.c_void_p
            ] * 5
            lib.statmc_bvh_free.restype = None
            lib.statmc_bvh_free.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def build_bvh_native(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray,
                     leaf_size: int):
    """Returns (lo [N,3], hi [N,3], miss [N], leaf_off [N], slots [S])
    or None if the native library is unavailable."""
    lib = get_library()
    if lib is None:
        return None
    p0 = np.ascontiguousarray(p0, np.float32)
    e1 = np.ascontiguousarray(e1, np.float32)
    e2 = np.ascontiguousarray(e2, np.float32)
    n = p0.shape[0]
    h = lib.statmc_bvh_build(
        p0.ctypes.data, e1.ctypes.data, e2.ctypes.data, n, leaf_size
    )
    try:
        nn = lib.statmc_bvh_num_nodes(h)
        ns = lib.statmc_bvh_num_slots(h)
        lo = np.empty((nn, 3), np.float32)
        hi = np.empty((nn, 3), np.float32)
        miss = np.empty((nn,), np.int32)
        leaf = np.empty((nn,), np.int32)
        slots = np.empty((ns,), np.int32)
        lib.statmc_bvh_export(
            h, lo.ctypes.data, hi.ctypes.data, miss.ctypes.data,
            leaf.ctypes.data, slots.ctypes.data,
        )
        return lo, hi, miss, leaf, slots
    finally:
        lib.statmc_bvh_free(h)
