"""ctypes binding for the native C++ SAH builder (native/sah_builder.cpp).

Counterpart of embree_tpu/build/native.py. Compiles the repository's
shared C++ source on demand with g++ into this package's own `_build/`
directory (never beside the source, where the JAX package keeps its
copy). `_load` returns None when the toolchain or the source is missing;
the callers then take the numpy frontier builder, as `builder=python`
asks for explicitly.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from .bvh import BVHArraysNP

_pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(os.path.dirname(_pkg), "native", "sah_builder.cpp")
BUILD_DIR = os.path.join(_pkg, "_build")
_SO = os.path.join(BUILD_DIR, "libet_sah.so")

_lib = None
_lock = threading.Lock()
_failed = False


def _load():
    global _lib, _failed
    with _lock:
        if _lib is not None or _failed:
            return _lib
        try:
            if not os.path.exists(_SO) or (
                    os.path.exists(_SRC)
                    and os.path.getmtime(_SRC) > os.path.getmtime(_SO)):
                os.makedirs(BUILD_DIR, exist_ok=True)
                # build beside the target, then rename: another process
                # that loads the library never sees a half-written file
                tmp = f"{_SO}.{os.getpid()}.tmp"
                subprocess.run(
                    ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                     "-fPIC", "-pthread", _SRC, "-o", tmp],
                    check=True, capture_output=True)
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
            lib.et_build_sah.restype = ctypes.c_void_p
            lib.et_build_sah.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float]
            lib.et_build_sah_tri.restype = ctypes.c_void_p
            lib.et_build_sah_tri.argtypes = [
                ctypes.POINTER(ctypes.c_float)] * 5 + [
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_float]
            lib.et_num_refs.restype = ctypes.c_int64
            lib.et_num_refs.argtypes = [ctypes.c_void_p]
            lib.et_num_nodes.restype = ctypes.c_int64
            lib.et_num_nodes.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.et_get_arrays.restype = None
            lib.et_get_arrays.argtypes = [ctypes.c_void_p] + \
                [ctypes.POINTER(ctypes.c_float)] * 2 + \
                [ctypes.POINTER(ctypes.c_int32)] * 3
            lib.et_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError):
            _failed = True
    return _lib


def native_available() -> bool:
    return _load() is not None


def build_sah_native(prim_lower: np.ndarray, prim_upper: np.ndarray,
                     branching: int = 4, max_leaf: int = 4,
                     min_leaf: int = 1,
                     spatial_factor: float = 1.0,
                     tri_verts=None) -> BVHArraysNP | None:
    """spatial_factor > 1 enables BINNED SPATIAL SPLITS (SBVH,
    RTC_BUILD_QUALITY_HIGH; heuristic_spatial_array.h semantics): every
    range evaluates both the 32-bin object split and a 16-bin spatial
    split with entry/exit counts and clipped per-bin bounds, takes the
    cheaper, and duplicates straddling references under a budget of
    (spatial_factor - 1) * P (embree's max_spatial_split_replications,
    state.h:113). `tri_verts=(v0, v1, v2)` enables exact
    Sutherland-Hodgman triangle clipping for tight split boxes;
    without it, boxes are chopped at the plane. The returned prim_order
    then holds up to spatial_factor * P entries with repeats — leaves
    referencing a duplicated prim test it more than once, harmless for
    correctness."""
    lib = _load()
    if lib is None:
        return None
    lo = np.ascontiguousarray(prim_lower, np.float32)
    hi = np.ascontiguousarray(prim_upper, np.float32)
    P = lo.shape[0]
    fp = ctypes.POINTER(ctypes.c_float)
    if tri_verts is not None and spatial_factor > 1.0:
        v0, v1, v2 = (np.ascontiguousarray(v, np.float32)
                      for v in tri_verts)
        h = lib.et_build_sah_tri(
            lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
            v0.ctypes.data_as(fp), v1.ctypes.data_as(fp),
            v2.ctypes.data_as(fp),
            P, branching, max_leaf, min_leaf, float(spatial_factor))
    else:
        h = lib.et_build_sah(
            lo.ctypes.data_as(fp), hi.ctypes.data_as(fp),
            P, branching, max_leaf, min_leaf, float(spatial_factor))
    try:
        P = lib.et_num_refs(h)
        M = lib.et_num_nodes(h, branching)
        lower = np.empty((M, branching, 3), np.float32)
        upper = np.empty((M, branching, 3), np.float32)
        child = np.empty((M, branching), np.int32)
        count = np.empty((M, branching), np.int32)
        order = np.empty((P,), np.int32)
        lib.et_get_arrays(
            h,
            lower.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            upper.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            child.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            order.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.et_free(h)
    return BVHArraysNP(lower, upper, child, count, order)
