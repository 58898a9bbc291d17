"""ctypes bindings for the native C++ host runtime (csrc/).

The reference's host-side work (BVH construction bvh.rs:65-103, OBJ
parsing obj_model.rs) is native Rust; here the equivalents are C++
compiled to ``libptnative.so`` and loaded with ctypes.  Everything has
a pure-python fallback so the framework runs without a toolchain; the
native path is auto-built on first use when g++ is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LIB_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_SO_PATH = os.path.join(_CSRC, "libptnative.so")


# The build ignores the caller's compiler environment.  A host that
# exports CXX (and CC) for another gcc built, from a fresh checkout, a
# library against that gcc's libstdc++, and the OBJ parser segfaulted
# beside the interpreter's own libstdc++; the system g++ with the flags
# below does not.  The Makefile stamps compiler and flags into
# .build_flags, so a library built otherwise is rebuilt.
_BUILD_VARS = ("CXX=g++", "CXXFLAGS=-O3 -fPIC -std=c++17 -Wall")
_BUILD_ENV_DROP = ("CXX", "CXXFLAGS", "CPPFLAGS", "LDFLAGS", "LDLIBS",
                   "MAKEFLAGS", "MFLAGS")


def _try_build() -> bool:
    env = {k: v for k, v in os.environ.items() if k not in _BUILD_ENV_DROP}
    try:
        subprocess.run(
            ["make", "-s", *_BUILD_VARS],
            cwd=_CSRC,
            check=True,
            capture_output=True,
            timeout=180,
            env=env,
        )
        return os.path.exists(_SO_PATH)
    except Exception:
        return False


def _load():
    global _LIB, _TRIED
    with _LIB_LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        # ALWAYS run the (incremental, instant when fresh) make: a
        # stale .so would silently shadow source fixes while the
        # python oracle has them.  The .so is untracked, so it is
        # always a local build; only fall back to a pre-existing
        # binary when the toolchain is unavailable.
        if not _try_build() and not os.path.exists(_SO_PATH):
            return None
        try:
            lib = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None

        lib.pt_build_bvh.restype = ctypes.c_int
        lib.pt_build_bvh.argtypes = [
            ctypes.POINTER(ctypes.c_float),  # bbox_min [n,3]
            ctypes.POINTER(ctypes.c_float),  # bbox_max [n,3]
            ctypes.c_int,                    # n
            ctypes.c_int,                    # leaf_size
            ctypes.POINTER(ctypes.c_float),  # out node bbox_min [2n,3]
            ctypes.POINTER(ctypes.c_float),  # out node bbox_max [2n,3]
            ctypes.POINTER(ctypes.c_int),    # out miss [2n]
            ctypes.POINTER(ctypes.c_int),    # out leaf_first [2n]
            ctypes.POINTER(ctypes.c_int),    # out leaf_count [2n]
            ctypes.POINTER(ctypes.c_int),    # out prim_order [n]
        ]
        lib.pt_obj_open.restype = ctypes.c_void_p
        lib.pt_obj_open.argtypes = [ctypes.c_char_p]
        lib.pt_obj_counts.restype = None
        lib.pt_obj_counts.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pt_obj_fill.restype = None
        lib.pt_obj_fill.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),  # verts [n*9]
            ctypes.POINTER(ctypes.c_double),  # normals [n*3]
            ctypes.POINTER(ctypes.c_uint8),   # has_normal [n]
            ctypes.POINTER(ctypes.c_int),     # mat_index [n]
            ctypes.POINTER(ctypes.c_float),   # mat_kd [m*3]
            ctypes.POINTER(ctypes.c_float),   # mat_ns [m]
            ctypes.POINTER(ctypes.c_float),   # mat_ni [m]
            ctypes.POINTER(ctypes.c_int),     # mat_illum [m]
        ]
        lib.pt_obj_close.restype = None
        lib.pt_obj_close.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray, leaf_size: int = 4):
    """Native threaded-BVH build; same layout as bvh.build_bvh_numpy."""
    from rust_pathtracer_tpu.bvh import FlatBvh, build_bvh_numpy

    lib = _load()
    if lib is None:
        return build_bvh_numpy(bbox_min, bbox_max, leaf_size)

    n = int(bbox_min.shape[0])
    bmin = np.ascontiguousarray(bbox_min, np.float32)
    bmax = np.ascontiguousarray(bbox_max, np.float32)
    cap = 2 * n
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    miss = np.empty(cap, np.int32)
    leaf_first = np.empty(cap, np.int32)
    leaf_count = np.empty(cap, np.int32)
    order = np.empty(n, np.int32)

    fptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    iptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))
    nodes = lib.pt_build_bvh(
        fptr(bmin), fptr(bmax), n, int(leaf_size),
        fptr(nmin), fptr(nmax), iptr(miss), iptr(leaf_first), iptr(leaf_count),
        iptr(order),
    )
    if nodes <= 0:
        return build_bvh_numpy(bbox_min, bbox_max, leaf_size)
    return FlatBvh(
        bbox_min=nmin[:nodes].copy(),
        bbox_max=nmax[:nodes].copy(),
        miss=miss[:nodes].copy(),
        leaf_first=leaf_first[:nodes].copy(),
        leaf_count=leaf_count[:nodes].copy(),
        prim_order=order.copy(),
    )


def load_obj(path: str):
    """Native OBJ+MTL parse; returns the same tuple shape as
    scene.obj_loader.parse_obj_arrays: (verts (T,3,3) f64, normals
    (T,3) f64, has_normal (T,) bool, mat_index (T,) i32, materials
    list of dicts). Returns None when the native lib is unavailable
    or the file cannot be opened."""
    lib = _load()
    if lib is None:
        return None
    handle = lib.pt_obj_open(path.encode())
    if not handle:
        return None
    try:
        ntris = ctypes.c_int64()
        nmats = ctypes.c_int64()
        lib.pt_obj_counts(handle, ctypes.byref(ntris), ctypes.byref(nmats))
        t, m = ntris.value, nmats.value
        verts = np.empty((t, 3, 3), np.float64)
        normals = np.empty((t, 3), np.float64)
        has_n = np.empty(t, np.uint8)
        mat_idx = np.empty(t, np.int32)
        kd = np.empty((max(m, 1), 3), np.float32)
        ns = np.empty(max(m, 1), np.float32)
        ni = np.empty(max(m, 1), np.float32)
        illum = np.empty(max(m, 1), np.int32)
        dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        lib.pt_obj_fill(
            handle,
            dptr(verts), dptr(normals),
            has_n.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            mat_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
            kd.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ns.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            ni.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            illum.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        )
        materials = [
            dict(kd=tuple(kd[i].tolist()), ns=float(ns[i]), ni=float(ni[i]),
                 illum=int(illum[i]))
            for i in range(m)
        ]
        return verts, normals, has_n.astype(bool), mat_idx, materials
    finally:
        lib.pt_obj_close(handle)
