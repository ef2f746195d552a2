"""Frozen copy of mujoco_sim_tpu_torch's CPU path for the benchmark's
plain reference (bench_port/refsim): imports rewritten, CUDA wrappers
and graph capture removed.  Do not import the program from here.

ctypes bindings for the native geomlib (STL / quickhull / mass props).

Builds lazily via make on first use; scipy/numpy paths in mesh_io are the
fallback when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libgeomlib.so")
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB_PATH):
        try:
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None
    lib.geomlib_load_stl.restype = ctypes.c_int
    lib.geomlib_load_stl.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_double))]
    lib.geomlib_convex_hull.restype = ctypes.c_int
    lib.geomlib_convex_hull.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_double)),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int)),
        ctypes.POINTER(ctypes.c_int)]
    lib.geomlib_mass_properties.restype = ctypes.c_int
    lib.geomlib_mass_properties.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.POINTER(ctypes.c_double)]
    lib.geomlib_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_stl(path: str) -> np.ndarray | None:
    lib = _load()
    if lib is None:
        return None
    out = ctypes.POINTER(ctypes.c_double)()
    n = lib.geomlib_load_stl(path.encode(), ctypes.byref(out))
    if n < 0:
        return None
    verts = np.ctypeslib.as_array(out, shape=(n, 3)).copy()
    lib.geomlib_free(out)
    return verts


def convex_hull(verts: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    pts = np.ascontiguousarray(verts, dtype=np.float64)
    hv = ctypes.POINTER(ctypes.c_double)()
    nf = ctypes.c_int()
    nh = ctypes.c_int()
    fc = ctypes.POINTER(ctypes.c_int)()
    rc = lib.geomlib_convex_hull(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(pts),
        ctypes.byref(hv), ctypes.byref(nh), ctypes.byref(fc),
        ctypes.byref(nf))
    if rc != 0:
        return None
    hull = np.ctypeslib.as_array(hv, shape=(nh.value, 3)).copy()
    faces = np.ctypeslib.as_array(fc, shape=(nf.value, 3)).copy()
    lib.geomlib_free(hv)
    lib.geomlib_free(fc)
    return hull, faces


def mass_properties(verts: np.ndarray, faces: np.ndarray):
    lib = _load()
    if lib is None:
        return None
    v = np.ascontiguousarray(verts, dtype=np.float64)
    f = np.ascontiguousarray(faces, dtype=np.int32)
    out = np.zeros(13)
    rc = lib.geomlib_mass_properties(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), len(f),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        return None
    return float(out[0]), out[1:4].copy(), out[4:13].reshape(3, 3).copy()
