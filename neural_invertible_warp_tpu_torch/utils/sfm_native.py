"""ctypes bindings for the native SfM geometry core (port of
neural_invertible_warp_tpu/utils/sfm_native.py over the port's own build).

Compiles ``native/sfm_core.cpp`` on first use with
``g++ -O3 -shared -fPIC -std=c++14`` into ``build/niw_sfm/libniw_sfm.so``
(git-ignored; a few seconds), and again whenever the source is newer than
the library. The link goes to a temporary name that ``os.replace`` moves
into place, so processes that build at once never load a torn library.
``native/libniw_sfm.so`` belongs to the JAX package and is never touched.

All entry points mirror the numpy implementations in utils/sfm.py; set
``NIW_NO_NATIVE=1`` to force the numpy path (tests exercise both).
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_REPO, "native", "sfm_core.cpp")
BUILD_DIR = os.path.join(_REPO, "build", "niw_sfm")
LIBRARY = os.path.join(BUILD_DIR, "libniw_sfm.so")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++14"]

_lib_cache = {"checked": False, "lib": None}

_D = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _build():
    tmp = "{}.tmp{}".format(LIBRARY, os.getpid())
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run(["g++"] + CXX_FLAGS + ["-o", tmp, _SRC],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIBRARY)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _load():
    if _lib_cache["checked"]:
        return _lib_cache["lib"]
    _lib_cache["checked"] = True
    if os.environ.get("NIW_NO_NATIVE"):
        return None
    if not os.path.isfile(LIBRARY) or (
            os.path.isfile(_SRC)
            and os.path.getmtime(_SRC) > os.path.getmtime(LIBRARY)):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(LIBRARY)
    except OSError:
        return None
    lib.niw_ransac_essential.restype = ctypes.c_int
    lib.niw_ransac_essential.argtypes = [
        _D, _D, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_uint64, _D, _U8]
    lib.niw_triangulate.restype = None
    lib.niw_triangulate.argtypes = [_D, _D, _D, _D, ctypes.c_int, _D]
    lib.niw_pose_from_essential.restype = ctypes.c_int
    lib.niw_pose_from_essential.argtypes = [_D, _D, _D, ctypes.c_int, _D]
    lib.niw_ransac_pnp.restype = ctypes.c_int
    lib.niw_ransac_pnp.argtypes = [
        _D, _D, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ctypes.c_uint64, _D, _U8]
    _lib_cache["lib"] = lib
    return lib


def available():
    return _load() is not None


def reset_cache():
    _lib_cache["checked"] = False
    _lib_cache["lib"] = None


def _dptr(a):
    return a.ctypes.data_as(_D)


def ransac_essential(x1, x2, thresh, iters=500, seed=0):
    """Native RANSAC 8-point. Returns (E, inliers) or (None, None)."""
    lib = _load()
    x1 = np.ascontiguousarray(x1, np.float64)
    x2 = np.ascontiguousarray(x2, np.float64)
    n = x1.shape[0]
    E = np.zeros((3, 3), np.float64)
    inl = np.zeros(n, np.uint8)
    cnt = lib.niw_ransac_essential(_dptr(x1), _dptr(x2), n, float(thresh),
                                   int(iters), int(seed), _dptr(E),
                                   inl.ctypes.data_as(_U8))
    if cnt < 8:
        return None, None
    return E, inl.astype(bool)


def triangulate(P1, P2, x1, x2):
    lib = _load()
    P1 = np.ascontiguousarray(P1, np.float64)
    P2 = np.ascontiguousarray(P2, np.float64)
    x1 = np.ascontiguousarray(x1, np.float64)
    x2 = np.ascontiguousarray(x2, np.float64)
    n = x1.shape[0]
    X = np.zeros((n, 3), np.float64)
    lib.niw_triangulate(_dptr(P1), _dptr(P2), _dptr(x1), _dptr(x2), n,
                        _dptr(X))
    return X


def pose_from_essential(E, x1, x2):
    lib = _load()
    E = np.ascontiguousarray(E, np.float64)
    x1 = np.ascontiguousarray(x1, np.float64)
    x2 = np.ascontiguousarray(x2, np.float64)
    P2 = np.zeros((3, 4), np.float64)
    n_front = lib.niw_pose_from_essential(_dptr(E), _dptr(x1), _dptr(x2),
                                          x1.shape[0], _dptr(P2))
    return P2, n_front


def ransac_pnp(X, x, thresh, iters=300, seed=0):
    lib = _load()
    X = np.ascontiguousarray(X, np.float64)
    x = np.ascontiguousarray(x, np.float64)
    n = X.shape[0]
    P = np.zeros((3, 4), np.float64)
    inl = np.zeros(n, np.uint8)
    cnt = lib.niw_ransac_pnp(_dptr(X), _dptr(x), n, float(thresh),
                             int(iters), int(seed), _dptr(P),
                             inl.ctypes.data_as(_U8))
    if cnt < 6:
        return None, None
    return P, inl.astype(bool)
