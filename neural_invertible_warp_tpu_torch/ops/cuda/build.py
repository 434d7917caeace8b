"""Build and load the port's CUDA kernels.

``load_library()`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` into
one shared library with a plain C interface under ``<repo>/build/``, loads
it with ``ctypes`` and declares every function's signature. The library's
name carries a hash of the sources, so an edited source is rebuilt. Nothing
is compiled or loaded at import time.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "niw_kernels")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "niw_rm_fwd_workspace_floats": ([ctypes.c_longlong], ctypes.c_longlong),
    "niw_rm_fwd": ([_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                    ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "niw_rm_train_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                      ctypes.c_longlong),
    "niw_rm_train": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P,
                      _P, _P, _P], ctypes.c_int),
}


class KernelLibrary:
    """The loaded library plus how it was built (seconds, ptxas report)."""

    def __init__(self, path, build_seconds, ptxas_log):
        self.path = path
        self.build_seconds = build_seconds
        self.ptxas_log = ptxas_log
        self.lib = ctypes.CDLL(path)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(self.lib, name)
            fn.argtypes = argtypes
            fn.restype = restype


_LOADED = None


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return nvcc


def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    global _LOADED
    if _LOADED is not None:
        return _LOADED
    sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources + headers:
        with open(path, "rb") as f:
            digest.update(f.read())
    out = os.path.join(BUILD_DIR, "libniw_kernels_{}.so".format(
        digest.hexdigest()[:16]))
    log_path = out + ".ptxas.txt"
    t0 = time.time()
    if not os.path.isfile(out):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = out + ".tmp{}".format(os.getpid())
        cmd = [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-o", tmp] + sources
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(
                proc.returncode, proc.stdout[-4000:], proc.stderr[-8000:]))
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, out)
    build_seconds = time.time() - t0
    ptxas_log = ""
    if os.path.isfile(log_path):
        with open(log_path) as f:
            ptxas_log = f.read()
    _LOADED = KernelLibrary(out, build_seconds, ptxas_log)
    return _LOADED


def check(err, what):
    """Raise if a launch sequence returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {}".format(what, err))
