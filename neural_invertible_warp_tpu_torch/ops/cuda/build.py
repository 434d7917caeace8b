"""Build and load the port's CUDA kernels.

``load_library()`` compiles ``csrc/*.cu`` with ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together) and links the objects into one
shared library with a plain C interface under ``<repo>/build/``, loads it
with ``ctypes`` and declares every function's signature. The library's
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
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_SIGNATURES = {
    "niw_rm_fwd_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                    ctypes.c_longlong),
    "niw_rm_fwd": ([_P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                    ctypes.c_int, ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "niw_rm_bwd_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                    ctypes.c_longlong),
    "niw_rm_bwd": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                    ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, _P, _P],
                   ctypes.c_int),
    "niw_rm_train_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                      ctypes.c_longlong),
    "niw_rm_train": ([_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                      ctypes.c_int, ctypes.c_int, ctypes.c_float, _P, _P, _P,
                      _P, _P, _P, _P], ctypes.c_int),
    "niw_field_pe_fwd_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                          ctypes.c_longlong),
    "niw_field_pe_bwd_workspace_floats": ([ctypes.c_longlong], ctypes.c_longlong),
    "niw_field_pe_fwd": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                          ctypes.c_int, ctypes.c_int, _P, _P, _P], ctypes.c_int),
    "niw_field_pe_bwd": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                          ctypes.c_int, _P, ctypes.c_int, _P, _P, _P, _P, _P],
                         ctypes.c_int),
    "niw_field_fwd_workspace_floats": ([ctypes.c_longlong, ctypes.c_int],
                                       ctypes.c_longlong),
    "niw_field_bwd_workspace_floats": ([ctypes.c_longlong], ctypes.c_longlong),
    "niw_field_fwd": ([_P, _P, _P, ctypes.c_int, _P, ctypes.c_int, ctypes.c_int, _P,
                       _P, _P], ctypes.c_int),
    "niw_field_bwd": ([_P, ctypes.c_int, _P, ctypes.c_int, _P, ctypes.c_int, _P, _P,
                       _P, _P, _P], ctypes.c_int),
    "niw_inn_prep_floats": ([ctypes.c_int], ctypes.c_longlong),
    "niw_inn_bwd_workspace_floats": ([ctypes.c_int, ctypes.c_int], ctypes.c_longlong),
    "niw_inn_fwd": ([_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P, _P,
                     _P], ctypes.c_int),
    "niw_inn_bwd": ([_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_int, _P, _P,
                     _P, _P, _P, _P, _P], ctypes.c_int),
    "niw_corr_fwd": ([_P, _P] + [ctypes.c_int] * 4 + [_P, _P], ctypes.c_int),
    "niw_corr_adj_f1": ([_P, _P] + [ctypes.c_int] * 4 + [_P, _P], ctypes.c_int),
    "niw_corr_adj_f2": ([_P, _P] + [ctypes.c_int] * 4 + [_P, _P], ctypes.c_int),
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


def _check_nvcc(returncode, stdout, stderr):
    if returncode != 0:
        raise RuntimeError("nvcc failed ({}):\n{}\n{}".format(
            returncode, stdout[-4000:], stderr[-8000:]))


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
        objects = ["{}.{}.o".format(tmp, os.path.basename(src)) for src in sources]
        procs = [subprocess.Popen(
            [_nvcc()] + NVCC_FLAGS + ["-I", CSRC, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, obj in zip(sources, objects)]
        outputs = [proc.communicate() for proc in procs]
        try:
            for proc, (stdout, stderr) in zip(procs, outputs):
                _check_nvcc(proc.returncode, stdout, stderr)
            link = subprocess.run([_nvcc(), "-shared", "-o", tmp] + objects,
                                  capture_output=True, text=True)
            _check_nvcc(link.returncode, link.stdout, link.stderr)
        finally:
            for obj in objects:
                if os.path.isfile(obj):
                    os.remove(obj)
        with open(log_path, "w") as f:
            f.write("".join(stderr for _, stderr in outputs))
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
