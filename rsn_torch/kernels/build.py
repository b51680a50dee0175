"""Build and load the port's CUDA kernels.

The sources under rsn_torch/csrc/ have a plain C interface; nvcc
compiles them for sm_90a into one shared library, which is loaded with
ctypes.  The build runs at first use, on the machine with the card, into
rsn_torch/_build/ (git-ignored); the library's name carries a hash of
the sources, so an edited source is rebuilt and a stale library is never
loaded.  Nothing here runs at import time: the CPU test suite imports
every module on a machine without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("field_forward.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _sources_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build_library() -> Tuple[str, str]:
    """Compile the sources unless a library of the same digest exists.
    -> (path to the .so, nvcc's log; empty when nothing was built)."""
    path = os.path.join(BUILD_DIR, f"rsn_kernels-{_sources_digest()}.so")
    if os.path.isfile(path):
        return path, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *(os.path.join(CSRC_DIR, s) for s in SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build never sees half a file
    return path, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with every entry
    point's argtypes / restype declared."""
    path, _ = build_library()
    lib = ctypes.CDLL(path)
    vp, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    lib.rsn_field_forward_v3.argtypes = [vp, vp, vp, ptrs, vp,
                                         ctypes.c_longlong, ctypes.c_int, vp]
    lib.rsn_field_forward_v3.restype = ctypes.c_int
    lib.rsn_field_forward_density.argtypes = [vp, vp, ptrs, vp,
                                              ctypes.c_longlong, vp]
    lib.rsn_field_forward_density.restype = ctypes.c_int
    lib.rsn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rsn_cuda_error_string.restype = ctypes.c_char_p
    return lib
