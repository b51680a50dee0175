"""ctypes binding of the native PNG loader (loader.cpp, rsn's
rsn/data/native/loader.cpp unchanged): `probe_png` and
`decode_png_batch`, a pthread pool that decodes 8-bit non-interlaced
gray / RGB / gray + alpha / RGBA PNGs and blends alpha to white in C.

g++ builds the library at first use, with rsn's flags, into
rsn_torch/_build/ (git-ignored).  Its name carries a hash of the source,
the flags and the host's CPU (the flags hold -march=native), so an edited
source is rebuilt and a library built for another CPU is never loaded.
A failed build raises with the compiler's output: the port has no PIL to
fall back to.  A file the library cannot decode (palette, 16-bit,
interlaced, another size) is not an error here: probe_png and
decode_png_batch return None, and the loaders read it with
rsn_torch.data.png, as rsn reads it with PIL.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "loader.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "_build")
# rsn/data/native/__init__.py's flags: with -march=native g++ contracts
# the alpha blend into FMAs, and the port's images equal rsn's bit for bit
# only from the same code
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-lz", "-lpthread")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _cpu_identity() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            lines = f.read().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = (b"model name", b"flags")
    return b"\n".join(sorted({ln for ln in lines if ln.startswith(keep)}))


def library_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(_cpu_identity())
    return os.path.join(BUILD_DIR, f"loader-{h.hexdigest()[:16]}.so")


def _build(path: str) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native PNG loader "
                           f"({SOURCE}) is built from source at first use")
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [cxx, *FLAGS, SOURCE, "-o", tmp, *LIBS]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, path)  # atomic: no half-written library


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if it is missing."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not os.path.isfile(path):
                _build(path)
            lib = ctypes.CDLL(path)
            lib.rsn_decode_png_batch.restype = ctypes.c_int
            lib.rsn_decode_png_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.c_int]
            lib.rsn_probe_png.restype = ctypes.c_int
            lib.rsn_probe_png.argtypes = [ctypes.c_char_p,
                                          ctypes.POINTER(ctypes.c_int),
                                          ctypes.POINTER(ctypes.c_int)]
            _lib = lib
        return _lib


def probe_png(path: str) -> Optional[Tuple[int, int]]:
    """-> (height, width), or None when the library cannot decode the
    file."""
    h, w = ctypes.c_int(), ctypes.c_int()
    if get_lib().rsn_probe_png(path.encode(), ctypes.byref(h),
                               ctypes.byref(w)) != 0:
        return None
    return h.value, w.value


def decode_png_batch(paths: List[str], height: int, width: int,
                     blend_white: bool = True,
                     num_threads: int = 0) -> Optional[np.ndarray]:
    """Decode PNGs in parallel -> (N, H, W, 3) float32 in [0, 1]; None
    when an image fails (another format or size)."""
    if not paths:
        return None
    lib = get_lib()
    out = np.empty((len(paths), height, width, 3), np.float32)
    names = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
    rc = lib.rsn_decode_png_batch(
        names, len(paths), height, width, int(blend_white),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), num_threads)
    return out if rc == 0 else None
