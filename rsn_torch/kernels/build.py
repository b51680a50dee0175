"""Build and load the port's CUDA kernels.

Each source under rsn_torch/csrc/ has a plain C interface; nvcc compiles
it for sm_90a into its own shared library, which is loaded with ctypes.
The sources are compiled in parallel (one nvcc per source, all started
together).  The build runs at first use, on the machine with the card,
into rsn_torch/_build/ (git-ignored); a library's name carries a hash of
its source, the shared header and the flags, so an edited source is
rebuilt and a stale library is never loaded.  nvcc's output (with
ptxas's registers and spills) is kept beside each library.  Nothing here
runs at import time: the CPU test suite imports every module on a machine
without nvcc.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Callable, Dict, Tuple

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCES = ("field_forward.cu", "field_train.cu", "proposal_forward.cu",
           "experiments.cu", "experiments_bwd.cu")
HEADERS = ("field_common.cuh", "trunk_sm90.cuh", "train_sm90.cuh",
           "wgrad_sm90.cuh", "unfolded_sm90.cuh", "heads_sm90.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from source at first use")


def _library_path(source: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (source,) + HEADERS:
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")


def _log_path(library: str) -> str:
    return os.path.splitext(library)[0] + ".log"


def build_log(source: str) -> str:
    """nvcc's output (ptxas's registers and spills, -Xptxas -v) from the
    build of `source`'s current library; empty if it was not built here."""
    try:
        with open(_log_path(_library_path(source))) as f:
            return f.read()
    except FileNotFoundError:
        return ""


def build_library() -> Tuple[Dict[str, str], str]:
    """Compile every source whose library is missing, all at once.
    -> ({source: path to its .so}, nvcc's logs; empty when nothing was
    built)."""
    paths = {s: _library_path(s) for s in SOURCES}
    todo = [s for s in SOURCES if not os.path.isfile(paths[s])]
    if not todo:
        return paths, ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = find_nvcc()
    jobs = []
    for s in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, s)]
        jobs.append((s, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for s, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"--- {s}\n{out}")
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{out}")
        else:
            with open(_log_path(paths[s]), "w") as f:
                f.write(out)
            os.replace(tmp, paths[s])  # atomic: no half-written library
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths, "\n".join(logs)


def sass(source: str) -> str:
    """cuobjdump -sass of the port's current library of `source` (built
    first if it is missing)."""
    paths, _ = build_library()
    cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", paths[source]],
                          capture_output=True, text=True,
                          check=True).stdout


def start_variant(source: str, macros, tag: str, csrc: str = CSRC_DIR):
    """Start nvcc on `source` of the directory `csrc` (the port's own
    sources by default; another checkout's to compare with it) with
    -D`macros` (a design kept for a check or an ablation, which the port's
    own build never compiles) into rsn_torch/_build/variants/, beside
    the port's build -> a function that waits for it and returns (the
    loaded library, nvcc's output)."""
    out_dir = os.path.join(BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, f"{os.path.splitext(source)[0]}-{tag}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, *(f"-D{m}" for m in macros), "-o", lib,
           os.path.join(csrc, source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def done() -> Tuple[ctypes.CDLL, str]:
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {source} {macros}:\n{text}")
        handle = ctypes.CDLL(lib)
        _declare(handle, source)
        return handle, text
    return done


def finish_variants(waiting: Dict[str, Callable[[], Tuple[ctypes.CDLL,
                                                           str]]]):
    """Wait for every build of {name: start_variant(...)} -> ({name: the
    loaded library}, {name: nvcc's output}); raises once all have ended,
    with every failure."""
    libs, logs, failed = {}, {}, []
    for name, done in waiting.items():
        try:
            libs[name], logs[name] = done()
        except RuntimeError as e:
            failed.append(f"{name}: {e}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return libs, logs


def _signatures() -> Dict[str, Dict[str, list]]:
    """Each source's entry points and their argtypes (every one returns a
    cudaError_t code as an int)."""
    vp, ptrs = ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)
    ll, i32 = ctypes.c_longlong, ctypes.c_int
    lls = ctypes.POINTER(ctypes.c_longlong)
    return {
        "field_forward.cu": {
            "rsn_field_forward_v3": [vp, vp, vp, vp, ptrs, vp, ll, i32, vp],
            "rsn_field_forward_density": [vp, vp, vp, ptrs, vp, ll, vp],
            "rsn_field_forward_v2": [vp, vp, vp, ptrs, vp, ll, vp],
            "rsn_field_forward": [vp, vp, ptrs, vp, ll, vp],
            "rsn_mma_probe": [vp, vp, vp, vp, vp, vp],
        },
        "field_train.cu": {
            "rsn_field_forward_v6": [vp, vp, vp, vp, ptrs, vp, vp, ll, i32,
                                     i32, i32, vp],
            "rsn_field_backward_v5": [vp, vp, vp, vp, vp, vp, ptrs, vp, vp,
                                      vp, vp, ll, i32, i32, i32, i32, vp],
            "rsn_field_backward_v6": [vp, vp, vp, vp, ptrs, vp, vp, vp, ll,
                                      i32, i32, i32, i32, vp],
            "rsn_field_forward_v4": [vp, vp, vp, vp, ptrs, vp, ll, i32, i32,
                                     vp],
            "rsn_pack_train_blob": [ptrs, lls, i32, vp, vp],
            "rsn_field_backward_v4": [vp, vp, vp, vp, vp, ptrs, vp, vp, vp,
                                      vp, vp, ll, i32, i32, i32, i32, vp],
            "rsn_wgrad_sm90": [vp, vp, ll, i32, i32, vp],
            "rsn_field_forward_v5": [vp, vp, vp, ptrs, vp, ll, i32, i32, vp],
            "rsn_field_backward_v3": [vp, vp, vp, vp, vp, ptrs, vp, vp, vp,
                                      vp, vp, vp, ll, i32, i32, vp],
            "rsn_field_backward_whole": [vp, vp, vp, vp, vp, ptrs, vp, vp,
                                         vp, vp, vp, ll, i32, i32, vp],
            "rsn_field_backward_whole_stash": [vp, vp, vp, vp, vp, ptrs, vp,
                                               vp, vp, vp, vp, vp, ll, i32,
                                               i32, i32, i32, vp],
            "rsn_field_backward_v3_sum": [vp, i32, vp, i32, vp, vp],
        },
        "proposal_forward.cu": {
            "rsn_prop_forward": [vp, vp, ptrs, vp, ll, vp],
        },
        "experiments.cu": {
            "rsn_field_forward_v3u": [vp, vp, vp, vp, ptrs, vp, ll, i32,
                                      vp],
            "rsn_field_forward_v3i": [vp, vp, vp, vp, ptrs, vp, ll, i32,
                                      vp],
            "rsn_field_forward_v3L": [vp, vp, vp, vp, ptrs, vp, ll, i32, i32,
                                      vp],
            "rsn_cheap_sin": [vp, vp, ll, i32, vp],
        },
        "experiments_bwd.cu": {
            "rsn_bwd_ablate": [vp, vp, vp, vp, ptrs, vp, vp, vp, vp, ll, i32,
                               i32, i32, vp],
            "rsn_bwd_noipe": [vp, vp, vp, ptrs, vp, vp, ll, i32, i32, vp],
            "rsn_bwd_ablate_stash": [vp, vp, vp, vp, ptrs, vp, vp, vp, vp,
                                     vp, vp, ll, i32, i32, i32, i32, vp],
            "rsn_bwd_noipe_stash": [vp, vp, vp, ptrs, vp, vp, vp, ll, i32,
                                    i32, i32, i32, vp],
            "rsn_wgrad_unfolded": [vp, vp, ll, i32, i32, vp],
        },
    }


def _declare(lib: ctypes.CDLL, source: str) -> None:
    for name, argtypes in _signatures()[source].items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.rsn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.rsn_cuda_error_string.restype = ctypes.c_char_p


@functools.lru_cache(maxsize=None)
def load_library(source: str = "field_forward.cu") -> ctypes.CDLL:
    """Build (if needed) and load the library of one source, with every
    entry point's argtypes / restype declared."""
    paths, _ = build_library()
    lib = ctypes.CDLL(paths[source])
    _declare(lib, source)
    return lib
