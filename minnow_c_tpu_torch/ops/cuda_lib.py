"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``; the build runs
at first use and again whenever a source is newer than the library.
Compiled with ``-fmad=false``: the kernels name every rounding they want
(``__fadd_rn``, ``__fmaf_rn``), and a multiply-add contracted anywhere else
changes the frozen wire bits.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

from ._build import BUILD_DIR, build_locked

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libminnow_cuda.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
build_log = ""  # nvcc's output of the last build (ptxas register counts)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join("/usr/local/cuda", "bin", "nvcc")


def lib() -> ctypes.CDLL:
    """The loaded kernel library, building it if needed; raises
    RuntimeError when the build fails."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        sources = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
        log = build_locked(LIB_PATH, sources,
                           lambda out: [_nvcc(), *NVCC_FLAGS, "-o", out,
                                        *sources])
        if log is not None:
            build_log = log
        l = ctypes.CDLL(LIB_PATH)
        p, i64, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_uint32,
                                 ctypes.c_float)
        l.mnw_decode_uniform.restype = i32
        l.mnw_decode_uniform.argtypes = [p, i64, u32, u32, f32, f32, f32,
                                         i64, i32, i64, i32, p, p]
        l.mnw_pack_uniform.restype = i32
        l.mnw_pack_uniform.argtypes = [p, i64, i32, i32, p, i64, p]
        l.mnw_cuda_error_string.restype = ctypes.c_char_p
        l.mnw_cuda_error_string.argtypes = [i32]
        _lib = l
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().mnw_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
