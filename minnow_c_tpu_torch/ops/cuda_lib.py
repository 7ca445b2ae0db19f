"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The kernels are compiled by ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with ``ctypes``; the build runs
at first use and again whenever a source is newer than the library.  Each
source compiles in its own ``nvcc`` process, all started together, and one
more links the objects.  Compiled with ``-fmad=false``: the kernels name
every rounding they want (``__fadd_rn``, ``__fmaf_rn``), and a multiply-add
contracted anywhere else changes the frozen wire bits.  Compiled with
``-ftz=true``: f32 subnormals flush to zeros of their sign, as XLA's do on
the CPU (``kernels.ftz``); the kernels also flush explicitly where a raw
value could pass through without arithmetic (``csrc/bins.cuh``).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch

from ._build import BUILD_DIR, build_locked, run_all

CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
LIB_PATH = os.path.join(BUILD_DIR, "libminnow_cuda.so")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-O3", "-std=c++17", "-Xcompiler", "-fPIC",
              "-fmad=false", "-ftz=true", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
_sms = {}
build_log = ""  # nvcc's output of the last build (ptxas register counts)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join("/usr/local/cuda", "bin", "nvcc")


def _build(out: str, sources) -> str:
    """Compile every source at once, then link them into ``out``."""
    objs = [f"{out}.{os.path.basename(s)}.o" for s in sources]
    try:
        log = run_all([[_nvcc(), *NVCC_FLAGS, "-c", s, "-o", o]
                       for s, o in zip(sources, objs)])
        return log + run_all([[_nvcc(), *ARCH, "-shared", "-o", out,
                               *objs]])
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)


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
        headers = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
        log = build_locked(LIB_PATH, sources + headers,
                           lambda out: _build(out, sources))
        if log is not None:
            build_log = log
        l = ctypes.CDLL(LIB_PATH)
        p, i64, i32, u32, f32 = (ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_int, ctypes.c_uint32,
                                 ctypes.c_float)
        l.mnw_decode_tiles.restype = i32
        l.mnw_decode_tiles.argtypes = [p, i64, i64, i64, u32, i64, i32, i32,
                                       p, i64, i64, p, p, u32, u32, f32, f32,
                                       u32, f32, i32, i32, u32, i32, p, p]
        l.mnw_unpack_rows.restype = i32
        l.mnw_unpack_rows.argtypes = [p, i64, i64, i64, i32, i32, i32, u32,
                                      i32, p, p]
        l.mnw_pack_tiles.restype = i32
        l.mnw_pack_tiles.argtypes = [p, i64, i32, i32, i64, i32, i32, u32,
                                     i32, p, i64, p]
        l.mnw_stats_rows.restype = i32
        l.mnw_stats_rows.argtypes = [p, i64, i64, i32, p, p, i32, p, p, p,
                                     p]
        l.mnw_pack_recip_tiles.restype = i32
        l.mnw_pack_recip_tiles.argtypes = [p, i64, i32, i64, i32, i32, u32,
                                           i32, u32, u32, p, p, p, p, f32,
                                           f32, f32, f32, i32, p, i64, p]
        l.mnw_encode_recip_fused.restype = i32
        l.mnw_encode_recip_fused.argtypes = [p, i64, i64, i64, i32, f32, p,
                                             i32, i32, i32, i32, i32, u32, p,
                                             p, p, p, p, p]
        l.mnw_cumsum_u32.restype = i32
        l.mnw_cumsum_u32.argtypes = [p, i64, i64, u32, i32, p, p, p]
        l.mnw_chunked_decode.restype = i32
        l.mnw_chunked_decode.argtypes = [p, p, i64, p, p, p, i64, i32, i32,
                                         u32, p, i32, u32, u32, f32, f32,
                                         f32, i32, p, p]
        l.mnw_chunked_blocks_per_sm.restype = i32
        l.mnw_chunked_blocks_per_sm.argtypes = [i32]
        l.mnw_chunked_event.restype = p
        l.mnw_chunked_event.argtypes = []
        l.mnw_cuda_error_string.restype = ctypes.c_char_p
        l.mnw_cuda_error_string.argtypes = [i32]
        _lib = l
        return _lib


def row_magic(n: int) -> int:
    """The magic number of ``csrc/rows.cuh`` for rows of ``n`` elements,
    2 <= n <= 2^31: floor(2^32 / n) (a u32), with which the kernels divide
    an in-row offset below 2^32 by n in 32 bits (one correction step)."""
    if not 2 <= n <= 1 << 31:
        raise ValueError(f"a row of {n} elements is outside [2, 2^31]")
    return (1 << 32) // n


def sm_count(device) -> int:
    """The number of SMs of a CUDA ``device`` (the persistent grids'
    size)."""
    index = torch.device(device).index
    if index is None:
        index = torch.cuda.current_device()
    if index not in _sms:
        _sms[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return _sms[index]


def current_stream(device: torch.device) -> tuple:
    """(index, raw current stream) of CUDA ``device``."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return index, torch._C._cuda_getCurrentRawStream(index)


def launch(what: str, entry, device: torch.device, *args) -> None:
    """Call the C entry point ``entry(*args, stream)`` on the current
    stream of CUDA ``device``; raise if it returns a CUDA error code."""
    launch_on(what, entry, *current_stream(device), *args)


def launch_on(what: str, entry, index: int, stream: int, *args) -> None:
    """``entry(*args, stream)`` with device ``index`` made the current
    device for the call only when it is not already (the guard costs host
    time on every launch); raise if it returns a CUDA error code."""
    if index == torch._C._cuda_getDevice():
        rc = entry(*args, stream)
    else:
        with torch.cuda.device(index):
            rc = entry(*args, stream)
    check(rc, what)


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib().mnw_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")
