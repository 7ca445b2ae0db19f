"""ctypes bindings to the native host library (LZ4, checksum, host pack).

The C++ source is the JAX package's ``minnow_c_tpu/native/minnow_native.cpp``,
compiled read-only with the flags of ``minnow_c_tpu/native/Makefile`` into
this package's git-ignored build directory (``_build/``), so the two
packages share one implementation of the wire's entropy coder and checksum
without this package importing the other.  The library is built on first
use and again whenever the source is newer than it.  All entry points
release the GIL for the duration of the call.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ._build import BUILD_DIR, build_locked

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "minnow_c_tpu", "native",
    "minnow_native.cpp")
_LIB_PATH = os.path.join(BUILD_DIR, "libminnow_native.so")
# The flags of minnow_c_tpu/native/Makefile.
_CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-Werror",
             "-march=native", "-shared"]

_lock = threading.Lock()
_lib = None


def lib() -> ctypes.CDLL:
    """The loaded native library, building it if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        build_locked(_LIB_PATH, [_SRC],
                     lambda out: ["g++", *_CXXFLAGS, "-o", out, _SRC])
        l = ctypes.CDLL(_LIB_PATH)

        l.mnw_checksum.restype = ctypes.c_uint32
        l.mnw_checksum.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_uint32]

        l.mnw_lz4_compress_bound.restype = ctypes.c_int32
        l.mnw_lz4_compress_bound.argtypes = [ctypes.c_int32]

        l.mnw_lz4_compress.restype = ctypes.c_int32
        l.mnw_lz4_compress.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32]

        l.mnw_lz4_decompress.restype = ctypes.c_int32
        l.mnw_lz4_decompress.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_void_p, ctypes.c_int32]

        l.mnw_uniform_pack.restype = None
        l.mnw_uniform_pack.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_void_p,
                                       ctypes.c_int32]

        l.mnw_uniform_unpack.restype = None
        l.mnw_uniform_unpack.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                         ctypes.c_int32, ctypes.c_void_p,
                                         ctypes.c_int32]
        _lib = l
        return _lib


def uniform_pack_host(x: np.ndarray, width: int) -> np.ndarray:
    """Host bitpack oracle (bit-exact vs the device pack)."""
    from . import bitpack
    if not (0 <= width <= 32):
        raise ValueError(f"width {width} not in [0, 32]")
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D array, got shape {x.shape}")
    n_words = bitpack.packed_words(x.size, width)
    out = np.zeros(n_words, dtype=np.uint32)
    lib().mnw_uniform_pack(x.ctypes.data, x.size, width, out.ctypes.data,
                           n_words)
    return out


def uniform_unpack_host(x: np.ndarray, width: int, n: int) -> np.ndarray:
    if not (0 <= width <= 32):
        raise ValueError(f"width {width} not in [0, 32]")
    x = np.ascontiguousarray(x, dtype=np.uint32)
    if x.ndim != 1:
        raise ValueError(f"expected a 1-D array, got shape {x.shape}")
    out = np.zeros(n, dtype=np.uint32)
    lib().mnw_uniform_unpack(x.ctypes.data, x.size, width,
                             out.ctypes.data, n)
    return out
