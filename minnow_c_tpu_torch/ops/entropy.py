"""Entropy backend: LZ4 block-format compression of byte streams.

Replaces the reference's vendored lz4 submodule behind
``util_EntropyEncode`` / ``util_UndoEntropyEncode`` (util.c:408-436).  Like
the reference, the uncompressed size is *not* stored here -- callers carry
it out-of-band in their block headers (util.c:423-429 requires the same).

The codec is our own native implementation of the public LZ4 block format
(``native/minnow_native.cpp``); it is wire-compatible with standard LZ4, and
the test suite cross-checks against the system ``liblz4`` when present.

``decode_into`` decodes into a buffer the caller holds (the snapshot
reader's rows).  ``encode_blocks`` / ``decode_blocks`` fan independent
buffers across a thread pool -- the native calls release the GIL, so
this is the host-side "shared memory parallelization" the spec assigns
to minnow (header_format.tex:58-59).
"""

from __future__ import annotations

import concurrent.futures as _futures
import os
from typing import List, Sequence

import numpy as np

from . import native

_MAX_WORKERS = min(32, (os.cpu_count() or 4))
_pool = None
_pool_lock = __import__("threading").Lock()


def _get_pool():
    global _pool
    if _pool is None:
        with _pool_lock:  # first-use race would leak a second pool
            if _pool is None:
                _pool = _futures.ThreadPoolExecutor(
                    max_workers=_MAX_WORKERS)
    return _pool


def compress_bound(n: int) -> int:
    return int(native.lib().mnw_lz4_compress_bound(n))


def encode(data, accel: int = 1) -> bytes:
    """LZ4-compress one buffer (util_EntropyEncode, util.c:408-421)."""
    return encode_view(data, accel).tobytes()


def encode_view(data, accel: int = 1) -> np.ndarray:
    """``encode``'s bytes as a uint8 view into a buffer of their own, of
    ``compress_bound`` bytes: no copy of the written bytes."""
    arr = _to_u8(data)
    n = arr.size
    if n > 0x7E000000:  # LZ4 block format limit; beyond it the i32
        # narrowing would silently truncate the length
        raise ValueError(
            f"buffer of {n} bytes exceeds the LZ4 block limit "
            "(0x7E000000); segment the field (spec table 1)")
    bound = compress_bound(n)
    out = np.empty(bound, dtype=np.uint8)
    written = native.lib().mnw_lz4_compress(arr.ctypes.data, n,
                                            out.ctypes.data, bound, accel)
    if written <= 0 and n > 0:
        raise RuntimeError("LZ4 compression failed")
    return out[:written]


def decode(data, uncompressed_size: int) -> np.ndarray:
    """LZ4-decompress one buffer (util_UndoEntropyEncode, util.c:423-436).
    ``uncompressed_size`` must be supplied out-of-band."""
    arr = _to_u8(data)
    out = np.empty(uncompressed_size, dtype=np.uint8)
    if uncompressed_size == 0:
        return out
    consumed = native.lib().mnw_lz4_decompress(arr.ctypes.data, arr.size,
                                               out.ctypes.data,
                                               uncompressed_size)
    if consumed < 0:
        raise ValueError("malformed LZ4 stream")
    return out


def decode_into(data, out: np.ndarray) -> None:
    """``decode`` into the bytes of ``out`` (a writable C-contiguous array,
    whose size in bytes is the uncompressed size): no buffer of its own.
    Raises ValueError as ``decode`` does, on a malformed stream or one that
    decodes to another size than ``out``'s."""
    if not (out.flags.c_contiguous and out.flags.writeable):
        raise ValueError("LZ4 decode needs a writable C-contiguous "
                         "destination")
    dst = out.reshape(-1).view(np.uint8)
    if dst.size == 0:
        return
    arr = _to_u8(data)
    consumed = native.lib().mnw_lz4_decompress(arr.ctypes.data, arr.size,
                                               dst.ctypes.data, dst.size)
    if consumed < 0:
        raise ValueError("malformed LZ4 stream")


def pool_map(fn, *items) -> list:
    """``fn`` over independent items (``map``'s arguments) in the pool's
    host threads, results in order; one item runs in this thread.  The
    native calls release the GIL."""
    if len(items[0]) <= 1:
        return list(map(fn, *items))
    return list(_get_pool().map(fn, *items))


def encode_blocks(blocks: Sequence, accel: int = 1) -> List[bytes]:
    """Compress independent blocks in parallel host threads."""
    return pool_map(lambda b: encode(b, accel), blocks)


def decode_blocks(blocks: Sequence, sizes: Sequence[int]) -> List[np.ndarray]:
    """Decompress independent blocks in parallel host threads."""
    return pool_map(decode, blocks, sizes)


def _to_u8(data) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data.reshape(-1).view(np.uint8))
    return np.frombuffer(bytes(data), dtype=np.uint8)
