"""BSD-style rotating checksum (util_Checksum, util.c:438-445).

The recurrence ``c = ror1(c) + byte`` is carry-coupled and therefore
inherently sequential per stream -- a poor fit for the TPU vector units --
so it runs on the host in native code, parallelized across independent
fields/blocks by the callers (per-field checksums: funcs.c:72; per-block
checksums: header_format.tex:179-196).

Init value: the reference *code* initializes to 1 (util.c:439) while the
*spec* says 0xff so that an error zeroing both data and checksum is still
detected (header_format.tex:381-393).  We follow the spec -- CHECKSUM_INIT =
0xff -- and record the divergence here.  A ``init`` parameter keeps the
code-parity value expressible for tests.
"""

from __future__ import annotations

import numpy as np

from . import native

CHECKSUM_INIT = 0xFF  # spec value (header_format.tex:382); code uses 1


def checksum(data, init: int = CHECKSUM_INIT) -> int:
    """Checksum of a byte buffer (bytes, bytearray, or uint8 ndarray)."""
    if isinstance(data, np.ndarray):
        arr = np.ascontiguousarray(data.view(np.uint8).reshape(-1))
    else:
        arr = np.frombuffer(bytes(data), dtype=np.uint8)
    if arr.size == 0:
        return init & 0xFFFFFFFF
    return int(native.lib().mnw_checksum(arr.ctypes.data, arr.size,
                                         init & 0xFFFFFFFF))


def checksum_py(data, init: int = CHECKSUM_INIT) -> int:
    """Pure-python reference implementation (slow; used to validate the
    native kernel)."""
    c = init & 0xFFFFFFFF
    for b in bytes(data):
        c = ((c >> 1) + ((c & 1) << 31)) & 0xFFFFFFFF
        c = (c + b) & 0xFFFFFFFF
    return c
