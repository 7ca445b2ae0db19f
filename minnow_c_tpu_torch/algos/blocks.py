"""Shared block machinery for compression algorithms.

Every block an algorithm emits is self-describing::

    prelude (16 B, little-endian):
        u32 raw_len     payload bytes before entropy coding
        u32 comp_len    payload bytes as stored (== raw_len if not coded)
        u8  width       bit width of packed data (0 for metadata blocks)
        u8  flags       bit0: LZ4 entropy-coded; bits 1-7 reserved (0)
        u16 reserved
        u32 reserved2
    payload (comp_len B), zero-padded to an 8-byte boundary

The prelude makes field blobs self-delimiting (parseable without the
segment block table) and carries the uncompressed size the LZ4 backend
needs out-of-band (util.c:423-429).  Stored block length is always a
multiple of 8, satisfying the spec's alignment rule
(header_format.tex:198-204).

Like util.c for the reference's algorithms, this module is *load-bearing
for frozen codec versions*: changes to the wire behavior here require a
minor-version bump of every algorithm that uses it
(header_format.tex:266-276).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops import entropy
from ..segment.stream import Reader, Writer

FLAG_LZ4 = 1
_KNOWN_FLAGS = FLAG_LZ4  # bits 1-7 reserved; no writer ever sets them

PRELUDE_BYTES = 16
_MAX_BLOCK_PAYLOAD = 0xFFFFFFFF  # prelude lengths are u32


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def encode_block(payload, width: int = 0, try_entropy: bool = True,
                 accel: int = 1) -> bytes:
    """Wrap a payload (bytes or ndarray) into a self-describing block,
    entropy-coding it when that helps."""
    if isinstance(payload, np.ndarray):
        payload = np.ascontiguousarray(payload)
        payload = payload.astype(payload.dtype.newbyteorder("<"),
                                 copy=False).tobytes()
    from ..utils.debug import debug_assert
    debug_assert(0 <= width <= 64, f"block width {width} out of range")
    raw_len = len(payload)
    if raw_len > _MAX_BLOCK_PAYLOAD:
        raise ValueError(
            f"block payload of {raw_len} bytes exceeds the u32 prelude "
            "length; split the field into more blocks (spec table 1)")
    flags = 0
    stored = payload
    if try_entropy and raw_len > 0:
        comp = entropy.encode(payload, accel)
        if len(comp) < raw_len:
            stored = comp
            flags |= FLAG_LZ4
    w = Writer()
    w.u32(raw_len).u32(len(stored)).u8(width).u8(flags).u16(0).u32(0)
    w.raw(stored).align(8)
    return w.data


def decode_block(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Unwrap a block: returns (payload uint8 array, width, flags)."""
    r = Reader(data)
    raw_len = r.u32()
    comp_len = r.u32()
    width = r.u8()
    flags = r.u8()
    r.u16()
    r.u32()
    if flags & ~_KNOWN_FLAGS:
        raise ValueError(f"unknown block flag bits {flags:#x}; refusing "
                         "to return misdecoded payload")
    stored = r.raw(comp_len)
    if flags & FLAG_LZ4:
        payload = entropy.decode(stored, raw_len)
    else:
        if comp_len != raw_len:
            raise ValueError("block comp_len != raw_len without entropy flag")
        payload = np.frombuffer(stored, dtype=np.uint8)
    return payload, width, flags


def split_blocks(blob: bytes) -> list:
    """Split a concatenated field blob back into blocks using the
    self-delimiting preludes."""
    out = []
    off = 0
    n = len(blob)
    while off < n:
        if off + PRELUDE_BYTES > n:
            raise ValueError("truncated block prelude")
        comp_len = int.from_bytes(blob[off + 4:off + 8], "little")
        total = PRELUDE_BYTES + _pad8(comp_len)
        if off + total > n:
            raise ValueError("truncated block payload")
        out.append(blob[off:off + total])
        off += total
    return out


def bits_needed(v: int) -> int:
    """Minimal bit width that represents v (0 -> width 0)."""
    return int(v).bit_length()
