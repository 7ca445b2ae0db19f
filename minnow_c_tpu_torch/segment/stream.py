"""Little-endian byte stream writer/reader.

Equivalent of the reference's ``src/stream.{h,c}`` + the growable byte
sequences it writes into (``src/base_seq.c``).  The reference's stream layer
is pass-by-value and loses reader offsets / writer reallocations
(stream.c:19-28,54-87, SURVEY.md section 2 row 7); these are stateful
objects, which fixes that by construction.

All multi-byte values are little-endian on the wire (header_format.tex
section "Endianness"); numpy handles byte order explicitly so the code is
endian-portable without the reference's mock-endian compile flags.
"""

from __future__ import annotations

import struct

import numpy as np


class Writer:
    """Append-only little-endian writer (stream_NewWriter/stream_Write,
    stream.c:9-17,54-87).

    Backed by a growable bytearray: amortized growth mirrors the sequence
    layer's x1.25-rounded-to-8 policy (base_seq.c:8,96-97) via Python's
    bytearray, which has the same amortized-doubling contract.
    """

    def __init__(self):
        self._buf = bytearray()

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def data(self) -> bytes:
        return bytes(self._buf)

    def u8(self, v: int) -> "Writer":
        self._buf += struct.pack("<B", v)
        return self

    def u16(self, v: int) -> "Writer":
        self._buf += struct.pack("<H", v)
        return self

    def u32(self, v: int) -> "Writer":
        self._buf += struct.pack("<I", v & 0xFFFFFFFF)
        return self

    def i32(self, v: int) -> "Writer":
        self._buf += struct.pack("<i", v)
        return self

    def u64(self, v: int) -> "Writer":
        self._buf += struct.pack("<Q", v)
        return self

    def i64(self, v: int) -> "Writer":
        self._buf += struct.pack("<q", v)
        return self

    def f32(self, v: float) -> "Writer":
        self._buf += struct.pack("<f", v)
        return self

    def raw(self, b) -> "Writer":
        if isinstance(b, np.ndarray):
            b = np.ascontiguousarray(b)
            if b.dtype.byteorder == ">":  # force little-endian on the wire
                b = b.astype(b.dtype.newbyteorder("<"))
            b = b.tobytes()
        self._buf += b
        return self

    def array(self, arr: np.ndarray) -> "Writer":
        """Write an array in little-endian element order."""
        arr = np.ascontiguousarray(arr)
        le = arr.astype(arr.dtype.newbyteorder("<"), copy=False)
        self._buf += le.tobytes()
        return self

    def align(self, n: int = 8) -> "Writer":
        """Zero-pad to an n-byte boundary (spec alignment rule,
        header_format.tex:198-204)."""
        rem = len(self._buf) % n
        if rem:
            self._buf += bytes(n - rem)
        return self

    def patch_u32(self, offset: int, v: int) -> None:
        """Back-patch a u32 written earlier (used for header checksums)."""
        self._buf[offset:offset + 4] = struct.pack("<I", v & 0xFFFFFFFF)

    def view(self, start: int, stop: int) -> bytes:
        """Bytes of a written span (copies only the span, unlike
        ``data`` which copies the whole buffer)."""
        return bytes(self._buf[start:stop])


class StreamUnderflowError(EOFError, ValueError):
    """Wire data ended early.  Subclasses both EOFError (the historic
    type callers catch) and ValueError (the package's documented
    corrupt-input contract), so either handler style works."""


class Reader:
    """Offset-tracking little-endian reader (stream_NewReader/stream_Read,
    stream.c:29-52,89-110)."""

    def __init__(self, data: bytes, offset: int = 0):
        self._data = memoryview(data)
        self.offset = offset

    def __len__(self) -> int:
        return len(self._data)

    @property
    def remaining(self) -> int:
        return len(self._data) - self.offset

    def _take(self, n: int) -> memoryview:
        if self.offset + n > len(self._data):
            raise StreamUnderflowError(
                f"stream underflow: need {n} bytes at offset {self.offset}, "
                f"only {self.remaining} remain")
        v = self._data[self.offset:self.offset + n]
        self.offset += n
        return v

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f32(self) -> float:
        return struct.unpack("<f", self._take(4))[0]

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def array(self, dtype, count: int) -> np.ndarray:
        dt = np.dtype(dtype).newbyteorder("<")
        out = np.frombuffer(self._take(dt.itemsize * count), dtype=dt)
        return out.astype(np.dtype(dtype), copy=False)

    def align(self, n: int = 8) -> None:
        rem = self.offset % n
        if rem:
            self._take(n - rem)

    def peek_u32(self) -> int:
        return struct.unpack(
            "<I", self._data[self.offset:self.offset + 4])[0]
