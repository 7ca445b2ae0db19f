"""Suggested I/O format: chained IOHeaders for multi-segment files.

Implements the spec's IOHeader (header_format.tex:209-218)::

    struct IOHeader {
        uint32_t Magic;        // 'Mnw\\0' tag for *.min files
        uint32_t Version;      // library semver (non-algorithm code)
        float    Origin[3];    // segment bounding-box origin
        float    Width[3];     // segment bounding-box extent
        uint64_t SegmentBytes; // payload size that follows
        uint64_t NextIOHeader; // absolute offset of next header, 0 = end
    };                         // 48 bytes

``NextIOHeader`` chaining gives skip-ahead iteration over multi-segment
files without parsing segment bodies (header_format.tex:209-218,
SURVEY.md "checkpoint/resume").
"""

from __future__ import annotations

import io as _io
from dataclasses import dataclass
from typing import BinaryIO, Iterator, Optional, Sequence, Tuple

from .. import semver
from .stream import Reader, Writer

MAGIC = 0x00776E4D  # little-endian u32 -> b'Mnw\0' on disk
LIBRARY_VERSION = semver.pack(1, 0, 0)
IO_HEADER_BYTES = 48


@dataclass
class IOHeader:
    magic: int
    version: int
    origin: Tuple[float, float, float]
    width: Tuple[float, float, float]
    segment_bytes: int
    next_io_header: int

    def pack(self) -> bytes:
        w = Writer()
        w.u32(self.magic).u32(self.version)
        for v in self.origin:
            w.f32(v)
        for v in self.width:
            w.f32(v)
        w.u64(self.segment_bytes).u64(self.next_io_header)
        return w.data

    @classmethod
    def unpack(cls, data: bytes) -> "IOHeader":
        r = Reader(data)
        magic = r.u32()
        if magic != MAGIC:
            raise ValueError(f"bad magic {magic:#x}; not a minnow file")
        return cls(magic=magic, version=r.u32(),
                   origin=(r.f32(), r.f32(), r.f32()),
                   width=(r.f32(), r.f32(), r.f32()),
                   segment_bytes=r.u64(), next_io_header=r.u64())


def _parts(seg) -> Sequence:
    """A segment's buffers in write order: the list it is given as
    (``format.serialize_parts``), or the bytes alone."""
    return seg if isinstance(seg, (list, tuple)) else (seg,)


def segment_nbytes(seg) -> int:
    """Length of a segment given as bytes or as a list of buffers."""
    return sum(map(len, _parts(seg)))


def write_segments(fp: BinaryIO,
                   segments: Sequence,
                   geometry: Optional[Sequence[Tuple[Tuple[float, float,
                                                           float],
                                                     Tuple[float, float,
                                                           float]]]] = None
                   ) -> None:
    """Write segments with chained IOHeaders.  A segment is bytes, or a
    list of buffers written in order (``format.serialize_parts``).
    ``geometry[i]`` is the (origin, width) bounding box the client assigns
    to segment i (spatial indexing is client data, table 1 of the spec)."""
    write_segments_streaming(
        fp, ((seg, None if geometry is None else geometry[i])
             for i, seg in enumerate(segments)))


def write_segments_streaming(fp: BinaryIO, seg_iter) -> int:
    """Incremental variant of ``write_segments``: consume an iterator of
    ``(segment, (origin, width) | None)`` pairs, writing each segment
    (with its chained IOHeader) before pulling the next -- peak memory is
    one segment regardless of file size.  One-item lookahead resolves the
    last header's ``NextIOHeader = 0``.  Returns the number of segments
    written."""
    def write_one(item, offset, last):
        seg, geom = item
        org, wid = ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)) if geom is None \
            else geom
        parts = _parts(seg)
        n = sum(map(len, parts))
        next_off = 0 if last else offset + IO_HEADER_BYTES + n
        hd = IOHeader(magic=MAGIC, version=LIBRARY_VERSION, origin=org,
                      width=wid, segment_bytes=n, next_io_header=next_off)
        fp.write(hd.pack())
        for part in parts:
            fp.write(part)
        return next_off

    count = 0
    offset = fp.tell()
    prev = None
    for item in seg_iter:
        if prev is not None:
            offset = write_one(prev, offset, last=False)
            count += 1
        prev = item
    if prev is not None:
        write_one(prev, offset, last=True)
        count += 1
    return count


_SANE_U64 = 1 << 62  # IOHeaders carry no checksum: bound u64 fields so a
# corrupt value raises ValueError instead of OverflowError inside
# fp.seek/fp.read (C ssize_t limits)


def _advance(offset: int, hd: IOHeader) -> int:
    """Next chain offset; a corrupt NextIOHeader that fails to advance
    (IOHeaders carry no checksum) must error, not loop forever."""
    nxt = hd.next_io_header
    if nxt >= _SANE_U64:
        raise ValueError(
            f"corrupt IOHeader: NextIOHeader {nxt:#x} out of range")
    if nxt != 0 and nxt <= offset:
        raise ValueError(
            f"corrupt IOHeader chain: NextIOHeader {nxt:#x} does not "
            f"advance past {offset:#x}")
    return nxt


def append_segments(fp: BinaryIO, seg_iter) -> int:
    """Extend an existing chained file in place: walk the IOHeader chain
    from the current position, patch the last header's ``NextIOHeader``
    to point at the file end, and stream the new segments there.
    ``seg_iter`` yields ``(segment_bytes, (origin, width) | None)`` pairs
    (as in :func:`write_segments_streaming`).  ``fp`` must be opened for
    read+write.  Returns the number of segments appended.

    Segments are independent and self-describing, so appending never
    rewrites existing data -- only the 8-byte chain link is patched
    (the durability story: a crash mid-append leaves the original file
    intact apart from a link to a truncated tail, which iteration
    reports as a short read)."""
    import itertools as _itertools
    import struct as _struct
    start = fp.tell()
    last_off = None
    offset = start
    while True:
        fp.seek(offset)
        raw = fp.read(IO_HEADER_BYTES)
        if len(raw) < IO_HEADER_BYTES:
            if last_off is not None:
                raise ValueError("truncated IOHeader chain")
            break  # empty file: plain write from start
        hd = IOHeader.unpack(raw)
        last_off = offset
        nxt = _advance(offset, hd)
        if nxt == 0:
            break
        offset = nxt
    # Pull the first item BEFORE patching the chain link: an empty
    # iterator must leave the file untouched (a patched link with no
    # segment behind it would poison every later chain walk).
    it = iter(seg_iter)
    try:
        first = next(it)
    except StopIteration:
        return 0
    fp.seek(0, 2)
    end = fp.tell()
    if last_off is not None:
        fp.seek(last_off + 40)  # NextIOHeader is the trailing u64
        fp.write(_struct.pack("<Q", end))
        fp.seek(end)
    else:
        fp.seek(start)
    return write_segments_streaming(fp, _itertools.chain([first], it))


def _read_body(fp: BinaryIO, hd: IOHeader) -> bytes:
    """Read a segment body, validating the unchecksummed u64 length
    (a corrupt SegmentBytes must raise ValueError, not OverflowError
    inside fp.read or a misleading underflow later)."""
    if hd.segment_bytes >= _SANE_U64:
        raise ValueError(
            f"corrupt IOHeader: SegmentBytes {hd.segment_bytes:#x} "
            "out of range")
    seg = fp.read(hd.segment_bytes)
    if len(seg) < hd.segment_bytes:
        raise ValueError(
            f"truncated segment body: header claims "
            f"{hd.segment_bytes} bytes, file has {len(seg)}")
    return seg


def iter_segments(fp: BinaryIO,
                  all_chains: bool = False
                  ) -> Iterator[Tuple[IOHeader, bytes]]:
    """Iterate (header, segment bytes) pairs following the chain.

    A file may hold several consecutive chains (e.g. one per particle
    type in ``.il.min`` archives); by default iteration stops at the
    first chain's ``NextIOHeader = 0`` terminator with the file
    positioned at the next chain.  ``all_chains=True`` keeps going
    through every chain until end of file."""
    offset = fp.tell()
    while True:
        fp.seek(offset)
        raw = fp.read(IO_HEADER_BYTES)
        if len(raw) < IO_HEADER_BYTES:
            return
        hd = IOHeader.unpack(raw)
        yield hd, _read_body(fp, hd)
        nxt = _advance(offset, hd)
        if nxt == 0:
            if not all_chains:
                return
            nxt = offset + IO_HEADER_BYTES + hd.segment_bytes
        offset = nxt


def _interval_hits(o: float, w: float, qo: float, qw: float,
                   L: Optional[float]) -> bool:
    """1-D closed-interval intersection of [o, o+w] and [qo, qo+qw],
    modulo the periodic box length ``L`` when given."""
    if L is None:
        return o <= qo + qw and qo <= o + w
    # Wrap both interval starts into [0, L); an interval may straddle the
    # seam, in which case it is the union of two plain intervals.
    def pieces(a, w):
        if w >= L:
            return [(0.0, L)]  # interval covers the whole box
        a %= L
        if a + w >= L:  # straddles (or closed-touches) the periodic seam
            return [(a, L), (0.0, (a + w) - L)]
        return [(a, a + w)]
    return any(p0 <= q1 and q0 <= p1
               for p0, p1 in pieces(o, w)
               for q0, q1 in pieces(qo, qw))


def box_intersects(origin, width, q_origin, q_width,
                   periodic=None) -> bool:
    """Axis-aligned box intersection for skip-ahead spatial queries
    (header_format.tex:206-218).  A header whose Width is all zeros means
    the writer recorded no geometry: conservatively treated as
    intersecting everything.  ``periodic`` is an optional per-dim (or
    scalar) box length for wrap-aware comparison."""
    if all(w == 0.0 for w in width) and all(o == 0.0 for o in origin):
        return True
    for d in range(3):
        L = None
        if periodic is not None:
            L = float(periodic[d]) if hasattr(periodic, "__len__") \
                else float(periodic)
        if not _interval_hits(float(origin[d]), float(width[d]),
                              float(q_origin[d]), float(q_width[d]), L):
            return False
    return True


def iter_segments_intersecting(fp: BinaryIO, origin, width,
                               periodic=None, all_chains: bool = False
                               ) -> Iterator[Tuple[IOHeader, bytes]]:
    """Skip-ahead spatial query: yield only the (header, segment bytes)
    pairs whose IOHeader bounding box intersects the query box
    [origin, origin+width].  Non-matching segments are skipped without
    reading their bodies (seek straight to NextIOHeader).
    ``all_chains`` as in :func:`iter_segments`."""
    offset = fp.tell()
    while True:
        fp.seek(offset)
        raw = fp.read(IO_HEADER_BYTES)
        if len(raw) < IO_HEADER_BYTES:
            return
        hd = IOHeader.unpack(raw)
        if hd.segment_bytes >= _SANE_U64:
            raise ValueError(
                f"corrupt IOHeader: SegmentBytes {hd.segment_bytes:#x} "
                "out of range")
        if box_intersects(hd.origin, hd.width, origin, width, periodic):
            yield hd, _read_body(fp, hd)
        nxt = _advance(offset, hd)
        if nxt == 0:
            if not all_chains:
                return
            nxt = offset + IO_HEADER_BYTES + hd.segment_bytes
        offset = nxt


def iter_segments_selected(fp: BinaryIO, indices
                           ) -> Iterator[Tuple[int, IOHeader, bytes]]:
    """Skip-ahead read of only the segments at the given chain positions
    (0-based, ascending): yields ``(index, header, segment_bytes)``.
    Bodies of unselected segments are never read -- the walk seeks
    straight from header to header via ``NextIOHeader``
    (header_format.tex:209-218, the distributed-reader contract of
    doc/separation_of_duties.md:7-12: each rank pulls its own segments
    from one shared file)."""
    want = sorted(set(int(i) for i in indices))
    if want and want[0] < 0:
        raise ValueError(f"negative segment index {want[0]}")
    wi = 0
    offset = fp.tell()
    idx = 0
    while wi < len(want):
        fp.seek(offset)
        raw = fp.read(IO_HEADER_BYTES)
        if len(raw) < IO_HEADER_BYTES:
            raise ValueError(
                f"segment index {want[wi]} beyond end of chain "
                f"({idx} segments)")
        hd = IOHeader.unpack(raw)
        if hd.segment_bytes >= _SANE_U64:
            raise ValueError(
                f"corrupt IOHeader: SegmentBytes {hd.segment_bytes:#x} "
                "out of range")
        if idx == want[wi]:
            yield idx, hd, _read_body(fp, hd)
            wi += 1
        nxt = _advance(offset, hd)
        if nxt == 0:
            if wi < len(want):
                raise ValueError(
                    f"segment index {want[wi]} beyond end of chain "
                    f"({idx + 1} segments)")
            return
        offset = nxt
        idx += 1


class _HeldBytes:
    """``read``/``seek``/``tell`` over a whole file's bytes, whose ``read``
    gives a ``memoryview`` slice of them, not a copy: the chain readers run
    on it unchanged and yield views."""

    def __init__(self, whole, pos: int):
        self._buf = memoryview(whole)
        self._pos = pos

    def read(self, n: int) -> memoryview:
        view = self._buf[self._pos:self._pos + n]
        self._pos += len(view)
        return view

    def seek(self, offset: int) -> int:
        self._pos = offset
        return offset

    def tell(self) -> int:
        return self._pos


def _held_bytes(fp: BinaryIO):
    """The whole file as bytes the stream already holds, or None.  An
    ``io.BytesIO`` gives ``getvalue()``: the caller's ``bytes`` object
    itself while the stream shares it, no copy (``getbuffer()`` would
    unshare, and so copy, it)."""
    return fp.getvalue() if isinstance(fp, _io.BytesIO) else None


def iter_segment_views(fp: BinaryIO, box=None, periodic=None
                       ) -> Iterator[Tuple[IOHeader, memoryview | bytes]]:
    """``iter_segments`` (``iter_segments_intersecting`` for a query
    ``box=(origin, width)``, ``periodic`` as there), with each body a
    ``memoryview`` of the bytes the stream already holds
    (``_held_bytes``) instead of a copy; any other stream is read by those
    readers as it is, and its bodies are ``bytes``.  The checks, the
    ValueErrors and where ``fp`` is left are theirs."""
    whole = _held_bytes(fp)
    src = fp if whole is None else _HeldBytes(whole, fp.tell())
    try:
        if box is None:
            yield from iter_segments(src)
        else:
            yield from iter_segments_intersecting(src, box[0], box[1],
                                                  periodic)
    finally:
        if src is not fp:
            fp.seek(src.tell())


def count_segments(fp: BinaryIO) -> int:
    """Number of segments in the chain at the current position (headers
    only; no body reads)."""
    return sum(1 for _ in iter_headers(fp))


def iter_headers(fp: BinaryIO, all_chains: bool = False
                 ) -> Iterator[IOHeader]:
    """Skip-ahead iteration over headers only (no segment reads).
    ``all_chains`` as in :func:`iter_segments`."""
    offset = fp.tell()
    while True:
        fp.seek(offset)
        raw = fp.read(IO_HEADER_BYTES)
        if len(raw) < IO_HEADER_BYTES:
            return
        hd = IOHeader.unpack(raw)
        if hd.segment_bytes >= _SANE_U64:
            raise ValueError(
                f"corrupt IOHeader: SegmentBytes {hd.segment_bytes:#x} "
                "out of range")
        yield hd
        nxt = _advance(offset, hd)
        if nxt == 0:
            if not all_chains:
                return
            nxt = offset + IO_HEADER_BYTES + hd.segment_bytes
        offset = nxt
