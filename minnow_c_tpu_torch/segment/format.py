"""Spec-exact compressed-segment wire format.

Layout (header_format.tex section 3, Fig. segment_format)::

    SegmentHeader  { u32 Checksum; i32 BlockNum; i32 FieldNum;
                     i32 ParticleNum }                          16 B
    FieldHeader[F] { u32 FieldCode; u32 AlgorithmCode;
                     u32 Version;   i32 BlockNum }              16 B each
    BlockHeader[B] { i32 Length; u32 Checksum }                  8 B each
    blocks         concatenated, each 8-aligned

``SegmentHeader.Checksum`` covers the 12 + 16F + 8B bytes starting at
``BlockNum`` (header_format.tex:150-156) -- everything except the blocks
and the checksum itself.  Each ``BlockHeader.Checksum`` covers its block's
stored bytes; a failed block checksum yields ``None`` for that block so
codecs can localize the damage instead of failing the segment
(header_format.tex:186-196).

``serialize_parts`` gives a segment as the buffers it is written in: the
header it builds, then each block's stored parts as the writer made them
(``StoredBlock``: prelude, payload, pad, with their checksum), so a block's
bytes go from the LZ4 output to the file with no copy.  ``serialize`` is
their join.

``layout`` is the reader's counterpart: ``deserialize``'s parse with the
block checksums left to the caller, each block given as where it lies in
the segment (``BlockSpan``), so a reader can check and decode the blocks
in parallel on views of the segment bytes.

All values little-endian (spec "Endianness" section).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Union

from ..ops.checksum import checksum
from .stream import Reader, StreamUnderflowError, Writer

SEGMENT_HEADER_BYTES = 16
FIELD_HEADER_BYTES = 16
BLOCK_HEADER_BYTES = 8


@dataclass(frozen=True)
class StoredBlock:
    """A block as the buffers it is stored in, in order, and the checksum
    of their concatenation (the snapshot writer's pool tasks build them:
    ``parallel.snapshot._stored_block``)."""

    parts: tuple
    checksum: int

    def __len__(self) -> int:
        return sum(len(p) for p in self.parts)


@dataclass
class WireField:
    """One field's wire identity + its blocks."""

    field_code: int
    algo_code: int
    version: int
    # bytes or StoredBlock; None marks a corrupt block after read; a
    # BlockSpan in ``layout``'s parse
    blocks: List[Union[bytes, StoredBlock, "BlockSpan", None]]


def serialize_parts(fields: List[WireField], particle_num: int) -> list:
    """A spec segment as the buffers it is written in, in order: the
    header (segment, field and block headers), then every block's parts.
    A ``StoredBlock``'s checksum is taken as given, a bytes block's is
    taken here; no block byte is copied."""
    blocks = [b if isinstance(b, StoredBlock) else StoredBlock((b,),
                                                               checksum(b))
              for f in fields for b in f.blocks]
    w = Writer()
    w.u32(0)  # checksum patched below
    w.i32(len(blocks)).i32(len(fields)).i32(particle_num)
    for f in fields:
        w.u32(f.field_code).u32(f.algo_code).u32(f.version)
        w.i32(len(f.blocks))
    for b in blocks:
        if len(b) % 8 != 0:
            raise ValueError("blocks must be 8-aligned")
        w.u32(len(b)).u32(b.checksum)
    # Header checksum over BlockNum .. end of BlockHeaders.
    w.patch_u32(0, checksum(w.view(4, len(w))))
    return [w.data] + [p for b in blocks for p in b.parts]


def serialize(fields: List[WireField], particle_num: int) -> bytes:
    """Serialize compressed fields into a spec segment: the join of
    ``serialize_parts``."""
    return b"".join(serialize_parts(fields, particle_num))


@dataclass
class ParsedSegment:
    particle_num: int
    fields: List[WireField]
    header_valid: bool


def deserialize(data: bytes, verify: bool = True) -> ParsedSegment:
    """Parse a spec segment.  Corrupt blocks come back as ``None``; a
    corrupt header raises (the layout itself cannot be trusted)."""
    r = Reader(data)
    hdr_checksum = r.u32()
    block_num = r.i32()
    field_num = r.i32()
    particle_num = r.i32()
    # Sanity-bound the counts BEFORE using them (negative or absurd
    # values shift every later offset and misparse silently when the
    # caller opted out of checksum verification).
    if block_num < 0 or field_num < 0 or particle_num < 0 or \
            12 + FIELD_HEADER_BYTES * field_num + \
            BLOCK_HEADER_BYTES * block_num > len(data):
        raise ValueError(
            f"implausible segment header counts: blocks={block_num} "
            f"fields={field_num} particles={particle_num} "
            f"for {len(data)} bytes")
    hdr_span = 12 + FIELD_HEADER_BYTES * field_num + \
        BLOCK_HEADER_BYTES * block_num
    header_valid = checksum(data[4:4 + hdr_span]) == hdr_checksum
    if verify and not header_valid:
        raise ValueError(
            f"segment header checksum mismatch ({hdr_checksum:#x})")

    fields = []
    for _ in range(field_num):
        fc = r.u32()
        ac = r.u32()
        ver = r.u32()
        bn = r.i32()
        fields.append(WireField(fc, ac, ver, [None] * bn))

    block_meta = [(r.u32(), r.u32()) for _ in range(block_num)]

    bi = 0
    for f in fields:
        for j in range(len(f.blocks)):
            length, bsum = block_meta[bi]
            bi += 1
            raw = r.raw(length)
            if not verify or checksum(raw) == bsum:
                f.blocks[j] = raw
    return ParsedSegment(particle_num=particle_num, fields=fields,
                         header_valid=header_valid)


class BlockSpan(NamedTuple):
    """Where a stored block lies in its segment's bytes, and the checksum
    its block header states for it."""

    offset: int
    length: int
    checksum: int


def layout(data) -> ParsedSegment:
    """``deserialize``'s parse of a segment (any buffer) that takes no
    block checksum and copies no block: each field's blocks come back as
    their ``BlockSpan``s, for the caller to check.  A corrupt header, or
    blocks that run past the end of ``data``, raise ValueError, as there."""
    r = Reader(data)
    hdr_checksum = r.u32()
    block_num = r.i32()
    field_num = r.i32()
    particle_num = r.i32()
    hdr_span = 12 + FIELD_HEADER_BYTES * field_num + \
        BLOCK_HEADER_BYTES * block_num
    if block_num < 0 or field_num < 0 or particle_num < 0 or \
            hdr_span > len(r):
        raise ValueError(
            f"implausible segment header counts: blocks={block_num} "
            f"fields={field_num} particles={particle_num} "
            f"for {len(r)} bytes")
    if checksum(memoryview(data)[4:4 + hdr_span]) != hdr_checksum:
        raise ValueError(
            f"segment header checksum mismatch ({hdr_checksum:#x})")
    fields = [WireField(r.u32(), r.u32(), r.u32(), [None] * r.i32())
              for _ in range(field_num)]
    block_meta = [(r.u32(), r.u32()) for _ in range(block_num)]
    bi, offset = 0, r.offset
    for f in fields:
        for j in range(len(f.blocks)):
            length, bsum = block_meta[bi]
            bi += 1
            if offset + length > len(r):
                raise StreamUnderflowError(
                    f"stream underflow: need {length} bytes at offset "
                    f"{offset}, only {len(r) - offset} remain")
            f.blocks[j] = BlockSpan(offset, length, bsum)
            offset += length
    return ParsedSegment(particle_num=particle_num, fields=fields,
                         header_valid=True)
