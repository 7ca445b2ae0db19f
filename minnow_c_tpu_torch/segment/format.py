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

All values little-endian (spec "Endianness" section).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..ops.checksum import checksum
from .stream import Reader, Writer

SEGMENT_HEADER_BYTES = 16
FIELD_HEADER_BYTES = 16
BLOCK_HEADER_BYTES = 8


@dataclass
class WireField:
    """One field's wire identity + its blocks."""

    field_code: int
    algo_code: int
    version: int
    blocks: List[Optional[bytes]]  # None marks a corrupt block after read


def serialize(fields: List[WireField], particle_num: int) -> bytes:
    """Serialize compressed fields into a spec segment."""
    w = Writer()
    block_num = sum(len(f.blocks) for f in fields)
    w.u32(0)  # checksum back-patched below
    w.i32(block_num)
    w.i32(len(fields))
    w.i32(particle_num)
    for f in fields:
        w.u32(f.field_code)
        w.u32(f.algo_code)
        w.u32(f.version)
        w.i32(len(f.blocks))
    for f in fields:
        for b in f.blocks:
            if len(b) % 8 != 0:
                raise ValueError("blocks must be 8-aligned")
            w.u32(len(b))
            w.u32(checksum(b))
    for f in fields:
        for b in f.blocks:
            w.raw(b)
    # Header checksum over BlockNum .. end of BlockHeaders, back-patched
    # in place (copying the whole segment just to stamp 4 bytes costs ~3x
    # peak memory on multi-GB snapshot segments).
    hdr_span = 12 + FIELD_HEADER_BYTES * len(fields) + \
        BLOCK_HEADER_BYTES * block_num
    w.patch_u32(0, checksum(w.view(4, 4 + hdr_span)))
    return w.data


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
