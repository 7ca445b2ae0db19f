"""L4 segment API -- the library's public surface.

Port of ``minnow_c_tpu/segment/api.py``: the reference's ``src/funcs.{h,c}``
stage names (Quantize / Compress and inverses) plus the one-call
``compress_segment`` / ``decompress_segment`` over the spec wire format.
Field data are torch tensors; encode runs on the device of each field's
tensor (numpy data goes to ``device``), decode runs on ``device``.  Every
entry point's ``device`` is ``cuda`` unless the caller asks for ``cpu``:
nothing runs on the CPU unasked.

Fault tolerance follows the reference contract: a field that fails its
checksum is *skipped, not fatal* -- it comes back with ``valid=False``
(funcs.c:40-60); with the spec's block-granular checksums, Trim further
localizes damage to single dimensions, surfaced as NaN planes
(header_format.tex:186-196).
"""

from __future__ import annotations

from copy import copy

import torch

from ..algos import registry
from ..ops.checksum import checksum
from ..quant import engine
from ..types import CField, CSeg, Field, FieldHeader, QField, QSeg, Seg
from . import format as wire
from .stream import Reader, Writer


def quantize(s: Seg, seed: int = 0, scale_mode: str = "div",
             device="cuda") -> QSeg:
    """Quantize every field (Quantize, funcs.c:13-23).  ``seed`` is the
    segment's dither seed, carried into the stream for deterministic
    decode.  ``scale_mode`` picks the float bin map ('div' = C-exact
    division, 'recip' = reciprocal multiply; wire-compatible, see
    quant.engine.quantize)."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    return QSeg(fields=[engine.quantize(f, seed, scale_mode=scale_mode,
                                        device=device)
                        for f in s.fields])


def undo_quantize(qs: QSeg, field_indices=None) -> Seg:
    """Dequantize every valid field (UndoQuantize, funcs.c:25-38).  Fields
    with ``valid=False`` are passed through as invalid placeholders; float
    fields with invalid dimensions get those planes set to NaN.

    ``field_indices`` optionally gives each field's true position in its
    segment (the dither key derives from it); defaults to enumeration
    order.  Callers decoding a *subset* of a segment's fields must pass
    the original positions or the dither streams won't match a full
    decode."""
    out = []
    for i, qf in enumerate(qs.fields):
        fi = field_indices[i] if field_indices is not None else i
        if not qf.valid and qf.data is None:
            out.append(Field(hd=qf.hd, data=None, acc=None, valid=False))
            continue
        f = engine.dequantize(qf, field_index=fi)
        dim_valid = getattr(qf, "dim_valid", None)
        if dim_valid is not None and not all(dim_valid):
            if f.data.is_floating_point():
                data = f.data.clone()
                for d, ok in enumerate(dim_valid):
                    if not ok:
                        data[d] = float("nan")
                f.data = data
            f.valid = False
        out.append(f)
    return Seg(fields=out)


def compress(qs: QSeg) -> CSeg:
    """Run each field's codec and stamp per-field checksums (Compress,
    funcs.c:62-76)."""
    out = []
    for qf in qs.fields:
        codec = registry.get(qf.hd.algo_code, qf.hd.algo_version)
        blocks = codec.compress(qf)
        blob = b"".join(blocks)
        cf = CField(hd=qf.hd, data=blob, checksum=checksum(blob))
        cf.blocks = blocks
        out.append(cf)
    return CSeg(fields=out)


def decompress(cs: CSeg, device="cuda") -> QSeg:
    """Verify checksums and decode each field's bins onto ``device``
    (Decompress, funcs.c:40-60).  A field whose checksum fails is skipped
    (valid=False), not fatal."""
    out = []
    for cf in cs.fields:
        # Checksum FIRST: split_blocks raises on malformed block preludes,
        # and a corrupt field must degrade to valid=False, not crash the
        # segment (funcs.c:49-56 skip-not-fatal contract).
        if cf.checksum != checksum(cf.data):
            out.append(QField(hd=cf.hd, data=None, quant=None, valid=False))
            continue
        blocks = getattr(cf, "blocks", None)
        if blocks is None:
            from ..algos.blocks import split_blocks
            blocks = split_blocks(cf.data)
        codec = registry.get(cf.hd.algo_code, cf.hd.algo_version)
        out.append(codec.decompress(cf.hd, list(blocks), device=device))
    return QSeg(fields=out)


# ---------------------------------------------------------------------------
# v0 byte format (funcs.c ToBytes/FromBytes, funcs.c:78-120) -- kept for
# parity with the reference's checked-in layout.
# ---------------------------------------------------------------------------

def to_bytes(cs: CSeg) -> bytes:
    """[FieldLen u32][per field: FieldHeader(16 B), Checksum u32,
    DataLen u32][concatenated field blobs] (funcs.c:78-97)."""
    w = Writer()
    w.u32(len(cs.fields))
    for cf in cs.fields:
        w.u32(cf.hd.field_code)
        w.u32(cf.hd.algo_code)
        w.u32(cf.hd.algo_version)
        w.i32(cf.hd.particle_len)
        w.u32(cf.checksum)
        w.u32(len(cf.data))
    for cf in cs.fields:
        w.raw(cf.data)
    return w.data


def from_bytes(data: bytes) -> CSeg:
    """Inverse of to_bytes (FromBytes, funcs.c:99-120)."""
    r = Reader(data)
    n = r.u32()
    metas = []
    for _ in range(n):
        hd = FieldHeader(field_code=r.u32(), algo_code=r.u32(),
                         algo_version=r.u32(), particle_len=r.i32())
        metas.append((hd, r.u32(), r.u32()))
    return CSeg(fields=[CField(hd=hd, data=r.raw(dlen), checksum=csum)
                        for hd, csum, dlen in metas])


# ---------------------------------------------------------------------------
# Spec wire format, one-call pipeline
# ---------------------------------------------------------------------------

def seg_to_wire(cs: CSeg, particle_num: int) -> bytes:
    return wire.serialize(
        [wire.WireField(cf.hd.field_code, cf.hd.algo_code,
                        cf.hd.algo_version, list(cf.blocks))
         for cf in cs.fields], particle_num)


def wire_to_cseg(data: bytes) -> CSeg:
    parsed = wire.deserialize(data)
    fields = []
    for f in parsed.fields:
        hd = FieldHeader(field_code=f.field_code, algo_code=f.algo_code,
                         algo_version=f.version,
                         particle_len=parsed.particle_num)
        ok_blocks = [b for b in f.blocks if b is not None]
        blob = b"".join(ok_blocks)
        cf = CField(hd=hd, data=blob, checksum=checksum(blob))
        cf.blocks = f.blocks
        fields.append(cf)
    return CSeg(fields=fields)


def transcode_segment(data: bytes, algo: int, version: int = None,
                      device="cuda") -> bytes:
    """Losslessly re-encode a segment with a different compression
    algorithm, at the QUANTIZED level: the stored bins are decoded (no
    dithered float reconstruction) and re-compressed with the new codec,
    keeping the original dither seed -- decoding the output yields
    bit-identical floats to decoding the input
    (header_format.tex:239-283)."""
    if version is None:
        version = registry.newest(algo)
    parsed = wire.deserialize(data)
    out = []
    for f in parsed.fields:
        hd = FieldHeader(field_code=f.field_code, algo_code=f.algo_code,
                         algo_version=f.version,
                         particle_len=parsed.particle_num)
        old_codec = registry.get(hd.algo_code, hd.algo_version)
        qf = old_codec.decompress(hd, f.blocks, device=device)
        if getattr(qf, "valid", True) is False:
            raise ValueError(
                f"field {f.field_code:#x} is corrupt; refusing to "
                "transcode damaged data")
        qf = copy(qf)
        qf.hd = FieldHeader(field_code=hd.field_code, algo_code=algo,
                            algo_version=version,
                            particle_len=hd.particle_len)
        out.append(qf)
    cs2 = compress(QSeg(fields=out))
    return seg_to_wire(cs2, parsed.particle_num)


def compress_segment(s: Seg, seed: int = 0, scale_mode: str = "div",
                     device="cuda") -> bytes:
    """Full encode: Seg -> spec segment bytes.  Each field runs on the
    device of its tensor; numpy data goes to ``device`` (``cuda`` unless
    the caller asks for ``cpu``).  ``scale_mode``:
    see :func:`quantize` (decode needs no flag -- the bin map is the
    encoder's choice and the stream is self-describing either way)."""
    lens = {f.hd.particle_len for f in s.fields}
    if len(lens) > 1:
        raise ValueError(
            f"all fields in a segment must share particle_len; got {lens}")
    particle_num = lens.pop() if lens else 0
    qs = quantize(s, seed, scale_mode=scale_mode, device=device)
    cs = compress(qs)
    return seg_to_wire(cs, particle_num)


def decompress_segment(data: bytes, fused: bool = False, fields=None,
                       device="cuda") -> Seg:
    """Full decode: spec segment bytes -> Seg of tensors on ``device``
    (invalid fields/dims degrade gracefully).

    ``fused=True`` routes eligible fields (Trim plane coding, uniform
    depth, linear scale) through the single-pass decode
    (``TrimV1_0.decompress_field_fused``: the CUDA decode kernel on a CUDA
    device), skipping the intermediate bin materialization; output bits
    are identical to the generic path.  Ineligible fields fall back
    transparently.

    ``fields``: optional collection of ``FieldCode`` values to decode;
    other fields stay ``None`` in the returned Seg WITHOUT any decode
    work.  Field positions (and so dither keys) are unaffected by the
    filter -- selected fields decode bit-identically to a full decode."""
    device = torch.device(device)
    parsed = wire.deserialize(data)
    want = None if fields is None else set(fields)
    out_fields = [None] * len(parsed.fields)
    qfields = []
    q_slots = []
    for i, f in enumerate(parsed.fields):
        if want is not None and f.field_code not in want:
            continue
        hd = FieldHeader(field_code=f.field_code, algo_code=f.algo_code,
                         algo_version=f.version,
                         particle_len=parsed.particle_num)
        codec = registry.get(hd.algo_code, hd.algo_version)
        if fused and hasattr(codec, "decompress_field_fused"):
            fld = codec.decompress_field_fused(hd, f.blocks, i,
                                               device=device)
            if fld is not None:
                out_fields[i] = fld
                continue
        qfields.append(codec.decompress(hd, f.blocks, device=device))
        q_slots.append(i)
    generic = undo_quantize(QSeg(fields=qfields), field_indices=q_slots) \
        if qfields else Seg(fields=[])
    for j, i in enumerate(q_slots):
        out_fields[i] = generic.fields[j]
    return Seg(fields=out_fields)
