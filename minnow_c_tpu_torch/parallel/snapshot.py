"""Snapshot-scale compression in torch: block-batched encode and decode of
whole particle snapshots on one device.

Port of ``minnow_c_tpu/parallel/snapshot.py`` (the single-host writer and
reader).  A snapshot is split into equal particle blocks; the positions,
velocities and masses of all blocks are unwrapped, reduced to per-block
stats, binned and bitpacked in batched device passes over (block, dim)
rows; IDs are decomposed device-wide and packed per block.  On the host,
one pool task a (block, dim) payload takes its LZ4, prelude, pad and
checksum (``_entropy``); each block is then a *standard* wire-format
segment (Trim v1.0 layout) given as its header and those parts, and the
segments are written in file order with chained IOHeaders, the stored
bytes straight from the LZ4 outputs.  The batched reader mirrors it: it
parses each segment's layout with no copy (``format.layout``), checks
every stored block's checksum in one pool task a block on a view of the
segment bytes, and LZ4-decodes each (segment, dim) payload straight into
its row of one host array a dim (``_payload_words``).  The files are
byte-identical to the JAX package's writer, and either package reads the
other's.

Depth policy: one depth per field across all blocks; ranges stay per
block.  Encode runs on the device of the given tensors (numpy input goes
to ``device=``, ``cuda`` unless the caller asks for ``cpu``); decode
returns tensors on ``device``.

Each float field kind (POSN, VELC, UNSF) is one entry of ``_KINDS``: its
dims, its map, whether it is periodic; from these one encoder
(``_encode_float``), one meta writer (``_float_meta``) and one meta reader
(``_read_meta``) serve every kind, and the batched reader decodes every
kind in one branch.  One field assembly (``_encode_fields``) encodes the
fields of a write for the three writers, which differ only in how the
field's depth is picked (a *depth rule*) and how the segments reach the
file.  The batched passes run through the row steps of ``rows``, which
pick the kernels: K6 ``stats_rows`` (per-block stats), K7 ``pack_rows``
(every pack when 32 | nb), K8 ``encode_recip_rows`` (the whole float bin
map and pack in the recip scale mode, 32 | nb), K2 ``decode_rows`` (float
decode) and K3 ``unpack_rows`` (ID decode); with 32 ∤ nb the blocks pack
and decode row by row through K4 (or K5 in the recip mode) and K1.

The log10 / symlog10 maps run as torch ops (``engine.map_float``) on the
whole (block, dim) rows before the stats and again before the bin map, so
K6, K7 and K8 see mapped rows and no kernel holds a map; the batched read
unmaps K2's output op by op (``engine.unmap_float``).  A field with
per-particle accuracies (Deltas mode) goes block by block through the
segment engine and Trim v1.1 (``_encode_float_blocks_deltas``), whose
chunk bodies pack with K7; the batched read leaves such a file to the
per-segment decode, as the JAX package's does.

``compress_snapshot_streaming`` writes a snapshot block by block, one
segment per block, with the same field assembly at B = 1.

``compress_snapshot_multihost`` and ``decompress_snapshot_multihost`` are
the distributed client's writer and reader: each process of a
``torch.distributed`` group (``multihost.py``) encodes, or reads, the
segments of its own blocks of one shared file, and the file is
byte-identical to the single-host writer's.
"""

from __future__ import annotations

import dataclasses
import struct
from dataclasses import dataclass
from typing import BinaryIO, Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..algos.algo_trim_v1_0 import VERSION as TRIM_VERSION
from ..algos.blocks import (FLAG_LZ4, PRELUDE_BYTES, decode_block,
                            encode_block)
from ..ops import entropy, kernels
from ..ops import rng as _rng
from ..ops.checksum import CHECKSUM_INIT, checksum
from ..quant import engine
from ..segment import format as wire
from ..segment import io as seg_io
from ..segment.api import decompress_segment
from ..segment.stream import Reader, StreamUnderflowError, Writer
from ..types import (AlgoCode, FieldCode, FloatAccuracy, IDAccuracy,
                     PositionAccuracy, VelocityAccuracy)
from ..utils import native_order
from ..utils.profiling import count, operation, phase
from . import multihost as mh
from . import rows
from .sharding import make_mesh

@dataclass(frozen=True)
class SnapshotSpec:
    """Accuracy requests for the standard snapshot fields.  ``mass`` is
    an optional scalar per-particle float field (stored as UNSF) -- e.g.
    the Gadget-2 per-particle MASS block."""

    pos: Optional[PositionAccuracy] = None
    vel: Optional[VelocityAccuracy] = None
    ids: Optional[IDAccuracy] = None
    mass: Optional[FloatAccuracy] = None


@dataclass(frozen=True)
class _FloatKind:
    """One float field kind of a snapshot.

    A kind of 3 dims forms each block's range shared by its dims
    (``rows.block_stats``) and stores x1 = x0 + range, which the decode
    turns back into the bin range f32(x0 + maxDiff) - f32(x0).  UNSF (1
    dim) stores its raw x0 and x1, the true max, and its bin range is
    f32(x1) - f32(x0).  A periodic kind (positions) unwraps in the box
    ``acc.width``, stores the box in its meta, and gives the room rule
    the box as its magnitude; the others give their largest |x0| or
    |x1|."""

    name: str           # span prefix, stats key and SnapshotSpec field
    code: int
    dims: int
    periodic: bool
    map_of: Callable    # accuracy -> (map mode, threshold)


_KINDS = {k.name: k for k in (
    _FloatKind("pos", int(FieldCode.POSN), 3, True, lambda acc: (0, 0.0)),
    _FloatKind("vel", int(FieldCode.VELC), 3, False, lambda acc: (
        2 if acc.sym_log10_scaled else 0, float(acc.sym_log10_threshold))),
    _FloatKind("mass", int(FieldCode.UNSF), 1, False, lambda acc: (
        int(getattr(acc, "log10_scaled", 0)),
        float(getattr(acc, "sym_log10_threshold", 0.0)))))}
_KIND_BY_CODE = {k.code: k for k in _KINDS.values()}


def _host_u32(words: torch.Tensor) -> np.ndarray:
    """int32 words of u32 bits -> host uint32 array."""
    return rows.host(words).view(np.uint32)


def _upload(data, dtype: torch.dtype, device) -> torch.Tensor:
    """``engine.as_tensor``; numpy input that goes to the card counts as
    ``h2d`` (a tensor stays on its own device)."""
    t = engine.as_tensor(data, dtype, device)
    count("h2d", t.numel() * t.element_size() if t.is_cuda and
          not isinstance(data, torch.Tensor) else 0)
    return t


def _open_counters(*keys: str) -> None:
    """Give the open record each counter from the operation's start, 0
    until a step adds to it: a write's ``packed_bits`` (depth or ID width
    times elements, every field's packed bins before LZ4),
    ``depth_room`` (fields the room rule made deeper) and
    ``pooled_sum_bytes`` (stored block bytes whose checksum a pool task
    took, ``_entropy``), a read's ``h2d`` and ``d2h`` (a read that leaves
    its fields on the card downloads nothing), ``pooled_decode_bytes``
    (stored payload block bytes that a pool task decoded into their row,
    ``_payload_words``; 0 when the read ran per segment) and
    ``viewed_segment_bytes`` (segment body bytes taken as views of the
    whole file's bytes that the caller's stream held,
    ``seg_io.iter_segment_views``; 0 when they were read as copies)."""
    for key in keys:
        count(key, 0)


def _float_extent(x0: torch.Tensor, rng_b: torch.Tensor) -> tuple:
    """The widest block range and the largest |x0| or |x0 + range| of
    every (block, dim), host floats in one copy: what the room rule of a
    field without a box needs (``engine.delta_to_depth``)."""
    x0 = x0.reshape(rng_b.shape[0], -1)
    mag = torch.maximum(x0.abs(), (x0 + rng_b[:, None]).abs()).amax()
    rng, mag = rows.host(torch.stack([rng_b.amax(), mag]))
    return float(rng), float(mag)


def _float_depth(delta: float, rng: float, magnitude: float) -> int:
    """A float field's shared depth by the room rule over the widest
    block range; counts ``depth_room`` 1 when the room made it deeper than
    the reference's rule."""
    depth = engine.delta_to_depth(delta, 0.0, rng, magnitude=magnitude)
    count("depth_room", int(depth > engine.delta_to_depth(delta, 0.0, rng)))
    return depth


def _depth_by_room(kind: _FloatKind, delta: float, extent) -> int:
    """``compress_snapshot``'s depth rule: ``_float_depth`` over the
    field's own ``extent()`` (widest block range, magnitude)."""
    return _float_depth(delta, *extent())


# ---------------------------------------------------------------------------
# Bin + pack, and the host wire of a field
# ---------------------------------------------------------------------------

def _bin_pack(x: torch.Tensor, x0: torch.Tensor, rng_b: torch.Tensor,
              depth: int, box, scale_mode: str) -> torch.Tensor:
    """(B, D, nb) mapped floats (RAW positions when ``box`` is not None),
    x0 (B*D,), shared range (B,) -> (B, D, words): ``rows.bin_pack``."""
    b, d, nb = x.shape
    return rows.bin_pack(x.reshape(b * d, nb), x0, rng_b, depth, box,
                         scale_mode).reshape(b, d, -1)


def _batched_bin_pack_pos(x: torch.Tensor, x0: torch.Tensor,
                          rng_b: torch.Tensor, depth: int, width: float,
                          scale_mode: str = "div"):
    """(B, 3, nb) RAW positions -> (B, 3, words) packed bins at ``depth``;
    recomputes the periodic unwrap of the stats pass.  The writer looks it
    up through the module, so a test can alter the positions' bins."""
    return _bin_pack(x, x0, rng_b, depth, float(width), scale_mode)


def _stored_block(words: np.ndarray, width: int,
                  accel: int) -> wire.StoredBlock:
    """``encode_block(words, width)``'s block as the buffers it is stored
    in (prelude, payload, zero pad; empty ones left out) and their
    checksum, chained through the parts.  The stored payload is a view of
    the LZ4 output, or of ``words``' own bytes when LZ4 does not shrink
    them: no copy."""
    raw = np.ascontiguousarray(words)
    raw = raw.astype(raw.dtype.newbyteorder("<"), copy=False)
    raw = raw.reshape(-1).view(np.uint8)
    if raw.size > 0xFFFFFFFF:
        raise ValueError(
            f"block payload of {raw.size} bytes exceeds the u32 prelude "
            "length; use more blocks (spec table 1)")
    stored, flags = raw, 0
    if raw.size > 0:
        comp = entropy.encode_view(raw, accel)
        if comp.size < raw.size:
            stored, flags = comp, FLAG_LZ4
    prelude = struct.pack("<IIBBHI", raw.size, stored.size, width, flags,
                          0, 0)
    pad = bytes(-stored.size % 8)
    parts = tuple(p for p in (prelude, stored, pad) if len(p))
    c = CHECKSUM_INIT
    for p in parts:
        c = checksum(p, c)
    return wire.StoredBlock(parts, c)


def _entropy(payloads: List[np.ndarray], widths: List[int], accel: int,
             name: str) -> List[wire.StoredBlock]:
    """Every payload of host words (block-major order, each with its bit
    width) as its stored block, one pool task each: LZ4, prelude, pad and
    the chained checksum.  Their bytes count as ``pooled_sum_bytes``."""
    with phase(f"{name}.entropy"):
        out = entropy.pool_map(lambda r, w: _stored_block(r, w, accel),
                               payloads, widths)
    count("pooled_sum_bytes", sum(map(len, out)))
    return out


def _float_meta(kind: _FloatKind, x0, x1, box, depth: int, mode: int,
                thr: float, seed: int) -> bytes:
    """A float block's meta (Trim v1.0): x0 and x1 of each dim (f32);
    then for positions the box (f32), the depth, a zero flag and a zero
    u16, for the other kinds the depth, a zero flag, the map mode, a zero
    u8 and the threshold (f32); then the seed (u64)."""
    meta = Writer()
    for v in (*x0, *x1):
        meta.f32(float(v))
    if kind.periodic:
        meta.f32(box).u8(depth).u8(0).u16(0)
    else:
        meta.u8(depth).u8(0).u8(mode).u8(0).f32(thr)
    return meta.u64(seed).data


def _read_meta(kind: _FloatKind, data: np.ndarray) -> Optional[tuple]:
    """Inverse of ``_float_meta``: (x0, x1, (depth, seed, box, map mode,
    threshold)) of a block's meta bytes; None for a block with
    per-particle depths."""
    r = Reader(data.tobytes())
    x0 = [r.f32() for _ in range(kind.dims)]
    x1 = [r.f32() for _ in range(kind.dims)]
    box = r.f32() if kind.periodic else 0.0
    depth = r.u8()
    if r.u8():
        return None
    if kind.periodic:
        r.u16()
        mode, thr = 0, 0.0
    else:
        mode = r.u8()
        r.u8()
        thr = r.f32()
    return x0, x1, (depth, r.u64(), box, mode, thr)


# ---------------------------------------------------------------------------
# Field encoders: device passes -> per-block wire block lists
# ---------------------------------------------------------------------------

def _encode_float(kind: _FloatKind, arr, B: int, nb: int, acc, seed: int,
                  accel: int, device, depth_rule, scale_mode: str):
    """Batched device encode of a float field of ``kind`` ((3, B*nb), or
    (B*nb,) for UNSF) -> per-block wire block lists (Trim v1.0 layout),
    the shared depth, and for positions the per-block bounding boxes of
    the raw values (lo, hi), host (B, 3) each (else None).  The depth is
    ``depth_rule(kind, delta, extent)``; ``extent()`` downloads the widest
    block range and the room rule's magnitude, host floats.  Numpy input
    goes to ``device``."""
    name, d = kind.name, kind.dims
    box = float(acc.width) if kind.periodic else None
    mode, thr = kind.map_of(acc)
    with phase(f"{name}.upload"):
        x = _upload(arr, torch.float32, device)
    with phase(f"{name}.stats"):
        xb = x.reshape(d, B, nb).transpose(0, 1).contiguous()
        if d == 1:   # UNSF: the raw extremes of the mapped rows
            x0, x1 = rows.stats(
                engine.map_float(xb, mode, thr).reshape(B, nb), None)
            x0_h, x1_h = rows.host(x0), rows.host(x1)
            rng_h = x1_h - x0_h
        else:
            x0, rng_b = rows.block_stats(
                engine.map_float(xb, mode, thr).reshape(B * d, nb), box)
        if box is not None:
            lo, hi = xb.amin(dim=2), xb.amax(dim=2)

        def extent():
            """The widest block range and the room rule's magnitude: the
            box for positions, else the largest |x0| or |x1|."""
            if d == 1:
                return float(rng_h.max()), float(np.abs([x0_h, x1_h]).max())
            if box is None:
                return _float_extent(x0, rng_b)
            return float(rows.host(rng_b.max())), box
        depth = depth_rule(kind, acc.delta, extent)
    with phase(f"{name}.binpack"):
        if d == 1:
            rng_b = rows.card(torch.from_numpy(rng_h), x.device)
        if box is None:
            words = _bin_pack(engine.map_float(xb, mode, thr), x0, rng_b,
                              depth, None, scale_mode)
        else:
            words = _batched_bin_pack_pos(xb, x0, rng_b, depth, box,
                                          scale_mode)
    count("packed_bits", depth * xb.numel())
    bounds = None
    with phase(f"{name}.gather"):
        words_h = _host_u32(words)
        if d > 1:
            x0_h = rows.host(x0)
            x1_h = x0_h.reshape(B, d) + rows.host(rng_b)[:, None]
        if box is not None:
            bounds = rows.host(lo), rows.host(hi)
    stored = _entropy(list(words_h.reshape(B * d, -1)), [depth] * (B * d),
                      accel, name)
    x0_h, x1_h = x0_h.reshape(B, d), x1_h.reshape(B, d)
    with phase(f"{name}.wrap"):
        out = [[encode_block(_float_meta(kind, x0_h[b], x1_h[b], box, depth,
                                         mode, thr, seed), 0, True, accel)]
               + stored[b * d:(b + 1) * d] for b in range(B)]
    return out, depth, bounds


def _encode_id_batch(ids, B: int, nb: int, acc, accel: int, device,
                     id_sync=None):
    """Lagrangian IDs (B*nb,) -> per-block PTID wire block lists + the
    per-dim widths.  The decompose (grid split, unwrap, global minimum)
    runs over the whole array; each block then subtracts its own minimum,
    and every block of a dim packs at the dim's widest block range.

    ``id_sync`` (the multihost writer only, from ``_multihost_id_sync``):
    the globally synced frame that makes PTID bytes independent of the
    process topology -- {"gmin": (3,) int64 global per-dim minima of the
    anchored unwrap, "shifted": this process's (3, n) anchored unwrap};
    the widest block range is all-reduced here.  The unwrap's lift by L
    cancels in the relative bins (rel = shifted - gmin either way), so
    these give the single-host writer's bytes."""
    with phase("ids.decompose"):
        if id_sync is None:
            with phase("ids.upload"):
                ids = _upload(ids, torch.int64, device).reshape(-1)
            qdims, x0g, _ = engine.id_decompose(ids, int(acc.width))
            x0g = rows.host(x0g).view(np.uint64)  # global per-dim offset
        else:
            gmin = np.asarray(id_sync["gmin"], dtype=np.int64)
            lift = np.where(gmin < 0, np.int64(acc.width), np.int64(0))
            x0g = (gmin + lift).view(np.uint64)
            shifted = id_sync["shifted"]
            qdims = shifted - rows.card(torch.from_numpy(gmin),
                                        shifted.device)[:, None]
        # the low 32 bits, as the reference's u32 cast keeps them
        qd = qdims.bitwise_and_(kernels.M32).reshape(3, B, nb)
    # The stored per-block origin includes the global decompose offset,
    # so undoID's rewrap sees true unwrapped coordinates.
    with phase("ids.pack"):
        x0_rel = qd.amin(dim=2)                      # (3, B)
        rel = qd - x0_rel[:, :, None]
        relmax_b = rows.host(rel.amax(dim=2))        # (3, B)
        x0_blocks = rows.host(x0_rel).astype(np.uint64) + x0g[:, None]
        relmax = relmax_b.max(axis=1)
        if id_sync is not None:
            # the widest block range over every process's blocks, as the
            # single-host writer sees it
            relmax = mh.allgather_i64(relmax).max(axis=0)
        widths = [int(relmax[i]).bit_length() for i in range(3)]
        count("packed_bits", sum(max(w, 1) for w in widths) * B * nb)
        packed = []
        for i in range(3):
            words = rows.pack(kernels.i64_to_u32(rel[i]), max(widths[i], 1))
            with phase("ids.gather"):
                packed.append(_host_u32(words))
    stored = _entropy([packed[i][b] for b in range(B) for i in range(3)],
                      [max(widths[i], 1) for _ in range(B) for i in range(3)],
                      accel, "ids")
    out = []
    with phase("ids.wrap"):
        for b in range(B):
            meta = Writer()
            meta.u64(int(acc.width))
            for i in range(3):
                meta.u64(int(x0_blocks[i, b]))
            for i in range(3):
                meta.u64(int(x0_blocks[i, b]) + int(relmax_b[i, b]))
            out.append([encode_block(meta.data, 0, True, accel)] +
                       stored[b * 3:(b + 1) * 3])
    return out, widths


def _encode_float_blocks_deltas(arr, B: int, nb: int, code, acc, seed: int,
                                accel: int, scale_mode: str, device):
    """Per-particle-accuracy (Deltas) snapshot encode: each block goes
    through the segment engine (quantize, then Trim v1.1, whose chunk
    bodies pack with K7 on the card).  ``acc.deltas`` holds one accuracy
    per particle of ``arr``.  Returns (per-block block lists, the Trim v1.1
    version stamp)."""
    from ..algos.algo_trim_v1_1 import VERSION as TRIM11_VERSION
    from ..algos.algo_trim_v1_1 import TrimV1_1
    from ..types import Field, FieldHeader
    codec = TrimV1_1(accel=accel)
    deltas = acc.deltas
    if isinstance(deltas, torch.Tensor):
        deltas = rows.host(deltas)
    deltas = np.asarray(deltas, dtype=np.float32)
    n = arr.shape[-1]
    if deltas.shape[0] != n:
        raise ValueError(
            f"per-particle deltas length {deltas.shape[0]} != particle "
            f"count {n}")
    out = []
    with phase("deltas.encode"):
        for b in range(B):
            sl = slice(b * nb, (b + 1) * nb)
            data = arr[..., sl]
            if not isinstance(data, torch.Tensor):
                data = np.ascontiguousarray(data)
            f = Field(hd=FieldHeader(code, AlgoCode.TRIM, TRIM11_VERSION,
                                     nb),
                      data=data, acc=dataclasses.replace(acc,
                                                         deltas=deltas[sl]))
            qf = engine.quantize(f, seed=seed, scale_mode=scale_mode,
                                 device=device)
            count("packed_bits", int(qf.quant.depths.astype(np.int64).sum())
                  * (data.shape[0] if len(data.shape) == 2 else 1))
            out.append(codec.compress(qf))
    return out, TRIM11_VERSION


def _blocks_box(pos, B: int, nb: int, device):
    """Per-block bounding box (lo, hi), host (B, 3) each, of the raw
    positions (3, B*nb)."""
    xb = _upload(pos, torch.float32, device).reshape(3, B, nb)
    return rows.host(xb.amin(dim=2).T), rows.host(xb.amax(dim=2).T)


def _encode_fields(arrays: dict, spec: SnapshotSpec, B: int, nb: int,
                   seed: int, accel: int, scale_mode: str, device,
                   depth_rule, id_sync=None, deltas=None):
    """The given fields of ``arrays`` ({"pos", "vel", "ids", "mass"} in
    file order, each (3, B*nb) or (B*nb,), or None) as B blocks -> (each
    block's WireFields, each block's IOHeader geometry (origin, width) of
    its raw positions or None, stats {"<field>_depth", "id_widths"}).

    ``depth_rule`` picks each float field's depth (``_encode_float``).  A
    float field whose accuracy carries per-particle deltas, or that
    ``deltas`` ({field: (B*nb,) accuracies}) gives them, is written in Trim
    v1.1's Deltas coding.  ``id_sync(ids, width, device)`` gives the IDs'
    synced frame (``_multihost_id_sync``)."""
    fields: List[List[wire.WireField]] = [[] for _ in range(B)]
    geometry, stats = None, {}
    for name, arr in arrays.items():
        if arr is None:
            continue
        acc, kind = getattr(spec, name), _KINDS.get(name)
        version, bounds = TRIM_VERSION, None
        if (deltas or {}).get(name) is not None:
            acc = dataclasses.replace(acc, deltas=deltas[name])
        if kind is None:
            code = int(FieldCode.PTID)
            blocks, stats["id_widths"] = _encode_id_batch(
                arr, B, nb, acc, accel, device,
                id_sync and id_sync(arr, int(acc.width), device))
        elif getattr(acc, "deltas", None) is not None:
            code = kind.code
            blocks, version = _encode_float_blocks_deltas(
                arr, B, nb, code, acc, seed, accel, scale_mode, device)
            stats[f"{name}_depth"] = "per-particle"
            if kind.periodic:
                bounds = _blocks_box(arr, B, nb, device)
        else:
            code = kind.code
            blocks, stats[f"{name}_depth"], bounds = _encode_float(
                kind, arr, B, nb, acc, seed, accel, device, depth_rule,
                scale_mode)
        for b in range(B):
            fields[b].append(wire.WireField(code, int(AlgoCode.TRIM),
                                            version, blocks[b]))
        if bounds is not None:
            # IOHeader Origin/Width (header_format.tex:206-218): per-block
            # bounding box of the raw (wrapped) positions, for skip-ahead
            # spatial queries.
            lo, hi = bounds
            geometry = [(tuple(map(float, lo[b])),
                         tuple(map(float, hi[b] - lo[b]))) for b in range(B)]
    return fields, geometry, stats


def _writer_arrays(spec: SnapshotSpec, blocks: int, what: str, pos, vel,
                   ids, mass):
    """The arrays of a whole-snapshot writer as ``_encode_fields`` takes
    them, in native byte order, and the particles a block; ValueError when
    none is given, when ``mass`` comes without ``spec.mass``, or when the
    particles do not divide into ``blocks``."""
    arrays = dict(zip(("pos", "vel", "ids", "mass"),
                      (native_order(a) for a in (pos, vel, ids, mass))))
    if arrays["mass"] is not None and spec.mass is None:
        raise ValueError("mass array given without spec.mass accuracy")
    given = [a for a in arrays.values() if a is not None]
    if not given:
        raise ValueError("no fields given")
    n = given[0].shape[-1]
    if n % blocks:
        raise ValueError(f"{n} {what}particles do not divide into {blocks} "
                         "blocks; pad the tail (client duty)")
    return arrays, n // blocks


@operation("snapshot.compress")
def compress_snapshot(fp: BinaryIO, pos, vel, ids, spec: SnapshotSpec,
                      num_blocks: int, seed: int = 0, accel: int = 1,
                      scale_mode: str = "div", mass=None,
                      device="cuda") -> dict:
    """Compress a snapshot into ``fp`` as ``num_blocks`` chained standard
    segments.  Arrays (numpy, or tensors that stay on their device):
    pos/vel (3, n) f32, ids (n,) u64 (an int64 tensor is read as u64
    bits), mass (n,) f32 (optional scalar field, stored as UNSF; requires
    ``spec.mass``); n must divide
    by num_blocks.  Numpy arrays go to ``device``, ``cuda`` unless the
    caller asks for ``cpu``.  Returns stats (bytes,
    depths).

    ``scale_mode``: 'div' (default) is the C-exact division bin map;
    'recip' multiplies by the exactly rounded reciprocal of each block's
    range (``kernels.uniform_bin_index_recip``), wire-compatible, and its
    whole float encode is one K8 launch per field when 32 | nb.  A float
    field whose accuracy carries per-particle ``deltas`` (one per particle
    of the whole snapshot) is written block by block in Trim v1.1's
    Deltas coding; its stats entry is "per-particle"."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    arrays, nb = _writer_arrays(spec, num_blocks, "", pos, vel, ids, mass)
    _open_counters("packed_bits", "depth_room", "pooled_sum_bytes")
    fields, geometry, stats = _encode_fields(
        arrays, spec, num_blocks, nb, seed, accel, scale_mode, device,
        _depth_by_room)
    with phase("serialize"):
        segments = [wire.serialize_parts(f, nb) for f in fields]
    with phase("segments.write"):
        seg_io.write_segments(fp, segments, geometry)
    stats["bytes"] = sum(map(seg_io.segment_nbytes, segments)) + \
        seg_io.IO_HEADER_BYTES * num_blocks
    stats["num_blocks"] = num_blocks
    return stats


def _reject_deltas(spec: SnapshotSpec, writer: str) -> None:
    """A spec-level per-particle deltas array is ambiguous for a writer
    that cannot know each block's offset into it: ValueError, as in the
    JAX package."""
    for name in ("pos", "vel", "mass"):
        acc = getattr(spec, name, None)
        if acc is not None and getattr(acc, "deltas", None) is not None:
            raise ValueError(
                f"a spec-level per-particle deltas array for {name!r} is "
                f"not supported by {writer}; use compress_snapshot, or "
                "per-block '<field>_deltas' entries with the streaming "
                "writer")


@operation("snapshot.compress")
def compress_snapshot_streaming(fp: BinaryIO, blocks_iter,
                                spec: SnapshotSpec, seed: int = 0,
                                accel: int = 1,
                                depths: Optional[dict] = None,
                                scale_mode: str = "div",
                                device="cuda") -> dict:
    """Memory-bounded snapshot encode: each block of ``blocks_iter`` is
    encoded on the device and written as one segment before the next
    block is pulled, so peak memory is one block.

    ``blocks_iter`` yields dicts with any of ``pos`` / ``vel`` (3, nb) f32,
    ``ids`` (nb,) u64 and ``mass`` (nb,) f32 -- the same fields in every
    block; numpy arrays go to ``device`` (``cuda`` unless the caller asks
    for ``cpu``), tensors stay on theirs.  Pass
    ``depths={"pos": d1, "vel": d2, "mass": d3}`` to pin the bit depths
    shared by all blocks (the batched reader's one-pass decode needs
    them), else each block derives its own from its range.  A block may
    carry per-particle accuracies for its own particles
    (``pos_deltas`` / ``vel_deltas`` / ``mass_deltas``, each (nb,) f32):
    that field of that block is written in Trim v1.1's Deltas coding.  A
    spec-level ``deltas`` array raises ValueError: the writer cannot know
    each block's offset into it.  Returns stats (bytes, num_blocks)."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    _reject_deltas(spec, "compress_snapshot_streaming")
    stats = {"bytes": 0, "num_blocks": 0}
    _open_counters("packed_bits", "depth_room", "pooled_sum_bytes")
    depths = depths or {}

    def depth_rule(kind, delta, extent):
        """The depth pinned in ``depths``, else the block's own."""
        pinned = depths.get(kind.name)
        return _float_depth(delta, *extent()) if pinned is None else pinned

    def seg_gen():
        for blk in blocks_iter:
            arrays = {k: native_order(blk.get(k))
                      for k in ("pos", "vel", "ids", "mass")}
            nb = next(arrays[k].shape[-1] for k in ("pos", "vel", "ids")
                      if arrays[k] is not None)
            fields, geometry, _ = _encode_fields(
                arrays, spec, 1, nb, seed, accel, scale_mode, device,
                depth_rule, deltas={k: native_order(blk.get(k + "_deltas"))
                                    for k in _KINDS})
            seg = wire.serialize_parts(fields[0], nb)
            stats["bytes"] += seg_io.segment_nbytes(seg) + \
                seg_io.IO_HEADER_BYTES
            stats["num_blocks"] += 1
            yield seg, None if geometry is None else geometry[0]

    seg_io.write_segments_streaming(fp, seg_gen())
    return stats


def compress_snapshot_multihost(fp: Optional[BinaryIO], pos, vel, ids,
                                spec: SnapshotSpec, num_blocks_local: int,
                                seed: int = 0, accel: int = 1,
                                scale_mode: str = "div", mass=None,
                                device="cuda") -> dict:
    """Distributed-client snapshot write: every process compresses its own
    contiguous slab of particles (``num_blocks_local`` blocks; arrays as
    :func:`compress_snapshot` takes them) and the segments land in ONE
    chained file in global block order (rank-major) -- the ordered-gather
    contract the spec assigns to the distributed client
    (doc/separation_of_duties.md:7-12).

    ``fp`` is written by process 0 only (other processes may pass None).
    Returns the same stats dict on every process.

    Depth policy: one scalar all-gather per float field syncs the global
    range (and, but for positions, the largest magnitude), so every
    process derives the shared depth the single-host writer would; the
    PTID frame is synced by the global element-0 anchor and the
    all-reduced per-dim minima and widest block ranges
    (``_multihost_id_sync``).  The file is byte-identical to a single-host
    :func:`compress_snapshot` of the concatenated data, whatever the
    process count."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    _reject_deltas(spec, "compress_snapshot_multihost")
    B = num_blocks_local
    arrays, nb = _writer_arrays(spec, B, "local ", pos, vel, ids, mass)

    def depth_rule(kind, delta, extent):
        """The room rule over every process's widest range and, but for
        the box, its largest magnitude."""
        rng, mag = extent()
        return _float_depth(delta, mh.allgather_max_f32(rng),
                            mag if kind.periodic else
                            mh.allgather_max_f32(mag))

    fields, geometry, stats = _encode_fields(
        arrays, spec, B, nb, seed, accel, scale_mode, device, depth_rule,
        id_sync=_multihost_id_sync)
    with phase("serialize"):
        segments = [wire.serialize(f, nb) for f in fields]
    all_segs = mh.allgather_bytes(segments)
    all_geos = mh.allgather_bytes(
        [b""] * B if geometry is None else
        [struct.pack("<6d", *origin, *width) for origin, width in geometry])
    if mh.process_index() == 0:
        if fp is None:
            raise ValueError("process 0 must pass a writable fp")
        if geometry is not None:
            geometry = [(vals[:3], vals[3:]) for vals in (
                struct.unpack("<6d", blob) for blob in all_geos)]
        seg_io.write_segments(fp, all_segs, geometry)
        fp.flush()  # visible to the other processes before the barrier
    mh.barrier("minnow_snapshot_write")
    stats["bytes"] = sum(len(s) for s in all_segs) + \
        seg_io.IO_HEADER_BYTES * len(all_segs)
    stats["num_blocks"] = len(all_segs)
    return stats


def _id_unwrap_anchored(ids: torch.Tensor, width: int, anchor,
                        exempt_first: bool) -> torch.Tensor:
    """Grid split + signed periodic unwrap against an EXPLICIT anchor (the
    global element 0's dims) -- the multihost variant of
    ``engine.id_decompose``'s unwrap (util.c:115-143 semantics).  Only the
    true global element 0 is exempt from unwrapping (the reference loop
    starts at i=1), so the other processes unwrap every element.  ``ids``
    are u64 bits in int64, ``anchor`` (3,) int64; returns the signed int64
    (3, n) dims before the lift (``width`` below 2^63, as
    ``id_decompose`` takes)."""
    xi = torch.stack(engine.id_split(ids, width))
    L = int(width)
    a = rows.card(torch.from_numpy(np.asarray(anchor, dtype=np.int64)),
              xi.device)[:, None]
    d = xi - a
    move = torch.ones(xi.shape[1], dtype=torch.bool, device=xi.device)
    if exempt_first and xi.shape[1]:
        move[0] = False
    shifted = torch.where(move & (d >= L // 2), xi - L, xi)
    return torch.where(move & (d < -(L // 2)), xi + L, shifted)


def _multihost_id_sync(ids, width: int, device) -> dict:
    """The globally synced PTID frame for ``_encode_id_batch(id_sync=...)``:
    the global element-0 anchor (process 0's first ID, gathered) and the
    global per-dim minima of every process's anchored unwrap.  Every
    process then bins against the same frame, and PTID streams are
    byte-identical to the single-host writer's whatever the process count
    (one extra i64 triple all-gather per snapshot)."""
    ids = _upload(ids, torch.int64, device).reshape(-1)
    w = int(width)
    first = kernels.i64_to_u64(ids[0])
    ww = (w * w) & kernels.M64  # numpy's u64 product and quotient by 0
    anchor_local = np.asarray(
        [kernels.u64_to_i64(v) for v in
         (first % w, (first // w) % w, first // ww if ww else 0)],
        dtype=np.int64)
    anchor = mh.allgather_i64(anchor_local)[0]
    shifted = _id_unwrap_anchored(ids, w, anchor,
                                  exempt_first=mh.process_index() == 0)
    gmin = mh.allgather_i64(rows.host(shifted.amin(dim=1))).min(axis=0)
    return {"gmin": gmin, "shifted": shifted}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_FIELD_BY_NAME = dict({name: k.code for name, k in _KINDS.items()},
                      ids=int(FieldCode.PTID))


def _parse_want(fields):
    """Normalize a field-selection argument ({"pos", ...} names or
    FieldCodes) to a set of int codes; None = everything."""
    if fields is None:
        return None
    want = set()
    for f in fields:
        if isinstance(f, (int, FieldCode)):  # accept FieldCode too,
            want.add(int(f))  # matching decompress_segment(fields=...)
        elif f in _FIELD_BY_NAME:
            want.add(_FIELD_BY_NAME[f])
        else:
            raise ValueError(
                f"unknown field selector {f!r}: expected one of "
                f"{sorted(_FIELD_BY_NAME)} or a FieldCode")
    return want


@operation("snapshot.decompress")
def decompress_snapshot(fp: BinaryIO, batched: bool = True, box=None,
                        periodic=None, fields=None, device="cuda") -> dict:
    """Read a chained multi-segment snapshot back into concatenated field
    tensors on ``device`` (``cuda`` unless the caller asks for ``cpu``;
    ordered gather in file order): "pos" and "vel"
    (3, n) f32, "ids" (n,) int64, "mass" (n,) f32.

    ``batched=True`` decodes all blocks of each field in one device pass
    when the file has the uniform structure the snapshot writer produces
    (same fields, shared depth, Trim coding) -- bit-identical to the
    per-segment path, which remains the path for any other file.

    ``box=(origin, width)`` restricts the read to segments whose IOHeader
    bounding box intersects the query box (skip-ahead spatial query,
    header_format.tex:206-218); only particles from those segments are
    returned.  ``periodic`` optionally gives the box length(s) for
    wrap-aware intersection.

    ``fields``: optional subset of {"pos", "vel", "ids", "mass"} (or
    FieldCodes) to decode; the rest are skipped entirely and absent from
    the result.  Selected fields are bit-identical to a full read.

    From an ``io.BytesIO`` the segment bodies are views of the bytes it
    holds (``seg_io.iter_segment_views``); no returned tensor shares them,
    and nothing holds them once the read returns."""
    _open_counters("h2d", "d2h", "pooled_decode_bytes",
                   "viewed_segment_bytes")
    want = _parse_want(fields)
    with phase("decode.read"):
        segments = [s for _, s in seg_io.iter_segment_views(fp, box,
                                                            periodic)]
    count("viewed_segment_bytes",
          sum(len(s) for s in segments if isinstance(s, memoryview)))
    return decode_segments(segments, batched, want, device)


def decode_segments(segments, batched: bool = True, want=None,
                    device="cuda") -> dict:
    """Decode a list of serialized segments (bytes or views of them;
    ``want``: a set of FieldCodes, or None for all) into concatenated
    field tensors on ``device``, as ``decompress_snapshot`` returns them."""
    device = torch.device(device)
    if not segments:
        return {}
    if batched:
        out = _decompress_snapshot_batched(segments, want, device)
        if out is not None:
            return out
    parts = {FieldCode.POSN: [], FieldCode.VELC: [], FieldCode.PTID: [],
             FieldCode.UNSF: []}
    for seg_bytes in segments:
        seg = decompress_segment(seg_bytes, fused=True, fields=want,
                                 device=device)
        for f in seg.fields:
            if f is not None and f.hd.field_code in parts:
                parts[f.hd.field_code].append(f.data)
    out = {}
    for name, code, dim in (("pos", FieldCode.POSN, 1),
                            ("vel", FieldCode.VELC, 1),
                            ("ids", FieldCode.PTID, 0),
                            ("mass", FieldCode.UNSF, 0)):
        if parts[code]:
            # a field that failed its checksum decodes to no data
            # (decompress_segment skips it); a file cannot be gathered
            # around the hole, and the JAX package's reader raises
            # ValueError there too
            if any(p is None for p in parts[code]):
                raise ValueError(f"a {name!r} field of the snapshot failed "
                                 "its checksum: corrupt file")
            out[name] = torch.cat(parts[code], dim=dim)
    return out


def decompress_snapshot_multihost(fp: BinaryIO, mesh=None, fields=None,
                                  batched: bool = True,
                                  device="cuda") -> dict:
    """Distributed-client snapshot read -- the inverse of
    :func:`compress_snapshot_multihost`.

    Every process opens the SAME chained file and walks the IOHeader chain
    headers-only; process p reads the bodies of only its contiguous
    rank-major slice of segments (``seg_io.iter_segments_selected`` seeks
    past foreign bodies, header_format.tex:209-218), decodes them as
    :func:`decompress_snapshot` does, and returns its slabs as global
    block-sharded :class:`multihost.BlockShards`.

    ``mesh``: the mesh whose first device takes the arrays; None takes
    ``device`` (``cuda`` unless the caller asks for ``cpu``).  ``fields``
    as in :func:`decompress_snapshot`.

    Returns (every process): ``{"pos": (B, 3, nb) f32, "vel": (B, 3, nb),
    "ids": (B, nb) int64 of u64 bits, "mass": (B, nb) f32 -- BlockShards
    of this process's blocks -- "local": {the slabs in
    decompress_snapshot's shapes}, "num_blocks", "blocks_local",
    "n_per_block"}``.  Decoded values are bit-identical to a
    single-process :func:`decompress_snapshot` of the same file."""
    want = _parse_want(fields)
    P, p = mh.process_count(), mh.process_index()
    start = fp.tell()
    S = seg_io.count_segments(fp)
    if S == 0:
        return {}
    if S % P:
        raise ValueError(
            f"{S} segments do not divide across {P} processes; "
            "write with num_blocks a multiple of the process count")
    k = S // P
    fp.seek(start)
    segments = [body for _, _, body in seg_io.iter_segments_selected(
        fp, range(p * k, (p + 1) * k))]
    local = decode_segments(segments, batched, want, device)
    out = {"num_blocks": S, "blocks_local": k, "local": local}
    if mesh is None:
        mesh = make_mesh(1, device=device)
    for name, arr in local.items():
        if arr.shape[-1] % k:
            raise ValueError(f"field {name!r}: {arr.shape[-1]} local "
                             f"particles do not divide into {k} blocks")
        nb = arr.shape[-1] // k
        if arr.dim() == 2:      # float triple: (3, n_local)
            blocks = arr.reshape(arr.shape[0], k, nb).transpose(0, 1)
        else:                   # scalar / ids: (n_local,)
            blocks = arr.reshape(k, nb)
        out["n_per_block"] = nb
        out[name] = mh.global_block_array(blocks.contiguous(), mesh)
    return out


def _block_view(seg, span: wire.BlockSpan) -> np.ndarray:
    """A stored block's bytes as a uint8 view of its segment's."""
    return np.frombuffer(seg, np.uint8, count=span.length,
                         offset=span.offset)


def _meta(seg, field: wire.WireField) -> np.ndarray:
    """The payload of a field's meta block (its first) in one segment."""
    return decode_block(_block_view(seg, field.blocks[0]))[0]


def _blocks_hold(segments, layouts) -> bool:
    """Whether every stored block of every field matches the checksum its
    block header states (``wire.deserialize``'s check), one pool task a
    block on a view of its segment's bytes."""
    spans = [(seg, b) for seg, lay in zip(segments, layouts)
             for f in lay.fields for b in f.blocks]
    if not spans:
        return True
    return all(entropy.pool_map(
        lambda seg, b: checksum(_block_view(seg, b)) == b.checksum,
        *zip(*spans)))


class _Payload(NamedTuple):
    """A payload block as its prelude gives it: its stored bytes (a view
    of the segment's), raw length, width, and whether LZ4 codes them."""

    stored: np.ndarray
    raw_len: int
    width: int
    lz4: bool


def _payload(seg, span: wire.BlockSpan) -> _Payload:
    """A payload block's prelude, read as ``decode_block`` reads it.
    Raises ValueError where ``decode_block`` would, and on a raw length
    that is no whole number of u32 words."""
    if span.length < PRELUDE_BYTES:
        raise StreamUnderflowError(
            f"block of {span.length} bytes has no {PRELUDE_BYTES}-byte "
            "prelude")
    raw_len, comp_len, width, flags = struct.unpack_from("<IIBB", seg,
                                                         span.offset)
    if flags & ~FLAG_LZ4:   # the one flag a writer sets
        raise ValueError(f"unknown block flag bits {flags:#x}; refusing "
                         "to return misdecoded payload")
    if PRELUDE_BYTES + comp_len > span.length:
        raise StreamUnderflowError(
            f"block of {span.length} bytes cannot hold its stored "
            f"payload of {comp_len}")
    lz4 = bool(flags & FLAG_LZ4)
    if not lz4 and comp_len != raw_len:
        raise ValueError("block comp_len != raw_len without entropy flag")
    if raw_len % 4:
        raise ValueError(f"payload of {raw_len} bytes is no whole number "
                         "of u32 words")
    stored = np.frombuffer(seg, np.uint8, count=comp_len,
                           offset=span.offset + PRELUDE_BYTES)
    return _Payload(stored, raw_len, width, lz4)


def _into_row(p: _Payload, row: np.ndarray) -> None:
    """One pool task: a payload's stored bytes into its row of words."""
    if p.lz4:
        entropy.decode_into(p.stored, row)
    else:
        np.copyto(row.view(np.uint8), p.stored)


def _payload_words(segments, layouts, fi: int, nd: int) -> Optional[list]:
    """Payload blocks 1..``nd`` of field ``fi`` of every segment as one
    host (B, words) u32 array a dim, and the dim's width: one pool task a
    (segment, dim) LZ4-decodes its stored view (or copies a raw one)
    straight into its row.  None when a dim's widths differ; their stored
    bytes count as ``pooled_decode_bytes``."""
    spans = [[lay.fields[fi].blocks[1 + d] for lay in layouts]
             for d in range(nd)]
    dims = [[_payload(seg, sp) for seg, sp in zip(segments, spans_d)]
            for spans_d in spans]
    if any(len({p.width for p in dim}) != 1 for dim in dims):
        return None
    if any(len({p.raw_len for p in dim}) != 1 for dim in dims):
        raise ValueError("payload lengths differ across segments")
    out = [(np.empty((len(dim), dim[0].raw_len // 4), "<u4"), dim[0].width)
           for dim in dims]
    tasks = [(p, words[b]) for dim, (words, _) in zip(dims, out)
             for b, p in enumerate(dim)]
    entropy.pool_map(_into_row, *zip(*tasks))
    count("pooled_decode_bytes", sum(sp.length for spans_d in spans
                                     for sp in spans_d))
    return out


def _to_device(words: np.ndarray, device, name: str) -> torch.Tensor:
    """Host (B, words) u32 rows as int32 on ``device``, in span
    ``decode.<name>.upload``."""
    with phase(f"decode.{name}.upload"):
        return rows.card(torch.from_numpy(words.view(np.int32)), device)


def _decompress_snapshot_batched(segments, want,
                                 device) -> Optional[dict]:
    """Batched decode of a uniform snapshot file; None if the file doesn't
    fit the writer's structure or a block fails its checksum (the caller
    then decodes per segment).  The host wire runs in the pool on views of
    the segment bytes: every block's checksum (``decode.parse``), then
    each field's payloads decoded into their rows (``_payload_words``)."""
    with phase("decode.parse"):
        try:
            layouts = [wire.layout(s) for s in segments]
        except ValueError:
            return None
        if not layouts:
            return None
        nb = layouts[0].particle_num
        sig = [(f.field_code, f.algo_code, len(f.blocks))
               for f in layouts[0].fields]
        for lay in layouts:
            if lay.particle_num != nb or \
                    [(f.field_code, f.algo_code, len(f.blocks))
                     for f in lay.fields] != sig:
                return None
        if any(algo != int(AlgoCode.TRIM) for _, algo, _ in sig) or \
                not _blocks_hold(segments, layouts):
            return None

    B = len(layouts)
    out = {}
    for fi, (code, _, _) in enumerate(sig):
        if want is not None and code not in want:
            continue
        fields = [lay.fields[fi] for lay in layouts]
        kind = _KIND_BY_CODE.get(code)
        if kind is not None:
            metas = []
            for b in range(B):
                m = _read_meta(kind, _meta(segments[b], fields[b]))
                if m is None:
                    return None  # per-particle depths: per segment
                metas.append(m)
            depth, seed, box, mode, threshold = metas[0][2]
            if any(a != b for m in metas for a, b in zip(m[2], metas[0][2])):
                return None
            if depth < 1 or depth > 24:
                return None  # foreign/corrupt depth: per-segment path
            name, nd = kind.name, kind.dims
            with phase(f"decode.{name}.entropy"):
                dims_h = _payload_words(segments, layouts, fi, nd)
            if dims_h is None or any(w != depth for _, w in dims_h):
                return None
            x0_np = np.array([m[0] for m in metas], dtype=np.float32)
            x1_np = np.array([m[1] for m in metas], dtype=np.float32)
            if nd == 1:   # UNSF: f32(x1) - f32(x0), the scalar engine's
                dx_np = x1_np - x0_np
            else:         # canonical per-dim: f32(x0 + maxDiff) - f32(x0)
                md_np = (x1_np - x0_np).max(axis=1).astype(np.float64)
                dx_np = (np.float32(x0_np.astype(np.float64) +
                                    md_np[:, None]) - x0_np).astype(
                    np.float32)   # (B, 3)
            # the per-segment decode derives a key per dim; so does this
            with phase(f"decode.{name}"):
                dims = [rows.decode(
                    _to_device(dims_h[d][0], device, name),
                    [_rng.field_key(seed, fi, d)], x0_np[:, d], dx_np[:, d],
                    depth, nb, float(box) if kind.periodic else None)
                    for d in range(nd)]
                data = engine.unmap_float(
                    torch.stack(dims, dim=1) if nd > 1 else dims[0][:, None],
                    mode, float(threshold))  # (B, nd, nb)
            flat = data.transpose(0, 1).reshape(nd, B * nb)
            out[name] = flat if nd > 1 else flat[0]
        elif code == int(FieldCode.PTID):
            metas = []
            for b in range(B):
                r = Reader(_meta(segments[b], fields[b]).tobytes())
                width = r.u64()
                x0 = [r.u64() for _ in range(3)]
                _ = [r.u64() for _ in range(3)]
                metas.append((width, x0))
            width = metas[0][0]
            if any(m[0] != width for m in metas):
                return None
            with phase("decode.ids.entropy"):
                dims_h = _payload_words(segments, layouts, fi, 3)
            if dims_h is None:
                return None
            with phase("decode.ids"):
                dims = []
                for words_h, wbits in dims_h:
                    words_d = _to_device(words_h, device, "ids")
                    bins = rows.unpack(words_d, wbits, nb)
                    dims.append(kernels.u32_to_i64(bins))
                x0 = rows.card(torch.tensor(
                    [[kernels.u64_to_i64(m[1][d]) for m in metas]
                     for d in range(3)], dtype=torch.int64), device)
                ids = engine.id_recompose(dims, x0, width)
            out["ids"] = ids.reshape(-1)
        else:
            return None
    return out
