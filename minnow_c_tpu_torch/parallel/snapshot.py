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
bytes straight from the LZ4 outputs.  The files are byte-identical to the
JAX package's writer, and either package reads the other's.

Depth policy: one depth per field across all blocks; ranges stay per
block.  Encode runs on the device of the given tensors (numpy input goes
to ``device=``, ``cuda`` unless the caller asks for ``cpu``); decode
returns tensors on ``device``.  The batched passes
go through the rows kernels: K6 ``stats_rows`` (per-block stats), K7
``pack_rows`` (every pack when 32 | nb), K8 ``encode_recip_rows`` (the
whole float bin map and pack in the recip scale mode, 32 | nb), K2
``decode_rows`` (float decode) and K3 ``unpack_rows`` (ID decode); with
32 ∤ nb the blocks pack and decode row by row through K4 (or K5 in the
recip mode) and K1.

The log10 / symlog10 maps run as torch ops (``engine.map_float``) on the
whole (block, dim) rows before the stats and again before the bin map, so
K6, K7 and K8 see mapped rows and no kernel holds a map; the batched read
unmaps K2's output op by op (``engine.unmap_float``).  A field with
per-particle accuracies (Deltas mode) goes block by block through the
segment engine and Trim v1.1 (``_encode_float_blocks_deltas``), whose
chunk bodies pack with K7; the batched read leaves such a file to the
per-segment decode, as the JAX package's does.

``compress_snapshot_streaming`` writes a snapshot block by block, one
segment per block, with the same encoders at B = 1.

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
from typing import BinaryIO, List, Optional

import numpy as np
import torch

from ..algos.algo_trim_v1_0 import VERSION as TRIM_VERSION
from ..algos.blocks import FLAG_LZ4, decode_block, encode_block
from ..ops import bitpack, entropy, kernels
from ..ops import rng as _rng
from ..ops.checksum import CHECKSUM_INIT, checksum
from ..ops.decode_cuda import (decode_cuda, decode_rows_cuda,
                               rows_kernel_eligible, unpack_rows_cuda)
from ..ops.encode_cuda import encode_recip_cuda, encode_recip_rows_cuda
from ..quant import engine
from ..segment import format as wire
from ..segment import io as seg_io
from ..segment.api import decompress_segment
from ..segment.stream import Reader, Writer
from ..types import (AlgoCode, FieldCode, FloatAccuracy, IDAccuracy,
                     PositionAccuracy, VelocityAccuracy)
from ..utils import native_order
from ..utils.profiling import count, operation, phase
from . import multihost as mh
from .sharding import _block_stats, _rows_stats, make_mesh

@dataclass(frozen=True)
class SnapshotSpec:
    """Accuracy requests for the standard snapshot fields.  ``mass`` is
    an optional scalar per-particle float field (stored as UNSF) -- e.g.
    the Gadget-2 per-particle MASS block."""

    pos: Optional[PositionAccuracy] = None
    vel: Optional[VelocityAccuracy] = None
    ids: Optional[IDAccuracy] = None
    mass: Optional[FloatAccuracy] = None


def _nbytes(a) -> int:
    return a.numel() * a.element_size() if isinstance(a, torch.Tensor) \
        else np.asarray(a).nbytes


def _host(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as numpy; its bytes count as ``d2h`` when it
    leaves the card."""
    count("d2h", _nbytes(t) if t.is_cuda else 0)
    return t.cpu().numpy()


def _host_u32(words: torch.Tensor) -> np.ndarray:
    """int32 words of u32 bits -> host uint32 array."""
    return _host(words).view(np.uint32)


def _card(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; its bytes count as ``h2d`` when that
    is the card."""
    out = t.to(device)
    count("h2d", _nbytes(out) if out.is_cuda and not t.is_cuda else 0)
    return out


def _upload(data, dtype: torch.dtype, device) -> torch.Tensor:
    """``engine.as_tensor``; numpy input that goes to the card counts as
    ``h2d`` (a tensor stays on its own device)."""
    t = engine.as_tensor(data, dtype, device)
    count("h2d", _nbytes(t) if t.is_cuda and
          not isinstance(data, torch.Tensor) else 0)
    return t


# ---------------------------------------------------------------------------
# Per-block stats (sharding._rows_stats_raw / _float_rows_stats)
# ---------------------------------------------------------------------------

def _float_rows_stats(x: torch.Tensor, box):
    """(B, 3, nb) -> x0 (B, 3), per-block shared range (B,) =
    max over dims of (max - min)."""
    b, d, nb = x.shape
    mn, rng_b = _block_stats(x.reshape(b * d, nb), box)
    return mn.reshape(b, d), rng_b


def _open_counters(*keys: str) -> None:
    """Give the open record each counter from the operation's start, 0
    until a step adds to it: a write's ``packed_bits`` (depth or ID width
    times elements, every field's packed bins before LZ4),
    ``depth_room`` (fields the room rule made deeper) and
    ``pooled_sum_bytes`` (stored block bytes whose checksum a pool task
    took, ``_entropy``), a read's ``h2d``
    and ``d2h`` (a read that leaves its fields on the card downloads
    nothing)."""
    for key in keys:
        count(key, 0)


def _float_extent(x0: torch.Tensor, rng_b: torch.Tensor) -> tuple:
    """The widest block range and the largest |x0| or |x0 + range| of
    every (block, dim), host floats in one copy: what the room rule of a
    field without a box needs (``engine.delta_to_depth``)."""
    x0 = x0.reshape(rng_b.shape[0], -1)
    mag = torch.maximum(x0.abs(), (x0 + rng_b[:, None]).abs()).amax()
    rng, mag = _host(torch.stack([rng_b.amax(), mag]))
    return float(rng), float(mag)


def _float_depth(delta: float, rng: float, magnitude: float) -> int:
    """A float field's shared depth by the room rule over the widest
    block range; counts ``depth_room`` 1 when the room made it deeper than
    the reference's rule."""
    depth = engine.delta_to_depth(delta, 0.0, rng, magnitude=magnitude)
    count("depth_room", int(depth > engine.delta_to_depth(delta, 0.0, rng)))
    return depth


def _batched_stats_pos(x: torch.Tensor, width: float):
    """(B, 3, nb) -> per-block x0 (B, 3), per-block shared range (B,) of
    the periodically unwrapped positions.  The unwrapped plane is not
    kept: the pack phase recomputes it, bit-identically."""
    return _float_rows_stats(x, width)


def _batched_stats_vel(x: torch.Tensor, sym_log10_scaled: int = 0,
                       threshold: float = 0.0):
    """Velocity analog of ``_batched_stats_pos``: stats of the mapped
    plane (the identity or the symlog map)."""
    xm = engine.map_float(x, 2 if sym_log10_scaled else 0, threshold)
    return _float_rows_stats(xm, None)


def _batched_stats_scalar(x: torch.Tensor, mode: int = 0,
                          threshold: float = 0.0):
    """(B, nb) scalar float field -> per-block (x0 (B,), x1 (B,)) of the
    mapped plane.  Raw min AND max: the UNSF decode derives its bin width
    as f32(x1) - f32(x0), so the stored x1 must be the true max."""
    return _rows_stats(engine.map_float(x, mode, threshold), None)


# ---------------------------------------------------------------------------
# Bin + pack
# ---------------------------------------------------------------------------

def _pack_bins_rows(bins: torch.Tensor, depth: int) -> torch.Tensor:
    """(B, D, nb) u32 bins -> (B, D, words) packed streams."""
    b, d, nb = bins.shape
    rows = bins.reshape(b * d, nb)
    if nb % 32 == 0:
        words = bitpack.uniform_pack_rows(rows, depth)
    else:
        words = torch.stack([bitpack.uniform_pack(r, depth) for r in rows])
    return words.reshape(b, d, -1)


def _bin_pack_rows(x: torch.Tensor, x0: torch.Tensor, rng_b: torch.Tensor,
                   depth: int, box, scale_mode: str) -> torch.Tensor:
    """(B, D, nb) mapped floats (RAW positions when ``box`` is not None),
    x0 (B, D), shared range (B,) -> (B, D, words): the bin map of every
    row in ``scale_mode``, then the pack."""
    if scale_mode == "recip":
        return _recip_rows(x, x0, rng_b, depth, box)
    b, d, nb = x.shape
    rows = x.reshape(b * d, nb)
    if box is not None:
        rows = kernels.undo_periodic(rows, box)
    bins = kernels.uniform_bin_index(
        rows, depth, x0.reshape(b * d, 1),
        rng_b.repeat_interleave(d)[:, None])
    return _pack_bins_rows(bins.reshape(b, d, nb), depth)


def _recip_rows(x: torch.Tensor, x0: torch.Tensor, rng_b: torch.Tensor,
                depth: int, box) -> torch.Tensor:
    """The recip scale mode's bin map and pack of (B, D, nb) RAW floats
    (``sharding._float_rows_encode_recip``): row (b, d) maps with x0[b, d]
    and the block's recip = rn(1 / rng_b[b]), unwrapped around its own raw
    element 0 when ``box`` is not None.  One K8 launch when 32 | nb, else
    K5 row by row; a depth outside 1-24 takes the plain map and the
    pack."""
    b, d, nb = x.shape
    periodic = box is not None
    boxf = float(np.float32(box if periodic else 0.0))
    rows = x.reshape(b * d, nb)
    recip = np.repeat(np.atleast_1d(kernels.exact_recip(
        _host(rng_b))), d)                                   # (B*D,)
    kernel_width = 1 <= depth <= 24
    if kernel_width and nb % 32:
        x0_h = _host(x0.reshape(b * d))
        anchors = _host(rows[:, 0])
        return torch.stack([
            encode_recip_cuda(rows[r], depth, x0_h[r], recip[r], boxf,
                              anchors[r], periodic)
            for r in range(b * d)]).reshape(b, d, -1)
    recip_t = _card(torch.from_numpy(recip), x.device)
    if kernel_width:
        boxes = torch.full((b * d,), boxf, dtype=torch.float32,
                           device=x.device)
        return encode_recip_rows_cuda(
            rows, depth, x0.reshape(b * d), recip_t, boxes, rows[:, 0],
            periodic).reshape(b, d, -1)
    bins = kernels.recip_scaled_bins(rows, x0.reshape(b * d, 1),
                                     recip_t[:, None], boxf, rows[:, :1],
                                     depth, periodic)
    return _pack_bins_rows(bins.reshape(b, d, nb), depth)


def _batched_bin_pack_pos(x: torch.Tensor, x0: torch.Tensor,
                          rng_b: torch.Tensor, depth: int, width: float,
                          scale_mode: str = "div"):
    """(B, 3, nb) RAW positions -> (B, 3, words) packed bins at ``depth``;
    recomputes the periodic unwrap of the stats pass."""
    return _bin_pack_rows(x, x0, rng_b, depth, float(width), scale_mode)


def _batched_bin_pack_vel(x: torch.Tensor, x0: torch.Tensor,
                          rng_b: torch.Tensor, depth: int,
                          sym_log10_scaled: int = 0,
                          threshold: float = 0.0, scale_mode: str = "div"):
    """Velocity analog: recomputes the map (the identity or the symlog,
    bit-identical to the stats pass's), then bins and packs."""
    xm = engine.map_float(x, 2 if sym_log10_scaled else 0, threshold)
    return _bin_pack_rows(xm, x0, rng_b, depth, None, scale_mode)


def _batched_bin_pack_scalar(x: torch.Tensor, x0: torch.Tensor,
                             rng_b: torch.Tensor, depth: int, mode: int = 0,
                             threshold: float = 0.0,
                             scale_mode: str = "div"):
    """(B, nb) scalar floats -> (B, 1, words) packed bins."""
    xm = engine.map_float(x, mode, threshold)
    return _bin_pack_rows(xm[:, None, :], x0[:, None], rng_b, depth, None,
                          scale_mode)


def _batched_id_pack(rel: torch.Tensor, w: int) -> torch.Tensor:
    """(B, nb) u32 relative ID coordinates -> (B, words); each block's
    stream is padded on its own, so any (nb, width) is valid."""
    return _pack_bins_rows(rel[:, None, :], w)[:, 0]


# ---------------------------------------------------------------------------
# Field encoders: device passes -> per-block wire block lists
# ---------------------------------------------------------------------------

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


def _entropy(rows: List[np.ndarray], widths: List[int], accel: int,
             name: str) -> List[wire.StoredBlock]:
    """Every payload of host words (rows in block-major order, each with
    its bit width) as its stored block, one pool task each: LZ4, prelude,
    pad and the chained checksum.  Their bytes count as
    ``pooled_sum_bytes``."""
    with phase(f"{name}.entropy"):
        out = entropy.pool_map(lambda r, w: _stored_block(r, w, accel),
                               rows, widths)
    count("pooled_sum_bytes", sum(map(len, out)))
    return out


def _float_entropy(words_h: np.ndarray, depth: int, accel: int,
                   name: str) -> List[wire.StoredBlock]:
    """``_entropy`` of every (block, dim) row of (B, D, words) host
    words."""
    b, d, w = words_h.shape
    rows = list(words_h.reshape(b * d, w))
    return _entropy(rows, [depth] * len(rows), accel, name)


def _float_blocks(meta: Writer, stored: List[wire.StoredBlock], b: int,
                  d: int, accel: int) -> list:
    """Block ``b``'s wire blocks: its meta, then its ``d`` stored dims."""
    return [encode_block(meta.data, 0, True, accel)] + \
        stored[b * d:(b + 1) * d]


def _encode_pos_batch(pos, B: int, nb: int, acc, seed: int, accel: int,
                      device, depth: Optional[int] = None,
                      scale_mode: str = "div"):
    """Batched device encode of positions (3, B*nb) -> per-block wire
    block lists (Trim v1.0 layout), the shared depth (``depth=None``
    derives it from the observed global range), and the per-block bounding
    boxes of the raw positions (lo, hi), host (B, 3) each.  Numpy input
    goes to ``device``."""
    with phase("pos.upload"):
        pos = _upload(pos, torch.float32, device)
    with phase("pos.stats"):
        xb = pos.reshape(3, B, nb).transpose(0, 1).contiguous()
        x0, rng_b = _batched_stats_pos(xb, float(acc.width))
        box = (xb.amin(dim=2), xb.amax(dim=2))
        if depth is None:
            depth = _float_depth(acc.delta, float(_host(rng_b.max())),
                                 float(acc.width))
    with phase("pos.binpack"):
        words = _batched_bin_pack_pos(xb, x0, rng_b, depth, float(acc.width),
                                      scale_mode)
    count("packed_bits", depth * xb.numel())
    with phase("pos.gather"):
        words_h = _host_u32(words)
        x0_h = _host(x0)
        rng_h = _host(rng_b)
        box = tuple(_host(t) for t in box)
    stored = _float_entropy(words_h, depth, accel, "pos")
    out = []
    with phase("pos.wrap"):
        for b in range(B):
            meta = Writer()
            for v in x0_h[b]:
                meta.f32(float(v))
            for v in x0_h[b] + rng_h[b]:
                meta.f32(float(v))
            meta.f32(acc.width)
            meta.u8(depth).u8(0).u16(0)
            meta.u64(seed)
            out.append(_float_blocks(meta, stored, b, words_h.shape[1],
                                     accel))
    return out, depth, box


def _encode_vel_batch(vel, B: int, nb: int, acc, seed: int, accel: int,
                      device, depth: Optional[int] = None,
                      scale_mode: str = "div"):
    sym = int(acc.sym_log10_scaled)
    thr = float(acc.sym_log10_threshold)
    with phase("vel.upload"):
        vel = _upload(vel, torch.float32, device)
    with phase("vel.stats"):
        xb = vel.reshape(3, B, nb).transpose(0, 1).contiguous()
        x0, rng_b = _batched_stats_vel(xb, sym, thr)
        if depth is None:
            depth = _float_depth(acc.delta, *_float_extent(x0, rng_b))
    with phase("vel.binpack"):
        words = _batched_bin_pack_vel(xb, x0, rng_b, depth, sym, thr,
                                      scale_mode)
    count("packed_bits", depth * xb.numel())
    with phase("vel.gather"):
        words_h = _host_u32(words)
        x0_h = _host(x0)
        rng_h = _host(rng_b)
    stored = _float_entropy(words_h, depth, accel, "vel")
    out = []
    with phase("vel.wrap"):
        for b in range(B):
            meta = Writer()
            for v in x0_h[b]:
                meta.f32(float(v))
            for v in x0_h[b] + rng_h[b]:
                meta.f32(float(v))
            meta.u8(depth).u8(0)
            meta.u8(2 if sym else 0).u8(0)
            meta.f32(thr)
            meta.u64(seed)
            out.append(_float_blocks(meta, stored, b, words_h.shape[1],
                                     accel))
    return out, depth


def _encode_scalar_float_batch(vals, B: int, nb: int, acc, seed: int,
                               accel: int, device,
                               depth: Optional[int] = None,
                               scale_mode: str = "div"):
    """Batched device encode of a scalar per-particle float field (n,) ->
    per-block UNSF wire block lists (Trim v1.0 layout) + the shared
    depth.  Used for Gadget-2 per-particle MASS and any other auxiliary
    scalar field."""
    mode = int(getattr(acc, "log10_scaled", 0))
    threshold = float(getattr(acc, "sym_log10_threshold", 0.0))
    with phase("mass.upload"):
        xb = _upload(vals, torch.float32, device).reshape(B, nb)
    with phase("mass.stats"):
        x0, x1 = _batched_stats_scalar(xb, mode, threshold)
        x0_h = _host(x0)
        x1_h = _host(x1)
        rng_h = x1_h.astype(np.float32) - x0_h.astype(np.float32)  # (B,)
        if depth is None:
            depth = _float_depth(acc.delta, float(rng_h.max()),
                                 float(np.abs([x0_h, x1_h]).max()))
    with phase("mass.binpack"):
        words = _batched_bin_pack_scalar(
            xb, x0, _card(torch.from_numpy(rng_h), xb.device), depth, mode,
            threshold, scale_mode)
    count("packed_bits", depth * xb.numel())
    with phase("mass.gather"):
        words_h = _host_u32(words)  # (B, 1, wpb)
    stored = _float_entropy(words_h, depth, accel, "mass")
    out = []
    with phase("mass.wrap"):
        for b in range(B):
            meta = Writer()
            meta.f32(float(x0_h[b])).f32(float(x1_h[b]))
            meta.u8(depth).u8(0)
            meta.u8(mode).u8(0)
            meta.f32(threshold)
            meta.u64(seed)
            out.append(_float_blocks(meta, stored, b, words_h.shape[1],
                                     accel))
    return out, depth


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
            x0g = _host(x0g).view(np.uint64)  # global per-dim offset
        else:
            gmin = np.asarray(id_sync["gmin"], dtype=np.int64)
            lift = np.where(gmin < 0, np.int64(acc.width), np.int64(0))
            x0g = (gmin + lift).view(np.uint64)
            shifted = id_sync["shifted"]
            qdims = shifted - _card(torch.from_numpy(gmin),
                                    shifted.device)[:, None]
        # the low 32 bits, as the reference's u32 cast keeps them
        qd = qdims.bitwise_and_(kernels.M32).reshape(3, B, nb)
    # The stored per-block origin includes the global decompose offset,
    # so undoID's rewrap sees true unwrapped coordinates.
    with phase("ids.pack"):
        x0_rel = qd.amin(dim=2)                      # (3, B)
        rel = qd - x0_rel[:, :, None]
        relmax_b = _host(rel.amax(dim=2))            # (3, B)
        x0_blocks = _host(x0_rel).astype(np.uint64) + x0g[:, None]
        relmax = relmax_b.max(axis=1)
        if id_sync is not None:
            # the widest block range over every process's blocks, as the
            # single-host writer sees it
            relmax = mh.allgather_i64(relmax).max(axis=0)
        widths = [int(relmax[i]).bit_length() for i in range(3)]
        count("packed_bits", sum(max(w, 1) for w in widths) * B * nb)
        packed = []
        for i in range(3):
            words = _batched_id_pack(kernels.i64_to_u32(rel[i]),
                                     max(widths[i], 1))
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
        deltas = _host(deltas)
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
    return _host(xb.amin(dim=2).T), _host(xb.amax(dim=2).T)


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
    pos, vel, ids, mass = (native_order(a) for a in (pos, vel, ids, mass))
    if mass is not None and spec.mass is None:
        raise ValueError("mass array given without spec.mass accuracy")
    given = [a for a in (pos, vel, ids, mass) if a is not None]
    if not given:
        raise ValueError("no fields given")
    n = given[0].shape[-1]
    if n % num_blocks:
        raise ValueError(f"{n} particles do not divide into {num_blocks} "
                         "blocks; pad the tail (client duty)")
    nb = n // num_blocks
    B = num_blocks
    stats = {}
    _open_counters("packed_bits", "depth_room", "pooled_sum_bytes")
    per_block_fields: List[List[wire.WireField]] = [[] for _ in range(B)]

    def add_field(code, field_blocks, version=TRIM_VERSION):
        for b in range(B):
            per_block_fields[b].append(wire.WireField(
                int(code), int(AlgoCode.TRIM), version, field_blocks[b]))

    def float_field(name, arr, code, encode):
        acc = getattr(spec, name)
        if getattr(acc, "deltas", None) is not None:
            field_blocks, version = _encode_float_blocks_deltas(
                arr, B, nb, code, acc, seed, accel, scale_mode, device)
            stats[f"{name}_depth"] = "per-particle"
            add_field(code, field_blocks, version)
            return None
        out = encode(arr, B, nb, acc, seed, accel, device,
                     scale_mode=scale_mode)
        stats[f"{name}_depth"] = out[1]
        add_field(code, out[0])
        return out

    geometry = None
    if pos is not None:
        out = float_field("pos", pos, FieldCode.POSN, _encode_pos_batch)
        lo, hi = _blocks_box(pos, B, nb, device) if out is None else out[2]
        # IOHeader Origin/Width (header_format.tex:206-218): per-block
        # bounding box of the raw (wrapped) positions, for skip-ahead
        # spatial queries.
        geometry = [(tuple(float(lo[b, d]) for d in range(3)),
                     tuple(float(hi[b, d] - lo[b, d]) for d in range(3)))
                    for b in range(B)]
    if vel is not None:
        float_field("vel", vel, FieldCode.VELC, _encode_vel_batch)
    if ids is not None:
        field_blocks, widths = _encode_id_batch(ids, B, nb, spec.ids, accel,
                                                device)
        stats["id_widths"] = widths
        add_field(FieldCode.PTID, field_blocks)
    if mass is not None:
        float_field("mass", mass, FieldCode.UNSF, _encode_scalar_float_batch)

    # ---- serialize + chain -----------------------------------------------
    with phase("serialize"):
        segments = [wire.serialize_parts(fields, nb)
                    for fields in per_block_fields]
    with phase("segments.write"):
        seg_io.write_segments(fp, segments, geometry)
    stats["bytes"] = sum(map(seg_io.segment_nbytes, segments)) + \
        seg_io.IO_HEADER_BYTES * B
    stats["num_blocks"] = B
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
    encoders = {FieldCode.POSN: _encode_pos_batch,
                FieldCode.VELC: _encode_vel_batch,
                FieldCode.UNSF: _encode_scalar_float_batch}

    def seg_gen():
        for blk in blocks_iter:
            pos, vel, ids, mass = (native_order(blk.get(k))
                                   for k in ("pos", "vel", "ids", "mass"))
            nb = next(a.shape[-1] for a in (pos, vel, ids) if a is not None)
            fields: List[wire.WireField] = []
            geometry = None

            def float_field(arr, code, acc, dkey):
                bd = native_order(blk.get(dkey + "_deltas"))
                if bd is not None:
                    fbl, ver = _encode_float_blocks_deltas(
                        arr, 1, nb, code, dataclasses.replace(acc, deltas=bd),
                        seed, accel, scale_mode, device)
                    fields.append(wire.WireField(int(code),
                                                 int(AlgoCode.TRIM), ver,
                                                 fbl[0]))
                    return None
                out = encoders[code](arr, 1, nb, acc, seed, accel, device,
                                     depth=depths.get(dkey),
                                     scale_mode=scale_mode)
                fields.append(wire.WireField(int(code), int(AlgoCode.TRIM),
                                             TRIM_VERSION, out[0][0]))
                return out

            if pos is not None:
                out = float_field(pos, FieldCode.POSN, spec.pos, "pos")
                lo, hi = _blocks_box(pos, 1, nb, device) if out is None \
                    else out[2]
                geometry = (tuple(float(v) for v in lo[0]),
                            tuple(float(h - l) for h, l in zip(hi[0],
                                                               lo[0])))
            if vel is not None:
                float_field(vel, FieldCode.VELC, spec.vel, "vel")
            if ids is not None:
                fb, _ = _encode_id_batch(ids, 1, nb, spec.ids, accel, device)
                fields.append(wire.WireField(
                    int(FieldCode.PTID), int(AlgoCode.TRIM), TRIM_VERSION,
                    fb[0]))
            if mass is not None:
                float_field(mass, FieldCode.UNSF, spec.mass, "mass")
            seg = wire.serialize_parts(fields, nb)
            stats["bytes"] += seg_io.segment_nbytes(seg) + \
                seg_io.IO_HEADER_BYTES
            stats["num_blocks"] += 1
            yield seg, geometry

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
    range, so every process derives the shared depth the single-host
    writer would; the PTID frame is synced by the global element-0 anchor
    and the all-reduced per-dim minima and widest block ranges
    (``_multihost_id_sync``).  The file is byte-identical to a single-host
    :func:`compress_snapshot` of the concatenated data, whatever the
    process count."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    _reject_deltas(spec, "compress_snapshot_multihost")
    pos, vel, ids, mass = (native_order(a) for a in (pos, vel, ids, mass))
    if mass is not None and spec.mass is None:
        raise ValueError("mass array given without spec.mass accuracy")
    given = [a for a in (pos, vel, ids, mass) if a is not None]
    if not given:
        raise ValueError("no fields given")
    n = given[0].shape[-1]
    B = num_blocks_local
    if n % B:
        raise ValueError(f"{n} local particles do not divide into {B} "
                         "blocks; pad the tail (client duty)")
    nb = n // B
    stats = {}
    per_block_fields: List[List[wire.WireField]] = [[] for _ in range(B)]

    def add_field(code, field_blocks):
        for b in range(B):
            per_block_fields[b].append(wire.WireField(
                int(code), int(AlgoCode.TRIM), TRIM_VERSION,
                field_blocks[b]))

    def blocks(arr):
        arr = _upload(arr, torch.float32, device)
        return arr.reshape(3, B, nb).transpose(0, 1).contiguous()

    geo_blobs = [b""] * B
    if pos is not None:
        _, rng_b = _batched_stats_pos(blocks(pos), float(spec.pos.width))
        depth = _float_depth(spec.pos.delta,
                             mh.allgather_max_f32(float(_host(rng_b.max()))),
                             float(spec.pos.width))
        fb, _, (lo, hi) = _encode_pos_batch(
            pos, B, nb, spec.pos, seed, accel, device, depth=depth,
            scale_mode=scale_mode)
        stats["pos_depth"] = depth
        add_field(FieldCode.POSN, fb)
        geo_blobs = [struct.pack("<6d", *(float(v) for v in lo[b]),
                                 *(float(v) for v in hi[b] - lo[b]))
                     for b in range(B)]
    if vel is not None:
        x0, rng_b = _batched_stats_vel(blocks(vel),
                                       int(spec.vel.sym_log10_scaled),
                                       float(spec.vel.sym_log10_threshold))
        depth = _float_depth(spec.vel.delta, *(
            mh.allgather_max_f32(v) for v in _float_extent(x0, rng_b)))
        fb, _ = _encode_vel_batch(vel, B, nb, spec.vel, seed, accel, device,
                                  depth=depth, scale_mode=scale_mode)
        stats["vel_depth"] = depth
        add_field(FieldCode.VELC, fb)
    if ids is not None:
        fb, widths = _encode_id_batch(
            ids, B, nb, spec.ids, accel, device,
            id_sync=_multihost_id_sync(ids, int(spec.ids.width), device))
        stats["id_widths"] = widths
        add_field(FieldCode.PTID, fb)
    if mass is not None:
        mode = int(getattr(spec.mass, "log10_scaled", 0))
        thr = float(getattr(spec.mass, "sym_log10_threshold", 0.0))
        x0, x1 = _batched_stats_scalar(
            _upload(mass, torch.float32, device).reshape(B, nb),
            mode, thr)
        x0_h, x1_h = _host(x0), _host(x1)
        depth = _float_depth(
            spec.mass.delta, mh.allgather_max_f32(float((x1_h - x0_h).max())),
            mh.allgather_max_f32(float(np.abs([x0_h, x1_h]).max())))
        fb, _ = _encode_scalar_float_batch(mass, B, nb, spec.mass, seed,
                                           accel, device, depth=depth,
                                           scale_mode=scale_mode)
        stats["mass_depth"] = depth
        add_field(FieldCode.UNSF, fb)

    with phase("serialize"):
        segments = [wire.serialize(fields, nb)
                    for fields in per_block_fields]
    all_segs = mh.allgather_bytes(segments)
    all_geos = mh.allgather_bytes(geo_blobs)
    if mh.process_index() == 0:
        if fp is None:
            raise ValueError("process 0 must pass a writable fp")
        geometry = None
        if pos is not None:
            geometry = []
            for blob in all_geos:
                vals = struct.unpack("<6d", blob)
                geometry.append((vals[:3], vals[3:]))
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
    a = _card(torch.from_numpy(np.asarray(anchor, dtype=np.int64)),
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
    gmin = mh.allgather_i64(_host(shifted.amin(dim=1))).min(axis=0)
    return {"gmin": gmin, "shifted": shifted}


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

_FIELD_BY_NAME = {"pos": int(FieldCode.POSN), "vel": int(FieldCode.VELC),
                  "ids": int(FieldCode.PTID),
                  "mass": int(FieldCode.UNSF)}


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
    the result.  Selected fields are bit-identical to a full read."""
    _open_counters("h2d", "d2h")
    want = _parse_want(fields)
    with phase("decode.read"):
        if box is not None:
            origin, width = box
            segments = [s for _, s in seg_io.iter_segments_intersecting(
                fp, origin, width, periodic)]
        else:
            segments = [s for _, s in seg_io.iter_segments(fp)]
    return decode_segments(segments, batched, want, device)


def decode_segments(segments, batched: bool = True, want=None,
                    device="cuda") -> dict:
    """Decode a list of serialized segments (``want``: a set of FieldCodes,
    or None for all) into concatenated field tensors on ``device``, as
    ``decompress_snapshot`` returns them."""
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


def _batched_float_decode(words: torch.Tensor, x0: np.ndarray,
                          rng_b: np.ndarray, key, depth: int, nb: int,
                          periodic: bool, box: float) -> torch.Tensor:
    """(B, D, wpb) words -> (B, D, nb) floats; ``x0`` (B, D) and the bin
    range ``rng_b`` (B,) are host f32.  Every row shares the dither key
    and counters 0..nb, exactly what the per-segment decode does.  One K2
    launch over all (block, dim) rows when 32 | nb, else K1 row by row."""
    b, d = words.shape[:2]
    if depth <= 24 and rows_kernel_eligible(depth, nb):
        keys = _card(torch.tensor(key, dtype=torch.int64),
                     words.device).expand(b * d, 2)
        out = decode_rows_cuda(
            words.reshape(b * d, -1), keys, depth, nb, x0.reshape(b * d),
            np.repeat(rng_b, d), box=(box if periodic else 0.0),
            periodic=periodic)
        return out.reshape(b, d, nb)
    return torch.stack([torch.stack([
        decode_cuda(words[i, j], key, depth, nb, x0[i, j], rng_b[i], box,
                    periodic) for j in range(d)]) for i in range(b)])


def _stacked_words(blocks_by_seg, block: int):
    """The payload words of block ``block`` of every segment as host u32
    rows, and their shared width; None when the widths differ."""
    rows, widths = [], set()
    for blocks in blocks_by_seg:
        payload, w, _ = decode_block(blocks[block])
        widths.add(w)
        rows.append(np.frombuffer(payload.tobytes(), dtype="<u4"))
    if len(widths) != 1:
        return None
    return np.stack(rows), widths.pop()


def _to_device(words: np.ndarray, device, name: str) -> torch.Tensor:
    """Host u32 words as int32 on ``device``, in span
    ``decode.<name>.upload``."""
    with phase(f"decode.{name}.upload"):
        return _card(torch.from_numpy(
            np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)),
            device)


def _decompress_snapshot_batched(segments, want,
                                 device) -> Optional[dict]:
    """Batched decode of a uniform snapshot file; None if the file doesn't
    fit the writer's structure (the caller then decodes per segment)."""
    try:
        with phase("decode.parse"):
            parsed = [wire.deserialize(s) for s in segments]
    except ValueError:
        return None
    if not parsed:
        return None
    nb = parsed[0].particle_num
    sig = [(f.field_code, f.algo_code, len(f.blocks))
           for f in parsed[0].fields]
    for p in parsed:
        if p.particle_num != nb or \
                [(f.field_code, f.algo_code, len(f.blocks))
                 for f in p.fields] != sig:
            return None
        for f in p.fields:
            if (f.algo_code != int(AlgoCode.TRIM) or
                    any(b is None for b in f.blocks)):
                return None

    B = len(parsed)
    out = {}
    for fi, (code, _, _) in enumerate(sig):
        if want is not None and code not in want:
            continue
        blocks_by_seg = [p.fields[fi].blocks for p in parsed]
        if code in (int(FieldCode.POSN), int(FieldCode.VELC)):
            is_pos = code == int(FieldCode.POSN)
            metas = []
            for b in range(B):
                meta, _, _ = decode_block(blocks_by_seg[b][0])
                r = Reader(meta.tobytes())
                x0 = [r.f32() for _ in range(3)]
                x1 = [r.f32() for _ in range(3)]
                box = r.f32() if is_pos else 0.0
                depth = r.u8()
                if r.u8():
                    return None  # per-particle depths: per segment
                symlog, threshold = 0, 0.0
                if not is_pos:
                    symlog = r.u8()
                    r.u8()
                    threshold = r.f32()
                else:
                    r.u16()
                seed = r.u64()
                metas.append((x0, x1, box, depth, seed, symlog, threshold))
            depth = metas[0][3]
            seed = metas[0][4]
            box = metas[0][2]
            symlog, threshold = metas[0][5], metas[0][6]
            if any(m[3] != depth or m[4] != seed or m[2] != box or
                   m[5] != symlog or m[6] != threshold for m in metas):
                return None
            if depth < 1 or depth > 24:
                return None  # foreign/corrupt depth: per-segment path
            name = "pos" if is_pos else "vel"
            with phase(f"decode.{name}.entropy"):
                dims_h = [_stacked_words(blocks_by_seg, 1 + d)
                          for d in range(3)]
            if any(w is None or w[1] != depth for w in dims_h):
                return None
            x0_np = np.array([m[0] for m in metas], dtype=np.float32)
            md_np = np.array(
                [np.float32(np.max(np.float32(m[1]) - np.float32(m[0])))
                 for m in metas], dtype=np.float64)
            # canonical per-dim bin range: f32(x0 + maxDiff) - f32(x0)
            dx_np = (np.float32(x0_np.astype(np.float64) + md_np[:, None]) -
                     x0_np).astype(np.float32)  # (B, 3)
            # the per-segment decode derives a key per dim; so does this
            keys = [_rng.field_key(seed, fi, d) for d in range(3)]
            with phase(f"decode.{name}"):
                dims = [_batched_float_decode(
                    _to_device(dims_h[d][0], device, name)[:, None],
                    x0_np[:, d:d + 1],
                    dx_np[:, d], keys[d], depth, nb, is_pos,
                    float(box))[:, 0] for d in range(3)]
                data = engine.unmap_float(torch.stack(dims, dim=1), symlog,
                                          float(threshold))  # (B, 3, nb)
            out[name] = data.transpose(0, 1).reshape(3, B * nb)
        elif code == int(FieldCode.UNSF):
            metas = []
            for b in range(B):
                meta, _, _ = decode_block(blocks_by_seg[b][0])
                r = Reader(meta.tobytes())
                x0 = r.f32()
                x1 = r.f32()
                depth = r.u8()
                if r.u8():
                    return None  # per-particle depths: per segment
                log10_scaled = r.u8()
                r.u8()
                threshold = r.f32()
                seed = r.u64()
                metas.append((x0, x1, depth, seed, log10_scaled,
                              threshold))
            depth, seed = metas[0][2], metas[0][3]
            log10_scaled, threshold = metas[0][4], metas[0][5]
            if any(m[2:] != metas[0][2:] for m in metas):
                return None
            if depth < 1 or depth > 24:
                return None
            with phase("decode.mass.entropy"):
                stacked = _stacked_words(blocks_by_seg, 1)
            if stacked is None or stacked[1] != depth:
                return None
            x0_np = np.array([m[0] for m in metas], dtype=np.float32)
            # UNSF bin range is f32(x1) - f32(x0) directly (the scalar
            # engine path), unlike the 3-dim fields' canonical
            # f32(x0 + maxDiff) - f32(x0) form.
            dx_np = (np.array([m[1] for m in metas], dtype=np.float32)
                     - x0_np)
            with phase("decode.mass"):
                res = _batched_float_decode(
                    _to_device(stacked[0], device, "mass")[:, None],
                    x0_np[:, None], dx_np, _rng.field_key(seed, fi, 0),
                    depth, nb, False, 0.0)
                data = engine.unmap_float(res[:, 0], log10_scaled,
                                          float(threshold))  # (B, nb)
            out["mass"] = data.reshape(-1)
        elif code == int(FieldCode.PTID):
            metas = []
            for b in range(B):
                meta, _, _ = decode_block(blocks_by_seg[b][0])
                r = Reader(meta.tobytes())
                width = r.u64()
                x0 = [r.u64() for _ in range(3)]
                _ = [r.u64() for _ in range(3)]
                metas.append((width, x0))
            width = metas[0][0]
            if any(m[0] != width for m in metas):
                return None
            with phase("decode.ids.entropy"):
                dims_h = [_stacked_words(blocks_by_seg, 1 + d)
                          for d in range(3)]
            if any(w is None for w in dims_h):
                return None
            with phase("decode.ids"):
                dims = []
                for words_h, wbits in dims_h:
                    words_d = _to_device(words_h, device, "ids")
                    if rows_kernel_eligible(wbits, nb):
                        bins = unpack_rows_cuda(words_d, wbits, nb)
                    else:
                        bins = torch.stack([
                            bitpack.uniform_unpack(r, wbits, nb)
                            for r in words_d])
                    dims.append(kernels.u32_to_i64(bins))
                x0 = _card(torch.tensor(
                    [[kernels.u64_to_i64(m[1][d]) for m in metas]
                     for d in range(3)], dtype=torch.int64), device)
                ids = engine.id_recompose(dims, x0, width)
            out["ids"] = ids.reshape(-1)
        else:
            return None
    return out
