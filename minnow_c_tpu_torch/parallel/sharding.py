"""Data-parallel scale-out over a mesh of shards: the block-sharded
position and snapshot codecs.

Port of ``minnow_c_tpu/parallel/sharding.py``.  A snapshot is split into
equal particle blocks, and the blocks are split over the shards of a
:class:`Mesh` in contiguous runs.  The JAX package runs each codec as one
SPMD program under ``shard_map``; here each shard runs its blocks in one
batched pass over their (B_local*3, n_b) block-major rows, through the
row steps of ``rows`` that the snapshot writer and reader take too:

* encode: K6 ``stats_rows`` (each row's min / max after the periodic
  unwrap around its element 0), then the C-exact bin map and K7
  ``pack_rows`` in the div scale mode, or K8 ``encode_recip_rows`` (the
  recip map and the pack in one launch) in the recip scale mode; the IDs'
  grid split and u64 unwrap as torch ops, then K7;
* decode: K2 ``decode_rows`` with one dither key per row, and K3
  ``unpack_rows`` for the IDs.

``fused_rows=False`` runs every step through the kernels' plain torch
versions instead, the decode row by row as the JAX package's
``_float_rows_decode`` does (the plain reference of the card's path); on
CPU shards both paths run the plain versions.  The header all-reduces of
the SPMD programs (the adaptive profile's ``pmax``, the velocity keys'
``psum``) become a max and a count over the shards, and over the
processes when the input is a multi-process :class:`BlockShards`
(``multihost``).

Dither keys: positions of global block ``bi``, dim ``d`` use
``field_key(seed, bi, d)`` and velocities ``field_key(seed, B_total + bi,
d)``, where ``B_total`` counts the blocks of every shard and process, so
decoded bits do not depend on the mesh size or the process count.

Two encode profiles: ``spmd`` takes a static depth from the accuracy and
the periodic box (``spmd_depth_for``), ``adaptive`` the tightest depth
for the blocks' global range (``adaptive_depth_for``, one host sync).
Results are gathered on the mesh's first device.  The JAX codecs'
``axis`` and ``interpret`` have no counterpart here: the mesh carries its
axis, and Pallas's interpret mode is a TPU tool.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops import kernels
from ..ops import rng as _rng
from ..quant import engine
from . import multihost, rows
from .multihost import BlockShards


@dataclass(frozen=True)
class Mesh:
    """An ordered list of shard devices on one axis; the shards take
    contiguous runs of blocks in this order.  A device may repeat."""

    devices: Tuple[torch.device, ...]
    axis: str = "dp"

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: Optional[int] = None, axis: str = "dp",
              device="cuda") -> Mesh:
    """A mesh of ``n_devices`` shards; by default one shard per visible
    CUDA device.  On ``cuda`` the shards cycle over the visible cards (4
    shards on one card are 4 logical shards); on ``cpu`` (or a device with
    an index) every shard is that device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is visible; pass "
                               "device='cpu' for a CPU mesh")
        n = count if n_devices is None else n_devices
        devs = [torch.device("cuda", i % count) for i in range(n)]
    else:
        devs = [dev] * (1 if n_devices is None else n_devices)
    if not devs:
        raise ValueError("a mesh needs at least one shard")
    return Mesh(tuple(devs), axis)


def block_split(x, num_blocks: int):
    """Reshape (3, n) or (n,) particle data (numpy or a tensor) into
    (num_blocks, ..., n_b).  n must divide evenly; the client pads ragged
    tails (segmenting is the client's duty, spec table 1)."""
    n = x.shape[-1]
    if n % num_blocks:
        raise AssertionError("particle count must divide into blocks")
    if x.ndim == 1:
        return x.reshape(num_blocks, n // num_blocks)
    x = x.reshape(x.shape[0], num_blocks, n // num_blocks)
    return x.movedim(1, 0) if isinstance(x, torch.Tensor) else \
        np.moveaxis(x, 1, 0)


def _block_keys(seed: int, blocks) -> list:
    """The dither keys of blocks x 3 dims, block-major: [(k0, k1)] * 3B.
    The JAX package takes the seed as a u32."""
    seed = int(seed) & kernels.M32
    return [_rng.field_key(seed, int(bi), d) for bi in blocks
            for d in range(3)]


def _id_encode(ids: torch.Tensor, grid: int, width: int,
               fused: bool):
    """(b, n) u64 IDs (int64 bits) -> (b*3, n*width/32) words and the
    per-(block, dim) origins (b, 3), u64 bits (id(), quant.c:291-327, per
    block): grid split, the u64 unwrap around each block's element 0,
    minus the block's minimum; lossless."""
    dims = kernels.u64_undo_periodic(
        torch.stack(engine.id_split(ids, grid), dim=1), grid)
    x0 = kernels.u64_minmax(dims, -1)[0]
    bins = kernels.i64_to_u32(dims.sub_(x0[..., None]).bitwise_and_(
        kernels.M32))
    return rows.pack(bins.reshape(-1, ids.shape[1]), width, fused), x0


def _id_decode(words: torch.Tensor, x0: torch.Tensor, grid: int,
               width: int, n_b: int, fused: bool) -> torch.Tensor:
    """Inverse of ``_id_encode`` (undoID, quant.c:553-587): (b*3, W) words
    and (b, 3) origins -> (b, n_b) IDs, exact.  One K3 launch."""
    bins = rows.unpack(words, width, n_b, fused)
    dims = kernels.u32_to_i64(bins).reshape(-1, 3, n_b)
    return engine.id_recompose(dims.transpose(0, 1), x0.T, grid)


# ---------------------------------------------------------------------------
# Inputs, shards and outputs
# ---------------------------------------------------------------------------

def _local(x, per_block: int = 1):
    """(this process's array, global first block, global block count) of
    a codec input whose leading axis holds ``per_block`` entries a block
    (3 for block-major rows, else 1), plain or BlockShards."""
    if isinstance(x, BlockShards):
        return x.local, x.first // per_block, x.total // per_block
    return x, 0, x.shape[0] // per_block


def _rows(x):
    """(B, 3, n) -> (B*3, n) block-major rows; rows pass through."""
    if x.ndim == 3:
        return x.reshape(x.shape[0] * x.shape[1], x.shape[2])
    return x


def _float_input(x):
    """(rows (B*3, n), global first block, global block count) of a float
    input: (B, 3, n) blocks or (B*3, n) rows, plain or BlockShards."""
    loc = x.local if isinstance(x, BlockShards) else x
    loc, first, total = _local(x, 3 if loc.ndim == 2 else 1)
    return _rows(loc), first, total


def _tensor(a, device) -> torch.Tensor:
    """A tensor on ``device``: numpy arrays as ``multihost.host_tensor``
    reads them; tensors move."""
    if not isinstance(a, torch.Tensor):
        a = multihost.host_tensor(a)
    return a.to(device)


def _shards(mesh: Mesh, blocks: int):
    """(device, first local block, block count) of each shard."""
    if blocks % mesh.size:
        raise ValueError(f"{blocks} blocks do not divide over the mesh's "
                         f"{mesh.size} shards")
    bs = blocks // mesh.size
    return [(dev, s * bs, bs) for s, dev in enumerate(mesh.devices)]


def _gather(parts, mesh: Mesh) -> torch.Tensor:
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(mesh.devices[0]) for p in parts])


def _out(t: torch.Tensor, sharded: bool, first: int, total: int):
    return BlockShards(t, first, total) if sharded else t


class _MeshCodecBase:
    """Shard bookkeeping shared by the SPMD codecs."""

    @property
    def _fused(self) -> bool:
        return self.fused_rows is not False

    @staticmethod
    def _check_aligned(n_b: int):
        if n_b % 32:
            raise ValueError(
                f"block size {n_b} is not a multiple of 32; pad blocks "
                "to 32 particles (segment padding is the client's duty, "
                "header_format.tex table 1) -- misaligned packs would "
                "decode to a wrong-length block")

    def _float_encode(self, xr, b0: int, bs: int, dev, depth: int, box):
        """One shard's float field: rows of blocks [b0, b0 + bs) -> words,
        x0 (bs, 3), range (bs,)."""
        r = _tensor(xr[3 * b0:3 * (b0 + bs)], dev).to(torch.float32)
        mn, rng_b = rows.block_stats(r, box, self._fused)
        words = rows.bin_pack(r, mn, rng_b, depth, box, self.scale_mode,
                              self._fused)
        return words, mn.reshape(bs, 3), rng_b


@dataclass(frozen=True)
class ShardedPositionCodec(_MeshCodecBase):
    """Block-sharded position codec over a mesh.

    ``encode`` maps (B, 3, n_b) f32 positions (or block-major rows
    (B*3, n_b)) to packed u32 words plus per-block headers (x0, range);
    ``decode`` inverts it.  The static ``depth`` comes from the accuracy
    request (spmd profile) or the adaptive stats pass."""

    mesh: Mesh
    width: float  # periodic box width
    depth: int  # bits per value
    # None or True: the rows kernels (their plain versions on CPU shards);
    # False: the plain versions everywhere.  The bits are the same.
    fused_rows: Optional[bool] = None
    # 'div' = the C-exact division map (kernels.uniform_bin_index);
    # 'recip' = the reciprocal map (kernels.uniform_bin_index_recip), one
    # K8 launch a shard.  Wire-compatible; headers are identical.
    scale_mode: str = "div"

    def __post_init__(self):
        if self.scale_mode not in ("div", "recip"):
            raise ValueError(f"unknown scale_mode {self.scale_mode!r}")

    def encode(self, x):
        """x: (B, 3, n_b) f32 or rows (B*3, n_b) -- numpy, a tensor, or a
        multi-process :class:`BlockShards` -- with B divisible by the mesh
        size and 32 | n_b.  Returns (words (B*3, W) block-major rows,
        x0 (B, 3), range (B,)), BlockShards for a BlockShards input."""
        sharded = isinstance(x, BlockShards)
        xr, first, total = _float_input(x)
        self._check_aligned(xr.shape[1])
        parts = [self._float_encode(xr, b0, bs, dev, self.depth, self.width)
                 for dev, b0, bs in _shards(self.mesh, xr.shape[0] // 3)]
        words, x0, rng_b = (_gather(p, self.mesh) for p in zip(*parts))
        return (_out(words, sharded, 3 * first, 3 * total),
                _out(x0, sharded, first, total),
                _out(rng_b, sharded, first, total))

    def decode(self, words, x0, rng_b, seed: int = 0):
        """Inverse of :meth:`encode`; returns (B*3, n_b) block-major rows
        of floats (a BlockShards when ``x0`` is one)."""
        sharded = isinstance(x0, BlockShards)
        x0, first, total = _local(x0)
        words = _rows(_local(words)[0])
        rng_b = _local(rng_b)[0]
        depth = self.depth
        n_b = (words.shape[1] * 32) // depth if depth else 0
        parts = []
        for dev, b0, bs in _shards(self.mesh, x0.shape[0]):
            parts.append(rows.decode(
                _tensor(words[3 * b0:3 * (b0 + bs)], dev),
                _block_keys(seed, range(first + b0, first + b0 + bs)),
                _tensor(x0[b0:b0 + bs], dev).reshape(-1),
                _tensor(rng_b[b0:b0 + bs], dev).repeat_interleave(3),
                depth, n_b, self.width, self._fused))
        return _out(_gather(parts, self.mesh), sharded, 3 * first,
                    3 * total)

    def global_range(self, x) -> float:
        """Adaptive profile phase 1: the largest block range over every
        shard and process -- the one scalar that syncs to the host."""
        xr = _float_input(x)[0]
        g = np.max([rows.block_stats(
            _tensor(xr[3 * b0:3 * (b0 + bs)], dev).to(torch.float32),
            self.width, self._fused)[1].max().item()
            for dev, b0, bs in _shards(self.mesh, xr.shape[0] // 3)])
        if isinstance(x, BlockShards):
            return multihost.allgather_max_f32(g)
        return float(np.float32(g))


def spmd_depth_for(delta: float, width: float) -> int:
    """Static depth for the spmd profile: the range of any block never
    exceeds the box width, so this depth, by the room rule at the box's
    magnitude (``engine.delta_to_depth``), always satisfies ``delta``."""
    return engine.delta_to_depth(delta, 0.0, width, magnitude=width)


def adaptive_depth_for(codec: ShardedPositionCodec, x, delta: float) -> int:
    """Tightest shared depth across blocks by the room rule (one host
    sync)."""
    return engine.delta_to_depth(delta, 0.0, codec.global_range(x),
                                 magnitude=codec.width)


# ---------------------------------------------------------------------------
# Full-snapshot codec: positions + velocities + IDs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardedSnapshotCodec(_MeshCodecBase):
    """Block-sharded codec for a full standard snapshot (Posn + Velc +
    Ptid) over a mesh -- the analog of the reference's canonical client
    segment (funcs.c:212-266: position delta=1e-3, velocity delta=1, ID
    grid width).

    ``encode``: (pos (B, 3, n_b) f32, vel (B, 3, n_b) f32, ids (B, n_b)
    u64) -> packed word streams + per-block headers.  ``decode`` inverts
    it: positions and velocities within their deltas (dithered), IDs
    bit-exact.  Position bits equal ``ShardedPositionCodec``'s at the same
    seed; velocities use ``field_key(seed, B_total + bi, d)``, so no two
    (field, block, dim) streams collide."""

    mesh: Mesh
    box: float          # periodic box width (positions)
    pos_depth: int
    vel_depth: int
    id_grid: int        # Lagrangian ID grid width (IDAccuracy.width)
    fused_rows: Optional[bool] = None  # see ShardedPositionCodec
    scale_mode: str = "div"

    def __post_init__(self):
        if self.scale_mode not in ("div", "recip"):
            raise ValueError(f"unknown scale_mode {self.scale_mode!r}")
        if not (1 <= self.pos_depth <= 24) or not (1 <= self.vel_depth
                                                   <= 24):
            raise ValueError(
                f"float depths must be in [1, 24] (f32 mantissa cap, "
                f"quant.c:684-693); got pos={self.pos_depth} "
                f"vel={self.vel_depth}")
        if not (2 <= self.id_grid <= (1 << 21)):
            raise ValueError(
                f"id_grid must be in [2, 2^21] (grid^3 <= 2^64 and u32 "
                f"coordinate bins); got {self.id_grid}")

    @property
    def id_width(self) -> int:
        """Static bin width for ID grid coordinates: after the u64
        periodic unwrap + min-subtract the coords lie in [0, grid)."""
        return max(1, int(np.ceil(np.log2(self.id_grid))))

    def encode(self, pos, vel, ids):
        """pos / vel: (B, 3, n_b) f32 or rows (B*3, n_b); ids (B, n_b) u64
        (numpy, an int64 tensor of u64 bits, or BlockShards of either).
        Returns the 8-tuple (pw, px0, prng, vw, vx0, vrng, iw, ix0) with
        (B*3, W) block-major word rows and (B, 3) / (B,) headers, ix0 u64
        bits in int64."""
        sharded = isinstance(pos, BlockShards)
        prows, first, total = _float_input(pos)
        self._check_aligned(prows.shape[1])
        vrows = _float_input(vel)[0]
        ids = _local(ids)[0]
        parts = []
        for dev, b0, bs in _shards(self.mesh, prows.shape[0] // 3):
            iw, ix0 = _id_encode(_tensor(ids[b0:b0 + bs], dev),
                                 self.id_grid, self.id_width, self._fused)
            parts.append(
                self._float_encode(prows, b0, bs, dev, self.pos_depth,
                                   self.box) +
                self._float_encode(vrows, b0, bs, dev, self.vel_depth,
                                   None) + (iw, ix0))
        out = [_gather(p, self.mesh) for p in zip(*parts)]
        scale = (3, 1, 1, 3, 1, 1, 3, 1)
        return tuple(_out(t, sharded, k * first, k * total)
                     for t, k in zip(out, scale))

    def decode(self, enc, seed: int = 0):
        """``enc`` is the 8-tuple from :meth:`encode`; returns (pos
        (B*3, n_b) rows, vel (B*3, n_b) rows, ids (B, n_b) int64 of u64
        bits), BlockShards when the headers are."""
        sharded = isinstance(enc[1], BlockShards)
        _, first, b_total = _local(enc[1])
        pw, px0, prng, vw, vx0, vrng, iw, ix0 = (_local(t)[0] for t in enc)
        pw, vw, iw = _rows(pw), _rows(vw), _rows(iw)
        n_b = (pw.shape[1] * 32) // self.pos_depth
        pos, vel, ids = [], [], []
        for dev, b0, bs in _shards(self.mesh, px0.shape[0]):
            blk = slice(b0, b0 + bs)
            row = slice(3 * b0, 3 * (b0 + bs))
            bi = range(first + b0, first + b0 + bs)
            pos.append(rows.decode(
                _tensor(pw[row], dev), _block_keys(seed, bi),
                _tensor(px0[blk], dev).reshape(-1),
                _tensor(prng[blk], dev).repeat_interleave(3),
                self.pos_depth, n_b, self.box, self._fused))
            vel.append(rows.decode(
                _tensor(vw[row], dev),
                _block_keys(seed, (b_total + b for b in bi)),
                _tensor(vx0[blk], dev).reshape(-1),
                _tensor(vrng[blk], dev).repeat_interleave(3),
                self.vel_depth, n_b, None, self._fused))
            ids.append(_id_decode(_tensor(iw[row], dev),
                                  _tensor(ix0[blk], dev), self.id_grid,
                                  self.id_width, n_b, self._fused))
        return (_out(_gather(pos, self.mesh), sharded, 3 * first,
                     3 * b_total),
                _out(_gather(vel, self.mesh), sharded, 3 * first,
                     3 * b_total),
                _out(_gather(ids, self.mesh), sharded, first, b_total))
