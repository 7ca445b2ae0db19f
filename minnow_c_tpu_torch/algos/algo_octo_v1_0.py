"""Octo v1.0 -- octree/Morton hierarchical codec for 3-dim fields, frozen.

Port of ``minnow_c_tpu/algos/algo_octo_v1_0.py``; the wire is the same byte
for byte.  For a 3-dimensional field binned at ``depth`` bits per dim, each
dim splits into:

* a k-bit *cell* coordinate (k = min(depth, 10)) -- the three cells are
  Morton-interleaved into one 3k-bit octree cell index whose stream is
  delta+zigzag coded and chunk-packed (Coil-style);
* a (depth-k)-bit within-cell offset, packed raw per dim.

Per-field blocks: ``meta | morton | loX | loY | loZ``.  Scalar fields fall
back to Coil v1.0 plane coding (Octo derives from Coil); per-particle-depth
(Deltas) fields take Trim v1.0's layout and raw per-element-width planes,
as in the JAX package.  The ID field (Ptid)
uses its per-dim widths, splitting each at the same k rule.  The Morton
interleave runs on int64 tensors holding the u32 values.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .. import semver
from ..ops import bitpack, kernels
from ..segment.stream import Reader, Writer
from ..types import (
    AlgoCode,
    FieldHeader,
    IDQuantization,
    PositionQuantization,
    QField,
    VelocityQuantization,
)
from . import registry
from .algo_coil_v1_0 import CoilV1_0
from .algo_trim_v1_0 import _payload_words, _words_tensor
from .blocks import bits_needed, decode_block, encode_block

VERSION = semver.pack(1, 0, 0)
MAX_K = 10  # cell bits per dim; 3k must fit u32


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of each value to every 3rd bit (int64)."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def _compact1by2(x: torch.Tensor) -> torch.Tensor:
    """Inverse of _part1by2 (int64)."""
    x = x & 0x09249249
    x = (x | (x >> 2)) & 0x030C30C3
    x = (x | (x >> 4)) & 0x0300F00F
    x = (x | (x >> 8)) & 0x030000FF
    x = (x | (x >> 16)) & 0x000003FF
    return x


def morton3(cx, cy, cz):
    return _part1by2(cx) | (_part1by2(cy) << 1) | (_part1by2(cz) << 2)


def unmorton3(m):
    return _compact1by2(m), _compact1by2(m >> 1), _compact1by2(m >> 2)


def _split(depths):
    """Per dim (cell bits, low bits) of the k = min(10, max depth) rule."""
    k = min(MAX_K, max(depths))
    cell_bits = [min(k, d) for d in depths]
    return cell_bits, [d - c for d, c in zip(depths, cell_bits)]


class OctoV1_0(CoilV1_0):
    algo_code = int(AlgoCode.OCTO)
    version = VERSION

    # -- 3-dim float fields (Posn/Velc) ------------------------------------

    def _compress_3dim_float(self, qf: QField, is_pos: bool) -> List[bytes]:
        q = qf.quant
        if q.depths is not None:
            return super()._compress_3dim_float(qf, is_pos)
        return self._compress_morton(qf, self._float_meta(q, is_pos),
                                     [q.depth] * 3)

    def _decompress_3dim_float(self, hd: FieldHeader, blocks, is_pos: bool,
                               device) -> QField:
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = tuple(r.f32() for _ in range(3))
        x1 = tuple(r.f32() for _ in range(3))
        if is_pos:
            width = r.f32()
        depth = r.u8()
        has_depths = r.u8()
        if not is_pos:
            symlog = r.u8()
            r.u8()
            threshold = r.f32()
        else:
            r.u16()
        seed = r.u64()
        if has_depths:
            return super()._decompress_3dim_float(hd, blocks, is_pos, device)
        if is_pos:
            quant = PositionQuantization(x0=x0, x1=x1, width=width,
                                         depth=depth, depths=None, seed=seed)
        else:
            quant = VelocityQuantization(x0=x0, x1=x1, depth=depth,
                                         depths=None,
                                         sym_log10_scaled=symlog,
                                         sym_log10_threshold=threshold,
                                         seed=seed)
        return self._decompress_morton(hd, blocks, quant, [depth] * 3,
                                       device)

    def _compress_id(self, qf: QField) -> List[bytes]:
        q = qf.quant
        w = Writer()
        w.u64(q.width)
        for v in q.x0:
            w.u64(v)
        for v in q.x1:
            w.u64(v)
        depths = [bits_needed(q.x1[i] - q.x0[i]) for i in range(3)]
        return self._compress_morton(qf, w.data, depths)

    def _decompress_id(self, hd: FieldHeader, blocks, device) -> QField:
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        width = r.u64()
        x0 = tuple(r.u64() for _ in range(3))
        x1 = tuple(r.u64() for _ in range(3))
        quant = IDQuantization(width=width, x0=x0, x1=x1)
        depths = [bits_needed(x1[i] - x0[i]) for i in range(3)]
        return self._decompress_morton(hd, blocks, quant, depths, device)

    # -- Morton machinery --------------------------------------------------

    def _float_meta(self, q, is_pos: bool) -> bytes:
        w = Writer()
        for v in q.x0:
            w.f32(v)
        for v in q.x1:
            w.f32(v)
        if is_pos:
            w.f32(q.width)
        w.u8(q.depth)
        w.u8(0)
        if not is_pos:
            w.u8(q.sym_log10_scaled)
            w.u8(0)
            w.f32(q.sym_log10_threshold)
        else:
            w.u16(0)
        w.u64(q.seed)
        return w.data

    def _compress_morton(self, qf: QField, meta: bytes,
                         depths) -> List[bytes]:
        bins = kernels.u32_to_i64(qf.data.reshape(3, -1))
        cell_bits, lo_bits = _split(depths)
        m = morton3(*(bins[i] >> lo_bits[i] for i in range(3)))
        blocks = [encode_block(meta, 0, self.try_entropy, self.accel)]
        # The Morton stream through the plane encoder (the depth argument is
        # unused); virtual dispatch keeps Octo v1.0 on Coil v1.0's chunk
        # layout and sends Octo v1.1 to Coil v1.1's.
        mwords, _ = self._encode_plane(kernels.i64_to_u32(m), 32)
        blocks.append(encode_block(mwords, 0, self.try_entropy, self.accel))
        for i in range(3):
            if lo_bits[i] == 0:
                blocks.append(encode_block(np.zeros(0, dtype=np.uint32),
                                           0, False))
                continue
            low = kernels.i64_to_u32(bins[i] & ((1 << lo_bits[i]) - 1))
            words = bitpack.uniform_pack(low, lo_bits[i]).cpu().numpy()
            blocks.append(encode_block(words.view(np.uint32), lo_bits[i],
                                       self.try_entropy, self.accel))
        return blocks

    def _decompress_morton(self, hd: FieldHeader, blocks, quant, depths,
                           device) -> QField:
        n = hd.particle_len
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        cell_bits, lo_bits = _split(depths)

        payload, _, _ = decode_block(blocks[1])
        m = kernels.u32_to_i64(self._decode_plane(_payload_words(payload), 0,
                                                  n, device))
        cells = unmorton3(m)

        dims = []
        dim_valid = []
        for i in range(3):
            blk = blocks[2 + i] if len(blocks) > 2 + i else None
            low = 0
            ok = True
            if lo_bits[i] and blk is None:
                ok = False
            elif lo_bits[i]:
                p, wbits, _ = decode_block(blk)
                low = kernels.u32_to_i64(bitpack.uniform_unpack(
                    _words_tensor(_payload_words(p), device), wbits, n))
            dims.append(kernels.i64_to_u32(
                ((cells[i] << lo_bits[i]) | low) & kernels.M32))
            dim_valid.append(ok)
        qf = QField(hd=hd, data=torch.stack(dims), quant=quant,
                    valid=all(dim_valid))
        qf.dim_valid = tuple(dim_valid)
        return qf


registry.register(OctoV1_0())
