"""Trim v1.0 -- the baseline "fast uniform" codec, frozen.

Port of ``minnow_c_tpu/algos/algo_trim_v1_0.py``; the wire is the same
byte for byte.  Trim composes bin indices -> uniform bitpack -> LZ4 for all
five field types (test/compress_util_bench.c:234-298 of the reference).

Per-field block layout (all blocks use the prelude of algos/blocks.py):

  POSN  meta | dimX | dimY | dimZ [| depths]     bins packed at `depth` bits
  VELC  meta | dimX | dimY | dimZ [| depths]
  PTID  meta | dimX | dimY | dimZ                per-dim width from range
  UNSF  meta | data [| depths]
  UNSI  meta | lo [| hi]                         planes split at 32 bits

meta payloads carry the field's Quantization including the dither seed,
making every field self-decoding.  A corrupt dimension block invalidates
only that dimension (header_format.tex:186-196).

Planes are packed on the device of the field's bins (the pack kernel on
CUDA) and cross to the host as words for LZ4; decode moves the words to
``device`` and keeps everything after LZ4 there.  Per-particle-depth
(Deltas) planes pack each element at its own depth into one contiguous
bitstream (``bitpack.pack`` / ``unpack``, torch ops on the device).
The fused decode declines them: the JAX package's ``_undo_var_fused`` is
the generic dequantize step for step, with no kernel, so the generic path
decodes them to the same bits.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import semver
from ..ops import bitpack
from ..quant import engine
from ..segment.stream import Reader, Writer
from ..types import (
    AlgoCode,
    Field,
    FieldCode,
    FieldHeader,
    FloatQuantization,
    IDQuantization,
    IntQuantization,
    PositionQuantization,
    QField,
    VelocityQuantization,
)
from . import registry
from .blocks import bits_needed, decode_block, encode_block

VERSION = semver.pack(1, 0, 0)


def _pack_plane(bins: torch.Tensor, width: int) -> np.ndarray:
    """Uniform bitpack of one plane of bins on their device; returns host
    u32 words."""
    return bitpack.uniform_pack(bins, width).cpu().numpy().view(np.uint32)


def _words_tensor(words: np.ndarray, device) -> torch.Tensor:
    """Host u32 words -> int32 tensor of the same bits on ``device``."""
    return torch.from_numpy(np.array(words, dtype=np.uint32).view(
        np.int32)).to(device)


def _unpack_plane(words: np.ndarray, width: int, n: int, device):
    """Host words -> device unpack -> u32 bins (int32)."""
    return bitpack.uniform_unpack(_words_tensor(words, device), width, n)


def _pack_plane_var(bins: torch.Tensor, depths: np.ndarray) -> np.ndarray:
    """Per-element-depth pack of one plane on its device; host u32 words."""
    words = bitpack.pack(bins, engine.depths_tensor(depths, bins.device),
                         bitpack.var_packed_words(depths))
    return words.cpu().numpy().view(np.uint32)


def _unpack_plane_var(words: np.ndarray, depths: np.ndarray, device):
    return bitpack.unpack(_words_tensor(words, device),
                          engine.depths_tensor(depths, device))


def _payload_words(payload: np.ndarray) -> np.ndarray:
    return np.frombuffer(payload.tobytes(), dtype="<u4").astype(
        np.uint32, copy=False)


class TrimV1_0:
    algo_code = int(AlgoCode.TRIM)
    version = VERSION

    def __init__(self, accel: int = 1, try_entropy: bool = True):
        self.accel = accel
        self.try_entropy = try_entropy

    # -- plane hooks (overridden by derived codecs) ------------------------

    def _encode_plane(self, bins, depth: int):
        """One plane of bins -> (packed u32 words, stored width).  Trim
        packs raw bins at ``depth`` bits."""
        return _pack_plane(bins, depth), depth

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        """Inverse of _encode_plane.  Returns bins on ``device``."""
        return _unpack_plane(words, width, n, device)

    def _encode_plane_var(self, bins, depths: np.ndarray):
        """Per-particle-depth plane (Deltas mode): v1.0 packs exact
        per-element widths (one contiguous bitstream)."""
        return _pack_plane_var(bins, depths), 0

    def _decode_plane_var(self, words: np.ndarray, depths: np.ndarray,
                          n: int, device):
        return _unpack_plane_var(words, depths, device)

    def _depths_block(self, depths: np.ndarray) -> bytes:
        return self._block(np.asarray(depths, dtype=np.uint8), 8)

    # -- compress ----------------------------------------------------------

    def compress(self, qf: QField) -> List[bytes]:
        code = qf.hd.field_code
        if code == FieldCode.POSN:
            return self._compress_3dim_float(qf, is_pos=True)
        if code == FieldCode.VELC:
            return self._compress_3dim_float(qf, is_pos=False)
        if code == FieldCode.PTID:
            return self._compress_id(qf)
        if code == FieldCode.UNSF:
            return self._compress_ufloat(qf)
        if code == FieldCode.UNSI:
            return self._compress_uint(qf)
        raise ValueError(f"unrecognized field code {code:#x}")

    def _block(self, payload, width: int = 0) -> bytes:
        return encode_block(payload, width, self.try_entropy, self.accel)

    def _compress_3dim_float(self, qf: QField, is_pos: bool) -> List[bytes]:
        q = qf.quant
        w = Writer()
        for v in q.x0:
            w.f32(v)
        for v in q.x1:
            w.f32(v)
        if is_pos:
            w.f32(q.width)
        w.u8(q.depth)
        w.u8(0 if q.depths is None else 1)
        if not is_pos:
            w.u8(q.sym_log10_scaled)
            w.u8(0)
            w.f32(q.sym_log10_threshold)
        else:
            w.u16(0)
        w.u64(q.seed)
        blocks = [self._block(w.data)]
        bins = qf.data.reshape(3, -1)
        for i in range(3):
            if q.depths is None:
                words, wstore = self._encode_plane(bins[i], q.depth)
            else:
                words, wstore = self._encode_plane_var(bins[i], q.depths)
            blocks.append(self._block(words, wstore))
        if q.depths is not None:
            blocks.append(self._depths_block(q.depths))
        return blocks

    def _compress_id(self, qf: QField) -> List[bytes]:
        q: IDQuantization = qf.quant
        w = Writer()
        w.u64(q.width)
        for v in q.x0:
            w.u64(v)
        for v in q.x1:
            w.u64(v)
        blocks = [self._block(w.data)]
        bins = qf.data.reshape(3, -1)
        for i in range(3):
            width = bits_needed(q.x1[i] - q.x0[i])
            words, wstore = self._encode_plane(bins[i], width)
            blocks.append(self._block(words, wstore))
        return blocks

    def _compress_ufloat(self, qf: QField) -> List[bytes]:
        q: FloatQuantization = qf.quant
        w = Writer()
        w.f32(q.x0).f32(q.x1)
        w.u8(q.depth)
        w.u8(0 if q.depths is None else 1)
        w.u8(q.log10_scaled)
        w.u8(0)
        w.f32(q.sym_log10_threshold)
        w.u64(q.seed)
        blocks = [self._block(w.data)]
        bins = qf.data.reshape(-1)
        if q.depths is None:
            words, wstore = self._encode_plane(bins, q.depth)
            blocks.append(self._block(words, wstore))
        else:
            words, wstore = self._encode_plane_var(bins, q.depths)
            blocks += [self._block(words, wstore),
                       self._depths_block(q.depths)]
        return blocks

    def _compress_uint(self, qf: QField) -> List[bytes]:
        q: IntQuantization = qf.quant
        w = Writer()
        w.u64(q.x0).u64(q.x1)
        blocks = [self._block(w.data)]
        rng = q.x1 - q.x0
        lo_width = min(32, bits_needed(rng))
        words, wstore = self._encode_plane(qf.data.reshape(-1), lo_width)
        blocks.append(self._block(words, wstore))
        if rng > 0xFFFFFFFF:
            hi_width = bits_needed(rng >> 32)
            words_hi = _pack_plane(qf.data_hi.reshape(-1), hi_width)
            blocks.append(self._block(words_hi, hi_width))
        return blocks

    # -- fused decompress (optional fast path) -----------------------------

    def decompress_field_fused(self, hd: FieldHeader,
                               blocks: List[Optional[bytes]],
                               field_index: int, device):
        """words -> Field in one fused pass per plane (unpack + dither +
        undo + rewrap): the decode kernel (``ops.decode_cuda``) on CUDA, its
        plain twin (``ops.fastpath.fast_uniform_decode``) on the CPU, then
        the unmap of a log-mapped field.  Returns None when the field is
        ineligible (non-Trim plane coding, corrupt blocks, depth 0, fewer
        than 32 particles, per-particle depths: no kernel runs those) --
        callers fall back to the generic path.  Output bits are identical
        to decompress + dequantize (same dither spec and keys)."""
        code = hd.field_code
        if type(self)._decode_plane is not TrimV1_0._decode_plane:
            return None  # derived codec changed the plane wire
        if code not in (FieldCode.POSN, FieldCode.VELC, FieldCode.UNSF):
            return None
        if any(b is None for b in blocks) or not blocks:
            return None
        from ..ops import decode_cuda, fastpath
        from ..ops import rng as _rng
        from ..quant.engine import depth_to_delta, unmap_float
        from ..types import (FloatAccuracy, PositionAccuracy,
                             VelocityAccuracy)

        n = hd.particle_len

        def plane(block, key, depth, x0v, dxv, box, periodic):
            payload, _, _ = decode_block(block)
            words = _words_tensor(_payload_words(payload), device)
            if words.is_cuda:
                return decode_cuda.decode_cuda(words, key, depth, n, x0v,
                                               dxv, box, periodic=periodic)
            return fastpath.fast_uniform_decode(
                words, key, depth, n, x0v, dxv,
                periodic_width=(box if periodic else None))

        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        if code == FieldCode.UNSF:
            x0 = r.f32()
            x1 = r.f32()
            depth = r.u8()
            has_depths = r.u8()
            log10_scaled = r.u8()
            r.u8()
            threshold = r.f32()
            seed = r.u64()
            key = _rng.field_key(seed, field_index, 0)
            if has_depths or depth < 1 or n < 32 or len(blocks) < 2:
                return None
            x = plane(blocks[1], key, depth, x0,
                      np.float32(x1) - np.float32(x0), 0.0, False)
            x = unmap_float(x, log10_scaled, float(threshold))
            acc = FloatAccuracy(delta=depth_to_delta(depth, x0, x1),
                                log10_scaled=log10_scaled,
                                sym_log10_threshold=threshold)
            return Field(hd=hd, data=x, acc=acc)

        is_pos = code == FieldCode.POSN
        x0 = tuple(r.f32() for _ in range(3))
        x1 = tuple(r.f32() for _ in range(3))
        symlog, threshold = 0, 0.0
        width = 0.0
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
        x0a = np.asarray(x0, dtype=np.float32)
        x1a = np.asarray(x1, dtype=np.float32)
        max_diff = float(np.float32(np.max(x1a - x0a)))
        if has_depths or depth < 1 or n < 32 or len(blocks) < 4:
            return None
        dims = []
        for d in range(3):
            key = _rng.field_key(seed, field_index, d)
            # Canonical bin width is f32(x0 + maxDiff) - f32(x0) (the
            # generic engine path, which the frozen decode digests pin);
            # passing maxDiff directly differs by 1 ULP for offset ranges.
            dx_eff = float(np.float32(float(x0a[d]) + max_diff) - x0a[d])
            y = plane(blocks[1 + d], key, depth, float(x0a[d]), dx_eff,
                      width if is_pos else 0.0, is_pos)
            dims.append(unmap_float(y, symlog, float(threshold)))
        data = torch.stack(dims)
        delta = depth_to_delta(depth, x0a[0], x0a[0] + max_diff)
        if is_pos:
            acc = PositionAccuracy(delta=delta, width=width)
        else:
            acc = VelocityAccuracy(delta=delta, sym_log10_scaled=symlog,
                                   sym_log10_threshold=threshold)
        return Field(hd=hd, data=data, acc=acc)

    # -- decompress --------------------------------------------------------

    def decompress(self, hd: FieldHeader, blocks: List[Optional[bytes]],
                   device) -> QField:
        code = hd.field_code
        if blocks[0] is None:
            # Metadata loss cannot be localized -- whole field invalid
            # (header_format.tex:190-193).
            return QField(hd=hd, data=None, quant=None, valid=False)
        if code == FieldCode.POSN:
            return self._decompress_3dim_float(hd, blocks, True, device)
        if code == FieldCode.VELC:
            return self._decompress_3dim_float(hd, blocks, False, device)
        if code == FieldCode.PTID:
            return self._decompress_id(hd, blocks, device)
        if code == FieldCode.UNSF:
            return self._decompress_ufloat(hd, blocks, device)
        if code == FieldCode.UNSI:
            return self._decompress_uint(hd, blocks, device)
        raise ValueError(f"unrecognized field code {code:#x}")

    def _decode_dims(self, hd, blocks, device, depths=None):
        """The three dimension planes (at per-particle ``depths`` when
        given); a missing block becomes a zero plane marked invalid.
        Returns (stacked bins, dim_valid)."""
        n = hd.particle_len
        dims = []
        dim_valid = []
        for i in range(3):
            blk = blocks[1 + i] if len(blocks) > 1 + i else None
            if blk is None:
                dims.append(torch.zeros(n, dtype=torch.int32, device=device))
                dim_valid.append(False)
                continue
            payload, w, _ = decode_block(blk)
            words = _payload_words(payload)
            dims.append(self._decode_plane(words, w, n, device)
                        if depths is None else
                        self._decode_plane_var(words, depths, n, device))
            dim_valid.append(True)
        return torch.stack(dims), tuple(dim_valid)

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
        depths = None
        if has_depths:
            if len(blocks) < 5 or blocks[4] is None:
                return QField(hd=hd, data=None, quant=None, valid=False)
            depths = _depths(blocks[4])

        data, dim_valid = self._decode_dims(hd, blocks, device, depths)
        if is_pos:
            quant = PositionQuantization(x0=x0, x1=x1, width=width,
                                         depth=depth, depths=depths,
                                         seed=seed)
        else:
            quant = VelocityQuantization(x0=x0, x1=x1, depth=depth,
                                         depths=depths,
                                         sym_log10_scaled=symlog,
                                         sym_log10_threshold=threshold,
                                         seed=seed)
        qf = QField(hd=hd, data=data, quant=quant, valid=all(dim_valid))
        qf.dim_valid = dim_valid
        return qf

    def _decompress_id(self, hd: FieldHeader, blocks, device) -> QField:
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        width = r.u64()
        x0 = tuple(r.u64() for _ in range(3))
        x1 = tuple(r.u64() for _ in range(3))
        data, dim_valid = self._decode_dims(hd, blocks, device)
        quant = IDQuantization(width=width, x0=x0, x1=x1)
        qf = QField(hd=hd, data=data, quant=quant, valid=all(dim_valid))
        qf.dim_valid = dim_valid
        return qf

    def _decompress_ufloat(self, hd: FieldHeader, blocks, device) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = r.f32()
        x1 = r.f32()
        depth = r.u8()
        has_depths = r.u8()
        log10_scaled = r.u8()
        r.u8()
        threshold = r.f32()
        seed = r.u64()
        depths = None
        if has_depths:
            if len(blocks) < 3 or blocks[2] is None:
                return QField(hd=hd, data=None, quant=None, valid=False)
            depths = _depths(blocks[2])
        quant = FloatQuantization(x0=x0, x1=x1, depth=depth, depths=depths,
                                  log10_scaled=log10_scaled,
                                  sym_log10_threshold=threshold, seed=seed)
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        payload, w, _ = decode_block(blocks[1])
        words = _payload_words(payload)
        if depths is None:
            data = self._decode_plane(words, w, n, device)
        else:
            data = self._decode_plane_var(words, depths, n, device)
        return QField(hd=hd, data=data, quant=quant)

    def _decompress_uint(self, hd: FieldHeader, blocks, device) -> QField:
        n = hd.particle_len
        meta, _, _ = decode_block(blocks[0])
        r = Reader(meta.tobytes())
        x0 = r.u64()
        x1 = r.u64()
        quant = IntQuantization(x0=x0, x1=x1)
        if len(blocks) < 2 or blocks[1] is None:
            return QField(hd=hd, data=None, quant=quant, valid=False)
        payload, w, _ = decode_block(blocks[1])
        data = self._decode_plane(_payload_words(payload), w, n, device)
        data_hi = None
        if x1 - x0 > 0xFFFFFFFF:
            if len(blocks) < 3 or blocks[2] is None:
                return QField(hd=hd, data=None, quant=quant, valid=False)
            payload_hi, w_hi, _ = decode_block(blocks[2])
            data_hi = _unpack_plane(_payload_words(payload_hi), w_hi, n,
                                    device)
        return QField(hd=hd, data=data, quant=quant, data_hi=data_hi)


def _depths(block: bytes) -> np.ndarray:
    """The per-particle depths block as host u8 (a writable copy)."""
    dp, _, _ = decode_block(block)
    return np.array(dp, dtype=np.uint8)


registry.register(TrimV1_0())
