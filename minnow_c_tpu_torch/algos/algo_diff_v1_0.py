"""Diff v1.0 -- predecessor-delta codec, frozen.

Port of ``minnow_c_tpu/algos/algo_diff_v1_0.py``; the wire is the same byte
for byte.  Identical block/metadata layout to Trim v1.0, but each data plane
stores zigzag-mapped differences against the previous element, packed at
the width of the largest zigzag value; element 0 is stored raw in the
plane's first word.  For spatially coherent input orders (cell-sorted
snapshots, Lagrangian ID order) successive bin indices are close, so the
delta stream packs far below the raw ``depth`` bits.  The block prelude
``Width`` field stores the zigzag width.

Decode is a u32 prefix sum (K9, ``ops.scan_cuda``, on CUDA): the running
sum telescopes to the original bins.  The fused float decode
(``decompress_field_fused``) unpacks with K3, un-zigzags, scans with K9 and
runs the engine's dither + undo tail on the device.  Per-particle-depth
(Deltas) fields keep Trim v1.0's raw per-element-width planes, and the
fused decode declines them and log-mapped fields (the generic decode
takes them), as in the JAX package.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import bitpack, decode_cuda, kernels
from ..ops.fastpath import undo_uniform
from ..types import AlgoCode
from . import registry
from .algo_coil_v1_0 import undo_delta_zigzag_first
from .algo_trim_v1_0 import TrimV1_0, _payload_words, _words_tensor

VERSION = semver.pack(1, 0, 0)


def _bins(first, z: torch.Tensor) -> torch.Tensor:
    """The plane's bins from element 0 and the other elements' zigzag
    deltas: one u32 prefix sum over ``[first, unzigzag(z)...]``."""
    return undo_delta_zigzag_first(int(first),
                                   torch.nn.functional.pad(z, (1, 0)))


class DiffV1_0(TrimV1_0):
    algo_code = int(AlgoCode.DIFF)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        n = bins.shape[0]
        if n == 0:
            return np.zeros(0, dtype=np.uint32), 1
        # Element 0 is stored raw in the plane's first word: its "delta" is
        # the absolute value, whose zigzag would otherwise force
        # width = depth + 1 for the whole plane.
        z = kernels.u32_delta_zigzag(bins)[1:]
        first = int(bins[0]) & kernels.M32
        # One tiny host sync per plane: the pack width is data-dependent.
        zmax = int(kernels.u32_to_i64(z).max()) if z.shape[0] else 0
        width = max(1, zmax.bit_length())
        words = bitpack.uniform_pack(z, width).cpu().numpy().view(np.uint32)
        return np.concatenate([[first], words]).astype(np.uint32), width

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        z = bitpack.uniform_unpack(_words_tensor(words[1:], device), width,
                                   n - 1)
        return _bins(words[0], z)

    def decompress_field_fused(self, hd, blocks, field_index: int,
                               device):
        """Diff-coded float fields in one device pass per plane (see
        TrimV1_0's for the contract); the bits equal decompress +
        dequantize."""
        if type(self) is not DiffV1_0:
            return None
        return _fused_float_field(hd, blocks, field_index, device,
                                  _diff_plane_fused)


def _diff_plane_fused(payload: np.ndarray, key, n: int, depth: int, x0, dx,
                      box, periodic: bool, device, width: int):
    """One Diff plane -> floats: K3 unpack of the zigzag deltas (m = n - 1
    padded to a multiple of 32, then trimmed), un-zigzag, K9 scan, then the
    dither + undo tail of the engine's decode (``fastpath.undo_uniform``)."""
    words = _words_tensor(payload, device)
    m = n - 1
    m_pad = -(-m // 32) * 32
    if decode_cuda.rows_kernel_eligible(width, m_pad) and width <= 32:
        wp = m_pad * width // 32
        body = words[1:1 + wp]
        body = torch.nn.functional.pad(body, (0, wp - body.numel()))
        z = decode_cuda.unpack_rows_cuda(body.reshape(1, wp), width,
                                         m_pad)[0][:m]
    else:
        z = bitpack.uniform_unpack(words[1:], width, m)
    return undo_uniform(_bins(payload[0], z), key, depth, x0, dx,
                        box if periodic else None)


def _fused_float_field(hd, blocks, field_index: int, device, plane):
    """The fused decode hook shared by Diff v1.0 and Coil v1.1: parse the
    float field's metadata (the JAX package's ``_fused_for_diff`` /
    ``_fused_for_coil11``) and decode each plane with ``plane(payload, key,
    n, depth, x0, dx, box, periodic, device, width)``.  Returns None when
    the field is ineligible (not a float field, a corrupt or missing block,
    n < 2, per-particle depths or a log map), so the caller decodes it
    generically."""
    from ..ops import rng as _rng
    from ..quant.engine import depth_to_delta
    from ..segment.stream import Reader
    from ..types import (Field, FieldCode, FloatAccuracy, PositionAccuracy,
                         VelocityAccuracy)
    from .blocks import decode_block

    code = hd.field_code
    if code not in (FieldCode.POSN, FieldCode.VELC, FieldCode.UNSF):
        return None
    if not blocks or any(b is None for b in blocks):
        return None
    n = hd.particle_len
    if n < 2:
        return None
    if len(blocks) < (2 if code == FieldCode.UNSF else 4):
        return None  # short-but-checksum-valid list: let generic degrade
    meta, _, _ = decode_block(blocks[0])
    r = Reader(meta.tobytes())
    if code == FieldCode.UNSF:
        x0 = r.f32()
        x1 = r.f32()
        depth = r.u8()
        if r.u8() or r.u8():
            return None  # per-particle depths / log scaling
        r.u8()
        r.f32()
        seed = r.u64()
        payload, w, _ = decode_block(blocks[1])
        x = plane(_payload_words(payload), _rng.field_key(seed, field_index,
                                                          0),
                  n, depth, x0, np.float32(x1) - np.float32(x0), 0.0, False,
                  device, w)
        return Field(hd=hd, data=x,
                     acc=FloatAccuracy(delta=depth_to_delta(depth, x0, x1)))

    is_pos = code == FieldCode.POSN
    x0 = tuple(r.f32() for _ in range(3))
    x1 = tuple(r.f32() for _ in range(3))
    box = r.f32() if is_pos else 0.0
    depth = r.u8()
    if r.u8():
        return None
    if not is_pos:
        if r.u8():
            return None
        r.u8()
        r.f32()
    else:
        r.u16()
    seed = r.u64()
    x0a = np.asarray(x0, dtype=np.float32)
    x1a = np.asarray(x1, dtype=np.float32)
    max_diff = float(np.float32(np.max(x1a - x0a)))
    dims = []
    for d in range(3):
        payload, w, _ = decode_block(blocks[1 + d])
        # canonical bin width (see TrimV1_0.decompress_field_fused)
        dx_eff = float(np.float32(float(x0a[d]) + max_diff) - x0a[d])
        dims.append(plane(_payload_words(payload),
                          _rng.field_key(seed, field_index, d), n, depth,
                          float(x0a[d]), dx_eff, box, is_pos, device, w))
    data = torch.stack(dims)
    delta = depth_to_delta(depth, x0a[0], x0a[0] + max_diff)
    if is_pos:
        acc = PositionAccuracy(delta=delta, width=box)
    else:
        acc = VelocityAccuracy(delta=delta)
    return Field(hd=hd, data=data, acc=acc)


registry.register(DiffV1_0())
