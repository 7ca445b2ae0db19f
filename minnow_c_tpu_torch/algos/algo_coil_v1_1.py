"""Coil v1.1 -- chunked-width delta codec, kernel-native layout, frozen.

Port of ``minnow_c_tpu/algos/algo_coil_v1_1.py``; the wire is the same byte
for byte.  Over Coil v1.0 it adds a parametric chunk size (``chunk_log2``
header byte: 256-element chunks below 2^20 values, 16384-element chunks
from there) and column-major chunk bodies (``ops/chunked_cuda.py``
``body_to_cmajor``).

Plane payload layout::

    u32 n_chunks
    u32 first_value                      (element 0, raw)
    u8  chunk_log2                       (8..17; encoder uses 8 or 14)
    u8  reserved[3]
    u8  chunk_width[n_chunks]            (zero-padded to 4-byte alignment)
    <per chunk, in order: chunk zigzag deltas packed at chunk_width
     bits, column-major, each chunk starting on a u32 word boundary>

Decode of a 16384-chunk plane goes through K10 (``decode_chunked_stream``:
the kernel on CUDA, its plain version on the CPU); other chunk sizes take
the generic route (host column-major -> natural, chunk unpack, K9 scan).
The fused float decode (``decompress_field_fused``) runs K11 on 16384-chunk
planes and the generic bins plus the engine's undo tail otherwise.  A
kernel that fails raises: there is no fallback and no switch that turns a
kernel off.

Streams stamped 1.0.x keep decoding through the frozen algo_coil_v1_0
module.  This module is FROZEN at v1.1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import chunked_cuda
from ..ops.fastpath import undo_uniform
from ..types import AlgoCode
from . import chunked, registry
from .algo_coil_v1_0 import delta_zigzag_first, undo_delta_zigzag_first
from .algo_diff_v1_0 import _fused_float_field
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 1, 0)

KERNEL_CHUNK = chunked_cuda.KERNEL_CHUNK  # the decode kernels' chunk size
SMALL_CHUNK = 256        # v1.0-class chunks for small planes
BIG_PLANE = 1 << 20      # threshold for switching to kernel chunks


def _parse(words: np.ndarray):
    """A plane payload -> (first, chunk, widths, body words); a chunk_log2
    outside 8..17 raises ValueError."""
    raw = np.ascontiguousarray(words).view(np.uint8)
    n_chunks = int(raw[:4].view(np.uint32)[0])
    first = int(raw[4:8].view(np.uint32)[0])
    chunk_log2 = int(raw[8])
    if not 8 <= chunk_log2 <= 17:
        raise ValueError(f"Coil v1.1 chunk_log2 {chunk_log2} out of range")
    wtab_pad = (-n_chunks) % 4
    widths = raw[12:12 + n_chunks].astype(np.uint8)
    body = raw[12 + n_chunks + wtab_pad:].view(np.uint32)
    return first, 1 << chunk_log2, widths, body


class CoilV1_1(TrimV1_0):
    algo_code = int(AlgoCode.COIL)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(3, dtype=np.uint32), 0
        chunk = KERNEL_CHUNK if n >= BIG_PLANE else SMALL_CHUNK
        first, z = delta_zigzag_first(bins)
        widths, body = chunked.pack_cmajor(z, chunk)
        n_chunks = widths.shape[0]

        head = np.array([n_chunks, first], dtype=np.uint32)
        tag = np.array([chunk.bit_length() - 1, 0, 0, 0], dtype=np.uint8)
        wtab_pad = (-n_chunks) % 4
        wtab = np.concatenate([widths,
                               np.zeros(wtab_pad, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), tag, wtab.view(np.uint8),
             body.astype("<u4", copy=False).view(np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        first, chunk, widths, body = _parse(words)
        if chunk == KERNEL_CHUNK:
            # one pass: unpack + un-zigzag + prefix sum + first (K10)
            return chunked_cuda.decode_chunked_stream(
                _words_tensor(body, device), widths, first, chunk, n)
        return undo_delta_zigzag_first(
            first, chunked.unpack_cmajor(body, widths, chunk, n, device))

    def decompress_field_fused(self, hd, blocks, field_index: int,
                               device):
        """Coil v1.1 float fields: K11 per 16384-chunk plane, or the bins
        plus the engine's undo tail (see TrimV1_0's for the contract); the
        bits equal decompress + dequantize."""
        if type(self) is not CoilV1_1:
            return None

        def plane(payload, key, n, depth, x0, dx, box, periodic, device,
                  width):
            first, chunk, widths, body = _parse(payload)
            if chunk == KERNEL_CHUNK:
                return chunked_cuda.decode_chunked_stream_floats(
                    _words_tensor(body, device), widths, first, chunk, n,
                    key, depth, x0, dx, box, periodic)
            return undo_uniform(self._decode_plane(payload, 0, n, device),
                                key, depth, x0, dx,
                                box if periodic else None)

        return _fused_float_field(hd, blocks, field_index, device, plane)


registry.register(CoilV1_1())
