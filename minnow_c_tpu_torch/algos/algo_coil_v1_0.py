"""Coil v1.0 -- chunked-width delta codec (patched frame-of-reference),
frozen.

Port of ``minnow_c_tpu/algos/algo_coil_v1_0.py``; the wire is the same byte
for byte.  Like Diff, planes store zigzag-mapped predecessor deltas, but the
pack width is chosen per 256-element chunk, so a single large jump only
widens its own chunk.

Plane payload layout::

    u32 n_chunks
    u32 first_value                      (element 0, raw)
    u8  chunk_width[n_chunks]            (zero-padded to 4-byte alignment)
    <per chunk, in order: 256 zigzag deltas packed at chunk_width bits,
     each chunk starting on a u32 word boundary>

The plane prelude ``Width`` field is 0 (widths live in the payload).  On a
CUDA device the chunks pack with K7 and unpack with K3 (one rows call per
width bucket, ``algos/chunked.py``) and the decode's prefix sum is K9.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import kernels
from ..ops.scan_cuda import cumsum_u32_auto
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 0, 0)
CHUNK = chunked.CHUNK  # 256*w bits = 8w words, always word-aligned


def delta_zigzag_first(bins: torch.Tensor):
    """(first, z): element 0's u32 value, and the zigzag deltas with
    element 0's slot set to 0 so it stays width-neutral (it is carried
    raw)."""
    z = kernels.u32_delta_zigzag(bins)
    z[0] = 0
    return int(bins[0]) & kernels.M32, z


def with_first(first: int, d: torch.Tensor) -> torch.Tensor:
    """The u32 prefix sum of ``d`` (int32 bits) after its element 0 is set,
    in place, to the u32 ``first``: K9 on a CUDA tensor, its plain version
    on the CPU."""
    first &= kernels.M32
    d[0] = first - (1 << 32) if first >= 1 << 31 else first  # int32 bits
    return cumsum_u32_auto(d)


def undo_delta_zigzag_first(first: int, z: torch.Tensor) -> torch.Tensor:
    """Inverse of ``delta_zigzag_first``: un-zigzag (logical shift; the
    int32 form corrupts |delta| >= 2^30), put ``first`` in element 0's slot
    and take the u32 prefix sum."""
    return with_first(first, kernels.u32_unzigzag(z))


class CoilV1_0(TrimV1_0):
    algo_code = int(AlgoCode.COIL)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(2, dtype=np.uint32), 0
        first, z = delta_zigzag_first(bins)
        zc, widths = chunked.chunk_widths_auto(z)
        n_chunks = zc.shape[0]
        body = chunked.pack_chunks_auto(zc, widths)

        head = np.array([n_chunks, first], dtype=np.uint32)
        wtab_pad = (-n_chunks) % 4
        wtab = np.concatenate([widths,
                               np.zeros(wtab_pad, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_chunks = int(raw[:4].view(np.uint32)[0])
        first = int(raw[4:8].view(np.uint32)[0])
        wtab_pad = (-n_chunks) % 4
        widths = raw[8:8 + n_chunks].astype(np.uint8)
        body = raw[8 + n_chunks + wtab_pad:].view(np.uint32)

        z = chunked.unpack_chunks_auto(_words_tensor(body, device),
                                       widths).reshape(-1)[:n]
        return undo_delta_zigzag_first(first, z)


registry.register(CoilV1_0())
