"""Sort v1.2 -- sorted-delta codec with parametric chunks and an
order-free profile, frozen.

Port of ``minnow_c_tpu/algos/algo_sort_v1_2.py``; the wire is the same byte
for byte.  Over Sort v1.1:

* the chunk size is parametric and the chunk bodies column-major (the Coil
  v1.1 layout, ``ops/chunked_cuda.py``): 16384-element chunks from
  ``BIG_PLANE`` values, 256-element chunks below;
* the **order-free profile** (patch byte 1 of the requested version,
  1.2.1) drops the rank stream: decode returns the values in ASCENDING
  order -- lossless values, surrendered order -- for single-plane fields
  (UNSF / UNSI) only.  The stream records its ``mode``, so one module
  decodes both profiles;
* both streams store element 0 raw with a zero placeholder.

Plane payload layout::

    u32 n_chunks
    u32 first_value            (element 0 of the SORTED stream, raw)
    u32 rank_first             (rank of element 0; 0 in order-free mode)
    u32 rank_chunks            (0 in order-free mode)
    u8  chunk_log2
    u8  mode                   (0 = ranked, 1 = order-free)
    u8  reserved[2]
    u8  chunk_width[n_chunks]            (padded to 4)
    u8  rank_chunk_width[rank_chunks]    (padded to 4)
    <chunked sorted deltas, column-major>
    <chunked zigzag rank deltas (mode 0 only), column-major>

A 16384-chunk stream decodes through K10 (``decode_chunked_stream``: the
kernel on CUDA, its plain version on the CPU), the sorted deltas without
un-zigzag and the ranks with it; a 256-chunk stream decodes generically
(natural layout, chunk unpack with K3 on CUDA, K9 prefix sum).  Both add
``first`` to the encoder's zero placeholder, so they give the same bits.

This module is FROZEN at v1.2.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from .. import semver
from ..ops import chunked_cuda, kernels
from ..types import AlgoCode, FieldCode
from . import chunked, registry
from .algo_coil_v1_0 import with_first
from .algo_coil_v1_1 import BIG_PLANE, KERNEL_CHUNK, SMALL_CHUNK
from .algo_sort_v1_0 import chunk_table, ranks_of, sort_plane, unpermute
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 2, 0)
ORDER_FREE_PATCH = 1   # request version 1.2.1 to drop the rank stream


def encode_chunked(z: torch.Tensor, chunk: int):
    """Pack a u32 stream (int32 bits, element 0 already zeroed) into the
    v1.2 chunked layout: (widths, column-major body bytes)."""
    widths, body = chunked.pack_cmajor(z, chunk)
    return widths, body.astype("<u4", copy=False).tobytes()


def decode_chunked(body: np.ndarray, widths: np.ndarray, first: int,
                   chunk: int, n: int, zigzag: bool, device):
    """One chunked stream -> ``first + cumsum(un-zigzag?(...))`` on
    ``device``: K10 at the kernel chunk size, the generic route
    otherwise."""
    if chunk == KERNEL_CHUNK:
        return chunked_cuda.decode_chunked_stream(
            _words_tensor(body, device), widths, first, chunk, n,
            zigzag=zigzag)
    return decode_chunked_generic(body, widths, first, chunk, n, zigzag,
                                  device)


def decode_chunked_generic(body: np.ndarray, widths: np.ndarray, first: int,
                           chunk: int, n: int, zigzag: bool, device):
    """The JAX package's generic ``_decode_chunked`` at any chunk size:
    natural layout, chunk unpack, un-zigzag, element 0 set to ``first``,
    then the u32 prefix sum."""
    z = chunked.unpack_cmajor(body, widths, chunk, n, device)
    d = kernels.u32_unzigzag(z) if zigzag else z
    return with_first(first, d)


class SortV1_2(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION
    _order_free = False

    def compress(self, qf):
        # the mode rides the requested patch byte (an encoder-side choice;
        # the stream records it in its mode byte)
        if semver.patch(qf.hd.algo_version) != ORDER_FREE_PATCH:
            return super().compress(qf)
        if qf.data.ndim > 1:
            raise ValueError(
                "Sort v1.2 order-free profile (patch 1) is for "
                "single-plane fields only: 3-dim fields sort planes "
                "independently, so dropping ranks would break tuple "
                "pairing")
        if (qf.hd.field_code == FieldCode.UNSI and
                int(qf.quant.x1) - int(qf.quant.x0) > 0xFFFFFFFF):
            # a wide u64 range splits into lo + hi planes; only the lo
            # plane would sort, pairing mismatched halves on decode
            raise ValueError(
                "Sort v1.2 order-free profile cannot encode UNSI "
                "fields whose value range exceeds 2^32: the u64 "
                "stream splits into lo+hi planes, which is no "
                "longer single-plane (use the ranked profile)")
        # a per-call copy: the registry holds one shared instance, and a
        # mode flag left on it would drop the ranks of later fields
        enc = copy.copy(self)
        enc._order_free = True
        return TrimV1_0.compress(enc, qf)

    def _encode_plane(self, bins, depth: int):
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(5, dtype=np.uint32), 0
        chunk = KERNEL_CHUNK if n >= BIG_PLANE else SMALL_CHUNK
        order, first, deltas = sort_plane(bins)
        dwidths, dbody = encode_chunked(deltas, chunk)

        if self._order_free:
            rank_first = 0
            rwidths = np.zeros(0, np.uint8)
            rbody = b""
        else:
            ranks = ranks_of(order)
            rank_first = int(ranks[0])
            rz = kernels.u32_delta_zigzag(ranks)
            rz[0] = 0
            rwidths, rbody = encode_chunked(rz, chunk)

        head = np.array([len(dwidths), first, rank_first, len(rwidths)],
                        dtype=np.uint32)
        tag = np.array([chunk.bit_length() - 1,
                        1 if self._order_free else 0, 0, 0], dtype=np.uint8)
        payload = np.concatenate(
            [head.view(np.uint8), tag, chunk_table(dwidths),
             chunk_table(rwidths), np.frombuffer(dbody, dtype=np.uint8),
             np.frombuffer(rbody, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, rank_first, rank_chunks = (
            int(head[0]), int(head[1]), int(head[2]), int(head[3]))
        chunk_log2 = int(raw[16])
        mode = int(raw[17])
        if not 8 <= chunk_log2 <= 17:
            raise ValueError(
                f"Sort v1.2 chunk_log2 {chunk_log2} out of range")
        chunk = 1 << chunk_log2
        off = 20
        dwidths = raw[off:off + n_chunks].astype(np.uint8)
        off += n_chunks + ((-n_chunks) % 4)
        rwidths = raw[off:off + rank_chunks].astype(np.uint8)
        off += rank_chunks + ((-rank_chunks) % 4)
        body = raw[off:].view(np.uint32)

        dw = chunked.total_words(dwidths, chunk)
        sorted_vals = decode_chunked(body[:dw], dwidths, first, chunk, n,
                                     False, device)
        if mode == 1:
            # order-free profile: ascending values, no rank stream
            return sorted_vals
        ranks = decode_chunked(body[dw:], rwidths, rank_first, chunk, n,
                               True, device)
        return unpermute(sorted_vals, ranks)


registry.register(SortV1_2())
