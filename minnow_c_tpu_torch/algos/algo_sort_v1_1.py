"""Sort v1.1 -- sorted-delta codec with a delta-coded rank stream, frozen.

Port of ``minnow_c_tpu/algos/algo_sort_v1_1.py``; the wire is the same byte
for byte.  Over Sort v1.0 the rank stream is delta+zigzag chunk-coded
instead of packed raw at ``ceil(log2 n)`` bits: ranks of nearly sorted
inputs (Lagrangian-ordered IDs) differ by about 1 and pack in 2-3 bits.
Streams stamped 1.0.x keep decoding through the frozen ``algo_sort_v1_0``
module.

Plane payload layout (header as v1.0, rank section re-specified)::

    u32 n_chunks          (sorted-delta chunks, as v1.0)
    u32 first_value
    u32 rank_first        (rank of element 0)
    u32 rank_chunks
    u8  chunk_width[n_chunks]        (padded to 4)
    u8  rank_chunk_width[rank_chunks] (padded to 4)
    <chunked sorted deltas>
    <chunked zigzag rank deltas, element 0 excluded>

On a CUDA device both chunk streams pack with K7 and unpack with K3, and
both prefix sums of the decode are K9.

This module is FROZEN at v1.1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_coil_v1_0 import with_first
from .algo_sort_v1_0 import chunk_table, ranks_of, sort_plane, unpermute
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 1, 0)


class SortV1_1(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(4, dtype=np.uint32), 0
        order, first, deltas = sort_plane(bins)
        ranks = ranks_of(order)
        dc, widths = chunked.chunk_widths_auto(deltas)
        body = chunked.pack_chunks_auto(dc, widths)

        rank_first = int(ranks[0])
        rz = kernels.u32_delta_zigzag(ranks)[1:]  # element 0 carried raw
        rc, rwidths = chunked.chunk_widths_auto(rz)
        rbody = chunked.pack_chunks_auto(rc, rwidths)

        head = np.array([dc.shape[0], first, rank_first, rc.shape[0]],
                        dtype=np.uint32)
        payload = np.concatenate(
            [head.view(np.uint8), chunk_table(widths), chunk_table(rwidths),
             np.frombuffer(body, dtype=np.uint8),
             np.frombuffer(rbody, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, rank_first, rank_chunks = (
            int(head[0]), int(head[1]), int(head[2]), int(head[3]))
        off = 16
        widths = raw[off:off + n_chunks].astype(np.uint8)
        off += n_chunks + ((-n_chunks) % 4)
        rwidths = raw[off:off + rank_chunks].astype(np.uint8)
        off += rank_chunks + ((-rank_chunks) % 4)
        body = raw[off:].view(np.uint32)

        dw = chunked.total_words(widths)
        deltas = chunked.unpack_chunks_auto(_words_tensor(body[:dw], device),
                                            widths).reshape(-1)[:n]
        sorted_vals = with_first(first, deltas)
        rz = chunked.unpack_chunks_auto(_words_tensor(body[dw:], device),
                                        rwidths).reshape(-1)[:n - 1]
        # The rank un-zigzag is the JAX package's int32 spelling
        # (zi >> 1) ^ -(zi & 1), not kernels.u32_unzigzag: torch's int32
        # >> is arithmetic like XLA's, so it gives the reference's bits for
        # every z, valid or not (the two differ only for z >= 2^31).
        d = torch.empty(n, dtype=torch.int32, device=device)
        d[1:] = (rz >> 1) ^ -(rz & 1)
        # rank_first + the prefix sum of the rest, mod 2^32
        ranks = with_first(rank_first, d)
        return unpermute(sorted_vals, ranks)


registry.register(SortV1_1())
