"""Sort v1.0 -- sorted-delta + permutation codec, frozen.

Port of ``minnow_c_tpu/algos/algo_sort_v1_0.py``; the wire is the same byte
for byte.  Each plane's bins are sorted; the sorted sequence is stored as
non-negative first differences in Coil-style 256-element chunks, and the
original order is restored by a rank stream packed at ``ceil(log2 n)``
bits.

Plane payload layout::

    u32 n_chunks         (sorted-delta chunks of 256, Coil-style widths)
    u32 first_value      (smallest value)
    u32 rank_words       (words in the rank stream)
    u32 reserved
    u8  chunk_width[n_chunks]  (padded to 4-byte alignment)
    <chunked sorted deltas, each chunk word-aligned>
    <ranks packed at ceil(log2 n) bits>

The sort, the rank scatter and the un-permute gather are torch ops on the
bins' device.  On a CUDA device the chunks pack with K7 and unpack with K3
(``algos/chunked.py``), the rank stream packs with K4
(``bitpack.uniform_pack``) and the decode's prefix sum is K9; the bins stay
on the device from unpack to dequantization.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import bitpack, kernels
from ..types import AlgoCode
from . import chunked, registry
from .algo_coil_v1_0 import with_first
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 0, 0)
CHUNK = chunked.CHUNK


def _bits_for(v: int) -> int:
    return max(1, int(v).bit_length())


def sort_plane(bins: torch.Tensor):
    """The stable ascending sort of a plane of u32 bins (int32 bits):
    (order, first, deltas).  The sort runs on the u32 values in int64 --
    torch orders int32 as signed, which would put bins >= 2^31 first --
    and keeps equal bins in input order, as the JAX package's
    ``argsort(stable=True)`` does; the ranks, and with them the bytes,
    depend on it.  ``deltas`` are the sorted values' first differences
    (u32 bits, element 0 set to 0) and ``first`` the least value."""
    keys, order = torch.sort(kernels.u32_to_i64(bins), stable=True)
    deltas = torch.diff(keys, prepend=keys[:1])
    return order, int(keys[0]), kernels.i64_to_u32(deltas)


def ranks_of(order: torch.Tensor) -> torch.Tensor:
    """The inverse permutation of ``order``: ranks[order[i]] = i, as u32
    bits (int32) on order's device."""
    n = order.shape[0]
    ranks = torch.empty(n, dtype=torch.int32, device=order.device)
    ranks[order] = torch.arange(n, dtype=torch.int32, device=order.device)
    return ranks


def unpermute(sorted_vals: torch.Tensor, ranks: torch.Tensor):
    """``sorted_vals[ranks]``, indexed with an int64 copy of the u32 ranks
    on their device; the result stays int32 of u32 bits."""
    return sorted_vals[kernels.u32_to_i64(ranks)]


def chunk_table(widths: np.ndarray) -> np.ndarray:
    """A width table zero-padded to 4-byte alignment."""
    return np.concatenate([widths,
                           np.zeros((-len(widths)) % 4, dtype=np.uint8)])


class SortV1_0(TrimV1_0):
    algo_code = int(AlgoCode.SORT)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        n = int(bins.shape[0])
        if n == 0:
            return np.zeros(4, dtype=np.uint32), 0
        order, first, deltas = sort_plane(bins)
        ranks = ranks_of(order)

        dc, widths = chunked.chunk_widths_auto(deltas)
        n_chunks = dc.shape[0]
        body = chunked.pack_chunks_auto(dc, widths)

        rank_width = _bits_for(n - 1)
        rank_words = bitpack.uniform_pack(ranks, rank_width).cpu().numpy()

        head = np.array([n_chunks, first, rank_words.size, 0],
                        dtype=np.uint32)
        payload = np.concatenate(
            [head.view(np.uint8), chunk_table(widths),
             np.frombuffer(body, dtype=np.uint8),
             rank_words.view(np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        raw = np.ascontiguousarray(words).view(np.uint8)
        head = raw[:16].view(np.uint32)
        n_chunks, first, n_rank_words = int(head[0]), int(head[1]), \
            int(head[2])
        wtab_pad = (-n_chunks) % 4
        widths = raw[16:16 + n_chunks].astype(np.uint8)
        body = raw[16 + n_chunks + wtab_pad:].view(np.uint32)

        total_delta_words = chunked.total_words(widths)
        deltas = chunked.unpack_chunks_auto(
            _words_tensor(body[:total_delta_words], device),
            widths).reshape(-1)[:n]
        sorted_vals = with_first(first, deltas)

        rank_width = _bits_for(n - 1)
        rank_body = body[total_delta_words:total_delta_words + n_rank_words]
        ranks = bitpack.uniform_unpack(_words_tensor(rank_body, device),
                                       rank_width, n)
        return unpermute(sorted_vals, ranks)


registry.register(SortV1_0())
