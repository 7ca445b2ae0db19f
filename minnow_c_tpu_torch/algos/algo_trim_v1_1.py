"""Trim v1.1 -- chunked per-particle-depth packing, frozen.

Port of ``minnow_c_tpu/algos/algo_trim_v1_1.py``.  The wire differs from
Trim v1.0 ONLY in the Deltas-mode (per-particle accuracy) plane payload:
instead of one exact per-element-width bitstream, each 256-element chunk
packs uniformly at the chunk's maximum depth; the uniform-depth path is
byte-identical to v1.0.

Deltas-mode plane payload::

    u32 n_chunks
    u32 reserved
    u8  chunk_width[n_chunks]   (padded to 4)
    <per chunk: 256 bins packed at chunk_width, word-aligned>

The width table comes from the host depths, not from the values.  The
chunk bodies pack and unpack through ``algos/chunked.py``: one rows call
per width bucket on the device (K7 / K3 on CUDA), the host C++ otherwise.

Streams stamped 1.0.x keep decoding through the frozen v1.0 module.
This module is FROZEN at v1.1.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..types import AlgoCode
from . import chunked, registry
from .algo_trim_v1_0 import TrimV1_0, _words_tensor

VERSION = semver.pack(1, 1, 0)


class TrimV1_1(TrimV1_0):
    algo_code = int(AlgoCode.TRIM)
    version = VERSION

    def _encode_plane_var(self, bins, depths: np.ndarray):
        n = int(bins.shape[0])
        n_chunks = -(-n // chunked.CHUNK) if n else 0
        dp = np.zeros(n_chunks * chunked.CHUNK, dtype=np.uint8)
        dp[:n] = np.asarray(depths, dtype=np.uint8)
        widths = dp.reshape(n_chunks, chunked.CHUNK).max(axis=1) \
            if n_chunks else np.zeros(0, np.uint8)
        vc = torch.nn.functional.pad(
            bins, (0, n_chunks * chunked.CHUNK - n)).reshape(n_chunks,
                                                             chunked.CHUNK)
        if not vc.is_cuda:
            vc = vc.numpy().view(np.uint32)
        body = chunked.pack_chunks_auto(vc, widths)
        head = np.array([n_chunks, 0], dtype=np.uint32)
        wtab = np.concatenate(
            [widths, np.zeros((-n_chunks) % 4, dtype=np.uint8)])
        payload = np.concatenate(
            [head.view(np.uint8), wtab.view(np.uint8),
             np.frombuffer(body, dtype=np.uint8)])
        return payload.view(np.uint32), 0

    def _decode_plane_var(self, words: np.ndarray, depths: np.ndarray,
                          n: int, device):
        if n == 0:
            return torch.zeros(0, dtype=torch.int32, device=device)
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_chunks = int(raw[:4].view(np.uint32)[0])
        widths = raw[8:8 + n_chunks].astype(np.uint8)
        body = raw[8 + n_chunks + ((-n_chunks) % 4):].view(np.uint32)
        return chunked.unpack_chunks_auto(_words_tensor(body, device),
                                          widths).reshape(-1)[:n]


registry.register(TrimV1_1())
