"""Cart v1.0 -- Cartesian byte-plane codec, frozen.

Port of ``minnow_c_tpu/algos/algo_cart_v1_0.py``; the wire is the same byte
for byte.  Planes are binned and packed exactly like Trim, then the packed
words are byte-plane transposed and each byte plane delta-coded before
entropy coding (util_U32TransposeBytes util.c:244-281, util_U8DeltaEncode
util.c:283-309), so slowly varying byte planes become near-zero runs that
LZ4 collapses.

Plane payload = an 8-byte head ``[u32 n_words][u32 magic 'CART']``, then
the transposed and delta-coded bytes of the packed words (the transform
keeps the length, so the payload stays u32-aligned).

The pack is K4 on a CUDA device (``bitpack.uniform_pack``); the byte ops
(``ops/kernels.py``) and the unpack are torch ops on the bins' device, and
the bins stay there through dequantization.

This module is FROZEN at v1.0.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import semver
from ..ops import bitpack, kernels
from ..types import AlgoCode
from . import registry
from .algo_trim_v1_0 import TrimV1_0

VERSION = semver.pack(1, 0, 0)
MAGIC = 0x43415254  # 'CART'


def transpose_delta(words: torch.Tensor) -> torch.Tensor:
    """Packed u32 words (int32 bits) -> byte-plane transpose -> u8 delta
    over the whole byte stream; uint8 on the words' device."""
    if words.numel() == 0:
        return torch.zeros(0, dtype=torch.uint8, device=words.device)
    return kernels.u8_delta_encode(kernels.u32_transpose_bytes(words))


def undo_transpose_delta(body: torch.Tensor) -> torch.Tensor:
    """Inverse of ``transpose_delta``: uint8 bytes -> u32 words (int32
    bits) on the bytes' device."""
    if body.numel() == 0:
        return torch.zeros(0, dtype=torch.int32, device=body.device)
    return kernels.u32_undo_transpose_bytes(kernels.u8_undo_delta_encode(body))


class CartV1_0(TrimV1_0):
    algo_code = int(AlgoCode.CART)
    version = VERSION

    def _encode_plane(self, bins, depth: int):
        words = bitpack.uniform_pack(bins, depth)
        transformed = transpose_delta(words).cpu().numpy()
        head = np.array([words.numel(), MAGIC], dtype=np.uint32)
        payload = np.concatenate([head.view(np.uint8), transformed])
        return payload.view(np.uint32), depth

    def _decode_plane(self, words: np.ndarray, width: int, n: int, device):
        raw = np.ascontiguousarray(words).view(np.uint8)
        n_words = int(raw[0:4].view(np.uint32)[0])
        magic = int(raw[4:8].view(np.uint32)[0])
        if magic != MAGIC:
            raise ValueError("Cart plane magic mismatch")
        body = torch.from_numpy(raw[8:8 + 4 * n_words].copy()).to(device)
        return bitpack.uniform_unpack(undo_transpose_delta(body), width, n)


registry.register(CartV1_0())
