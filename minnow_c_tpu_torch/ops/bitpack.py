"""Uniform-width bitpacking: store the low ``width`` bits of each u32
contiguously in a little-endian bitstream.

Semantics match ``util_U32UniformPack`` / ``util_U32UndoUniformPack``
(util.c:311-406): bit b of element i lands at global bit ``i*width + b``;
global bit g lives in output word ``g // 32`` at position ``g % 32``; spare
bits in the last word are zero.

u32 arrays are int32 tensors holding the same bits (see ``kernels``).
``uniform_pack`` and ``uniform_pack_rows`` go through the pack kernels'
wrappers (``encode_cuda.pack_cuda`` / ``pack_rows_cuda``), which launch the
CUDA kernel for a CUDA tensor and run its plain torch version for a CPU
tensor.  ``uniform_unpack`` is plain torch on every device; the decode
kernels (``decode_cuda``) unpack inside themselves.  The per-element-width
``pack`` / ``unpack`` of the Deltas mode are not ported yet.
"""

from __future__ import annotations

import torch

from .kernels import i64_to_u32, u32_to_i64


def pl_cdiv(a: int, b: int) -> int:
    return -(-a // b)


def packed_words(n: int, width: int) -> int:
    """Number of u32 words needed to pack n elements at ``width`` bits
    (util.c:316-317)."""
    return pl_cdiv(n * width, 32)


def uniform_pack(x: torch.Tensor, width: int) -> torch.Tensor:
    """Pack the low ``width`` bits of each element of u32 tensor ``x``
    (util_U32UniformPack, util.c:311-355)."""
    from .encode_cuda import pack_cuda
    return pack_cuda(x, width)


def uniform_pack_rows(x: torch.Tensor, width: int) -> torch.Tensor:
    """Pack each row of u32 tensor ``x`` of shape (rows, n) independently;
    requires ``n % 32 == 0``.  Row r's stream is bit-identical to
    ``uniform_pack(x[r], width)`` and fills exactly (n//32)*width words, so
    the result is the dense (rows, (n//32)*width) matrix of per-row
    streams.  Goes through the rows pack kernel's wrapper
    (``encode_cuda.pack_rows_cuda``)."""
    from .encode_cuda import pack_rows_cuda
    return pack_rows_cuda(x, width)


def uniform_unpack(x: torch.Tensor, width: int, n: int) -> torch.Tensor:
    """Unpack ``n`` elements of ``width`` bits from u32 tensor ``x``
    (util_U32UndoUniformPack, util.c:357-406): one 64-bit funnel read per
    element, ``(w64[(i*w)//32] >> (i*w % 32)) & mask``."""
    if not 0 <= width <= 32:
        raise ValueError(f"width {width} not in [0, 32]")
    if x.numel() < packed_words(n, width):
        raise ValueError(f"{x.numel()} words cannot hold {n} elements of "
                         f"{width} bits")
    dev = x.device
    if n == 0 or width == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    if width == 32:
        return x[:n].to(torch.int32)
    w = u32_to_i64(x[:packed_words(n, width)])
    hi = torch.cat([w[1:], w.new_zeros(1)])
    # Bits 0..62 of the window are exact; bit 63 (sign) is never read:
    # off + width <= 31 + 31.
    w64 = w | (hi << 32)
    start = torch.arange(n, dtype=torch.int64, device=dev) * width
    window = w64[start >> 5]
    return i64_to_u32((window >> (start & 31)) & ((1 << width) - 1))
