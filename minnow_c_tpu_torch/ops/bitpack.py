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
``pack`` / ``unpack`` of the Deltas mode are torch ops on the data's device.
"""

from __future__ import annotations

import numpy as np
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


# ---------------------------------------------------------------------------
# Per-element widths (variable-depth mode)
# ---------------------------------------------------------------------------

def var_packed_words(widths) -> int:
    """Host-side: words needed for per-element widths (numpy array)."""
    total = int(np.sum(np.asarray(widths).astype(np.int64)))
    return total // 32 + (0 if total % 32 == 0 else 1)


def pack(x: torch.Tensor, widths: torch.Tensor, n_words: int
         ) -> torch.Tensor:
    """Pack element i's low ``widths[i]`` bits contiguously (``widths`` an
    integer tensor on x's device); ``n_words`` must equal
    ``var_packed_words(widths)``.  The bit offsets are an exclusive int64
    prefix sum of the widths; each element adds its low and high parts into
    at most two words with ``index_add_`` on int64.  The bits are disjoint,
    so add equals or, and integer atomics give one result in any order."""
    dev = x.device
    n = x.shape[0]
    if n == 0 or n_words == 0:
        return torch.zeros(n_words, dtype=torch.int32, device=dev)
    w = widths.to(torch.int64)
    mask = torch.where(w >= 32, 0xFFFFFFFF,
                       (1 << w.clamp(max=31)) - 1)
    val = u32_to_i64(x) & mask
    start = torch.cumsum(w, 0) - w
    word = start >> 5
    shifted = val << (start & 31)  # below 2^63: width <= 32, offset <= 31
    # two spare words: a zero-width element may start at word n_words, and
    # its high part lands one further
    out = torch.zeros(n_words + 2, dtype=torch.int64, device=dev)
    out.index_add_(0, word, shifted & 0xFFFFFFFF)
    out.index_add_(0, word + 1, shifted >> 32)
    return i64_to_u32(out[:n_words])


def unpack(x: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack``: element i's ``widths[i]`` bits, as u32 bits in
    int32; the output has the length of ``widths``.  Each element reads the
    64-bit window of its first word and the next.  The window is int64, so
    ``>>`` is arithmetic and fills the top ``offset`` bits with the sign;
    those bits sit at 33 and above, and the mask to the width (at most 32)
    drops them, so the result is the logical shift's.  A start past the
    words (a corrupt width table) reads the last window, as XLA's clamped
    gather does."""
    dev = widths.device
    n = widths.shape[0]
    if n == 0 or x.numel() == 0:
        return torch.zeros(n, dtype=torch.int32, device=dev)
    w = widths.to(torch.int64)
    start = torch.cumsum(w, 0) - w
    word = (start >> 5).clamp_(max=x.numel() - 1)
    xi = u32_to_i64(x)
    w64 = xi | (torch.cat([xi[1:], xi.new_zeros(1)]) << 32)
    mask = torch.where(w >= 32, 0xFFFFFFFF, (1 << w.clamp(max=31)) - 1)
    return i64_to_u32((w64[word] >> (start & 31)) & mask)
