"""K4: the uniform bitpack kernel (``csrc/pack.cu``) and its plain torch
version.

Port of ``minnow_c_tpu/ops/encode_pallas.py:pack_pallas``.  ``pack_cuda``
launches the CUDA kernel for a CUDA tensor, and runs ``pack_plain`` only
for a CPU tensor; there is no fallback from one to the other.
``from_f32=True`` takes the pre-scaled f32 plane ``delta * 2^width`` of
the div-mode encode and truncates / clamps it to bins first
(``kernels.scaled_to_bins``).
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .bitpack import packed_words
from .kernels import M32, i64_to_u32, scaled_to_bins, u32_to_i64


def _check(vals: torch.Tensor, width: int, n: int, from_f32: bool) -> None:
    if not 0 <= width <= 32:
        raise ValueError(f"width {width} not in [0, 32]")
    if from_f32 and width > 24:
        raise ValueError(f"float pack width {width} > 24 (f32 mantissa "
                         "cap; the clamp constant is only exact to 24 bits)")
    want = torch.float32 if from_f32 else torch.int32
    if vals.dtype != want:
        raise TypeError(f"pack of {'f32' if from_f32 else 'u32'} values "
                        f"needs {want}, got {vals.dtype}")
    if vals.dim() != 1 or not 0 <= n <= vals.numel():
        raise ValueError(f"expected a 1-D tensor of at least {n} elements, "
                         f"got shape {tuple(vals.shape)}")


def pack_plain(vals: torch.Tensor, width: int, n: int = None,
               from_f32: bool = False) -> torch.Tensor:
    """Plain torch pack of ``vals[:n]`` at ``width`` bits -> u32 words as
    int32; works on any device.  32 elements at ``width`` bits fill exactly
    ``width`` words, so element k of every 32-block ORs into static word
    columns (k*width)//32 and the next one."""
    n = vals.numel() if n is None else n
    _check(vals, width, n, from_f32)
    n_words = packed_words(n, width)
    if width == 0 or n == 0:
        return torch.zeros(n_words, dtype=torch.int32, device=vals.device)
    v = vals[:n]
    bins = scaled_to_bins(v, width) if from_f32 else \
        u32_to_i64(v) & ((1 << width) - 1)
    n_blocks = -(-n // 32)
    bins = torch.nn.functional.pad(bins, (0, n_blocks * 32 - n))
    blocks = bins.reshape(n_blocks, 32)
    out = torch.zeros(n_blocks, width, dtype=torch.int64, device=vals.device)
    for k in range(32):
        j, off = divmod(k * width, 32)
        out[:, j] |= (blocks[:, k] << off) & M32
        if off + width > 32:
            out[:, j + 1] |= blocks[:, k] >> (32 - off)
    return i64_to_u32(out.reshape(-1)[:n_words])


def pack_cuda(vals: torch.Tensor, width: int, n: int = None,
              from_f32: bool = False) -> torch.Tensor:
    """Pack ``vals[:n]`` at ``width`` bits; wire-identical to the JAX
    package's ``pack_pallas`` / ``uniform_pack``.  A CUDA tensor launches
    the kernel (counted in ``pack_cuda.launches``); a CPU tensor runs
    ``pack_plain``."""
    n = vals.numel() if n is None else n
    if vals.device.type == "cpu":
        return pack_plain(vals, width, n, from_f32)
    if vals.device.type != "cuda":
        raise ValueError(f"no pack for device {vals.device}")
    _check(vals, width, n, from_f32)
    vals = vals.contiguous()
    n_words = packed_words(n, width)
    out = torch.empty(n_words, dtype=torch.int32, device=vals.device)
    if n_words == 0:
        return out
    lib = cuda_lib.lib()
    with torch.cuda.device(vals.device):
        rc = lib.mnw_pack_uniform(
            vals.data_ptr(), n, width, int(from_f32), out.data_ptr(),
            n_words, torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "pack")
    pack_cuda.launches += 1
    return out


pack_cuda.launches = 0
