"""K9, the u32 prefix sum (``csrc/scan.cu``), and its plain torch version.

Port of ``minnow_c_tpu/ops/scan_pallas.py``: ``cumsum_u32`` is the inclusive
prefix sum mod 2^32 of a u32 stream (int32 tensor of u32 bits),
bit-identical to ``jnp.cumsum`` on u32.  The delta codecs' decode (Diff,
Coil v1.0 / v1.1 at small chunks) runs it over the un-zigzagged deltas.

* ``cumsum_u32`` launches the kernel for a CUDA tensor (counted in
  ``cumsum_u32.launches``) and raises for any other device;
* ``cumsum_u32_plain`` is the int64 ``torch.cumsum`` masked to 32 bits, on
  any device;
* ``cumsum_u32_auto`` runs the kernel for every CUDA tensor and the plain
  version for a CPU tensor.  The JAX package's ``n >= 2^14`` cut-over
  exists for the TPU's per-grid-step latency and is not carried over.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .kernels import i64_to_u32, u32_to_i64

TILE = 4096  # elements per block of the kernel's first and last launch


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError("cumsum_u32 needs a 1-D int32 tensor of u32 bits")


def cumsum_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive u32 prefix sum of ``x`` (int32 of u32 bits) as the int64
    cumsum of the u32 values masked to 32 bits; any device."""
    _check(x)
    return i64_to_u32(torch.cumsum(u32_to_i64(x), 0) & 0xFFFFFFFF)


def cumsum_u32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive u32 prefix sum of a CUDA tensor ``x`` by K9 (reduce the
    4096-element tiles, scan the tile sums, rescan each tile with its
    carry).  Semantics of the JAX package's ``scan_pallas.cumsum_u32``."""
    _check(x)
    if x.device.type != "cuda":
        raise ValueError(f"cumsum_u32 is the CUDA kernel; got device "
                         f"{x.device} (use cumsum_u32_auto)")
    x = x.contiguous()
    n = x.numel()
    out = torch.empty_like(x)
    if n == 0:
        return out
    scratch = torch.empty(2 * -(-n // TILE), dtype=torch.int32,
                          device=x.device)
    cuda_lib.launch("cumsum_u32", cuda_lib.lib().mnw_cumsum_u32, x.device,
                    x.data_ptr(), n, scratch.data_ptr(), out.data_ptr())
    cumsum_u32.launches += 1
    return out


cumsum_u32.launches = 0


def cumsum_u32_auto(x: torch.Tensor) -> torch.Tensor:
    """K9 for a CUDA tensor, the plain version for a CPU tensor; the same
    bits either way."""
    if x.device.type == "cpu":
        return cumsum_u32_plain(x)
    return cumsum_u32(x)
