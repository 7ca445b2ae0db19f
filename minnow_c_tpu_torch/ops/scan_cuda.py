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

The kernel is one launch, a single-pass scan with decoupled look-back: its
tiles publish 64-bit status words into a buffer kept per device and stream
(``status_words``), which the C entry point clears with one
``cudaMemsetAsync`` before the launch.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .kernels import i64_to_u32, u32_to_i64

TILE = 4096            # elements per tile: 128 threads x 32
BLOCKS_PER_SM = 8      # the persistent grid: blocks resident on each SM
MAX_TILES = 1 << 31    # tickets are 32-bit


def scan_plan(n: int, ptr: int, sms: int) -> dict:
    """How K9 cuts a stream of ``n`` >= 1 u32 values at address ``ptr`` on
    a card of ``sms`` SMs: ``tiles`` tiles of ``tile`` elements (the last
    one ragged), taken by ticket by the ``grid`` blocks of a persistent
    grid; one 64-bit status word per tile after the 8-byte ticket counter;
    16-byte loads when the stream starts on a 16-byte boundary (every tile
    then does), 4-byte loads otherwise."""
    tiles = -(-n // TILE)
    if tiles >= MAX_TILES:
        raise ValueError(f"cumsum_u32 of {n} elements needs {tiles} tiles; "
                         f"the kernel takes fewer than {MAX_TILES}")
    return {"tile": TILE, "tiles": tiles,
            "grid": min(tiles, sms * BLOCKS_PER_SM),
            "status_words": 1 + tiles, "vec16": ptr % 16 == 0}


_scratch = {}   # (device index, stream) -> int64 status words


def status_words(key, need: int, device) -> torch.Tensor:
    """The status words of one device and stream (``key``): at least
    ``need`` int64 words, kept between calls and grown only when n grows.
    One buffer a stream: calls on two streams may run at once."""
    words = _scratch.get(key)
    if words is None or words.numel() < need:
        words = _scratch[key] = torch.empty(need, dtype=torch.int64,
                                            device=device)
    return words


def _check(x: torch.Tensor) -> None:
    if x.dtype != torch.int32 or x.dim() != 1:
        raise TypeError("cumsum_u32 needs a 1-D int32 tensor of u32 bits")


def cumsum_u32_plain(x: torch.Tensor) -> torch.Tensor:
    """Inclusive u32 prefix sum of ``x`` (int32 of u32 bits) as the int64
    cumsum of the u32 values masked to 32 bits; any device."""
    _check(x)
    return i64_to_u32(torch.cumsum(u32_to_i64(x), 0) & 0xFFFFFFFF)


def cumsum_u32(x: torch.Tensor) -> torch.Tensor:
    """Inclusive u32 prefix sum of a CUDA tensor ``x`` by K9 (one pass,
    decoupled look-back).  Semantics of the JAX package's
    ``scan_pallas.cumsum_u32``.  The host work before the launch delays
    the kernel by as much, so it is kept to the least."""
    _check(x)
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"cumsum_u32 is the CUDA kernel; got device "
                         f"{device} (use cumsum_u32_auto)")
    if not x.is_contiguous():
        x = x.contiguous()
    out = torch.empty_like(x)
    n = out.numel()
    if n == 0:
        return out
    index, stream = cuda_lib.current_stream(device)
    ptr = x.data_ptr()
    plan = scan_plan(n, ptr, cuda_lib.sm_count(device))
    words = status_words((index, stream), plan["status_words"], device)
    cuda_lib.launch_on("cumsum_u32", cuda_lib.lib().mnw_cumsum_u32, index,
                       stream, ptr, n, plan["tiles"], plan["grid"],
                       plan["vec16"], words.data_ptr(), out.data_ptr())
    cumsum_u32.launches += 1
    return out


cumsum_u32.launches = 0


def cumsum_u32_auto(x: torch.Tensor) -> torch.Tensor:
    """K9 for a CUDA tensor, the plain version for a CPU tensor; the same
    bits either way."""
    if x.device.type == "cpu":
        return cumsum_u32_plain(x)
    return cumsum_u32(x)
