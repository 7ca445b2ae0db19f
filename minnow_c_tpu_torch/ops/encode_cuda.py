"""The encode kernels (``csrc/pack.cu``, ``csrc/stats.cu``) and their plain
torch versions.

* K4 ``pack_cuda`` / ``pack_plain``, port of
  ``minnow_c_tpu/ops/encode_pallas.py:pack_pallas``.  ``from_f32=True``
  takes the pre-scaled f32 plane ``delta * 2^width`` of the div-mode
  encode and truncates / clamps it to bins first
  (``kernels.scaled_to_bins``).
* K7 ``pack_rows_cuda`` / ``pack_rows_plain``, port of
  ``pack_pallas_rows``: each row of (R, n) u32 bins packed on its own,
  32 | n.
* K6 ``stats_rows_cuda`` / ``stats_rows_plain``, port of
  ``stats_pallas_rows``: per-row min and max of R streams after the
  anchored periodic unwrap.

Each ``*_cuda`` wrapper launches its CUDA kernel for a CUDA tensor and runs
the plain version only for a CPU tensor; there is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .bitpack import packed_words
from .kernels import M32, i64_to_u32, scaled_to_bins, u32_to_i64

STATS_SLICE = 4096  # elements per block of K6's first launch


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


def _check_rows(vals: torch.Tensor, width: int) -> None:
    if not 0 <= width <= 32:
        raise ValueError(f"width {width} not in [0, 32]")
    if vals.dtype != torch.int32 or vals.dim() != 2:
        raise TypeError("pack_rows needs a 2-D int32 tensor of u32 bins")
    if vals.shape[1] % 32:
        raise ValueError(f"pack_rows needs 32 | n, got n = {vals.shape[1]}")


def pack_rows_plain(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Plain torch version of K7 on any device: (R, n) u32 bins ->
    (R, (n/32)*width) words.  With 32 | n every row fills whole words, so
    the rows pack as one stream of R*n elements."""
    _check_rows(vals, width)
    return pack_plain(vals.reshape(-1), width).reshape(vals.shape[0], -1)


def pack_rows_cuda(vals: torch.Tensor, width: int) -> torch.Tensor:
    """Pack each row of ``vals`` (R, n), 32 | n, at ``width`` bits; row r
    equals ``pack_cuda(vals[r], width)``.  Semantics of the JAX package's
    ``pack_pallas_rows`` / ``bitpack.uniform_pack_rows``.  A CUDA tensor
    launches K7 (counted in ``pack_rows_cuda.launches``); a CPU tensor runs
    ``pack_rows_plain``."""
    if vals.device.type == "cpu":
        return pack_rows_plain(vals, width)
    if vals.device.type != "cuda":
        raise ValueError(f"no pack for device {vals.device}")
    _check_rows(vals, width)
    rows, n = vals.shape
    out = torch.empty((rows, n // 32 * width), dtype=torch.int32,
                      device=vals.device)
    if out.numel() == 0:
        return out
    vals = vals.contiguous()
    lib = cuda_lib.lib()
    with torch.cuda.device(vals.device):
        rc = lib.mnw_pack_rows(vals.data_ptr(), rows, n, width,
                               out.data_ptr(),
                               torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "pack_rows")
    pack_rows_cuda.launches += 1
    return out


pack_rows_cuda.launches = 0


def _check_stats(x: torch.Tensor, box: torch.Tensor,
                 anchor: torch.Tensor) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[1] == 0:
        raise TypeError("stats_rows needs a 2-D float32 tensor with n >= 1")
    for name, t in (("box", box), ("anchor", anchor)):
        if t.dtype != torch.float32 or t.shape != (x.shape[0],):
            raise ValueError(f"{name} must be float32 of shape "
                             f"({x.shape[0]},)")


def stats_rows_plain(x: torch.Tensor, box: torch.Tensor,
                     anchor: torch.Tensor, periodic: bool):
    """Plain torch version of K6 on any device: per row of ``x`` (R, n), the
    min and max after the unwrap around ``anchor[r]`` in a box of
    ``box[r]`` (``kernels.undo_periodic`` op for op).  Like ``jnp.min`` /
    ``jnp.max``: NaN propagates, -0.0 counts below +0.0."""
    _check_stats(x, box, anchor)
    if periodic:
        bx = box[:, None]
        a = anchor[:, None]
        half = bx * 0.5
        x = torch.where(x - a >= half, x - bx, x)
        x = torch.where(x - a < -half, x + bx, x)
    mn = x.amin(dim=1)
    mx = x.amax(dim=1)
    # torch.amin / amax return either zero when +-0.0 tie; pin the sign.
    zero = x == 0
    neg = torch.signbit(x)
    mn = torch.where(mn == 0, torch.where((zero & neg).any(dim=1), -0.0,
                                          0.0), mn)
    mx = torch.where(mx == 0, torch.where((zero & ~neg).any(dim=1), 0.0,
                                          -0.0), mx)
    nan = torch.isnan(x).any(dim=1)
    return (torch.where(nan, float("nan"), mn),
            torch.where(nan, float("nan"), mx))


def stats_rows_cuda(x: torch.Tensor, box: torch.Tensor,
                    anchor: torch.Tensor, periodic: bool):
    """Per-row (min (R,), max (R,)) of ``x`` (R, n) f32 after the periodic
    unwrap around ``anchor`` (R,) in boxes ``box`` (R,) when ``periodic``.
    Semantics of the JAX package's ``stats_pallas_rows``.  A CUDA tensor
    launches K6 (counted in ``stats_rows_cuda.launches``); a CPU tensor
    runs ``stats_rows_plain``."""
    if x.device.type == "cpu":
        return stats_rows_plain(x, box, anchor, periodic)
    if x.device.type != "cuda":
        raise ValueError(f"no stats for device {x.device}")
    _check_stats(x, box, anchor)
    x, box, anchor = x.contiguous(), box.contiguous(), anchor.contiguous()
    rows, n = x.shape
    slices = -(-n // STATS_SLICE)
    partials = torch.empty(2 * rows * slices, dtype=torch.float32,
                           device=x.device)
    mn = torch.empty(rows, dtype=torch.float32, device=x.device)
    mx = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return mn, mx
    lib = cuda_lib.lib()
    with torch.cuda.device(x.device):
        rc = lib.mnw_stats_rows(
            x.data_ptr(), rows, n, STATS_SLICE, box.data_ptr(),
            anchor.data_ptr(), int(periodic), partials.data_ptr(),
            mn.data_ptr(), mx.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "stats_rows")
    stats_rows_cuda.launches += 1
    return mn, mx


stats_rows_cuda.launches = 0
