"""The decode kernels (``csrc/decode.cu``) and their plain torch versions.

* K1 ``decode_cuda`` / ``decode_plain``, port of
  ``minnow_c_tpu/ops/decode_pallas.py:decode_pallas``: one pass that
  unpacks a plane at ``width`` bits, draws the Threefry-2x32-13 dither of
  ``ops/rng.py``, undoes the bin index as ``x0 + dx_bin*(bin + u)`` (the
  multiply and add rounded once together, as the frozen decode wire has
  them), and optionally rewraps into the periodic box.
* K2 ``decode_rows_cuda`` / ``decode_rows_plain``, port of
  ``decode_pallas_rows``: K1 over R independent streams with per-row key,
  x0 and range, the dither counter restarting at 0 in every row.
* K3 ``unpack_rows_cuda`` / ``unpack_rows_plain``, port of
  ``unpack_pallas_rows``: the bare unpack of R streams to u32 bins.

The rows kernels need ``rows_kernel_eligible``: 32 | n, so no row ends
inside a word.  K1, K2 and K3 are one CUDA tile kernel over the flat
stream of words, cut into tiles by ``decode_plan``, under two element
steps: the decoded floats (K1, K2) or the bare bins (K3).  Each
``*_cuda`` wrapper launches its CUDA kernel for a CUDA tensor and runs the
plain version only for a CPU tensor; there is no fallback from one to the
other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitpack, cuda_lib, kernels
from . import rng as _rng

DECODE_TILE = 4096      # elements per tile of K1-K3: a multiple of 128
BLOCKS_PER_SM = 4       # the persistent grid: blocks resident on each SM
MAX_ROW = 1 << 31       # K1 / K2 find a quad's row in 32 bits


def decode_plan(width: int, total: int, ptr: int, sms: int) -> dict:
    """How K1-K3 cut a flat stream of ``total`` elements packed at
    ``width`` bits in u32 words at address ``ptr``, for a card
    of ``sms`` SMs: tile t holds elements [t*tile, (t+1)*tile) and words
    [t*words_per_tile, (t+1)*words_per_tile) (both cut at the stream's
    end); the grid's blocks walk tiles b, b + grid, ...; two buffers of
    words_per_tile + 4 words each in shared memory; 16-byte copies when
    the stream starts on a 16-byte boundary (every tile then does, as
    words_per_tile is a multiple of 4), 4-byte copies otherwise."""
    tiles = -(-total // DECODE_TILE)
    wpt = DECODE_TILE // 32 * width
    return {"tile": DECODE_TILE, "tiles": tiles, "words_per_tile": wpt,
            "grid": max(1, min(tiles, sms * BLOCKS_PER_SM)),
            "smem_bytes": 2 * (wpt + 4) * 4, "vec16": ptr % 16 == 0}


def _launch_decode(words: torch.Tensor, total: int, n: int, width: int,
                   keys, x0, dx, ctr0: int, box, periodic: bool,
                   out: torch.Tensor) -> None:
    """One launch of the K1 / K2 kernel over ``words`` (contiguous, on the
    card), streams of ``n`` elements, ``total`` in all.  Rows of their own:
    ``keys`` an (R, 2) int64 tensor of any strides (the kernel reads each
    key's low 32 bits), ``x0`` and ``dx`` (R,) contiguous f32 tensors, dx
    the full range (the kernel derives the bin width f32(dx) / 2^width as
    ``kernels.bin_width`` does).  One stream: ``keys`` a (k0, k1) pair,
    ``x0`` and ``dx`` host scalars."""
    if n > MAX_ROW:
        raise ValueError(f"a row of {n} elements exceeds {MAX_ROW}")
    plan = decode_plan(width, total, words.data_ptr(),
                       cuda_lib.sm_count(words.device))
    if isinstance(keys, torch.Tensor):
        rows = (keys.data_ptr(), keys.stride(0), keys.stride(1),
                x0.data_ptr(), dx.data_ptr(), 0, 0, 0.0, 0.0)
        n_magic = cuda_lib.row_magic(n) if total > n else 0
    else:
        rows = (None, 0, 0, None, None, keys[0], keys[1], float(x0),
                float(dx))
        n_magic = 0
    cuda_lib.launch(
        "decode", cuda_lib.lib().mnw_decode_tiles, words.device,
        words.data_ptr(), words.numel(), total, n, n_magic, plan["tiles"],
        plan["tile"], int(plan["vec16"]), *rows, ctr0 & kernels.M32,
        float(box), int(periodic), width, plan["grid"], plan["smem_bytes"],
        out.data_ptr())


def decode_plain(words: torch.Tensor, k0: int, k1: int, x0, dx_bin, box,
                 n: int, width: int, elem0: int = 0,
                 periodic: bool = False) -> torch.Tensor:
    """Plain torch version of the kernel, on any device: unpack, dither
    (element i uses counter (elem0 + i) >> 2), ``x0 + dx_bin*(bin + u)``
    rounded as ``kernels.undo_bins``, rewrap.  ``dx_bin`` is the bin width,
    f32(dx) / 2^width."""
    bins = bitpack.uniform_unpack(words, width, n)
    u = _rng.uniform_dither((k0, k1), (n,), ctr0=elem0, device=words.device)
    x = kernels.undo_bins(bins, x0, dx_bin, u)
    return kernels.periodic(x, box) if periodic else x


def _check_decode(words: torch.Tensor, width: int, n: int,
                  elem0: int) -> None:
    if not 1 <= width <= 24:
        raise ValueError(f"float decode width {width} not in [1, 24]: "
                         "float depths cap at the f32 mantissa")
    if n < 1 or elem0 % 4:
        raise ValueError(f"need n >= 1 and elem0 % 4 == 0 (n={n}, "
                         f"elem0={elem0})")
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be a 1-D int32 tensor of u32 bits")
    if words.numel() < bitpack.packed_words(n, width):
        raise ValueError(f"{words.numel()} words cannot hold {n} elements "
                         f"of {width} bits")


def decode_cuda(words: torch.Tensor, key, width: int, n: int, x0, dx,
                box=0.0, periodic: bool = False,
                elem0: int = 0) -> torch.Tensor:
    """Fused decode of ``n`` elements packed at ``width`` bits in u32 words
    (int32 tensor); ``key`` is the (k0, k1) dither key, ``dx`` the plane's
    full range, ``elem0`` the global index of its first element (a
    multiple of 4).  Semantics of the JAX package's ``decode_pallas``.  A
    CUDA tensor launches the kernel (counted in ``decode_cuda.launches``);
    a CPU tensor runs ``decode_plain``.

    ``key`` may also be a (2,) integer tensor on the words' device, and
    ``x0`` / ``dx`` one-element f32 tensors there (or host scalars): on
    the card the kernel reads them as K2 reads its row parameters, one
    row, so a key made on the card (a benchmark's salted key) needs no
    host read."""
    _check_decode(words, width, n, elem0)
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no decode for device {dev}")
    box = np.float32(box)
    if dev.type == "cuda" and isinstance(key, torch.Tensor):
        keys = _row_param(key, dev, torch.int64, (1, 2))
        x0, dx = (_row_param(v, dev, torch.float32, (1,)) for v in (x0, dx))
    else:
        keys = tuple(int(k) & kernels.M32 for k in key)
        x0, dx = np.float32(float(x0)), np.float32(float(dx))
    if dev.type == "cpu":
        return decode_plain(words, *keys, x0, kernels.bin_width(dx, width),
                            box, n, width, elem0, periodic)
    words = words[:bitpack.packed_words(n, width)].contiguous()
    out = torch.empty(n, dtype=torch.float32, device=dev)
    _launch_decode(words, n, n, width, keys, x0, dx, elem0 // 4, box,
                   periodic, out)
    decode_cuda.launches += 1
    return out


decode_cuda.launches = 0


def rows_kernel_eligible(width: int, n: int) -> bool:
    """Gate of the rows kernels (K2, K3): a positive width and a 32-aligned
    element count, so that every row's stream ends on a word boundary
    (``decode_pallas.rows_kernel_eligible``)."""
    return width >= 1 and n >= 1 and n % 32 == 0


def _check_rows(words: torch.Tensor, width: int, n: int, max_width: int,
                what: str) -> None:
    if not rows_kernel_eligible(width, n) or width > max_width:
        raise ValueError(f"{what} needs 1 <= width <= {max_width} and "
                         f"32 | n (width={width}, n={n})")
    if words.dtype != torch.int32 or words.dim() != 2:
        raise TypeError("words must be a 2-D int32 tensor of u32 bits")
    if words.shape[1] != n // 32 * width:
        raise ValueError(f"rows of {words.shape[1]} words do not hold "
                         f"{n} elements of {width} bits")


def unpack_rows_plain(words: torch.Tensor, width: int,
                      n: int) -> torch.Tensor:
    """Plain torch version of K3 on any device: (R, n*width/32) words ->
    (R, n) u32 bins (int32).  With 32 | n every row starts on a word, so
    the rows are one stream of R*n elements."""
    rows = words.shape[0]
    return bitpack.uniform_unpack(words.reshape(-1), width,
                                  rows * n).reshape(rows, n)


def unpack_rows_cuda(words: torch.Tensor, width: int,
                     n: int) -> torch.Tensor:
    """Unpack R independent streams of ``n`` elements at ``width`` bits
    (1..32, 32 | n); row r equals ``uniform_unpack(words[r], width, n)``.
    Semantics of the JAX package's ``unpack_pallas_rows``.  A CUDA tensor
    launches K3 (counted in ``unpack_rows_cuda.launches``); a CPU tensor
    runs ``unpack_rows_plain``."""
    _check_rows(words, width, n, 32, "unpack_rows")
    if words.device.type == "cpu":
        return unpack_rows_plain(words, width, n)
    if words.device.type != "cuda":
        raise ValueError(f"no unpack for device {words.device}")
    words = words.contiguous()
    rows = words.shape[0]
    out = torch.empty((rows, n), dtype=torch.int32, device=words.device)
    if rows == 0:
        return out
    plan = decode_plan(width, rows * n, words.data_ptr(),
                       cuda_lib.sm_count(words.device))
    cuda_lib.launch("unpack_rows", cuda_lib.lib().mnw_unpack_rows,
                    words.device, words.data_ptr(), words.numel(), rows * n,
                    plan["tiles"], plan["tile"], int(plan["vec16"]), width,
                    plan["grid"], plan["smem_bytes"], out.data_ptr())
    unpack_rows_cuda.launches += 1
    return out


unpack_rows_cuda.launches = 0


def decode_rows_plain(words: torch.Tensor, keys: torch.Tensor,
                      x0: torch.Tensor, dx_bin: torch.Tensor, box,
                      n: int, width: int,
                      periodic: bool = False) -> torch.Tensor:
    """Plain torch version of K2 on any device: per row, unpack, the dither
    of key ``keys[r]`` from counter 0, ``x0[r] + dx_bin[r]*(bin + u)``
    rounded as ``kernels.undo_bins``, rewrap.  ``x0`` and ``dx_bin`` are
    (R,) f32, ``dx_bin`` the bin width f32(dx) / 2^width."""
    bins = unpack_rows_plain(words, width, n)
    u = _rng.uniform_dither_rows(keys, n)
    s = kernels.u32_to_i64(bins).to(torch.float32) + u
    x = kernels.fma_f32(dx_bin[:, None], s, x0[:, None])
    return kernels.periodic(x, box) if periodic else x


def decode_rows_cuda(words: torch.Tensor, keys, width: int, n: int, x0, dx,
                     box=0.0, periodic: bool = False) -> torch.Tensor:
    """Fused decode of R independent streams: ``words`` (R, n*width/32)
    int32 of u32 bits, ``keys`` (R, 2) dither keys (integers holding u32),
    ``x0`` and ``dx`` (R,) per-row offset and full range; width 1..24,
    32 | n.  Row r equals ``decode_cuda(words[r], keys[r], width, n, x0[r],
    dx[r], box, periodic)``.  Semantics of the JAX package's
    ``decode_pallas_rows``.  A CUDA tensor launches K2 (counted in
    ``decode_rows_cuda.launches``); a CPU tensor runs
    ``decode_rows_plain``."""
    _check_rows(words, width, n, 24, "decode_rows")
    dev = words.device
    rows = words.shape[0]
    if dev.type == "cpu":
        keys = torch.as_tensor(keys, device=dev).reshape(rows, 2)
        x0, dx = (torch.as_tensor(v, dtype=torch.float32, device=dev)
                  .reshape(rows) for v in (x0, dx))
        return decode_rows_plain(words, keys, x0, kernels.bin_width(dx, width),
                                 box, n, width, periodic)
    if dev.type != "cuda":
        raise ValueError(f"no decode for device {dev}")
    out = torch.empty((rows, n), dtype=torch.float32, device=dev)
    if rows == 0:
        return out
    _launch_decode(words.contiguous(), rows * n, n, width,
                   _row_param(keys, dev, torch.int64, (rows, 2)),
                   _row_param(x0, dev, torch.float32, (rows,)),
                   _row_param(dx, dev, torch.float32, (rows,)), 0,
                   np.float32(box), periodic, out)
    decode_rows_cuda.launches += 1
    return out


def _row_param(v, dev: torch.device, dtype: torch.dtype,
               shape: tuple) -> torch.Tensor:
    """A per-row parameter as a tensor of ``dtype`` and ``shape`` on
    ``dev``, contiguous unless it holds keys (the kernel takes their
    strides).  A tensor that already is one passes as it is: each torch
    call here is host time on every launch."""
    if not (isinstance(v, torch.Tensor) and v.device == dev and
            v.dtype == dtype and v.shape == shape and
            (dtype == torch.int64 or v.is_contiguous())):
        v = torch.as_tensor(v, device=dev).to(dtype).reshape(shape)
    return v if dtype == torch.int64 else v.contiguous()


decode_rows_cuda.launches = 0
