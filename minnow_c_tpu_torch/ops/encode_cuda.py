"""The encode kernels (``csrc/pack.cu``, ``csrc/stats.cu``,
``csrc/encode_recip.cu``) and their plain torch versions.

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
  anchored periodic unwrap, in one launch of one block per (row, slice of
  ``STATS_SLICE``); the block that takes a row's last ticket finishes the
  row.  Its ticket counters and slice keys live in the per-stream scratch
  of ``scan_cuda.status_words``; K12's first step runs the same slice
  routine.
* K5 ``encode_recip_cuda`` / ``encode_recip_plain``, port of
  ``encode_pallas_recip``'s kernel: the recip scale mode's whole bin map
  (anchored unwrap, ``((x - x0) * recip) * 2^w``, clamp) and the pack of one
  plane of any length, in one pass over the raw floats.
* K8 ``encode_recip_rows_cuda`` / ``encode_recip_rows_plain``, port of
  ``encode_pallas_recip_rows``: K5 over R rows with per-row scalars,
  32 | n; the snapshot writer's recip mode.
* K12 ``encode_recip_fused_blocks_cuda`` /
  ``encode_recip_fused_blocks_plain``, port of
  ``encode_recip_fused_blocks``: per block of D rows the stats, the shared
  range and its reciprocal, then K8's map and pack, in one launch.  Its
  plain version is the split pipeline (K6's stats, the host's
  ``exact_recip``, K8's map); no writer calls it, as none in the JAX
  package does.

K4, K5, K7 and K8 are one CUDA tile kernel (``csrc/pack.cuh``) over the
flat stream of bins or raw floats, cut into tiles by ``pack_plan``, under
three element maps (mask, clamp of a pre-scaled float, the recip map of
the element's row); K12's last step runs the same tile routine.  A row's
elements are found with the magic number of ``cuda_lib.row_magic``.  Each
``*_cuda`` wrapper launches its CUDA kernel
for a CUDA tensor and runs the plain version only for a CPU tensor; there
is no fallback from one to the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda_lib, kernels
from .bitpack import packed_words
from .kernels import M32, i64_to_u32, scaled_to_bins, u32_to_i64
from .scan_cuda import status_words

STATS_SLICE = 32768  # elements per block of K6 and K12's first step: 4 | it
PACK_TILE = 4096  # elements per tile of K4 / K7: a multiple of 1024
BLOCKS_PER_SM = 4  # the persistent grid: blocks resident on each SM


def pack_plan(width: int, n: int, ptr: int, sms: int) -> dict:
    """How K4 / K7 cut a flat stream of ``n`` bins (4 bytes each, at
    address ``ptr``) packed at ``width`` bits, for a card of ``sms`` SMs:
    tile t holds elements [t*tile, (t+1)*tile) and packs into words
    [t*words_per_tile, (t+1)*words_per_tile) (both cut at the stream's
    end); the grid's blocks walk tiles b, b + grid, ...; the tile's bins in
    shared memory, skewed by one word every 32 (tile + tile / 32 words);
    16-byte loads when the bins start on a 16-byte boundary (every tile
    then does), 4-byte loads otherwise."""
    tiles = -(-n // PACK_TILE)
    return {"tile": PACK_TILE, "tiles": tiles,
            "words_per_tile": PACK_TILE // 32 * width,
            "grid": max(1, min(tiles, sms * BLOCKS_PER_SM)),
            "smem_bytes": (PACK_TILE + PACK_TILE // 32) * 4,
            "vec16": ptr % 16 == 0}


def _launch_pack(vals: torch.Tensor, n: int, width: int, from_f32: bool,
                 out: torch.Tensor) -> None:
    """One launch of the K4 / K7 kernel: the first ``n`` values of the
    contiguous ``vals`` packed at ``width`` bits into ``out``."""
    plan = pack_plan(width, n, vals.data_ptr(),
                     cuda_lib.sm_count(vals.device))
    cuda_lib.launch("pack", cuda_lib.lib().mnw_pack_tiles, vals.device,
                    vals.data_ptr(), n, width, int(from_f32), plan["tiles"],
                    plan["tile"], int(plan["vec16"]), plan["grid"],
                    plan["smem_bytes"], out.data_ptr(), out.numel())


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
    _launch_pack(vals, n, width, from_f32, out)
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
    _launch_pack(vals.contiguous(), rows * n, width, False, out)
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
    ``jnp.max`` on XLA: subnormals count as zeros of their sign, NaN
    propagates, -0.0 counts below +0.0."""
    _check_stats(x, box, anchor)
    return kernels.minmax(
        kernels.unwrap_anchored(x, box[:, None], anchor[:, None])
        if periodic else x)


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
    mn = torch.empty(rows, dtype=torch.float32, device=x.device)
    mx = torch.empty(rows, dtype=torch.float32, device=x.device)
    if rows == 0:
        return mn, mx
    # rows u32 ticket counters, then each (row, slice)'s two i32 keys, in
    # the stream's scratch words (shared with K9: one stream runs one
    # kernel at a time)
    index, stream = cuda_lib.current_stream(x.device)
    ints = rows * (1 + 2 * -(-n // STATS_SLICE))
    scratch = status_words((index, stream), -(-ints // 2), x.device)
    cuda_lib.launch_on("stats_rows", cuda_lib.lib().mnw_stats_rows, index,
                       stream, x.data_ptr(), rows, n, STATS_SLICE,
                       box.data_ptr(), anchor.data_ptr(), int(periodic),
                       scratch.data_ptr(), mn.data_ptr(), mx.data_ptr())
    stats_rows_cuda.launches += 1
    return mn, mx


stats_rows_cuda.launches = 0


# ---------------------------------------------------------------------------
# The recip scale mode: K5, K8, K12
# ---------------------------------------------------------------------------

def _check_recip(x: torch.Tensor, width: int, dims: int) -> None:
    if not 1 <= width <= 24:
        raise ValueError(f"float encode width {width} not in [1, 24] (f32 "
                         "mantissa cap)")
    if x.dtype != torch.float32 or x.dim() != dims:
        raise TypeError(f"recip encode needs a {dims}-D float32 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    if dims > 1 and (x.shape[-1] == 0 or x.shape[-1] % 32):
        raise ValueError(f"recip rows encode needs 32 | n and n > 0, got "
                         f"n = {x.shape[-1]}")


def encode_recip_plain(x: torch.Tensor, width: int, x0, recip, box, anchor,
                       periodic: bool) -> torch.Tensor:
    """Plain torch version of K5 on any device: the recip bin map of the
    raw plane ``x`` (``kernels.recip_scaled_bins``), then the pack."""
    _check_recip(x, width, 1)
    return pack_plain(kernels.recip_scaled_bins(x, x0, recip, box, anchor,
                                                width, periodic), width)


def _launch_recip(x: torch.Tensor, total: int, width: int, row_n: int,
                  scalars, periodic: bool, out: torch.Tensor) -> None:
    """One launch of the K5 / K8 kernel (K7's tile kernel with the recip
    map) over the ``total`` raw floats of the contiguous ``x``.  Rows of
    ``row_n`` elements: ``scalars`` the (R,) f32 tensors x0, recip, box and
    anchor.  One plane (``row_n`` 0): ``scalars`` its four host values."""
    plan = pack_plan(width, total, x.data_ptr(),
                     cuda_lib.sm_count(x.device))
    if row_n:
        rows = (row_n, cuda_lib.row_magic(row_n),
                *(t.data_ptr() for t in scalars), 0.0, 0.0, 0.0, 0.0)
    else:
        rows = (0, 0, None, None, None, None,
                *(float(np.float32(v)) for v in scalars))
    cuda_lib.launch(
        "encode_recip", cuda_lib.lib().mnw_pack_recip_tiles, x.device,
        x.data_ptr(), total, width, plan["tiles"], plan["tile"],
        int(plan["vec16"]), plan["grid"], plan["smem_bytes"], *rows,
        int(periodic), out.data_ptr(), out.numel())


def encode_recip_cuda(x: torch.Tensor, width: int, x0, recip, box, anchor,
                      periodic: bool) -> torch.Tensor:
    """Recip-mode encode of one raw plane (n,) f32, any n, to
    ``ceil(n*width/32)`` words; ``x0``, ``recip`` = rn(1/range), ``box`` and
    ``anchor`` (the plane's raw element 0) are host scalars.  Semantics of
    the JAX package's ``encode_pallas_recip`` after its stats.  A CUDA
    tensor launches K5, K8's kernel at one row (counted in
    ``encode_recip_cuda.launches``); a CPU tensor runs
    ``encode_recip_plain``."""
    if x.device.type == "cpu":
        return encode_recip_plain(x, width, x0, recip, box, anchor, periodic)
    if x.device.type != "cuda":
        raise ValueError(f"no recip encode for device {x.device}")
    _check_recip(x, width, 1)
    if not x.is_contiguous():
        x = x.contiguous()
    n = x.numel()
    n_words = packed_words(n, width)
    out = torch.empty(n_words, dtype=torch.int32, device=x.device)
    if n_words == 0:
        return out
    _launch_recip(x, n, width, 0, (x0, recip, box, anchor), periodic, out)
    encode_recip_cuda.launches += 1
    return out


encode_recip_cuda.launches = 0


def _row_scalars(x: torch.Tensor, *vals):
    """Per-row scalars as contiguous f32 (R,) tensors on x's device."""
    rows = x.shape[0]
    out = []
    for v in vals:
        t = torch.as_tensor(v, dtype=torch.float32, device=x.device)
        if t.shape != (rows,):
            raise ValueError(f"per-row scalars must have shape ({rows},), "
                             f"got {tuple(t.shape)}")
        out.append(t.contiguous())
    return out


def encode_recip_rows_plain(x: torch.Tensor, width: int, x0, recip, box,
                            anchor, periodic: bool) -> torch.Tensor:
    """Plain torch version of K8 on any device: (R, n) raw floats, 32 | n,
    with per-row (R,) x0, recip, box and anchor -> (R, (n/32)*width)
    words."""
    _check_recip(x, width, 2)
    x0, recip, box, anchor = (t[:, None] for t in _row_scalars(
        x, x0, recip, box, anchor))
    return pack_rows_plain(kernels.recip_scaled_bins(
        x, x0, recip, box, anchor, width, periodic), width)


def encode_recip_rows_cuda(x: torch.Tensor, width: int, x0, recip, box,
                           anchor, periodic: bool) -> torch.Tensor:
    """Recip-mode encode of R independent rows (R, n), 32 | n, each with
    its own x0, recip, box and anchor (R,); row r equals
    ``encode_recip_cuda(x[r], ...)`` at row r's scalars.  Semantics of the
    JAX package's ``encode_pallas_recip_rows``.  A CUDA tensor launches K8
    (counted in ``encode_recip_rows_cuda.launches``); a CPU tensor runs
    ``encode_recip_rows_plain``."""
    if x.device.type == "cpu":
        return encode_recip_rows_plain(x, width, x0, recip, box, anchor,
                                       periodic)
    if x.device.type != "cuda":
        raise ValueError(f"no recip encode for device {x.device}")
    _check_recip(x, width, 2)
    if not x.is_contiguous():
        x = x.contiguous()
    rows, n = x.shape
    scalars = _row_scalars(x, x0, recip, box, anchor)
    out = torch.empty((rows, n // 32 * width), dtype=torch.int32,
                      device=x.device)
    if rows == 0:
        return out
    _launch_recip(x, rows * n, width, n, scalars, periodic, out)
    encode_recip_rows_cuda.launches += 1
    return out


encode_recip_rows_cuda.launches = 0


def _check_fused(x: torch.Tensor, anchors: torch.Tensor, width: int) -> None:
    _check_recip(x, width, 3)
    if anchors.dtype != torch.float32 or anchors.shape != x.shape[:2]:
        raise ValueError(f"anchors must be float32 of shape "
                         f"{tuple(x.shape[:2])}")


def encode_recip_fused_blocks_plain(x: torch.Tensor, box, anchors,
                                    width: int, periodic: bool):
    """Plain torch version of K12 on any device, as the split pipeline:
    K6's stats of every row, the block's range max_d(mx - mn),
    ``kernels.exact_recip`` on the host, then K8's map and pack.  Returns
    (words (B, D, (n/32)*width), mn (B, D), mx (B, D))."""
    _check_fused(x, anchors, width)
    b, d, n = x.shape
    rows = x.reshape(b * d, n)
    boxes = torch.full((b * d,), float(np.float32(box)), dtype=torch.float32,
                       device=x.device)
    a = anchors.reshape(b * d)
    mn, mx = stats_rows_plain(rows, boxes, a, periodic)
    rng = kernels.ftz(mx - mn).reshape(b, d).amax(dim=1)
    recip = torch.from_numpy(np.atleast_1d(kernels.exact_recip(
        rng.cpu().numpy()))).to(x.device)
    words = encode_recip_rows_plain(rows, width, mn,
                                    recip.repeat_interleave(d), boxes, a,
                                    periodic)
    return words.reshape(b, d, -1), mn.reshape(b, d), mx.reshape(b, d)


def encode_recip_fused_blocks_cuda(x: torch.Tensor, box, anchors,
                                   width: int, periodic: bool):
    """Recip-mode encode of (B, D, n) blocks, 32 | n, with the range shared
    by a block's D rows derived inside the launch: returns (words
    (B, D, (n/32)*width), mn (B, D), mx (B, D)); ``box`` is a host scalar,
    ``anchors`` (B, D) each row's raw element 0.  Semantics of the JAX
    package's ``encode_recip_fused_blocks``, without its VMEM cap on D*n.
    A CUDA tensor launches K12 (counted in
    ``encode_recip_fused_blocks_cuda.launches``); a CPU tensor runs
    ``encode_recip_fused_blocks_plain``."""
    if x.device.type == "cpu":
        return encode_recip_fused_blocks_plain(x, box, anchors, width,
                                               periodic)
    if x.device.type != "cuda":
        raise ValueError(f"no recip encode for device {x.device}")
    _check_fused(x, anchors, width)
    x, anchors = x.contiguous(), anchors.contiguous()
    b, d, n = x.shape
    items = b * d * -(-n // STATS_SLICE)
    scratch = torch.empty(2 * items + b * d, dtype=torch.float32,
                          device=x.device)
    barrier = torch.zeros(1, dtype=torch.int32, device=x.device)
    words = torch.empty((b, d, n // 32 * width), dtype=torch.int32,
                        device=x.device)
    mn = torch.empty((b, d), dtype=torch.float32, device=x.device)
    mx = torch.empty((b, d), dtype=torch.float32, device=x.device)
    if b * d == 0:
        return words, mn, mx
    plan = pack_plan(width, b * d * n, x.data_ptr(),
                     cuda_lib.sm_count(x.device))
    cuda_lib.launch(
        "encode_recip_fused_blocks", cuda_lib.lib().mnw_encode_recip_fused,
        x.device, x.data_ptr(), b, d, n, STATS_SLICE, float(np.float32(box)),
        anchors.data_ptr(), width, int(periodic), plan["tile"],
        int(plan["vec16"]), plan["smem_bytes"], cuda_lib.row_magic(n),
        scratch.data_ptr(), barrier.data_ptr(), words.data_ptr(),
        mn.data_ptr(), mx.data_ptr())
    encode_recip_fused_blocks_cuda.launches += 1
    return words, mn, mx


encode_recip_fused_blocks_cuda.launches = 0
