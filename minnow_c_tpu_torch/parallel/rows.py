"""The row steps of the batched codecs: the one place that picks the
kernel for a batch of rows.

The snapshot writer and reader (``snapshot``) and the block-sharded codecs
(``sharding``) run their fields as (R, n) rows, block-major.  Each step
takes the rows kernel when every row fills whole words (32 | n), else its
single-stream kernel a row, and the plain map where no kernel takes the
depth:

* ``stats`` / ``block_stats``: K6 ``stats_rows``, each row's min and max
  after the periodic unwrap around its element 0;
* ``bin_pack``: the div map (``kernels.uniform_bin_index``) then ``pack``,
  or the recip map and the pack in one K8 launch (K5 a row); at a depth
  outside 1-24 the plain map, then ``pack``;
* ``pack``: K7, or K4 a row;
* ``decode``: K2, or K1 a row;
* ``unpack``: K3, or the torch unpack a row.

``fused=False`` runs the plain torch versions of the rows kernels, and the
decode and unpack row by row (the sharded codecs' ``fused_rows=False``);
the bits are the same.  On a CPU tensor every kernel wrapper runs its
plain version.  ``host`` and ``card`` copy between host and card and count
the bytes as ``d2h`` / ``h2d`` in the open record (``utils/profiling``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import bitpack, kernels
from ..ops.decode_cuda import (decode_cuda, decode_plain, decode_rows_cuda,
                               rows_kernel_eligible, unpack_rows_cuda)
from ..ops.encode_cuda import (encode_recip_cuda, encode_recip_rows_cuda,
                               encode_recip_rows_plain, pack_cuda,
                               pack_rows_cuda, pack_rows_plain,
                               stats_rows_cuda, stats_rows_plain)
from ..utils.profiling import count


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def host(t: torch.Tensor) -> np.ndarray:
    """A tensor's host copy as numpy; its bytes count as ``d2h`` when it
    leaves the card."""
    count("d2h", _nbytes(t) if t.is_cuda else 0)
    return t.cpu().numpy()


def card(t: torch.Tensor, device) -> torch.Tensor:
    """A host tensor on ``device``; its bytes count as ``h2d`` when that
    is the card."""
    out = t.to(device)
    count("h2d", _nbytes(out) if out.is_cuda and not t.is_cuda else 0)
    return out


def _box(box) -> float:
    """The f32 box of the kernels, 0 when there is none."""
    return float(np.float32(0.0 if box is None else box))


def stats(x: torch.Tensor, box, fused: bool = True):
    """(min (R,), max (R,)) of (R, n) rows after the unwrap around each
    row's element 0 in a box of ``box`` (None: no unwrap): one K6
    launch."""
    boxes = torch.full((x.shape[0],), _box(box), dtype=torch.float32,
                       device=x.device)
    step = stats_rows_cuda if fused else stats_rows_plain
    return step(x, boxes, x[:, 0].contiguous(), box is not None)


def block_stats(x: torch.Tensor, box, fused: bool = True):
    """Rows (B*3, n) -> each row's x0 (B*3,) and each block's range shared
    by its three dims (B,)."""
    mn, mx = stats(x, box, fused)
    return mn, kernels.ftz(mx - mn).reshape(-1, 3).amax(dim=1)


def pack(bins: torch.Tensor, width: int, fused: bool = True) -> torch.Tensor:
    """(R, n) u32 bins -> (R, words) packed streams, each row padded on its
    own: one K7 launch when 32 | n, else K4 a row."""
    if bins.shape[1] % 32 == 0:
        return (pack_rows_cuda if fused else pack_rows_plain)(bins, width)
    return torch.stack([pack_cuda(r, width) for r in bins])


def bin_pack(x: torch.Tensor, x0: torch.Tensor, rng_b: torch.Tensor,
             depth: int, box, scale_mode: str,
             fused: bool = True) -> torch.Tensor:
    """Bin and pack (R, n) rows at ``depth``: row r with x0[r] and the
    range of its block, ``rng_b`` (B,) for blocks of R / B rows, unwrapped
    around its own element 0 when ``box`` is not None (RAW rows; the stats
    pass unwrapped them the same way, bit for bit).  (R, words).

    div: the unwrap, the C-exact map ``kernels.uniform_bin_index``, then
    ``pack``.  recip: each block's recip = rn(1 / range) on the host (IEEE
    division), then the unwrap, ``((x - x0) * recip) * 2^depth`` in three
    rounded ops and the pack, in one K8 launch (K5 a row when 32 does not
    divide n; ``kernels.recip_scaled_bins`` and ``pack`` at a depth outside
    1-24)."""
    d = x.shape[0] // rng_b.shape[0]
    periodic = box is not None
    if scale_mode == "recip":
        recip = np.repeat(np.atleast_1d(kernels.exact_recip(host(rng_b))), d)
        kernel_width = 1 <= depth <= 24
        if kernel_width and x.shape[1] % 32:
            x0_h, anchors = host(x0), host(x[:, 0])
            return torch.stack([
                encode_recip_cuda(x[r], depth, x0_h[r], recip[r], _box(box),
                                  anchors[r], periodic)
                for r in range(x.shape[0])])
        recip_t = card(torch.from_numpy(recip), x.device)
        if kernel_width:
            boxes = torch.full((x.shape[0],), _box(box), dtype=torch.float32,
                               device=x.device)
            step = encode_recip_rows_cuda if fused else \
                encode_recip_rows_plain
            return step(x, depth, x0, recip_t, boxes, x[:, 0].contiguous(),
                        periodic)
        bins = kernels.recip_scaled_bins(x, x0[:, None], recip_t[:, None],
                                         _box(box), x[:, :1], depth, periodic)
        return pack(bins, depth, fused)
    u = kernels.undo_periodic(x, box) if periodic else x
    bins = kernels.uniform_bin_index(u, depth, x0[:, None],
                                     rng_b.repeat_interleave(d)[:, None])
    del u
    return pack(bins, depth, fused)


def decode(words: torch.Tensor, keys, x0, dx, depth: int, n: int, box,
           fused: bool = True) -> torch.Tensor:
    """Dithered decode of (R, W) word rows to (R, n) floats: row r with
    dither key ``keys[r]`` (host (k0, k1) pairs, or one pair for every
    row), x0[r] and full range dx[r] ((R,), host arrays or tensors on the
    words' device), the dither counter from 0 in every row, rewrapped into
    the box when ``box`` is not None.  One K2 launch when 32 | n, else K1 a
    row; the plain decode a row at a depth outside 1-24 or when not
    ``fused``."""
    r = words.shape[0]
    periodic = box is not None
    boxf = box if periodic else 0.0
    keys = np.asarray(keys, dtype=np.int64).reshape(-1, 2)
    kernel = fused and 1 <= depth <= 24
    if kernel and rows_kernel_eligible(depth, n):
        return decode_rows_cuda(
            words, card(torch.from_numpy(keys), words.device).expand(r, 2),
            depth, n, x0, dx, box=boxf, periodic=periodic)
    x0, dx = (host(v) if isinstance(v, torch.Tensor) else v
              for v in (x0, dx))
    keys = np.broadcast_to(keys, (r, 2))
    if kernel:
        return torch.stack([
            decode_cuda(words[i], keys[i], depth, n, x0[i], dx[i], boxf,
                        periodic) for i in range(r)])
    out = torch.empty((r, n), dtype=torch.float32, device=words.device)
    for i in range(r):
        out[i] = decode_plain(words[i], int(keys[i, 0]), int(keys[i, 1]),
                              x0[i], kernels.bin_width(dx[i], depth), boxf,
                              n, depth, 0, periodic)
    return out


def unpack(words: torch.Tensor, width: int, n: int,
           fused: bool = True) -> torch.Tensor:
    """(R, W) word rows -> (R, n) u32 bins (int32): one K3 launch when
    32 | n, else the torch unpack a row."""
    if fused and rows_kernel_eligible(width, n):
        return unpack_rows_cuda(words, width, n)
    return torch.stack([bitpack.uniform_unpack(w, width, n) for w in words])
