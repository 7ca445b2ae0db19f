"""The "fast uniform" compositions (SURVEY.md section 3.3) in torch:
encode = unwrap -> minmax -> bin -> pack, decode = unpack -> dithered
un-bin -> rewrap.

``fast_uniform_decode`` is the plain torch twin of the fused decode kernel
(``decode_cuda``) and runs as plain torch on every device.
``fast_uniform_encode`` in div mode is torch's IEEE division followed by
the pack kernel's wrapper in ``from_f32`` mode, the split the JAX package
makes on the TPU (``minnow_c_tpu/ops/fastpath.py:113-119``); recip mode
takes the stats in torch and then one pass of K5 (``encode_recip_cuda``)
over the raw plane, for widths 1-24 (wider planes take the plain map and
the pack).
"""

from __future__ import annotations

import torch

from . import bitpack, kernels
from . import rng as _rng
from .decode_cuda import decode_plain
from .encode_cuda import encode_recip_cuda, pack_cuda


def fast_uniform_decode(words, key, level: int, n: int, x0, dx,
                        periodic_width=None, ctr0: int = 0):
    """words -> dithered floats: unpack at ``level`` bits, undo bin
    indexing over [x0, x0+dx), optionally rewrap into the periodic box.

    ``key``: (k0, k1) dither key; ``ctr0``: global element offset of this
    plane's first element (for a plane that continues a longer stream)."""
    periodic = periodic_width is not None
    bin_width = kernels.bin_width(dx, level)
    k0, k1 = (int(k) for k in key)
    return decode_plain(words, k0, k1, x0, bin_width,
                        periodic_width if periodic else 0.0, n, level,
                        ctr0, periodic)


def undo_uniform(bins, key, level: int, x0, dx, periodic_width=None):
    """u32 bins -> dithered floats: the decode without its unpack, as the
    JAX package's delta decodes run it after their prefix sum
    (``_diff_plane_fused``, ``_coil11_undo_tail``).  The dither of ``key``
    from counter 0, ``x0 + dx/2^level*(bin + u)`` rounded as
    ``kernels.undo_bins``, the optional rewrap; any device."""
    u = _rng.uniform_dither(key, (bins.shape[0],), device=bins.device)
    x = kernels.undo_bins(bins, x0, kernels.bin_width(dx, level), u)
    return x if periodic_width is None else kernels.periodic(x,
                                                             periodic_width)


def fast_uniform_encode(x: torch.Tensor, level: int, periodic_width=None,
                        scale_mode: str = "div"):
    """floats -> (packed words, x0, range): optionally unwrap the periodic
    box, min/max, bin at ``level`` bits, pack.  Returns the words (int32
    tensor of u32 bits, on x's device) and the plane's (x0, range) as
    0-dim tensors.

    ``scale_mode``: 'div' (default) is the C-exact division bin map
    (util.c:173-196 semantics); 'recip' multiplies by the exactly-rounded
    reciprocal (kernels.uniform_bin_index_recip) -- same error class,
    wire-compatible."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    periodic = periodic_width is not None
    xu = kernels.ftz(x) if not periodic else \
        kernels.undo_periodic(x, periodic_width)
    x0, x1 = kernels.minmax(xu)
    rng_v = kernels.ftz(x1 - x0)
    if scale_mode == "recip":
        # The map runs on the RAW plane, unwrapped around its element 0
        # inside the map, as the JAX package's _recip_bins_xla does.
        args = (x0.item(), kernels.exact_recip(rng_v.item()),
                periodic_width if periodic else 0.0, x[0].item())
        if 1 <= level <= 24:
            words = encode_recip_cuda(x, level, *args, periodic)
        else:
            words = bitpack.uniform_pack(kernels.recip_scaled_bins(
                x, *args, level, periodic), level)
        return words, x0, rng_v
    scaled = kernels.exact_div(xu - x0, rng_v) * float(1 << level)
    return pack_cuda(scaled, level, from_f32=True), x0, rng_v
