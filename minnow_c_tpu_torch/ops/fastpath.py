"""The "fast uniform" compositions (SURVEY.md section 3.3) in torch:
encode = unwrap -> minmax -> bin -> pack, decode = unpack -> dithered
un-bin -> rewrap.

``fast_uniform_decode`` is the plain torch twin of the fused decode kernel
(``decode_cuda``) and runs as plain torch on every device.
``fast_uniform_encode`` in div mode is torch's IEEE division followed by
the pack kernel's wrapper in ``from_f32`` mode, the split the JAX package
makes on the TPU (``minnow_c_tpu/ops/fastpath.py:113-119``); recip mode is
plain torch plus the pack.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitpack, kernels
from .decode_cuda import decode_plain
from .encode_cuda import pack_cuda


def fast_uniform_decode(words, key, level: int, n: int, x0, dx,
                        periodic_width=None, ctr0: int = 0):
    """words -> dithered floats: unpack at ``level`` bits, undo bin
    indexing over [x0, x0+dx), optionally rewrap into the periodic box.

    ``key``: (k0, k1) dither key; ``ctr0``: global element offset of this
    plane's first element (for a plane that continues a longer stream)."""
    periodic = periodic_width is not None
    bin_width = np.float32(dx) / np.float32(1 << level)
    k0, k1 = (int(k) for k in key)
    return decode_plain(words, k0, k1, x0, bin_width,
                        periodic_width if periodic else 0.0, n, level,
                        ctr0, periodic)


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
    if periodic_width is not None:
        x = kernels.undo_periodic(x, periodic_width)
    x0 = x.min()
    rng_v = x.max() - x0
    if scale_mode == "recip":
        bins = kernels.uniform_bin_index_recip(x, level, x0.item(),
                                               rng_v.item())
        return bitpack.uniform_pack(bins, level), x0, rng_v
    scaled = kernels.exact_div(x - x0, rng_v) * float(1 << level)
    return pack_cuda(scaled, level, from_f32=True), x0, rng_v
