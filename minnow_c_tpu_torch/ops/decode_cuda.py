"""K1: the fused uniform decode kernel (``csrc/decode.cu``) and its plain
torch version.

Port of ``minnow_c_tpu/ops/decode_pallas.py:decode_pallas``: one pass that
unpacks a plane at ``width`` bits, draws the Threefry-2x32-13 dither of
``ops/rng.py``, undoes the bin index as ``x0 + dx_bin*(bin + u)`` (the
multiply and add rounded once together, as the frozen decode wire has
them), and optionally rewraps into the periodic box.
``decode_cuda`` launches the CUDA kernel for a CUDA tensor and runs
``decode_plain`` only for a CPU tensor; there is no fallback from one to
the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bitpack, cuda_lib, kernels
from . import rng as _rng


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


def decode_cuda(words: torch.Tensor, key, width: int, n: int, x0, dx,
                box=0.0, periodic: bool = False,
                elem0: int = 0) -> torch.Tensor:
    """Fused decode of ``n`` elements packed at ``width`` bits in u32 words
    (int32 tensor); ``key`` is the (k0, k1) dither key, ``dx`` the plane's
    full range, ``elem0`` the global index of its first element (a
    multiple of 4).  Semantics of the JAX package's ``decode_pallas``.  A
    CUDA tensor launches the kernel (counted in ``decode_cuda.launches``);
    a CPU tensor runs ``decode_plain``."""
    if not 1 <= width <= 24:
        raise ValueError(f"float decode width {width} not in [1, 24]: "
                         "float depths cap at the f32 mantissa")
    if n < 1 or elem0 % 4:
        raise ValueError(f"need n >= 1 and elem0 % 4 == 0 (n={n}, "
                         f"elem0={elem0})")
    if words.dtype != torch.int32 or words.dim() != 1:
        raise TypeError("words must be a 1-D int32 tensor of u32 bits")
    n_words = bitpack.packed_words(n, width)
    if words.numel() < n_words:
        raise ValueError(f"{words.numel()} words cannot hold {n} elements "
                         f"of {width} bits")
    k0, k1 = (int(k) & kernels.M32 for k in key)
    x0 = np.float32(x0)
    dx_bin = np.float32(dx) / np.float32(2.0 ** width)
    box = np.float32(box)
    if words.device.type == "cpu":
        return decode_plain(words, k0, k1, x0, dx_bin, box, n, width,
                            elem0, periodic)
    if words.device.type != "cuda":
        raise ValueError(f"no decode for device {words.device}")
    words = words[:n_words].contiguous()
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    lib = cuda_lib.lib()
    with torch.cuda.device(words.device):
        rc = lib.mnw_decode_uniform(
            words.data_ptr(), n_words, k0, k1, float(x0), float(dx_bin),
            float(box), n, width, elem0 // 4, int(periodic),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    cuda_lib.check(rc, "decode")
    decode_cuda.launches += 1
    return out


decode_cuda.launches = 0
