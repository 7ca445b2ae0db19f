"""L1 compute kernels as torch ops: periodic wrap/unwrap and the uniform bin
maps of the reference's ``src/util.c``, bit-identical to the JAX package's
``minnow_c_tpu/ops/kernels.py`` on every device.

Conventions shared by the port:

* A u32 array (bins, packed words) is an ``int32`` tensor holding the same
  32 bits.  torch has few uint32 ops and ``>>`` on int32 is arithmetic, so
  u32 arithmetic runs on ``int64`` values masked to 32 bits
  (``u32_to_i64`` / ``i64_to_u32`` convert between the two forms).
* Float scalars enter tensor math as 0-dim float32 tensors on the data's
  device (``f32_scalar``).  A CPU scalar divisor on a CUDA tensor makes
  torch multiply by its reciprocal instead of dividing, which is not the
  IEEE quotient the wire's bin map is defined by.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def f32_scalar(v, device) -> torch.Tensor:
    """``v`` rounded to f32, as a 0-dim float32 tensor on ``device``."""
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in an int32 (or int64) tensor -> their value, int64."""
    return x.to(torch.int64) & M32


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


# ---------------------------------------------------------------------------
# Periodic boundary conditions (util.c:70-143)
# ---------------------------------------------------------------------------

def periodic(x, L):
    """Wrap values into [0, L).  Assumes points are within one box length of
    the range (util_Periodic, util.c:70-84)."""
    L = f32_scalar(L, x.device)
    x = torch.where(x >= L, x - L, x)
    return torch.where(x < 0, x + L, x)


def u64_periodic(x, L):
    """util_U64Periodic (util.c:86-95) on int64 values."""
    return torch.where(x >= L, x - L, x)


def undo_periodic(x, L):
    """Shift a periodically wrapped cluster into one contiguous range: values
    more than L/2 from x[0] are unwrapped across the boundary
    (util_UndoPeriodic, util.c:97-113)."""
    L = f32_scalar(L, x.device)
    half = L / 2
    x0 = x[0]
    x = torch.where(x - x0 >= half, x - L, x)
    return torch.where(x - x0 < -half, x + L, x)


def u64_undo_periodic(x, L):
    """util_U64UndoPeriodic (util.c:115-143): signed unwrap around x[0],
    then shift everything up by L if any value went negative.  Works in
    int64 like the reference (which views the u64 data as int64)."""
    L = int(L)
    x0 = x[0]
    # Reference loop starts at i=1: element 0 is never unwrapped.
    idx = torch.arange(x.shape[0], device=x.device) > 0
    shifted = torch.where(idx & (x - x0 >= L // 2), x - L, x)
    shifted = torch.where(idx & (x - x0 < -(L // 2)), x + L, shifted)
    if x.shape[0] and bool(shifted.min() < 0):
        shifted = shifted + L
    return shifted


# ---------------------------------------------------------------------------
# Error-bounded quantization -- the only lossy steps (util.c:145-242)
# ---------------------------------------------------------------------------

def exact_div(x, d):
    """IEEE f32 division.  The JAX package corrects the TPU's approximate
    divide here; CPU and CUDA divide exactly once the divisor is a device
    tensor (see the module docstring)."""
    if not isinstance(d, torch.Tensor):
        d = f32_scalar(d, x.device)
    return x / d


def exact_recip(d) -> np.float32:
    """rn(1 / d) in f32, on the host (a per-plane scalar)."""
    with np.errstate(divide="ignore"):
        return np.float32(1.0) / np.float32(d)


def fma_f32(a, b, c) -> torch.Tensor:
    """``a*b + c`` of f32 tensors with ONE rounding to f32, as a fused
    multiply-add gives it, on any device.  The product of two f32 values is
    exact in f64; the f64 sum is turned into its round-to-odd value with
    the exact error of the addition (TwoSum); rounding to odd at 53 bits
    and then to nearest at 24 bits is correctly rounded (Boldo and
    Melquiond, 2008)."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


def undo_bins(bins, x0, bin_width, u) -> torch.Tensor:
    """Dithered bin undo ``x0 + bin_width*(bin + u)`` of the frozen decode
    wire: ``bin + u`` rounds to f32, then multiply and add round once
    together (the JAX package's XLA code fuses them into a multiply-add, and
    the frozen decode digests carry those bits).  ``bins`` are u32 bits in
    int32, ``u`` the f32 dither."""
    dev = bins.device
    s = u32_to_i64(bins).to(torch.float32) + u
    return fma_f32(f32_scalar(bin_width, dev), s, f32_scalar(x0, dev))


def scaled_to_bins(scaled, level: int) -> torch.Tensor:
    """C cast semantics on a pre-scaled plane ``delta * 2^level``: trunc
    toward zero, clamp below 0 to 0 and at 2^level or above to
    2^level - 1, NaN to 0.  NaN and out-of-range values are masked before
    the cast: NaN -> int is undefined in torch.  Returns int64."""
    nb = float(1 << level)
    inside = (scaled >= 0) & (scaled < nb)  # False for NaN
    si = torch.where(inside, scaled, 0.0).to(torch.int64)
    return torch.where(scaled >= nb, (1 << level) - 1, si)


def uniform_bin_index(x, level: int, x0, dx):
    """Bin indices of x within [x0, x0 + dx) using 2^level bins
    (util_UniformBinIndex, util.c:173-196), as u32 bits in int32.

    Out-of-range values clamp to the first / last bin; a constant plane
    (dx == 0, delta = NaN) bins to 0.  ``delta * 2^level`` is an exact
    power-of-two scaling, so the clamp tests on it equal the reference's
    tests on ``delta``."""
    delta = exact_div(x - f32_scalar(x0, x.device), f32_scalar(dx, x.device))
    return scaled_to_bins(delta * float(1 << level), level).to(torch.int32)


def uniform_bin_index_recip(x, level: int, x0, dx):
    """The 'recip' scale-mode bin map: multiply by the exactly-rounded
    reciprocal instead of dividing (kernels.uniform_bin_index_recip of the
    JAX package)::

        recip  = rn(1 / dx)            (host scalar, exact IEEE division)
        bins   = trunc(clamp(rn(rn(x - x0) * recip) * 2^level))
    """
    dev = x.device
    recip = f32_scalar(exact_recip(dx), dev)
    scaled = ((x - f32_scalar(x0, dev)) * recip) * float(1 << level)
    return scaled_to_bins(scaled, level).to(torch.int32)
