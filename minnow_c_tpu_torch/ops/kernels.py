"""L1 compute kernels as torch ops: periodic wrap/unwrap, the uniform and
per-element-depth bin maps of the reference's ``src/util.c`` and the
log10 / exp2 of the float maps, as the JAX package's
``minnow_c_tpu/ops/kernels.py`` and ``quant/engine.py`` compute them:
bit-identical on every device, except log10 / exp2, whose bits follow
torch's ``log`` / ``exp`` (see ``log10_f32``).

Conventions shared by the port:

* A u32 array (bins, packed words) is an ``int32`` tensor holding the same
  32 bits.  torch has few uint32 ops and ``>>`` on int32 is arithmetic, so
  u32 arithmetic runs on ``int64`` values masked to 32 bits
  (``u32_to_i64`` / ``i64_to_u32`` convert between the two forms).
* A u64 array (Ptid / Unsi values) is an ``int64`` tensor holding the same
  64 bits: torch's uint64 dtype lacks the min, compare and division ops
  the codec needs.  Add, subtract and multiply wrap mod 2^64 in int64 as
  in u64; order, right shifts and division go through the ``u64_*``
  helpers.  A u64 host scalar is a Python int in [0, 2^64)
  (``u64_to_i64`` / ``i64_to_u64`` convert it to and from int64 bits).
* Float scalars enter tensor math as 0-dim float32 tensors on the data's
  device (``f32_scalar``).  A CPU scalar divisor on a CUDA tensor makes
  torch multiply by its reciprocal instead of dividing, which is not the
  IEEE quotient the wire's bin map is defined by.
* Subnormal f32 values flush to zero (``ftz``), as XLA on the CPU does in
  the JAX package: an f32 subnormal reads as a zero of the same sign, and
  a result that would be subnormal becomes a zero of the same sign.  Every
  float op here that the JAX package runs in XLA flushes its inputs and
  its result; the CUDA kernels build with ``-ftz=true`` to the same end.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
F32_TINY = float(np.finfo(np.float32).tiny)  # 2^-126, least normal f32


def f32_scalar(v, device) -> torch.Tensor:
    """``v`` rounded to f32, as a 0-dim float32 tensor on ``device``."""
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def ftz(x):
    """Flush f32 subnormals to a zero of the same sign: a float32 tensor
    stays a tensor on its device; anything else becomes numpy f32 (a
    scalar stays a scalar).  NaN and infinities pass unchanged."""
    if isinstance(x, torch.Tensor):
        return torch.where(x.abs() < F32_TINY, x * 0.0, x)
    a = np.asarray(x, dtype=np.float32)
    out = np.where(np.abs(a) < np.float32(F32_TINY),
                   np.copysign(np.float32(0), a), a).astype(np.float32)
    return out[()] if out.ndim == 0 else out


def _f32(v, device) -> torch.Tensor:
    """A flushed f32 operand: tensors pass, scalars become 0-dim tensors."""
    return ftz(v if isinstance(v, torch.Tensor) else f32_scalar(v, device))


def u32_to_i64(x: torch.Tensor) -> torch.Tensor:
    """u32 bits held in an int32 (or int64) tensor -> their value, int64
    (masked in place in the int64 copy, which halves the temporaries)."""
    if x.dtype == torch.int64:
        return x & M32
    return x.to(torch.int64).bitwise_and_(M32)


def i64_to_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 tensor holding the same bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


M64 = (1 << 64) - 1
_U64_FLIP = -(1 << 63)  # the sign bit: x ^ it maps u64 order to int64 order


def u64_to_i64(v: int) -> int:
    """A Python int taken mod 2^64, as the int64 value of the same bits."""
    v &= M64
    return v - (1 << 64) if v >> 63 else v


def i64_to_u64(v) -> int:
    """An int64 value (Python int or 0-dim tensor) as the u64 value of its
    bits, a Python int in [0, 2^64)."""
    return int(v) & M64


def u64_ge(x: torch.Tensor, y) -> torch.Tensor:
    """``x >= y`` on u64 bits held in int64 (``y`` a tensor or an int64
    scalar).  Against a scalar below 2^63 every x with its top bit set is
    larger, which spares the flipped copy of x."""
    if not isinstance(y, torch.Tensor) and y >= 0:
        return (x < 0) | (x >= y)
    return (x ^ _U64_FLIP) >= (y ^ _U64_FLIP)


def u64_minmax(x: torch.Tensor, dim: int):
    """(least, greatest) u64 value along ``dim`` of int64 bits.  Where no
    value has its top bit set the int64 order is the u64 order; otherwise
    the order goes through a copy with the sign bit flipped (waits for
    the device once, to choose)."""
    mn, mx = x.amin(dim=dim), x.amax(dim=dim)
    if bool((mn < 0).any()):
        f = x ^ _U64_FLIP
        mn, mx = f.amin(dim=dim) ^ _U64_FLIP, f.amax(dim=dim) ^ _U64_FLIP
    return mn, mx


def u64_shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of u64 bits held in int64 by 0 < k < 64 (``>>``
    on int64 is arithmetic: the sign-extended bits are masked off)."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def u64_divmod(x: torch.Tensor, d: int):
    """``(x // d, x % d)`` of u64 bits held in int64 by a divisor
    1 <= d < 2^64, as numpy's uint64 ``//`` and ``%`` give them.  Below
    2^63, halving first puts the dividend where int64 division is exact:
    q = 2 * ((x >> 1) // d) leaves a remainder below 2d, and one unsigned
    correction step finishes.  From 2^63 on the quotient is 0 or 1."""
    if not 1 <= d < 1 << 64:
        raise ValueError(f"u64 divisor {d} not in [1, 2^64)")
    if d >> 63:
        q = u64_ge(x, u64_to_i64(d)).to(torch.int64)
        return q, x - q * u64_to_i64(d)
    # in place where it can be: the snapshot writer divides 2^27 IDs
    q = u64_shr(x, 1).floor_divide_(d).bitwise_left_shift_(1)
    r = (q * d).neg_().add_(x)
    over = u64_ge(r, d)
    q.add_(over)
    r.sub_(over.to(torch.int64).mul_(d))
    return q, r


def minmax(x: torch.Tensor):
    """(min, max) of f32 ``x`` over its last dimension, as XLA's
    ``jnp.min`` / ``jnp.max`` give them (util_MinMax, util.c:27-46):
    subnormals count as zeros of their sign, NaN propagates, and -0.0
    counts below +0.0 (torch's amin / amax return either zero of a tie)."""
    x = ftz(x)
    mn = x.amin(dim=-1)
    mx = x.amax(dim=-1)
    zero = x == 0
    neg = torch.signbit(x)
    mn = torch.where(mn == 0, torch.where((zero & neg).any(dim=-1), -0.0,
                                          0.0), mn)
    mx = torch.where(mx == 0, torch.where((zero & ~neg).any(dim=-1), 0.0,
                                          -0.0), mx)
    nan = torch.isnan(x).any(dim=-1)
    return (torch.where(nan, float("nan"), mn),
            torch.where(nan, float("nan"), mx))


# ---------------------------------------------------------------------------
# Periodic boundary conditions (util.c:70-143)
# ---------------------------------------------------------------------------

def periodic(x, L):
    """Wrap values into [0, L).  Assumes points are within one box length of
    the range (util_Periodic, util.c:70-84).  The tests and the shifts see
    subnormals flushed; a value neither shift moves keeps its bits, as
    XLA's select hands its operand through."""
    L = _f32(L, x.device)
    xf = ftz(x)
    u = torch.where(xf >= L, ftz(xf - L), xf)
    u = torch.where(u < 0, ftz(u + L), u)
    return torch.where(u == xf, x, u)


def u64_periodic(x, L):
    """util_U64Periodic (util.c:86-95) on int64 values.  Signed as the
    reference's C: its inputs are grid coordinates below the ID width."""
    return torch.where(x >= L, x - L, x)


def undo_periodic(x, L):
    """Shift a periodically wrapped cluster into one contiguous range: values
    more than L/2 from x[0] are unwrapped across the boundary
    (util_UndoPeriodic, util.c:97-113).  A 2-D ``x`` is a stack of
    independent rows, each unwrapped around its own element 0.  As in
    ``periodic``, a value neither shift moves keeps its bits
    (``unwrap_anchored``, the kernels' plain form, flushes it)."""
    u = unwrap_anchored(x, L, x[..., :1])
    return torch.where(u == ftz(x), x, u)


def unwrap_anchored(x, box, anchor):
    """The periodic unwrap around ``anchor`` (the raw element 0 of each
    stream) in a box of ``box``: ``x - a >= half`` moves x down a box, then
    the already-moved ``x - a < -half`` moves it up; ``half = box * 0.5``
    (``undo_periodic`` and the JAX package's ``_recip_body``).  ``box`` and
    ``anchor`` are scalars or f32 tensors that broadcast against x."""
    box = _f32(box, x.device)
    a = _f32(anchor, x.device)
    half = ftz(box * 0.5)
    x = ftz(x)
    x = torch.where(ftz(x - a) >= half, ftz(x - box), x)
    return torch.where(ftz(x - a) < -half, ftz(x + box), x)


def u64_undo_periodic(x, L):
    """util_U64UndoPeriodic (util.c:115-143): signed unwrap around x[0],
    then shift everything up by L if any value went negative.  Works in
    int64 like the reference (which views the u64 data as int64), so it
    gives the reference's bits for any input; grid coordinates below the
    ID width never reach the sign bit.  Along the last axis: each row of
    an N-D ``x`` is unwrapped, and lifted, on its own."""
    L = int(L)
    x0 = x[..., :1]
    # Reference loop starts at i=1: element 0 is never unwrapped.
    idx = torch.arange(x.shape[-1], device=x.device) > 0
    shifted = torch.where(idx & (x - x0 >= L // 2), x - L, x)
    shifted = torch.where(idx & (x - x0 < -(L // 2)), x + L, shifted)
    if not x.shape[-1]:
        return shifted
    return torch.where(shifted.amin(dim=-1, keepdim=True) < 0,
                       shifted + L, shifted)


# ---------------------------------------------------------------------------
# Error-bounded quantization -- the only lossy steps (util.c:145-242)
# ---------------------------------------------------------------------------

def exact_div(x, d):
    """IEEE f32 division.  The JAX package corrects the TPU's approximate
    divide here; CPU and CUDA divide exactly once the divisor is a device
    tensor (see the module docstring)."""
    return ftz(ftz(x) / _f32(d, x.device))


def exact_recip(d):
    """rn(1 / d) in f32 on the host, for a per-plane scalar or a numpy
    array of per-block ranges.  A range of 0 (or a subnormal one) gives
    +inf, as XLA's division does."""
    with np.errstate(divide="ignore"):
        return ftz(np.float32(1.0) / ftz(d))


def bin_width(dx, level: int):
    """The decode's bin width ``f32(dx) / 2^level``, flushed as XLA
    computes it (``fastpath._fast_uniform_decode``); ``dx`` is a scalar
    (numpy f32 result) or an f32 tensor."""
    if isinstance(dx, torch.Tensor):
        return ftz(ftz(dx) / float(1 << level))
    return ftz(ftz(np.float32(dx)) / np.float32(1 << level))


def fma_f32(a, b, c) -> torch.Tensor:
    """``a*b + c`` of f32 tensors with ONE rounding to f32, as a fused
    multiply-add gives it, on any device.  The product of two f32 values is
    exact in f64; the f64 sum is turned into its round-to-odd value with
    the exact error of the addition (TwoSum); rounding to odd at 53 bits
    and then to nearest at 24 bits is correctly rounded (Boldo and
    Melquiond, 2008).  Subnormal inputs and a subnormal result flush to
    zero (``ftz``)."""
    a, b, c = ftz(a), ftz(b), ftz(c)
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    inexact_even = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(inexact_even, torch.nextafter(s, toward), s)
    return ftz(s.to(torch.float32))


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
    tests on ``delta``.  ``x0`` and ``dx`` are scalars, or f32 tensors on
    x's device that broadcast against it (one per row)."""
    delta = exact_div(ftz(x) - _f32(x0, x.device), _f32(dx, x.device))
    return scaled_to_bins(delta * float(1 << level), level).to(torch.int32)


def uniform_bin_index_recip(x, level: int, x0, dx):
    """The 'recip' scale-mode bin map: multiply by the exactly-rounded
    reciprocal instead of dividing (kernels.uniform_bin_index_recip of the
    JAX package)::

        recip  = rn(1 / dx)            (host scalar, exact IEEE division)
        bins   = trunc(clamp(rn(rn(x - x0) * recip) * 2^level))
    """
    return recip_scaled_bins(x, x0, exact_recip(dx), 0.0, 0.0, level, False)


def recip_scaled_bins(x, x0, recip, box, anchor, level: int,
                      periodic: bool) -> torch.Tensor:
    """The recip map on RAW values, op for op the JAX package's
    ``encode_pallas._recip_bins_xla`` (and the kernels K5 / K8): the
    anchored periodic unwrap when ``periodic``, then
    ``((x - x0) * recip) * 2^level`` in three separately rounded ops, then
    ``scaled_to_bins``.  The scalars are Python / numpy values or f32
    tensors that broadcast against x (one per row).  Returns u32 bits in
    int32."""
    dev = x.device
    x = unwrap_anchored(x, box, anchor) if periodic else ftz(x)
    q = ftz(ftz(x - _f32(x0, dev)) * _f32(recip, dev))
    return scaled_to_bins(q * float(1 << level), level).to(torch.int32)


def _exact_pow2_f32(level: torch.Tensor) -> torch.Tensor:
    """2^level as exact f32 for an integer tensor of per-element depths
    (level <= 24): an integer shift converted to f32, never ``exp2``, which
    is approximate even at integer inputs on XLA's CPU backend and would
    shift bins against the C-exact ``(float)(1 << level)``
    (util.c:160-166)."""
    return (torch.ones_like(level, dtype=torch.int64)
            << level.to(torch.int64)).to(torch.float32)


def bin_index(x, level: torch.Tensor, x0, dx) -> torch.Tensor:
    """Per-element-depth bin indices (util_BinIndex, util.c:145-170) as u32
    bits in int32: ``level`` is an integer tensor of depths on x's device.
    ``delta = (x - x0) / dx`` (IEEE); below 0 bins to 0, from 1 on to
    2^level - 1, NaN (a constant plane) to 0 through an explicit mask --
    torch's cast of NaN is undefined -- and the rest truncate
    ``delta * 2^level``, an exact power-of-two scaling."""
    dev = x.device
    delta = exact_div(ftz(x) - _f32(x0, dev), _f32(dx, dev))
    inside = (delta >= 0) & (delta < 1)  # False for NaN
    si = torch.where(inside, delta * _exact_pow2_f32(level), 0.0).to(
        torch.int64)
    top = (torch.ones_like(si) << level.to(torch.int64)) - 1
    return i64_to_u32(torch.where(delta >= 1, top, si))


def _undo_bin_index(idx, nbins, x0, dx, key) -> torch.Tensor:
    """``x0 + w*idx + u*w`` with ``w = dx / nbins``, each operation rounded
    on its own as the JAX package's op-by-op ``undo_bin_index`` /
    ``undo_uniform_bin_index`` round them."""
    from . import rng as _rng
    dev = idx.device
    w = ftz(_f32(dx, dev) / nbins)
    offset = ftz(_f32(x0, dev) + ftz(w * u32_to_i64(idx).to(torch.float32)))
    u = _rng.uniform_dither(key, tuple(idx.shape), device=dev)
    return ftz(offset + ftz(u * w))


def undo_uniform_bin_index(idx, level: int, x0, dx, key) -> torch.Tensor:
    """Floats from bin indices at one depth, dithered uniformly within each
    bin (util_UndoUniformBinIndex, util.c:223-242).  ``key`` is the
    (k0, k1) dither key; the reference's sequential xoroshiro state becomes
    the stateless counter-based dither of ``ops.rng``."""
    return _undo_bin_index(idx, f32_scalar(float(1 << int(level)),
                                           idx.device), x0, dx, key)


def undo_bin_index(idx, level: torch.Tensor, x0, dx, key) -> torch.Tensor:
    """Per-element-depth inverse (util_UndoBinIndex, util.c:198-221)."""
    return _undo_bin_index(idx, _exact_pow2_f32(level), x0, dx, key)


# ---------------------------------------------------------------------------
# Byte-plane transpose and u8 delta coding (util.c:244-309; Cart v1.0)
# ---------------------------------------------------------------------------

def u32_transpose_bytes(x: torch.Tensor) -> torch.Tensor:
    """Split u32 words (int32 bits) into 4 byte planes: output byte
    ``i + n*j`` is byte j of word i (util_U32TransposeBytes,
    util.c:244-259).  Returns uint8 of length 4n.  Each byte is masked
    after its shift: ``>>`` on int32 is arithmetic."""
    return torch.cat([((x >> (8 * j)) & 0xFF).to(torch.uint8)
                      for j in range(4)])


def u32_undo_transpose_bytes(x: torch.Tensor) -> torch.Tensor:
    """Inverse of ``u32_transpose_bytes`` (util_U32UndoTransposeBytes,
    util.c:261-281): ``x`` is uint8 of a length divisible by 4; returns
    the words as int32 bits, assembled in int64."""
    planes = x.reshape(4, x.shape[0] // 4).to(torch.int64)
    out = planes[0]
    for j in range(1, 4):
        out = out | (planes[j] << (8 * j))
    return i64_to_u32(out)


def u8_delta_encode(x: torch.Tensor) -> torch.Tensor:
    """y[0] = x[0]; y[i] = x[i] - x[i-1] on uint8, which wraps mod 256
    (util_U8DeltaEncode, util.c:283-295)."""
    if x.shape[0] == 0:
        return x
    return x - torch.cat([x.new_zeros(1), x[:-1]])


def u8_undo_delta_encode(x: torch.Tensor) -> torch.Tensor:
    """Prefix-sum inverse of ``u8_delta_encode`` (util_U8UndoDeltaEncode,
    util.c:297-309): the int64 cumsum masked to 8 bits, which wraps mod
    256 as the C loop does."""
    if x.shape[0] == 0:
        return x
    return (torch.cumsum(x.to(torch.int64), 0) & 0xFF).to(torch.uint8)


# ---------------------------------------------------------------------------
# log10 and exp2, as XLA lowers them (the log10 / symlog10 float maps)
# ---------------------------------------------------------------------------

LOG10_E = np.float32(0.434294492)  # f32(1 / ln 10)
LN_2 = np.float32(0.693147182)     # f32(ln 2)
LOG2_10 = np.float32(np.log2(10.0))


def log10_f32(x: torch.Tensor) -> torch.Tensor:
    """``log(x) * f32(1 / ln 10)``, two roundings: XLA's lowering of
    ``jnp.log10``.  Its bits differ from the JAX package's only where
    torch's ``log`` differs from XLA's (see ROADMAP.md queue 3)."""
    c = f32_scalar(LOG10_E, x.device)
    return ftz(ftz(torch.log(ftz(x))) * c)


def sign_f32(x: torch.Tensor) -> torch.Tensor:
    """``jnp.sign`` of flushed f32: -1 or +1, a zero of x's sign for a zero
    or a subnormal, NaN for NaN (``torch.sign`` gives +0 for both)."""
    x = ftz(x)
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0, x))


def exp2_f32(y: torch.Tensor) -> torch.Tensor:
    """``exp(f32(ln 2) * y)``, the product rounded before the exp: XLA's
    lowering of ``jnp.exp2``."""
    c = f32_scalar(LN_2, y.device)
    return ftz(torch.exp(ftz(c * ftz(y))))


# ---------------------------------------------------------------------------
# Delta + zigzag coding of bin indices (the delta codecs' building block)
# ---------------------------------------------------------------------------

def u32_delta_zigzag(bins: torch.Tensor) -> torch.Tensor:
    """Difference each element against its predecessor (element 0 keeps its
    value), then zigzag-map the signed deltas to unsigned,
    ``z = (d << 1) ^ (d >> 31)`` in int32 wrap arithmetic, as the JAX
    package's ``kernels.u32_delta_zigzag``.  Runs on int64 masked to 32
    bits: d is the u32 difference, ``d << 1`` drops its top bit and
    ``d >> 31`` (arithmetic) is all ones exactly when that bit is set."""
    s = u32_to_i64(bins)
    d = (s - torch.cat([s.new_zeros(1), s[:-1]])) & M32
    return i64_to_u32(((d << 1) & M32) ^ ((d >> 31) * M32))


def u32_unzigzag(z: torch.Tensor) -> torch.Tensor:
    """Inverse zigzag map, z -> signed delta mod 2^32 (u32 bits in int32),
    with a LOGICAL right shift: ``(z >> 1) ^ -(z & 1)`` on the u32 value.
    The int32 spelling sign-extends for z >= 2^31 and decodes every
    |delta| >= 2^30 off by 2^31."""
    v = u32_to_i64(z)
    return i64_to_u32((v >> 1) ^ ((v & 1) * M32))


def u32_undo_delta_zigzag(z: torch.Tensor) -> torch.Tensor:
    """Inverse of ``u32_delta_zigzag``: unzigzag, then the u32 prefix sum
    (K9 on a CUDA tensor, its plain version on the CPU)."""
    from .scan_cuda import cumsum_u32_auto
    return cumsum_u32_auto(u32_unzigzag(z))
