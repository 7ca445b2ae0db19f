"""Quantization engine: per-field-type quantize / dequantize, in torch.

Port of ``minnow_c_tpu/quant/engine.py`` (reference call structure:
position() quant.c:161-224, velocity() quant.c:226-289, id()
quant.c:291-327, ufloat() quant.c:329-371, uint() quant.c:373-398,
inverses quant.c:405-608).  Array passes run as torch ops on the device of
the field's tensor; the tiny per-plane stats (min/max) come to the host,
where bit depths are derived with C-exact f32 arithmetic.

All five field types, at uniform depth or with per-particle accuracies
(Deltas mode: one bit depth per element), and the log10 / symlog10 float
maps.  The maps follow XLA's lowering of ``jnp.log10`` / ``jnp.exp2``
(``kernels.log10_f32`` / ``exp2_f32``); their bits follow torch's ``log``
and ``exp``, so log-mapped fields agree with the JAX package's within the
contract of ROADMAP.md queue 3, while every identity-mapped field,
Deltas mode included, is bit-identical.

Integer fields (Ptid, Unsi) hold u64 values over their whole range, as
int64 tensors that carry the u64 bits: an int64 tensor passed in is read
as u64 bits, a numpy uint64 array is viewed as int64, and decoded fields
are int64 tensors whose ``.numpy().view(np.uint64)`` equals the JAX
package's uint64 output.  Every order, shift and division on them is
unsigned (``kernels.u64_*``); add, subtract and multiply wrap mod 2^64.
Bins are u32 bits held in int32 tensors (see ``ops.kernels``).

Documented divergences from the reference are the JAX package's (see its
module docstring); this port reproduces its bits.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..ops import kernels
from ..ops import rng as _rng
from ..types import (
    Field,
    FieldCode,
    FloatAccuracy,
    FloatQuantization,
    IDAccuracy,
    IDQuantization,
    IntAccuracy,
    IntQuantization,
    PositionAccuracy,
    PositionQuantization,
    QField,
    VelocityAccuracy,
    VelocityQuantization,
)
from ..utils import native_order
from ..utils.debug import debug_assert as _dbg

MAX_DEPTH = 24  # f32 mantissa limit (quant.c:684-693)


# ---------------------------------------------------------------------------
# Inputs: numpy or torch -> tensors on one device
# ---------------------------------------------------------------------------

def as_tensor(data, dtype: torch.dtype, device) -> torch.Tensor:
    """A field's data as a tensor of ``dtype``: a tensor keeps its device,
    numpy input goes to ``device``.  ``dtype`` int64 takes u64 values:
    an int64 tensor is read as u64 bits, unsigned numpy arrays are viewed
    as int64 bits."""
    if isinstance(data, torch.Tensor):
        return data.to(dtype)
    a = native_order(np.asarray(data))
    if dtype == torch.int64 and a.dtype.kind == "u":
        a = a.astype(np.uint64, copy=False).view(np.int64)
    a = a.astype(np.int64 if dtype == torch.int64 else np.float32, copy=False)
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


# ---------------------------------------------------------------------------
# depth <-> delta (quant.c:654-733), C-exact f32 arithmetic
# ---------------------------------------------------------------------------

# The room rule of the snapshot writers.  A bin narrower than delta does
# not alone keep a decode within delta: the encoder and the decoder round
# in f32 on the way.  Count each rounding in u = ulp_below(M), M a bound on
# |x| of the field's values (the box for positions, which lie in [0, box);
# the largest |x0| or |x0 + range| for the other fields, after the map).  A
# result below M rounds by at most u/2, one below 2M by at most u (the
# periodic unwrap moves a position up to 1.5 box).  Positions, div map:
#
#   encoder   unwrap x + box (< 2M)                             1
#             t = x - x0 (<= range <= M)                        1/2
#             map t / range (q < 1, so 2^-25 * range)           1/2
#   decoder   stored x1 = x0 + range (< 2M)                     1
#   range     rebuilt range' = x1 - x0, the largest over dims   1/2
#             x0 + range' (< 2M), less x0                       1 + 1/2
#   value     x0 + w * (bin + r), r the dither, as one FMA      1
#             (< 2M); bin + r rounds within [bin, bin + 1]
#
# An original thus lies within 5u of its stored bin as the decoder sees
# it, and a decode within the bin width plus 6u of the original: k = 6.
# The worst cases beyond it need every rounding at its largest in one
# direction: the recip map's rounded reciprocal adds up to 1 (a decode 7,
# the stored bin 6), and a field without the unwrap, whose range reaches
# 2M, trades the unwrap's 1 for 3/2 more in t, the map and the rebuilt
# range (6.5).  k = 7 would deepen a 64-wide box at delta 1e-3 whose
# blocks span it (6.1u of room), which the reference keeps at depth 16.
ROOM_ULPS = 6


def ulp_below(magnitude: float) -> float:
    """The spacing of f32 values of magnitude below ``magnitude``:
    2^(e - 24) for ``|magnitude|`` in (2^(e-1), 2^e], 0 for 0."""
    m, e = math.frexp(abs(float(magnitude)))
    if m == 0:
        return 0.0
    return math.ldexp(1.0, e - 24 - (m == 0.5))


def delta_to_depth(delta: float, x0: float, x1: float,
                   magnitude: Optional[float] = None) -> int:
    """Minimal bit depth whose bin width beats ``delta`` over [x0, x1]:
    first depth with ``delta * 2^depth > x1 - x0`` in f32
    (deltaToDepth, quant.c:681-696).

    With ``magnitude``, a bound on |x| of the field's values, the room
    rule: the first depth whose bin width plus ``ROOM_ULPS`` ulps below
    that magnitude stays under ``delta`` (the derivation above), never
    shallower than the first rule.  A constant field keeps depth 0, which
    decodes exactly; ValueError when no depth up to ``MAX_DEPTH`` leaves
    the room."""
    delta = np.float32(delta)
    rng = np.float32(x1) - np.float32(x0)
    for depth in range(MAX_DEPTH + 1):
        if delta * np.float32(1 << depth) > rng:
            break
    else:
        raise ValueError(
            f"accuracy {delta} over range [{x0}, {x1}] exceeds f32 "
            f"granularity (> {MAX_DEPTH} bits of mantissa)")
    if magnitude is None or rng == 0:
        return depth
    room = ROOM_ULPS * ulp_below(magnitude)
    for d in range(depth, MAX_DEPTH + 1):
        if float(rng) / (1 << d) + room < float(delta):
            return d
    raise ValueError(
        f"accuracy {delta} over range [{x0}, {x1}] leaves no room for "
        f"{ROOM_ULPS} f32 ulps at magnitude {magnitude} within "
        f"{MAX_DEPTH} bits")


def deltas_to_depths(deltas, x0: float, x1: float) -> np.ndarray:
    """Per-element depths (deltaToDepth array branch, quant.c:698-732): the
    first depth with ``delta * 2^depth > x1 - x0`` in f32, as u8.  The
    condition is monotone in depth (a power-of-two scaling), so the depth
    is the count of failing levels, counted level by level with no
    (n, 25) matrix; an element that no level satisfies (NaN, negative, or
    beyond f32 granularity) raises ValueError."""
    if isinstance(deltas, torch.Tensor):
        deltas = deltas.cpu().numpy()
    deltas = np.asarray(deltas, dtype=np.float32)
    rng = np.float32(x1) - np.float32(x0)
    depths = np.zeros(deltas.shape, dtype=np.uint8)
    for depth in range(MAX_DEPTH + 1):
        # C-exact (float)(1 << depth) scales (quant.c:713)
        depths += ~(deltas * np.float32(1 << depth) > rng)
    if depths.size and int(depths.max()) > MAX_DEPTH:
        raise ValueError(
            f"per-element accuracy exceeds f32 granularity over "
            f"[{x0}, {x1}]")
    return depths


def depth_to_delta(depth: int, x0: float, x1: float) -> float:
    """Achieved accuracy reported back to the user (depthToDelta,
    quant.c:654-673)."""
    return float((np.float32(x1) - np.float32(x0)) /
                 np.float32(1 << int(depth)))


def depths_to_deltas(depths: np.ndarray, x0: float, x1: float) -> np.ndarray:
    d = np.asarray(depths).astype(np.int64)
    return ((np.float32(x1) - np.float32(x0)) /
            (np.int64(1) << d).astype(np.float32)).astype(np.float32)


def depths_tensor(depths: np.ndarray, device) -> torch.Tensor:
    """Host u8 depths as an int64 tensor on ``device`` (copied as u8)."""
    return torch.from_numpy(np.ascontiguousarray(depths, dtype=np.uint8)).to(
        device).to(torch.int64)


# ---------------------------------------------------------------------------
# Float maps (mapFloat / unmap, quant.c:735-757, and the symlog10 map)
# ---------------------------------------------------------------------------

def map_float(x, log10_scaled: int, threshold: float):
    """The field's float map: 0 the identity, 1 ``log10(x)``, 2 the symlog
    ``sign(x) * log10(1 + |x| * f32(1 / t))``.  The JAX package writes
    ``|x| / t``, but every encode of its runs the map under jit with ``t``
    a constant, and XLA compiles a division by a constant into a multiply
    by its f32 reciprocal: that multiply is what its files hold.  Every
    operation rounds to f32 and flushes subnormals, as XLA does on the
    CPU."""
    if log10_scaled == 0:
        return x
    if log10_scaled == 1:
        return kernels.log10_f32(x)
    if log10_scaled == 2:
        x = kernels.ftz(x)
        r = kernels.f32_scalar(kernels.exact_recip(np.float32(threshold)),
                               x.device)
        a = kernels.ftz(kernels.ftz(x.abs() * r) + 1.0)
        return kernels.ftz(kernels.sign_f32(x) * kernels.log10_f32(a))
    raise ValueError(f"log10_scaled must be 0, 1, or 2; got {log10_scaled}")


def unmap_float(y, log10_scaled: int, threshold: float):
    """Inverse float map (quant.c:735-757 analog): ``exp2(y * log2 10)``
    with the product rounded to f32 first, and for the symlog
    ``sign(y) * t * (exp2(|y| * log2 10) - 1)``.  Op by op, as the JAX
    package's eager decode runs it: never one fused rounding."""
    if log10_scaled == 0:
        return y
    y = kernels.ftz(y)
    c = kernels.f32_scalar(kernels.LOG2_10, y.device)
    if log10_scaled == 1:
        return kernels.exp2_f32(kernels.ftz(y * c))
    if log10_scaled == 2:
        t = kernels.f32_scalar(threshold, y.device)
        mag = kernels.exp2_f32(kernels.ftz(y.abs() * c))
        return kernels.ftz(kernels.ftz(kernels.sign_f32(y) * t) *
                           kernels.ftz(mag - 1.0))
    raise ValueError(f"log10_scaled must be 0, 1, or 2; got {log10_scaled}")


# ---------------------------------------------------------------------------
# Array passes
# ---------------------------------------------------------------------------

def undo_float_uniform(bins, x0, x1, depth: int, key):
    """x0 + dx*(q + U[0,1)) with dx = (x1-x0)/2^depth (undoFloat,
    quant.c:634-652), counter-based dither; rounding as
    ``kernels.undo_bins``."""
    dx = kernels.bin_width(kernels.ftz(x1) - kernels.ftz(x0), depth)
    u = _rng.uniform_dither(key, tuple(bins.shape), device=bins.device)
    return kernels.undo_bins(bins, x0, dx, u)


def undo_float_var(bins, x0, x1, depths: torch.Tensor, key):
    """Per-element-depth undo: ``x0 + dx*(q + U[0,1))`` with
    ``dx = (x1 - x0) / 2^depth`` (an exact power of two, never ``exp2``),
    the multiply and add rounded once together as XLA fuses them in the
    JAX package's jitted ``undo_float_var``."""
    dev = bins.device
    rng_v = kernels.ftz(kernels.f32_scalar(kernels.ftz(x1), dev) -
                        kernels.f32_scalar(kernels.ftz(x0), dev))
    dx = kernels.ftz(rng_v / kernels._exact_pow2_f32(depths))
    u = _rng.uniform_dither(key, tuple(bins.shape), device=dev)
    s = kernels.u32_to_i64(bins).to(torch.float32) + u
    return kernels.fma_f32(dx, s, kernels.f32_scalar(x0, dev))


def id_decompose(ids, width: int):
    """Split Lagrangian IDs into 3D grid coordinates, unwrap each dim, and
    subtract the minimum -- fully lossless (id(), quant.c:291-327).  ``ids``
    are u64 bits in int64; the grid split divides and the minimum orders
    them as u64.  As in the reference, z is ids // (w * w mod 2^64): past
    w = 2^32 the product wraps (to 0 at multiples of 2^32, where the
    quotient is all ones, as XLA divides by 0), and the reference's signed
    unwrap takes w below 2^63."""
    w = int(width)
    dims = torch.stack([kernels.u64_undo_periodic(d, w)
                        for d in id_split(ids, w)])
    x0, x1 = kernels.u64_minmax(dims, 1)
    return dims - x0[:, None], x0, x1


def id_split(ids, width: int):
    """The grid coordinates (x, y, z) of u64 IDs held in int64: ids % w,
    (ids // w) % w and ids // (w * w mod 2^64), as u64 bits (the split of
    ``id_decompose``)."""
    w = int(width)
    if not 1 <= w < 1 << 63:
        raise ValueError(f"ID grid width {w} not in [1, 2^63)")
    q1, qx = kernels.u64_divmod(ids, w)
    ww = (w * w) & kernels.M64
    if ww == w * w:                         # (ids // w) // w = ids // w^2
        qz, qy = kernels.u64_divmod(q1, w)
    else:
        qy = kernels.u64_divmod(q1, w)[1]
        qz = kernels.u64_divmod(ids, ww)[0] if ww else \
            torch.full_like(ids, -1)
    return qx, qy, qz


def id_recompose(qdims, x0, width: int):
    """Inverse of id_decompose (undoID, quant.c:553-587): re-add the per-dim
    minimum, re-wrap into [0, width), and recombine.  ``qdims`` holds the
    three dimensions' coordinates and ``x0`` their minima (broadcast over
    the last axis), u64 bits in int64, taken one dimension at a time to
    bound the temporaries; the sums and products wrap mod 2^64 as the
    reference's u64 do, so every width id_decompose takes gives the
    reference's bits, w^3 past 2^64 included."""
    width = int(width)
    w = kernels.u64_to_i64(width)
    ids = None
    for d in range(3):
        v = qdims[d] + x0[d].unsqueeze(-1)
        v.sub_(kernels.u64_ge(v, w) * w)
        if d:
            v.mul_(kernels.u64_to_i64(width ** d))
        ids = v if ids is None else ids.add_(v)
    return ids


# ---------------------------------------------------------------------------
# Orchestration: quantize / dequantize one field (quant_QField / quant_Field,
# quant.c:135-155)
# ---------------------------------------------------------------------------

def quantize(field: Field, seed: int = 0, scale_mode: str = "div",
             device="cuda") -> QField:
    """Quantize one field on the device of its tensor (numpy data goes to
    ``device``, ``cuda`` unless the caller asks for ``cpu``).
    ``scale_mode``: 'div' (default) is the C-exact division bin map;
    'recip' multiplies by the exactly-rounded reciprocal
    (kernels.uniform_bin_index_recip) -- wire-compatible, same error
    class."""
    if scale_mode not in ("div", "recip"):
        raise ValueError(f"unknown scale_mode {scale_mode!r}")
    code = field.hd.field_code
    if code == FieldCode.POSN:
        return _quantize_position(field, seed, scale_mode, device)
    if code == FieldCode.VELC:
        return _quantize_velocity(field, seed, scale_mode, device)
    if code == FieldCode.PTID:
        return _quantize_id(field, device)
    if code == FieldCode.UNSF:
        return _quantize_ufloat(field, seed, scale_mode, device)
    if code == FieldCode.UNSI:
        return _quantize_uint(field, device)
    raise ValueError(f"unrecognized field code {code:#x}")


def dequantize(qf: QField, field_index: int = 0) -> Field:
    code = qf.hd.field_code
    if code == FieldCode.POSN:
        return _dequantize_position(qf, field_index)
    if code == FieldCode.VELC:
        return _dequantize_velocity(qf, field_index)
    if code == FieldCode.PTID:
        return _dequantize_id(qf)
    if code == FieldCode.UNSF:
        return _dequantize_ufloat(qf, field_index)
    if code == FieldCode.UNSI:
        return _dequantize_uint(qf)
    raise ValueError(f"unrecognized field code {code:#x}")


def _bin_fn(scale_mode: str):
    return kernels.uniform_bin_index_recip if scale_mode == "recip" \
        else kernels.uniform_bin_index


def _dims_quantize(xm, x0, x1, delta, deltas, scale_mode: str = "div"):
    """Shared 3-dim float quantize core (position/velocity both follow
    quant.c:161-289: per-dim x0, shared max_diff range, one depth or
    per-element depths).  Returns (bins, depth, depths, x0_h, x1_h).
    Deltas mode always takes the division map, as in the JAX package."""
    x0_h = x0.cpu().numpy()
    x1_h = x1.cpu().numpy()
    max_diff = float(np.float32(np.max(x1_h - x0_h)))
    if deltas is None:
        depth = delta_to_depth(delta, x0_h[0], x0_h[0] + max_diff)
        fn = _bin_fn(scale_mode)
        bins = torch.stack([fn(xm[d], depth, x0_h[d], max_diff)
                            for d in range(3)])
        return bins, depth, None, x0_h, x1_h
    depths = deltas_to_depths(deltas, x0_h[0], x0_h[0] + max_diff)
    dt = depths_tensor(depths, xm.device)
    bins = torch.stack([kernels.bin_index(xm[d], dt, x0_h[d], max_diff)
                        for d in range(3)])
    return bins, 0, depths, x0_h, x1_h


def _dims_dequantize(q, data, field_index, post):
    """Shared 3-dim dequantize loop: per-dim dithered undo + ``post``
    (periodic rewrap for positions, unmap for velocities).  Returns
    (stacked dims, max_diff, x0 array)."""
    x0 = np.asarray(q.x0, dtype=np.float32)
    x1 = np.asarray(q.x1, dtype=np.float32)
    max_diff = float(np.float32(np.max(x1 - x0)))
    bins = data.reshape(3, -1)
    dt = None if q.depths is None else depths_tensor(q.depths, bins.device)
    dims = []
    for i in range(3):
        key = _rng.field_key(q.seed, field_index, i)
        if dt is None:
            xd = undo_float_uniform(bins[i], float(x0[i]),
                                    float(x0[i]) + max_diff, q.depth, key)
        else:
            xd = undo_float_var(bins[i], float(x0[i]),
                                float(x0[i]) + max_diff, dt, key)
        dims.append(post(xd))
    return torch.stack(dims), max_diff, x0


def _dims_accuracy(q, x0, max_diff) -> dict:
    """The decoded field's accuracy: the achieved bin width, or per
    element at Deltas depths."""
    if q.depths is None:
        return dict(delta=depth_to_delta(q.depth, x0[0], x0[0] + max_diff))
    return dict(delta=0.0, deltas=depths_to_deltas(q.depths, x0[0],
                                                   x0[0] + max_diff))


def _quantize_position(field: Field, seed: int, scale_mode: str,
                       device) -> QField:
    acc: PositionAccuracy = field.acc
    x = as_tensor(field.data, torch.float32, device).reshape(3, -1)
    xu = torch.stack([kernels.undo_periodic(x[d], float(acc.width))
                      for d in range(3)])
    bins, depth, depths, x0_h, x1_h = _dims_quantize(
        xu, *kernels.minmax(xu), acc.delta, acc.deltas, scale_mode)
    if depths is None:
        _dbg(lambda: int(bins.max()) < (1 << depth),
             "position bin index exceeds 2^depth")
    quant = PositionQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        width=float(acc.width), depth=depth, depths=depths, seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_position(qf: QField, field_index: int) -> Field:
    q: PositionQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index, lambda xd: kernels.periodic(xd, q.width))
    acc = PositionAccuracy(width=q.width, **_dims_accuracy(q, x0, max_diff))
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_velocity(field: Field, seed: int, scale_mode: str,
                       device) -> QField:
    acc: VelocityAccuracy = field.acc
    # The reference treats ANY nonzero SymLog10Scaled as symlog10
    # (quant.c:248); velocities are signed, so plain log10 (flag 1) would
    # NaN on them.
    sym = 2 if acc.sym_log10_scaled else 0
    x = as_tensor(field.data, torch.float32, device).reshape(3, -1)
    xm = map_float(x, sym, float(acc.sym_log10_threshold))
    bins, depth, depths, x0_h, x1_h = _dims_quantize(
        xm, *kernels.minmax(xm), acc.delta, acc.deltas, scale_mode)
    quant = VelocityQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        depth=depth, depths=depths, sym_log10_scaled=sym,
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_velocity(qf: QField, field_index: int) -> Field:
    q: VelocityQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index,
        lambda yd: unmap_float(yd, q.sym_log10_scaled,
                               q.sym_log10_threshold))
    acc = VelocityAccuracy(sym_log10_scaled=q.sym_log10_scaled,
                           sym_log10_threshold=q.sym_log10_threshold,
                           **_dims_accuracy(q, x0, max_diff))
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_id(field: Field, device) -> QField:
    acc: IDAccuracy = field.acc
    ids = as_tensor(field.data, torch.int64, device).reshape(-1)
    qdims, x0, x1 = id_decompose(ids, int(acc.width))
    x0_h, x1_h = ([kernels.i64_to_u64(v) for v in t.tolist()]
                  for t in (x0, x1))
    quant = IDQuantization(width=int(acc.width), x0=tuple(x0_h),
                           x1=tuple(x1_h))
    # Coordinates after min-subtraction fit far below 2^32; stored as u32
    # bins: int64 -> int32 keeps the low 32 bits, the reference's u32 cast.
    return QField(hd=field.hd, data=qdims.to(torch.int32), quant=quant)


def _dequantize_id(qf: QField) -> Field:
    q: IDQuantization = qf.quant
    qdims = kernels.u32_to_i64(qf.data).reshape(3, -1)
    x0 = torch.tensor([kernels.u64_to_i64(v) for v in q.x0],
                      dtype=torch.int64, device=qdims.device)
    ids = id_recompose(qdims, x0, q.width)
    return Field(hd=qf.hd, data=ids, acc=IDAccuracy(width=q.width))


def _quantize_ufloat(field: Field, seed: int, scale_mode: str,
                     device) -> QField:
    acc: FloatAccuracy = field.acc
    x = as_tensor(field.data, torch.float32, device).reshape(-1)
    xm = map_float(x, int(acc.log10_scaled), float(acc.sym_log10_threshold))
    x0_t, x1_t = kernels.minmax(xm)
    x0_h = float(x0_t.item())
    x1_h = float(x1_t.item())
    dx = np.float32(x1_h) - np.float32(x0_h)
    if acc.deltas is None:
        depth, depths = delta_to_depth(acc.delta, x0_h, x1_h), None
        bins = _bin_fn(scale_mode)(xm, depth, x0_h, dx)
    else:
        depth, depths = 0, deltas_to_depths(acc.deltas, x0_h, x1_h)
        bins = kernels.bin_index(xm, depths_tensor(depths, xm.device),
                                 x0_h, dx)
    quant = FloatQuantization(
        x0=x0_h, x1=x1_h, depth=depth, depths=depths,
        log10_scaled=int(acc.log10_scaled),
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_ufloat(qf: QField, field_index: int) -> Field:
    q: FloatQuantization = qf.quant
    bins = qf.data.reshape(-1)
    key = _rng.field_key(q.seed, field_index, 0)
    if q.depths is None:
        y = undo_float_uniform(bins, q.x0, q.x1, q.depth, key)
        acc = dict(delta=depth_to_delta(q.depth, q.x0, q.x1))
    else:
        y = undo_float_var(bins, q.x0, q.x1,
                           depths_tensor(q.depths, bins.device), key)
        acc = dict(delta=0.0, deltas=depths_to_deltas(q.depths, q.x0, q.x1))
    data = unmap_float(y, q.log10_scaled, q.sym_log10_threshold)
    acc = FloatAccuracy(log10_scaled=q.log10_scaled,
                        sym_log10_threshold=q.sym_log10_threshold, **acc)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_uint(field: Field, device) -> QField:
    ids = as_tensor(field.data, torch.int64, device).reshape(-1)
    x0, x1 = kernels.u64_minmax(ids, 0)
    x0_h, x1_h = kernels.i64_to_u64(x0), kernels.i64_to_u64(x1)
    rel = ids - x0
    quant = IntQuantization(x0=x0_h, x1=x1_h)
    if x1_h - x0_h <= 0xFFFFFFFF:
        return QField(hd=field.hd, data=kernels.i64_to_u32(rel), quant=quant)
    lo = kernels.i64_to_u32(rel & kernels.M32)
    hi = kernels.i64_to_u32(kernels.u64_shr(rel, 32))
    return QField(hd=field.hd, data=lo, data_hi=hi, quant=quant)


def _dequantize_uint(qf: QField) -> Field:
    q: IntQuantization = qf.quant
    v = kernels.u32_to_i64(qf.data)
    if qf.data_hi is not None:
        v = v | (kernels.u32_to_i64(qf.data_hi) << 32)
    return Field(hd=qf.hd, data=v + kernels.u64_to_i64(q.x0),
                 acc=IntAccuracy())
