"""Quantization engine: per-field-type quantize / dequantize, in torch.

Port of ``minnow_c_tpu/quant/engine.py`` (reference call structure:
position() quant.c:161-224, velocity() quant.c:226-289, id()
quant.c:291-327, ufloat() quant.c:329-371, uint() quant.c:373-398,
inverses quant.c:405-608).  Array passes run as torch ops on the device of
the field's tensor; the tiny per-plane stats (min/max) come to the host,
where bit depths are derived with C-exact f32 arithmetic.

This slice covers all five field types at uniform depth with the linear
map.  Per-particle accuracies (Deltas mode) and the log10/symlog maps
raise NotImplementedError; ROADMAP.md queue 1 lists them as the next step.

Integer fields (Ptid, Unsi) hold u64 values.  They stay on int64 tensors,
so values must lie below 2^63: ``as_tensor`` raises on larger input, and
decode raises on a stream whose values would not fit.  Bins are u32 bits
held in int32 tensors (see ``ops.kernels``).

Documented divergences from the reference are the JAX package's (see its
module docstring); this port reproduces its bits.
"""

from __future__ import annotations

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
_I63 = 1 << 63

NOT_PORTED_DELTAS = ("per-particle accuracies (Deltas mode) are not ported "
                     "to torch yet (ROADMAP.md queue 1)")
NOT_PORTED_MAPS = ("log10/symlog10 float maps are not ported to torch yet "
                   "(ROADMAP.md queue 1)")


# ---------------------------------------------------------------------------
# Inputs: numpy or torch -> tensors on one device
# ---------------------------------------------------------------------------

def as_tensor(data, dtype: torch.dtype, device="cpu") -> torch.Tensor:
    """A field's data as a tensor of ``dtype``: a tensor keeps its device,
    numpy input goes to ``device``.  ``dtype`` int64 takes u64 values,
    which must lie below 2^63."""
    if isinstance(data, torch.Tensor):
        t = data
    else:
        a = native_order(np.asarray(data))
        if dtype == torch.int64:
            if a.dtype.kind == "u":
                a = a.astype(np.uint64)
                if a.size and int(a.max()) >= _I63:
                    raise ValueError("u64 values >= 2^63 are not supported "
                                     "by the torch port (int64 tensors)")
                a = a.view(np.int64)
            a = a.astype(np.int64, copy=False)
        else:
            a = a.astype(np.float32, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    if dtype == torch.int64 and t.numel() and bool(t.min() < 0):
        raise ValueError("integer field values must be non-negative u64 "
                         "below 2^63")
    return t.to(dtype)


# ---------------------------------------------------------------------------
# depth <-> delta (quant.c:654-733), C-exact f32 arithmetic
# ---------------------------------------------------------------------------

def delta_to_depth(delta: float, x0: float, x1: float) -> int:
    """Minimal bit depth whose bin width beats ``delta`` over [x0, x1]:
    first depth with ``delta * 2^depth > x1 - x0`` in f32
    (deltaToDepth, quant.c:681-696)."""
    delta = np.float32(delta)
    rng = np.float32(x1) - np.float32(x0)
    for depth in range(MAX_DEPTH + 1):
        if delta * np.float32(1 << depth) > rng:
            return depth
    raise ValueError(
        f"accuracy {delta} over range [{x0}, {x1}] exceeds f32 granularity "
        f"(> {MAX_DEPTH} bits of mantissa)")


def depth_to_delta(depth: int, x0: float, x1: float) -> float:
    """Achieved accuracy reported back to the user (depthToDelta,
    quant.c:654-673)."""
    return float((np.float32(x1) - np.float32(x0)) /
                 np.float32(1 << int(depth)))


def map_float(x, log10_scaled: int, threshold: float):
    if log10_scaled == 0:
        return x
    if log10_scaled in (1, 2):
        raise NotImplementedError(NOT_PORTED_MAPS)
    raise ValueError(f"log10_scaled must be 0, 1, or 2; got {log10_scaled}")


def unmap_float(y, log10_scaled: int, threshold: float):
    return map_float(y, log10_scaled, threshold)


# ---------------------------------------------------------------------------
# Array passes
# ---------------------------------------------------------------------------

def undo_float_uniform(bins, x0, x1, depth: int, key):
    """x0 + dx*(q + U[0,1)) with dx = (x1-x0)/2^depth (undoFloat,
    quant.c:634-652), counter-based dither; rounding as
    ``kernels.undo_bins``."""
    dx = (np.float32(x1) - np.float32(x0)) / np.float32(1 << depth)
    u = _rng.uniform_dither(key, tuple(bins.shape), device=bins.device)
    return kernels.undo_bins(bins, x0, dx, u)


def id_decompose(ids, width: int):
    """Split Lagrangian IDs into 3D grid coordinates, unwrap each dim, and
    subtract the minimum -- fully lossless (id(), quant.c:291-327)."""
    w = int(width)
    dims = torch.stack([ids % w, (ids // w) % w, ids // (w * w)])
    dims = torch.stack([kernels.u64_undo_periodic(d, w) for d in dims])
    x0 = dims.min(dim=1).values
    x1 = dims.max(dim=1).values
    return dims - x0[:, None], x0, x1


def id_recompose(qdims, x0, width: int):
    """Inverse of id_decompose (undoID, quant.c:553-587): re-add the per-dim
    minimum, re-wrap into [0, width), and recombine."""
    w = int(width)
    if w ** 3 > _I63:
        raise ValueError(f"ID grid width {w} overflows int64 IDs")
    dims = qdims + x0[:, None]
    dims = torch.where(dims >= w, dims - w, dims)
    return dims[0] + w * dims[1] + w * w * dims[2]


# ---------------------------------------------------------------------------
# Orchestration: quantize / dequantize one field (quant_QField / quant_Field,
# quant.c:135-155)
# ---------------------------------------------------------------------------

def quantize(field: Field, seed: int = 0, scale_mode: str = "div",
             device="cpu") -> QField:
    """Quantize one field on the device of its tensor (numpy data goes to
    ``device``).  ``scale_mode``: 'div' (default) is the C-exact division
    bin map; 'recip' multiplies by the exactly-rounded reciprocal
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
    quant.c:161-289: per-dim x0, shared max_diff range, one depth).
    Returns (bins, depth, x0_h, x1_h)."""
    if deltas is not None:
        raise NotImplementedError(NOT_PORTED_DELTAS)
    x0_h = x0.cpu().numpy()
    x1_h = x1.cpu().numpy()
    max_diff = float(np.float32(np.max(x1_h - x0_h)))
    depth = delta_to_depth(delta, x0_h[0], x0_h[0] + max_diff)
    fn = _bin_fn(scale_mode)
    bins = torch.stack([fn(xm[d], depth, x0_h[d], max_diff)
                        for d in range(3)])
    return bins, depth, x0_h, x1_h


def _dims_dequantize(q, data, field_index, post):
    """Shared 3-dim dequantize loop: per-dim dithered undo + ``post``
    (periodic rewrap for positions, unmap for velocities).  Returns
    (stacked dims, max_diff, x0 array)."""
    if q.depths is not None:
        raise NotImplementedError(NOT_PORTED_DELTAS)
    x0 = np.asarray(q.x0, dtype=np.float32)
    x1 = np.asarray(q.x1, dtype=np.float32)
    max_diff = float(np.float32(np.max(x1 - x0)))
    bins = data.reshape(3, -1)
    dims = []
    for i in range(3):
        key = _rng.field_key(q.seed, field_index, i)
        xd = undo_float_uniform(bins[i], float(x0[i]),
                                float(x0[i]) + max_diff, q.depth, key)
        dims.append(post(xd))
    return torch.stack(dims), max_diff, x0


def _quantize_position(field: Field, seed: int, scale_mode: str,
                       device) -> QField:
    acc: PositionAccuracy = field.acc
    x = as_tensor(field.data, torch.float32, device).reshape(3, -1)
    xu = torch.stack([kernels.undo_periodic(x[d], float(acc.width))
                      for d in range(3)])
    bins, depth, x0_h, x1_h = _dims_quantize(
        xu, xu.min(dim=1).values, xu.max(dim=1).values, acc.delta,
        acc.deltas, scale_mode)
    _dbg(lambda: int(bins.max()) < (1 << depth),
         "position bin index exceeds 2^depth")
    quant = PositionQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        width=float(acc.width), depth=depth, depths=None, seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_position(qf: QField, field_index: int) -> Field:
    q: PositionQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index, lambda xd: kernels.periodic(xd, q.width))
    acc = PositionAccuracy(
        delta=depth_to_delta(q.depth, x0[0], x0[0] + max_diff),
        width=q.width)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_velocity(field: Field, seed: int, scale_mode: str,
                       device) -> QField:
    acc: VelocityAccuracy = field.acc
    # The reference treats ANY nonzero SymLog10Scaled as symlog10
    # (quant.c:248).
    sym = 2 if acc.sym_log10_scaled else 0
    x = as_tensor(field.data, torch.float32, device).reshape(3, -1)
    xm = map_float(x, sym, float(acc.sym_log10_threshold))
    bins, depth, x0_h, x1_h = _dims_quantize(
        xm, xm.min(dim=1).values, xm.max(dim=1).values, acc.delta,
        acc.deltas, scale_mode)
    quant = VelocityQuantization(
        x0=tuple(float(v) for v in x0_h), x1=tuple(float(v) for v in x1_h),
        depth=depth, depths=None, sym_log10_scaled=sym,
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_velocity(qf: QField, field_index: int) -> Field:
    q: VelocityQuantization = qf.quant
    data, max_diff, x0 = _dims_dequantize(
        q, qf.data, field_index,
        lambda yd: unmap_float(yd, q.sym_log10_scaled,
                               q.sym_log10_threshold))
    acc = VelocityAccuracy(
        delta=depth_to_delta(q.depth, x0[0], x0[0] + max_diff),
        sym_log10_scaled=q.sym_log10_scaled,
        sym_log10_threshold=q.sym_log10_threshold)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_id(field: Field, device) -> QField:
    acc: IDAccuracy = field.acc
    ids = as_tensor(field.data, torch.int64, device).reshape(-1)
    qdims, x0, x1 = id_decompose(ids, int(acc.width))
    quant = IDQuantization(width=int(acc.width),
                           x0=tuple(int(v) for v in x0.tolist()),
                           x1=tuple(int(v) for v in x1.tolist()))
    # Coordinates after min-subtraction fit far below 2^32.
    return QField(hd=field.hd, data=qdims.to(torch.int32), quant=quant)


def _dequantize_id(qf: QField) -> Field:
    q: IDQuantization = qf.quant
    qdims = kernels.u32_to_i64(qf.data).reshape(3, -1)
    x0 = torch.tensor(q.x0, dtype=torch.int64, device=qdims.device)
    ids = id_recompose(qdims, x0, q.width)
    return Field(hd=qf.hd, data=ids, acc=IDAccuracy(width=q.width))


def _quantize_ufloat(field: Field, seed: int, scale_mode: str,
                     device) -> QField:
    acc: FloatAccuracy = field.acc
    if acc.deltas is not None:
        raise NotImplementedError(NOT_PORTED_DELTAS)
    x = as_tensor(field.data, torch.float32, device).reshape(-1)
    xm = map_float(x, int(acc.log10_scaled), float(acc.sym_log10_threshold))
    x0_h = float(xm.min().item())
    x1_h = float(xm.max().item())
    depth = delta_to_depth(acc.delta, x0_h, x1_h)
    bins = _bin_fn(scale_mode)(
        xm, depth, x0_h, np.float32(x1_h) - np.float32(x0_h))
    quant = FloatQuantization(
        x0=x0_h, x1=x1_h, depth=depth, depths=None,
        log10_scaled=int(acc.log10_scaled),
        sym_log10_threshold=float(acc.sym_log10_threshold), seed=seed)
    return QField(hd=field.hd, data=bins, quant=quant)


def _dequantize_ufloat(qf: QField, field_index: int) -> Field:
    q: FloatQuantization = qf.quant
    if q.depths is not None:
        raise NotImplementedError(NOT_PORTED_DELTAS)
    bins = qf.data.reshape(-1)
    key = _rng.field_key(q.seed, field_index, 0)
    y = undo_float_uniform(bins, q.x0, q.x1, q.depth, key)
    data = unmap_float(y, q.log10_scaled, q.sym_log10_threshold)
    acc = FloatAccuracy(delta=depth_to_delta(q.depth, q.x0, q.x1),
                        log10_scaled=q.log10_scaled,
                        sym_log10_threshold=q.sym_log10_threshold)
    return Field(hd=qf.hd, data=data, acc=acc)


def _quantize_uint(field: Field, device) -> QField:
    ids = as_tensor(field.data, torch.int64, device).reshape(-1)
    x0_h = int(ids.min())
    x1_h = int(ids.max())
    rel = ids - x0_h
    quant = IntQuantization(x0=x0_h, x1=x1_h)
    if x1_h - x0_h <= 0xFFFFFFFF:
        return QField(hd=field.hd, data=kernels.i64_to_u32(rel), quant=quant)
    lo = kernels.i64_to_u32(rel & kernels.M32)
    hi = kernels.i64_to_u32(rel >> 32)
    return QField(hd=field.hd, data=lo, data_hi=hi, quant=quant)


def _dequantize_uint(qf: QField) -> Field:
    q: IntQuantization = qf.quant
    if q.x1 >= _I63:
        raise ValueError("u64 values >= 2^63 are not supported by the torch "
                         "port (int64 tensors)")
    v = kernels.u32_to_i64(qf.data)
    if qf.data_hi is not None:
        v = v | (kernels.u32_to_i64(qf.data_hi) << 32)
    return Field(hd=qf.hd, data=v + q.x0, acc=IntAccuracy())
