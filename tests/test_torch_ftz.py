"""Subnormal f32 values: the port flushes them as the JAX package does.

XLA on the CPU (and the Pallas interpret mode, which runs on XLA) reads an
f32 subnormal as a zero of the same sign and turns a result that would be
subnormal into a zero of the same sign.  The port adopts that rule in its
torch ops (``kernels.ftz``) and in its CUDA kernels (built with
``-ftz=true``), so the same data gives the same bytes and bits in both
packages.  Inputs are made with numpy and handed to both.  Tolerance:
bitwise equality throughout.
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.ops import encode_pallas
from minnow_c_tpu.ops import fastpath as jfast
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.ops import encode_cuda, fastpath, kernels

SUB = np.float32(1e-40)
MODES = ["div", "recip"]


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def test_ftz_flushes_subnormals_keeping_the_sign():
    x = np.array([1e-40, -1e-40, 5e-45, 0.0, -0.0, 1.2e-38, -3.0, np.inf,
                  np.nan], np.float32)
    got = kernels.ftz(torch.from_numpy(x)).numpy()
    want = np.array([0.0, -0.0, 0.0, 0.0, -0.0, 1.2e-38, -3.0, np.inf,
                     np.nan], np.float32)
    assert _bits(got) == _bits(want)
    assert _bits(np.float32(kernels.ftz(np.float32(-1e-40)))) == \
        _bits(np.float32(-0.0))
    assert _bits(np.asarray(jnp.asarray(x) * 1)) == _bits(want)


# values around zero, at the box edge and past it; three orders put a
# subnormal, a value at the edge and a plain value in element 0 (the
# anchor of ``undo_periodic``)
_WRAP = np.array([1e-40, -1e-40, 1e-38, -1e-38, 0.0, -0.0, 64.0, 64.5,
                  -0.5, -64.0, 63.99, 32.0, -1e-45, 127.5, 0.0, 96.0],
                 np.float32)


@pytest.mark.parametrize("order", ["as_is", "reversed", "rolled"])
@pytest.mark.parametrize("op", ["periodic", "undo_periodic"])
def test_wrap_ops_pass_unmoved_subnormals_like_xla(op, order):
    """``kernels.periodic`` / ``undo_periodic`` against ``jax.jit`` of the
    JAX package's ops, bitwise: a value neither shift moves keeps its
    bits (XLA's select hands its operand through: 1e-40 stays 1e-40),
    while the tests and the shifts see subnormals as zeros."""
    x = {"as_is": _WRAP, "reversed": _WRAP[::-1].copy(),
         "rolled": np.roll(_WRAP, 7)}[order]
    want = np.asarray(jax.jit(getattr(jkernels, op), static_argnums=1)(
        jnp.asarray(x), 64.0))
    got = getattr(kernels, op)(torch.from_numpy(x), 64.0)
    assert _bits(got) == _bits(want)
    kept = np.abs(x) < np.float32(1.17e-38)
    if op == "periodic":
        assert _bits(want[kept & (x != 0)]) == _bits(x[kept & (x != 0)])


@pytest.mark.parametrize("mode", MODES)
def test_bin_maps_flush_like_xla(mode):
    """x = [0, 5e-41, 1e-40, 3], x0 = 0, range 1e-40, level 8: XLA reads
    the subnormals and the range as zeros."""
    x = np.array([0.0, 5e-41, 1e-40, 3.0, -1e-40], np.float32)
    jfn, tfn = ((jkernels.uniform_bin_index, kernels.uniform_bin_index)
                if mode == "div" else
                (jkernels.uniform_bin_index_recip,
                 kernels.uniform_bin_index_recip))
    want = np.asarray(jfn(jnp.asarray(x), 8, np.float32(0), SUB))
    got = tfn(torch.from_numpy(x), 8, np.float32(0), SUB)
    assert _bits(got) == _bits(want)
    assert want.tolist() == [0, 0, 0, 255, 0]


@pytest.mark.parametrize("periodic", [False, True])
def test_stats_flush_like_xla(periodic):
    x = np.array([[1e-40, 2.0, 1.0, 3.0], [-1e-40, -2.0, -0.5, -1e-40],
                  [1e-40, -1e-40, 5e-41, 1e-40], [63.9, 1e-40, 0.5, 32.0]],
                 np.float32)
    x = np.repeat(x, 8, axis=1)
    box = np.full(4, 64.0, np.float32)
    mn, mx = encode_pallas.stats_pallas_rows(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(x[:, 0]), periodic,
        interpret=True)
    got = encode_cuda.stats_rows_plain(torch.from_numpy(x),
                                       torch.from_numpy(box),
                                       torch.from_numpy(x[:, 0].copy()),
                                       periodic)
    assert _bits(got[0]) == _bits(mn)
    assert _bits(got[1]) == _bits(mx)


def _subnormal_fields(n: int, seed: int):
    """Positions, velocities with +-1e-40 entries (one dim non-negative
    whose least values are 1e-40, one non-positive whose greatest are
    -1e-40), IDs and masses."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    vel[0] = np.abs(vel[0])
    vel[1] = -np.abs(vel[1])
    vel[0, ::7] = SUB
    vel[1, ::5] = -SUB
    vel[2, ::3] = SUB
    vel[2, 1::3] = -SUB
    ids = rng.permutation(1 << 16)[:n].astype(np.uint64)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mass[::11] = SUB
    return pos, vel, ids, mass


def _jax_segment(pos, vel, mass, version=(1, 0, 0)):
    n = pos.shape[1]
    F = mnw.FieldCode

    def field(code, data, acc):
        hd = mnw.FieldHeader(code, mnw.AlgoCode.TRIM,
                             mnw.semver.pack(*version), n)
        return mnw.Field(hd=hd, data=data, acc=acc)

    fields = [field(F.POSN, pos, mnw.PositionAccuracy(delta=1e-3, width=64.0)),
              field(F.VELC, vel, mnw.VelocityAccuracy(delta=0.5))]
    if mass is not None:
        fields.append(field(F.UNSF, mass, mnw.FloatAccuracy(delta=1e-4)))
    return mnw.Seg(fields=fields)


def _same_segments(blob, fused_too=True):
    for fused in (False, True) if fused_too else (False,):
        ref = japi.decompress_segment(blob, fused=fused)
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        for a, b in zip(ref.fields, got.fields):
            assert _bits(np.asarray(a.data)) == _bits(b.data)


@pytest.mark.parametrize("mode", MODES)
def test_segment_with_subnormal_velocities(mode):
    pos, vel, _, mass = _subnormal_fields(4096, 1)
    seg = _jax_segment(pos, vel, mass)
    blob = japi.compress_segment(seg, seed=7, scale_mode=mode)
    assert mt.compress_segment(interop.seg_from_reference(seg), seed=7,
                               scale_mode=mode, device="cpu") == blob
    _same_segments(blob)


@pytest.mark.parametrize("mode, n, blocks", [("div", 16384, 4),
                                             ("recip", 16384, 4),
                                             ("div", 2468, 2),
                                             ("recip", 2468, 2)])
def test_snapshot_with_subnormal_velocities(mode, n, blocks):
    pos, vel, ids, mass = _subnormal_fields(n, 2)

    def spec(pkg, snap):
        return snap.SnapshotSpec(pos=pkg.PositionAccuracy(delta=1e-3,
                                                          width=64.0),
                                 vel=pkg.VelocityAccuracy(delta=0.5),
                                 ids=pkg.IDAccuracy(width=64),
                                 mass=pkg.FloatAccuracy(delta=1e-4))

    fa, fb = io.BytesIO(), io.BytesIO()
    jsnap.compress_snapshot(fa, pos, vel, ids, spec(mnw, jsnap), blocks,
                            seed=3, scale_mode=mode, mass=mass)
    mt.compress_snapshot(fb, pos, vel, ids, spec(mt, mt), blocks, seed=3,
                         scale_mode=mode, mass=mass, device="cpu")
    assert fb.getvalue() == fa.getvalue()
    for batched in (True, False):
        ref = jsnap.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                        batched=batched)
        got = mt.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                     batched=batched, device="cpu")
        assert set(ref) == set(got)
        for k in ref:
            assert _bits(got[k]) == _bits(ref[k]), k


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_plane_with_subnormal_spread(mode, periodic):
    """Every value is subnormal: XLA sees a constant plane of zeros."""
    rng = np.random.default_rng(3)
    x = (rng.uniform(0, 1, 4096) * 1e-38).astype(np.float32)
    x[::9] = -x[::9]
    box = 64.0 if periodic else None
    w, x0, r = jfast.fast_uniform_encode(jnp.asarray(x), 12, box,
                                         scale_mode=mode)
    gw, gx0, gr = fastpath.fast_uniform_encode(torch.from_numpy(x), 12, box,
                                               scale_mode=mode)
    assert _bits(gw) == _bits(w)
    assert _bits(gx0) == _bits(x0) and _bits(gr) == _bits(r)
    seg = _jax_segment(np.stack([x + 1.0, x, x]).astype(np.float32),
                       np.stack([x, x, -x]), x)
    blob = japi.compress_segment(seg, seed=5, scale_mode=mode)
    assert mt.compress_segment(interop.seg_from_reference(seg), seed=5,
                               scale_mode=mode, device="cpu") == blob
    _same_segments(blob)


@pytest.mark.parametrize("periodic", [False, True])
def test_decode_with_subnormal_bin_width(periodic):
    """dx / 2^16 is subnormal: XLA's bin width is 0, so every element
    decodes to x0 (then rewrapped)."""
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, 2048, dtype=np.uint64).astype(np.uint32)
    x0, dx = np.float32(1e-37), np.float32(1e-36)
    box = 64.0 if periodic else None
    want = np.asarray(jfast.fast_uniform_decode(
        jnp.asarray(words), jnp.asarray([3, 4], jnp.uint32), 16, 4096, x0,
        dx, box))
    got = fastpath.fast_uniform_decode(
        torch.from_numpy(words.view(np.int32)), (3, 4), 16, 4096, x0, dx,
        box)
    assert _bits(got) == _bits(want)
    assert np.unique(want).size == 1


@pytest.mark.parametrize("mode", MODES)
def test_segment_with_subnormal_bin_width(mode):
    """Masses in [1e-37, 1.1e-36] at delta 1e-40: 14 bits, and a bin width
    of ~6e-41 that XLA flushes to zero on decode."""
    rng = np.random.default_rng(6)
    n = 3000
    pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
    vel = rng.normal(0, 10, (3, n)).astype(np.float32)
    m = (1e-37 + rng.uniform(0, 1, n) * 1e-36).astype(np.float32)
    seg = _jax_segment(pos, vel, None)
    seg.fields.append(mnw.Field(
        hd=mnw.FieldHeader(mnw.FieldCode.UNSF, mnw.AlgoCode.TRIM,
                           mnw.semver.pack(1, 0, 0), n),
        data=m, acc=mnw.FloatAccuracy(delta=1e-40)))
    blob = japi.compress_segment(seg, seed=9, scale_mode=mode)
    assert mt.compress_segment(interop.seg_from_reference(seg), seed=9,
                               scale_mode=mode, device="cpu") == blob
    _same_segments(blob)


@pytest.mark.parametrize("mode", MODES)
def test_plane_with_subnormal_differences(mode):
    """Normal values whose differences from the plane's minimum are
    subnormal (x in [1.2e-38, 1.12e-37]): XLA flushes those differences to
    zero, so their bins are 0 even though the range is normal."""
    rng = np.random.default_rng(7)
    x = (np.float32(1.2e-38) + rng.uniform(0, 1, 4096) * 1e-37).astype(
        np.float32)
    x[:8] = np.float32(1.2e-38) + np.arange(8, dtype=np.float32) * \
        np.float32(1e-39)
    for level in (6, 16, 24):
        w, x0, r = jfast.fast_uniform_encode(jnp.asarray(x), level,
                                             scale_mode=mode)
        gw, gx0, gr = fastpath.fast_uniform_encode(torch.from_numpy(x),
                                                   level, scale_mode=mode)
        assert _bits(gw) == _bits(w)
        assert _bits(gx0) == _bits(x0) and _bits(gr) == _bits(r)


@pytest.mark.parametrize("periodic", [False, True])
def test_decode_with_subnormal_results(periodic):
    """x0 = -2e-38 and a bin width of 2e-38: x0 + dx*(bin + u) is subnormal
    for much of bin 0, and XLA flushes those results."""
    words = np.random.default_rng(8).integers(0, 1 << 32, 64,
                                              dtype=np.uint64).astype(
                                                  np.uint32)
    box = 64.0 if periodic else None
    x0, dx = np.float32(-2e-38), np.float32(4e-38)
    want = np.asarray(jfast.fast_uniform_decode(
        jnp.asarray(words), jnp.asarray([5, 6], jnp.uint32), 1, 2048, x0, dx,
        box))
    got = fastpath.fast_uniform_decode(
        torch.from_numpy(words.view(np.int32)), (5, 6), 1, 2048, x0, dx, box)
    assert _bits(got) == _bits(want)
    assert (want == 0).any()
