"""The torch port's recip scale mode (K5, K8, K12), the streaming snapshot
writer, and K4's kernel as K13's counterpart, against the JAX package on
the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The kernels' plain torch versions (which the port's wrappers run for CPU
tensors) are held against the Pallas kernels in interpret mode, as
``tests/test_recip_mode.py`` and ``tests/test_pallas.py`` run them, or
against the JAX package's op-identical XLA map; snapshot files against the
JAX package's writers.  Tolerance: bitwise equality throughout -- words,
file bytes, and floats compared as their raw bytes.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.ops import encode_pallas, pack_pallas
from minnow_c_tpu.ops import fastpath as jfast
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.ops import native as jnative
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu_torch.ops import encode_cuda, fastpath

W = 64.0
SUB = np.float32(1e-40)


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _hazard_plane(n: int, seed: int, periodic: bool) -> np.ndarray:
    """Values in the box (or around 0) with the unwrap's edges: exactly
    anchor +- half and one ulp either side, the box edges, subnormals of
    either sign and signed zeros; element 0 (the anchor) at a box edge."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, W, n).astype(np.float32)
    a = np.float32(np.nextafter(np.float32(W), np.float32(0)))
    half = np.float32(W * 0.5)
    edges = np.array([a, a - half, a + half,
                      np.nextafter(a - half, np.float32(0)),
                      np.nextafter(a - half, np.float32(W)), 0.0, -0.0,
                      SUB, -SUB, np.float32(W), 31.999998, 32.0],
                     np.float32)
    k = min(n, edges.size)
    x[:k] = edges[:k]
    if not periodic:
        x -= np.float32(20.0)
        x[1:k] = edges[1:k]
    return x


def _jax_plane(x: np.ndarray, width: int, box):
    """The JAX package's recip encode of one plane in XLA, op for op
    ``_fast_uniform_encode_recip_xla``, packed on the host."""
    periodic = box is not None
    boxf = jnp.float32(box if periodic else 0.0)
    xj = jnp.asarray(x)
    u = jkernels.undo_periodic(xj, boxf) if periodic else xj
    x0 = jnp.min(u)
    rng = jnp.max(u) - x0
    bins = encode_pallas._recip_bins_xla(
        xj, x0, jkernels.exact_recip(rng), boxf, xj[0], width, periodic)
    return jnative.uniform_pack_host(np.asarray(bins), width), x0, rng


# ---------------------------------------------------------------------------
# K5: one plane
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
def test_k5_plain_matches_pallas(periodic):
    """n = 3*2^14 + 160: the JAX kernel's tile cascade plus its XLA tail."""
    n = (1 << 14) * 3 + 160
    x = np.random.default_rng(1).uniform(0, W, n).astype(np.float32)
    box = W if periodic else None
    wk, x0k, rk = encode_pallas.encode_pallas_recip(
        jnp.asarray(x), 14, periodic_width=box, interpret=True)
    wx, x0x, rx = jfast._fast_uniform_encode_recip_xla(
        jnp.asarray(x), 14, jnp.float32(box if periodic else 0.0), periodic)
    assert _bits(wk) == _bits(wx)
    w, x0, r = fastpath.fast_uniform_encode(_t(x), 14, box,
                                            scale_mode="recip")
    assert _bits(w) == _bits(wk)
    assert _bits(x0) == _bits(x0k) and _bits(r) == _bits(rk)
    wp = encode_cuda.encode_recip_plain(
        _t(x), 14, x0.item(), np.float32(1) / np.float32(r.item()),
        box or 0.0, x[0], periodic)
    assert _bits(wp) == _bits(wk)


@pytest.mark.parametrize("n", [1, 17, 33, 1000 + 5])
@pytest.mark.parametrize("periodic", [True, False])
def test_k5_hazards_every_width(n, periodic):
    """Widths 1-24, n = 1, n < 32 and 32 does not divide n, the unwrap's
    edges and subnormals; through ``fast_uniform_encode`` (K5's wrapper)
    and ``encode_recip_cuda`` directly."""
    x = _hazard_plane(n, n, periodic)
    box = W if periodic else None
    for width in range(1, 25):
        want, x0, rng = _jax_plane(x, width, box)
        w, gx0, gr = fastpath.fast_uniform_encode(_t(x), width, box,
                                                  scale_mode="recip")
        assert _bits(w) == _bits(want), width
        assert _bits(gx0) == _bits(x0) and _bits(gr) == _bits(rng)
        got = encode_cuda.encode_recip_cuda(
            _t(x), width, np.asarray(x0), jkernels.exact_recip(rng),
            box or 0.0, x[0], periodic)
        assert _bits(got) == _bits(want), width


@pytest.mark.parametrize("case", ["constant", "subnormal_range", "tiny_x0"])
def test_k5_degenerate_planes(case):
    """A constant plane (range 0, recip inf, 0 * inf = NaN -> bin 0), a
    plane whose range is subnormal (XLA flushes it: recip inf), and one
    whose values and min are subnormal."""
    rng = np.random.default_rng(9)
    if case == "constant":
        x = np.full(100, 7.5, np.float32)
    elif case == "subnormal_range":
        x = (np.float32(1.0) + np.zeros(100, np.float32))
        x[::3] = np.nextafter(np.float32(1.0), np.float32(2.0))
        x = x - np.float32(1.0) + np.float32(2e-38)
    else:
        x = (rng.uniform(0, 1, 100) * 1e-38).astype(np.float32)
        x[::4] = 3.0
    for width in (1, 12, 24):
        want, x0, r = _jax_plane(x, width, None)
        w, gx0, gr = fastpath.fast_uniform_encode(_t(x), width,
                                                  scale_mode="recip")
        assert _bits(w) == _bits(want)
        assert _bits(gx0) == _bits(x0) and _bits(gr) == _bits(r)
    if case == "constant":
        assert not want.any()


@pytest.mark.parametrize("level", [0, 25, 28])
def test_recip_encode_outside_kernel_widths(level):
    """Widths outside 1-24 take the plain map and the pack, as the JAX
    package's XLA path does."""
    x = np.random.default_rng(3).uniform(0, W, 300).astype(np.float32)
    want, _, _ = jfast._fast_uniform_encode_recip_xla(
        jnp.asarray(x), level, jnp.float32(0.0), False)
    w, _, _ = fastpath.fast_uniform_encode(_t(x), level, scale_mode="recip")
    assert _bits(w) == _bits(want)


# ---------------------------------------------------------------------------
# K8: rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
def test_k8_plain_matches_pallas(periodic):
    """6 rows of 4096 + 32: ordinary rows, then rows with the hazards: a
    constant row (recip inf), a subnormal x0, the unwrap's edges."""
    rng = np.random.default_rng(2)
    rows, n, width = 6, 4096 + 32, 11
    x = rng.uniform(0, W, (rows, n)).astype(np.float32)
    x[3] = _hazard_plane(n, 3, periodic)
    x[4] = np.float32(7.5)
    x0 = rng.uniform(0, 4, rows).astype(np.float32)
    x0[4] = 7.5   # the constant row's own min: (x - x0) * inf = NaN
    x0[5] = SUB
    rngv = rng.uniform(40, 60, rows).astype(np.float32)
    rngv[4] = 0.0
    recip = jkernels.exact_recip(jnp.asarray(rngv))
    boxes = np.full(rows, W, np.float32)
    anchors = x[:, 0].copy()
    want = encode_pallas.encode_pallas_recip_rows(
        jnp.asarray(x), jnp.asarray(x0), recip, jnp.asarray(boxes),
        jnp.asarray(anchors), width, periodic, interpret=True)
    args = (width, _t(x0), _t(np.asarray(recip)), _t(boxes), _t(anchors),
            periodic)
    got = encode_cuda.encode_recip_rows_cuda(_t(x), *args)
    assert got.shape == (rows, n // 32 * width)
    assert _bits(got) == _bits(want)
    assert _bits(encode_cuda.encode_recip_rows_plain(_t(x), *args)) == \
        _bits(want)
    assert not np.asarray(want)[4].any()


def test_k8_rows_equal_k5_per_row():
    rng = np.random.default_rng(4)
    x = rng.uniform(0, W, (3, 96)).astype(np.float32)
    x0 = x.min(axis=1)
    recip = np.float32(1) / (x.max(axis=1) - x0)
    boxes = np.full(3, W, np.float32)
    for width in (1, 13, 24):
        rows = encode_cuda.encode_recip_rows_plain(
            _t(x), width, _t(x0), _t(recip), _t(boxes), _t(x[:, 0].copy()),
            True)
        for r in range(3):
            assert _bits(rows[r]) == _bits(encode_cuda.encode_recip_plain(
                _t(x[r]), width, x0[r], recip[r], W, x[r, 0], True))


def test_recip_kernels_reject_bad_shapes():
    x = torch.zeros(2, 40)
    one = torch.zeros(2)
    with pytest.raises(ValueError, match="32 | n"):
        encode_cuda.encode_recip_rows_cuda(x, 8, one, one, one, one, False)
    with pytest.raises(ValueError, match="width"):
        encode_cuda.encode_recip_cuda(torch.zeros(8), 25, 0, 1, 0, 0, False)
    with pytest.raises(ValueError, match="anchors"):
        encode_cuda.encode_recip_fused_blocks_cuda(
            torch.zeros(1, 3, 64), 0.0, torch.zeros(3), 8, False)


# ---------------------------------------------------------------------------
# K12: stats, block range, recip, bin and pack of (B, D, n) blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [True, False])
def test_k12_plain_matches_pallas(periodic):
    """(3, 3, 2048) at 14 bits; block 2 holds the hazards: a row with the
    unwrap's edges and subnormals, and a constant row."""
    rng = np.random.default_rng(1)
    B, D, n, depth = 3, 3, 2048, 14
    x = rng.uniform(0, W, (B, D, n)).astype(np.float32)
    x[2, 0] = _hazard_plane(n, 5, periodic)
    x[2, 2] = np.float32(3.25)
    box = W if periodic else 0.0
    anchors = x[:, :, 0].copy()
    words, mn, mx = encode_pallas.encode_recip_fused_blocks(
        jnp.asarray(x), jnp.float32(box), jnp.asarray(anchors), depth,
        periodic, interpret=True)
    got = encode_cuda.encode_recip_fused_blocks_cuda(_t(x), box,
                                                     _t(anchors), depth,
                                                     periodic)
    for a, b in zip(got, (words, mn, mx)):
        assert _bits(a) == _bits(b)


def test_k12_constant_plane():
    x = np.full((1, 3, 1024), 7.5, np.float32)
    words, mn, mx = encode_pallas.encode_recip_fused_blocks(
        jnp.asarray(x), jnp.float32(0.0), jnp.asarray(x[:, :, 0]), 11,
        False, interpret=True)
    got = encode_cuda.encode_recip_fused_blocks_plain(
        _t(x), 0.0, _t(x[:, :, 0].copy()), 11, False)
    for a, b in zip(got, (words, mn, mx)):
        assert _bits(a) == _bits(b)
    assert not got[0].any() and float(got[1][0, 0]) == 7.5


# ---------------------------------------------------------------------------
# K13: K4's kernel computes pack_pallas_tiles' function
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 7, 14, 17, 24, 31])
def test_k13_tiles_pack_equals_k4_plain(width):
    bins = np.random.default_rng(width).integers(
        0, 1 << width, 2 * pack_pallas.TILE, dtype=np.uint64).astype(
            np.uint32)
    want = pack_pallas.pack_pallas_tiles(jnp.asarray(bins), width,
                                         interpret=True)
    got = encode_cuda.pack_cuda(_t(bins.view(np.int32)), width)
    assert _bits(got) == _bits(want)
    assert _bits(encode_cuda.pack_plain(_t(bins.view(np.int32)), width)) == \
        _bits(want)


# ---------------------------------------------------------------------------
# Snapshot files in the recip mode
# ---------------------------------------------------------------------------

def _fields(n: int, seed: int):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    pos[:, ::97] = np.float32(np.nextafter(np.float32(W), np.float32(0)))
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 16)[:n].astype(np.uint64)
    mass = rng.uniform(0.5, 2.0, n).astype(np.float32)
    mass[::13] = -mass[::13]
    return pos, vel, ids, mass


def _spec(pkg, snap, ids=True, deltas=None):
    return snap.SnapshotSpec(
        pos=pkg.PositionAccuracy(delta=1e-3, width=W, deltas=deltas),
        vel=pkg.VelocityAccuracy(delta=1.0),
        ids=pkg.IDAccuracy(width=64) if ids else None,
        mass=pkg.FloatAccuracy(delta=1e-4))


def _same_arrays(ref: dict, got: dict):
    assert set(ref) == set(got)
    for k in ref:
        assert _bits(got[k]) == _bits(ref[k]), k


@pytest.mark.parametrize("n, blocks", [(4096 * 4, 4), (1234 * 2, 2)])
def test_recip_snapshot_matches_jax(n, blocks):
    """32 | nb (K8 over all rows of a field) and 32 does not divide nb (K5
    row by row)."""
    pos, vel, ids, mass = _fields(n, 5)
    fa, fb = io.BytesIO(), io.BytesIO()
    ja = jsnap.compress_snapshot(fa, pos, vel, ids, _spec(mnw, jsnap),
                                 blocks, seed=3, scale_mode="recip",
                                 mass=mass)
    tb = mt.compress_snapshot(fb, pos, vel, ids, _spec(mt, mt), blocks,
                              seed=3, scale_mode="recip", mass=mass,
                              device="cpu")
    assert fb.getvalue() == fa.getvalue()
    assert tb == ja
    for batched in (True, False):
        # each package decodes the other's file
        ref = jsnap.decompress_snapshot(io.BytesIO(fb.getvalue()),
                                        batched=batched)
        got = mt.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                     batched=batched, device="cpu")
        _same_arrays(ref, got)
    e = np.abs(got["pos"].numpy() - pos)
    assert np.minimum(e, W - e).max() <= 1e-3


def test_recip_file_size_near_div():
    pos, vel, ids, mass = _fields(4096 * 4, 6)
    sizes = []
    for mode in ("div", "recip"):
        f = io.BytesIO()
        mt.compress_snapshot(f, pos, vel, ids, _spec(mt, mt), 4, seed=1,
                             scale_mode=mode, mass=mass, device="cpu")
        sizes.append(len(f.getvalue()))
    assert abs(sizes[0] - sizes[1]) <= max(64, sizes[0] // 1000), sizes


# ---------------------------------------------------------------------------
# The streaming writer
# ---------------------------------------------------------------------------

def _blocks(pos, vel, ids, mass, nb: int, with_ids: bool):
    for b in range(pos.shape[1] // nb):
        sl = slice(b * nb, (b + 1) * nb)
        blk = {"pos": pos[:, sl], "vel": vel[:, sl], "mass": mass[sl]}
        if with_ids:
            blk["ids"] = ids[sl]
        yield blk


@pytest.mark.parametrize("mode", ["div", "recip"])
@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("n, nb", [(4 * 2048, 2048), (3 * 1000, 1000)])
def test_streaming_matches_jax(mode, pinned, n, nb):
    """Unpinned, with IDs: each block derives its own depths.  Pinned to
    the one-pass writer's depths, without IDs: the one-pass file,
    exactly."""
    pos, vel, ids, mass = _fields(n, 7)
    one_pass = io.BytesIO()
    stats = mt.compress_snapshot(one_pass, pos, vel, None,
                                 _spec(mt, mt, ids=False), n // nb, seed=2,
                                 scale_mode=mode, mass=mass, device="cpu")
    depths = {k: stats[f"{k}_depth"] for k in ("pos", "vel", "mass")} \
        if pinned else None
    fa, fb = io.BytesIO(), io.BytesIO()
    sa = jsnap.compress_snapshot_streaming(
        fa, _blocks(pos, vel, ids, mass, nb, not pinned),
        _spec(mnw, jsnap, ids=not pinned), seed=2, depths=depths,
        scale_mode=mode)
    sb = mt.compress_snapshot_streaming(
        fb, _blocks(pos, vel, ids, mass, nb, not pinned),
        _spec(mt, mt, ids=not pinned), seed=2, depths=depths,
        scale_mode=mode, device="cpu")
    assert fb.getvalue() == fa.getvalue()
    assert sb == sa
    _same_arrays(jsnap.decompress_snapshot(io.BytesIO(fb.getvalue())),
                 mt.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                        device="cpu"))
    if pinned:
        assert fb.getvalue() == one_pass.getvalue()


def test_streaming_from_tensors_and_errors():
    pos, vel, ids, mass = _fields(2 * 1024, 8)
    blocks = [{k: _t(v.astype(np.int64) if k == "ids" else v)
               for k, v in b.items()}
              for b in _blocks(pos, vel, ids, mass, 1024, True)]
    fa, fb = io.BytesIO(), io.BytesIO()
    mt.compress_snapshot_streaming(fa, iter(blocks), _spec(mt, mt),
                                   scale_mode="recip", device="cpu")
    jsnap.compress_snapshot_streaming(
        fb, _blocks(pos, vel, ids, mass, 1024, True), _spec(mnw, jsnap),
        scale_mode="recip")
    assert fa.getvalue() == fb.getvalue()
    # a block's own per-particle accuracies (Deltas mode) give JAX's bytes
    pd = np.full(1024, 1e-3, np.float32)
    fa, fb = io.BytesIO(), io.BytesIO()
    mt.compress_snapshot_streaming(fa, iter([dict(blocks[0], pos_deltas=pd)]),
                                   _spec(mt, mt), device="cpu")
    jsnap.compress_snapshot_streaming(
        fb, iter([dict(next(_blocks(pos, vel, ids, mass, 1024, True)),
                       pos_deltas=pd)]), _spec(mnw, jsnap))
    assert fa.getvalue() == fb.getvalue()
    deltas = np.full(2048, 1e-3, np.float32)
    with pytest.raises(ValueError, match="spec-level"):
        mt.compress_snapshot_streaming(io.BytesIO(), iter(blocks),
                                       _spec(mt, mt, deltas=deltas),
                                       device="cpu")


# ---------------------------------------------------------------------------
# Mode errors
# ---------------------------------------------------------------------------

def test_scale_mode_errors():
    pos, vel, ids, mass = _fields(1024, 9)
    with pytest.raises(ValueError, match="scale_mode"):
        mt.compress_snapshot(io.BytesIO(), pos, vel, ids, _spec(mt, mt), 2,
                             scale_mode="exp", mass=mass, device="cpu")
    with pytest.raises(ValueError, match="scale_mode"):
        mt.compress_snapshot_streaming(io.BytesIO(), iter([]),
                                       _spec(mt, mt), scale_mode="exp",
                                       device="cpu")
    with pytest.raises(ValueError, match="scale_mode"):
        fastpath.fast_uniform_encode(_t(pos[0]), 8, scale_mode="exp")
    # symlog velocities in the recip mode: the mapped rows go through the
    # recip map; the velocities decode within the mapped-space accuracy
    # (the map's bits follow torch's log, tests/test_torch_logmaps.py)
    symlog = dataclasses.replace(_spec(mt, mt), vel=mt.VelocityAccuracy(
        delta=1e-3, sym_log10_scaled=2, sym_log10_threshold=1.0))
    f = io.BytesIO()
    mt.compress_snapshot(f, pos, vel, ids, symlog, 2, scale_mode="recip",
                         mass=mass, device="cpu")
    out = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device="cpu")

    def sl(v):
        return np.sign(v) * np.log10(1.0 + np.abs(v.astype(np.float64)))
    assert np.abs(sl(out["vel"].numpy()) - sl(vel)).max() <= 1e-3 + 1.2e-6


@pytest.mark.parametrize("mode", ["div", "recip"])
def test_snapshot_with_constant_fields_matches_jax(mode):
    """Constant velocities and masses: range 0, depth 0, outside the
    kernels' widths (the plain map and the pack, as in XLA)."""
    pos, vel, ids, _ = _fields(2 * 1024, 10)
    vel = np.full_like(vel, 3.5)
    mass = np.full(2 * 1024, -1.25, np.float32)
    fa, fb = io.BytesIO(), io.BytesIO()
    jsnap.compress_snapshot(fa, pos, vel, ids, _spec(mnw, jsnap), 2, seed=4,
                            scale_mode=mode, mass=mass)
    stats = mt.compress_snapshot(fb, pos, vel, ids, _spec(mt, mt), 2, seed=4,
                                 scale_mode=mode, mass=mass, device="cpu")
    assert fb.getvalue() == fa.getvalue()
    assert stats["vel_depth"] == 0 and stats["mass_depth"] == 0
    _same_arrays(jsnap.decompress_snapshot(io.BytesIO(fa.getvalue())),
                 mt.decompress_snapshot(io.BytesIO(fb.getvalue()),
                                        device="cpu"))
