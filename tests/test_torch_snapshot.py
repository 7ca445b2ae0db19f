"""The torch port's snapshot path and its rows kernels against the JAX
package, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The rows kernels' plain torch versions (which the port's wrappers run for
CPU tensors) are held against the Pallas kernels in interpret mode, as
``tests/test_pallas.py`` runs them; whole snapshots against the JAX
package's ``compress_snapshot`` / ``decompress_snapshot``.  Tolerance:
bitwise equality throughout -- file bytes, and arrays compared as their
raw bytes (u64 IDs decode to int64 tensors of the same bits in the port).
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.ops import decode_pallas, encode_pallas
from minnow_c_tpu.ops import native as jnative
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.segment import io as jio
from minnow_c_tpu_torch.ops import bitpack, decode_cuda, encode_cuda
from minnow_c_tpu_torch.parallel import snapshot as tsnap
from test_snapshot import make_snapshot

SMALL, BIG = 96, (1 << 14) + 32  # row lengths below and above 2^14
ROWS = 3


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _u32_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _u32(rng, shape, width: int = 32) -> np.ndarray:
    return rng.integers(0, 1 << width, shape, dtype=np.uint64).astype(
        np.uint32)


# ---------------------------------------------------------------------------
# Rows kernels: plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width, n", [(1, SMALL), (7, BIG), (16, SMALL),
                                      (24, BIG), (32, SMALL), (9, BIG),
                                      (31, SMALL)])
def test_unpack_rows_plain_matches_pallas(width, n):
    words = _u32(np.random.default_rng(width), (ROWS, n * width // 32))
    ref = np.asarray(decode_pallas.unpack_pallas_rows(
        jnp.asarray(words), width, n, interpret=True))
    got = decode_cuda.unpack_rows_cuda(_u32_tensor(words), width, n)
    assert got.shape == (ROWS, n)
    assert _bits(got) == _bits(ref)
    assert _bits(decode_cuda.unpack_rows_plain(_u32_tensor(words), width,
                                               n)) == _bits(ref)


@pytest.mark.parametrize("width, n, periodic", [
    (1, SMALL, False), (7, BIG, True), (16, SMALL, True), (24, BIG, False)])
def test_decode_rows_plain_matches_pallas(width, n, periodic):
    rng = np.random.default_rng(100 + width)
    bins = _u32(rng, (ROWS, n), width)
    bins[:, :2] = (0, (1 << width) - 1)
    words = np.stack([jnative.uniform_pack_host(r, width) for r in bins])
    keys = _u32(rng, (ROWS, 2))
    # periodic rows span [-2, 66) in a box of 64, so both rewraps happen
    x0 = np.array([-2.0, -1.5, 0.25] if periodic else [1.5, -3.0, 1e3],
                  np.float32)
    dx = np.array([68.0, 66.5, 63.75] if periodic else [32.0, 0.0, 7.25],
                  np.float32)
    ref = np.asarray(decode_pallas.decode_pallas_rows(
        jnp.asarray(words), jnp.asarray(keys), width, n, jnp.asarray(x0),
        jnp.asarray(dx), box=64.0, periodic=periodic, interpret=True))
    got = decode_cuda.decode_rows_cuda(
        _u32_tensor(words), torch.from_numpy(keys.astype(np.int64)), width,
        n, x0, dx, 64.0, periodic)
    assert got.shape == (ROWS, n)
    assert _bits(got) == _bits(ref)
    # each row is K1's decode of that row, counter from 0
    for r in range(ROWS):
        one = decode_cuda.decode_cuda(_u32_tensor(words[r]), keys[r], width,
                                      n, x0[r], dx[r], 64.0, periodic)
        assert _bits(one) == _bits(ref[r])


@pytest.mark.parametrize("width, n", [(1, BIG), (7, SMALL), (16, BIG),
                                      (24, SMALL), (32, BIG)])
def test_pack_rows_plain_matches_pallas(width, n):
    vals = _u32(np.random.default_rng(200 + width), (ROWS, n))
    ref = np.asarray(encode_pallas.pack_pallas_rows(
        jnp.asarray(vals), width, interpret=True))
    got = encode_cuda.pack_rows_cuda(_u32_tensor(vals), width)
    assert got.shape == (ROWS, n // 32 * width)
    assert _bits(got) == _bits(ref)
    assert _bits(bitpack.uniform_pack_rows(_u32_tensor(vals), width)) == \
        _bits(ref)
    assert _bits(encode_cuda.pack_rows_plain(_u32_tensor(vals), width)) == \
        _bits(ref)


def _stats_rows(n: int) -> np.ndarray:
    """Five rows: a cluster across the periodic seam, a NaN, all +-0.0,
    zeros as the max of negatives, zeros as the min of positives."""
    rng = np.random.default_rng(n)
    x = np.empty((5, n), np.float32)
    x[0] = (rng.normal(0.0, 2.0, n) % 64.0).astype(np.float32)
    x[0, 0] = 63.5
    x[1] = rng.uniform(0, 64, n).astype(np.float32)
    x[1, n // 2] = np.nan
    x[2] = np.where(rng.random(n) < 0.5, np.float32(0.0), np.float32(-0.0))
    x[3] = -rng.uniform(0, 1, n).astype(np.float32)
    x[3, 1::7] = 0.0
    x[3, 2::7] = -0.0
    x[4] = rng.uniform(1, 2, n).astype(np.float32)
    x[4, 1::5] = -0.0
    x[4, 3::5] = 0.0
    return x


EDGE_N = 4132  # the length of the edge rows


def _edge_rows(n: int) -> np.ndarray:
    """Six rows of K6's edge values: +inf; -inf; NaN beside -inf; a
    subnormal anchor among subnormals; a row whose every value wraps in a
    box of 64 (anchor 1, the rest in [34, 63), 33.5 in the middle, which
    wraps to the min); -0.0 in a negative row."""
    rng = np.random.default_rng(n)
    x = rng.uniform(0, 64, (6, n)).astype(np.float32)
    mid = n // 2
    x[0, mid] = np.inf
    x[1, mid] = -np.inf
    x[2, mid] = np.nan
    x[2, mid - 1] = -np.inf
    x[3] = (rng.uniform(-1, 1, n) * 1e-39).astype(np.float32)
    x[3, 0] = 3e-39
    x[3, mid] = -1.1e-38
    x[4] = rng.uniform(34, 63, n).astype(np.float32)
    x[4, 0] = 1.0
    x[4, mid] = 33.5
    x[5] = -rng.uniform(0.5, 1, n).astype(np.float32)
    x[5, mid] = -0.0
    return x


@pytest.mark.parametrize("periodic, n", [(False, SMALL), (True, BIG),
                                         (True, SMALL), (False, BIG),
                                         (False, EDGE_N), (True, EDGE_N)])
def test_stats_rows_plain_matches_pallas(periodic, n):
    """The mixed rows of ``_stats_rows`` at SMALL and BIG; the edge rows of
    ``_edge_rows`` at EDGE_N."""
    x = _edge_rows(n) if n == EDGE_N else _stats_rows(n)
    box = np.full(x.shape[0], 64.0, np.float32)
    mn, mx = encode_pallas.stats_pallas_rows(
        jnp.asarray(x), jnp.asarray(box), jnp.asarray(x[:, 0]), periodic,
        interpret=True)
    got = encode_cuda.stats_rows_cuda(
        torch.from_numpy(x), torch.from_numpy(box),
        torch.from_numpy(x[:, 0].copy()), periodic)
    assert _bits(got[0]) == _bits(mn)
    assert _bits(got[1]) == _bits(mx)
    mn, mx = got[0].numpy(), got[1].numpy()
    if n != EDGE_N:
        assert np.isnan(mn[1]) and np.signbit(mn[2]) and \
            not np.signbit(mx[2])
        return
    assert mx[0] == np.inf and mn[1] == -np.inf
    assert np.isnan(mn[2]) and np.isnan(mx[2])
    assert mn[3] == 0 and np.signbit(mn[3]) and not np.signbit(mx[3])
    assert mn[4] == (np.float32(33.5) - np.float32(64.0) if periodic
                     else np.float32(1.0))
    assert mx[5] == 0 and np.signbit(mx[5])


@pytest.mark.parametrize("which", ["unpack", "decode", "pack", "stats"])
def test_rows_wrappers_run_plain_only_for_cpu_tensors(which):
    """A tensor off the CPU goes to the kernel or raises; the wrappers never
    fall back to the plain version for it."""
    words = torch.zeros(2, 64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        if which == "unpack":
            decode_cuda.unpack_rows_cuda(words, 8, 256)
        elif which == "decode":
            decode_cuda.decode_rows_cuda(words, [[1, 2], [3, 4]], 8, 256,
                                         [0.0, 0.0], [1.0, 1.0])
        elif which == "pack":
            encode_cuda.pack_rows_cuda(words, 8)
        else:
            x = torch.zeros(2, 64, device="meta")
            encode_cuda.stats_rows_cuda(x, x[:, 0], x[:, 0], True)


def test_rows_gate_matches_jax():
    for width, n in ((0, 32), (1, 32), (5, 33), (32, 64), (3, 0)):
        assert decode_cuda.rows_kernel_eligible(width, n) == \
            decode_pallas.rows_kernel_eligible(width, n)


# ---------------------------------------------------------------------------
# Whole snapshots: the port's files and decodes against the JAX package's
# ---------------------------------------------------------------------------

def _full_case():
    """pos + vel + ids + mass, 16384 particles in 4 blocks; block b's x
    moves by 8 b, so that the blocks' bounding boxes are apart."""
    pos, vel, ids = make_snapshot(n=16384)
    pos[0] = (pos[0] + np.float32(8.0) * (np.arange(16384) // 4096)) % 64.0
    mass = np.random.default_rng(5).uniform(0.5, 3.0, 16384).astype(
        np.float32)
    spec = dict(pos=("PositionAccuracy", dict(delta=1e-3, width=64.0)),
                vel=("VelocityAccuracy", dict(delta=1.0)),
                ids=("IDAccuracy", dict(width=1024)),
                mass=("FloatAccuracy", dict(delta=1e-4)))
    return dict(pos=pos, vel=vel, ids=ids, mass=mass), spec, 4


def _odd_case():
    """32 does not divide the block size (TestOddShapes)."""
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 100 ** 3, 4000, dtype=np.uint64)
    pos = rng.uniform(0, 64.0, (3, 4000)).astype(np.float32)
    spec = dict(pos=("PositionAccuracy", dict(delta=1e-3, width=64.0)),
                ids=("IDAccuracy", dict(width=100)))
    return dict(pos=pos, ids=ids), spec, 4


def _seam_case():
    """IDs clustered across the grid seam (test_id_grid_wrap_blocks)."""
    W, n = 100, 2048
    rng = np.random.default_rng(5)
    xs = (rng.integers(95, 105, n) % W).astype(np.uint64)
    ys = rng.integers(40, 60, n).astype(np.uint64)
    zs = (rng.integers(98, 102, n) % W).astype(np.uint64)
    ids = xs + W * ys + W * W * zs
    return dict(ids=ids), dict(ids=("IDAccuracy", dict(width=W))), 4


def _u64_ids_case(w: int):
    """u64 IDs on a grid of width w past 2^21: x and z across the seam, y
    anywhere, and 0, w^3 - 1 and 2^63 + 7 (top bit set); 4 blocks of
    1024 (32 | nb)."""
    def make():
        n = 4096
        rng = np.random.default_rng(w)
        xs = rng.integers(w - 6, w + 6, n) % w
        ys = rng.integers(0, w, n)
        zs = rng.integers(w - 3, w + 3, n) % w
        ids = np.array([int(x) + w * int(y) + w * w * int(z)
                        for x, y, z in zip(xs, ys, zs)], np.uint64)
        ids[[5, 1500, 4000]] = (0, w ** 3 - 1, (1 << 63) + 7)
        pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
        spec = dict(pos=("PositionAccuracy", dict(delta=1e-3, width=64.0)),
                    ids=("IDAccuracy", dict(width=w)))
        return dict(pos=pos, ids=ids), spec, 4
    return make


CASES = {"full": _full_case, "odd": _odd_case, "seam": _seam_case,
         "u64_ids_2097157": _u64_ids_case((1 << 21) + 5),
         "u64_ids_2642245": _u64_ids_case(2642245)}


def _spec(pkg, spec, snap):
    return snap.SnapshotSpec(**{k: getattr(pkg, cls)(**kw)
                                for k, (cls, kw) in spec.items()})


@pytest.fixture(scope="module")
def files():
    """case -> (arrays, JAX file bytes, JAX stats, port file, port stats)."""
    out = {}
    for name, make in CASES.items():
        arrays, spec, blocks = make()
        fa, fb = io.BytesIO(), io.BytesIO()
        sa = jsnap.compress_snapshot(fa, spec=_spec(mnw, spec, jsnap),
                                     num_blocks=blocks, seed=3,
                                     pos=arrays.get("pos"),
                                     vel=arrays.get("vel"),
                                     ids=arrays.get("ids"),
                                     mass=arrays.get("mass"))
        sb = mt.compress_snapshot(fb, spec=_spec(mt, spec, tsnap),
                                  num_blocks=blocks, seed=3,
                                  pos=arrays.get("pos"),
                                  vel=arrays.get("vel"),
                                  ids=arrays.get("ids"),
                                  mass=arrays.get("mass"), device="cpu")
        out[name] = (arrays, fa.getvalue(), sa, fb.getvalue(), sb)
    return out


def _assert_same(ref: dict, got: dict):
    assert set(got) == set(ref)
    for k in ref:
        assert isinstance(got[k], torch.Tensor)
        assert got[k].shape == tuple(np.shape(ref[k])), k
        assert _bits(got[k]) == _bits(ref[k]), k


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_snapshot_bytes_match_jax(case, files):
    arrays, jbytes, jstats, pbytes, pstats = files[case]
    assert pbytes == jbytes
    assert pstats == jstats


@pytest.mark.parametrize("batched", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_decompress_snapshot_matches_jax(case, batched, files):
    """The JAX-written file decodes in the port to the JAX decode's bits,
    and within the accuracy request (IDs exact)."""
    arrays, jbytes = files[case][:2]
    ref = jsnap.decompress_snapshot(io.BytesIO(jbytes), batched=batched)
    got = mt.decompress_snapshot(io.BytesIO(jbytes), batched=batched,
                                 device="cpu")
    _assert_same(ref, got)
    if "ids" in arrays:
        np.testing.assert_array_equal(got["ids"].numpy().view(np.uint64),
                                      arrays["ids"])
    if "pos" in arrays:
        err = np.abs(got["pos"].numpy() - arrays["pos"])
        assert np.minimum(err, 64.0 - err).max() <= 1e-3


def test_jax_decodes_port_file_to_port_bits(files):
    pbytes = files["full"][3]
    for batched in (True, False):
        _assert_same(
            jsnap.decompress_snapshot(io.BytesIO(pbytes), batched=batched),
            mt.decompress_snapshot(io.BytesIO(pbytes), batched=batched,
                                   device="cpu"))


@pytest.mark.parametrize("batched", [True, False])
def test_field_subset_and_region_match_jax(batched, files):
    jbytes = files["full"][1]
    for sel in ({"pos", "mass"}, {mt.FieldCode.VELC, "ids"}):
        _assert_same(
            jsnap.decompress_snapshot(io.BytesIO(jbytes), batched=batched,
                                      fields=sel),
            mt.decompress_snapshot(io.BytesIO(jbytes), batched=batched,
                                   fields=sel, device="cpu"))
    # a query box around block 2's bounding box, and no other block's
    hdr = list(jio.iter_headers(io.BytesIO(jbytes)))[2]
    box = (hdr.origin, hdr.width)
    ref = jsnap.decompress_snapshot(io.BytesIO(jbytes), batched=batched,
                                    box=box, periodic=64.0)
    got = mt.decompress_snapshot(io.BytesIO(jbytes), batched=batched,
                                 box=box, periodic=64.0, device="cpu")
    assert got["pos"].shape == (3, 4096)
    _assert_same(ref, got)


def test_unported_snapshot_modes_raise():
    pos, vel, ids = make_snapshot(n=1024)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=64.0),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           mass=mt.FloatAccuracy(delta=1e-3))
    mass = np.linspace(1, 2, 1024, dtype=np.float32)
    deltas = np.full(1024, 1e-3, np.float32)
    bad = (
        dataclasses.replace(spec, pos=mt.PositionAccuracy(
            delta=1e-3, width=64.0, deltas=deltas)),
        dataclasses.replace(spec, vel=mt.VelocityAccuracy(
            delta=1e-3, sym_log10_scaled=2, sym_log10_threshold=1.0)),
        dataclasses.replace(spec, mass=mt.FloatAccuracy(delta=1e-3,
                                                        log10_scaled=1)),
        dataclasses.replace(spec, mass=mt.FloatAccuracy(delta=0.0,
                                                        deltas=deltas)),
    )
    # the four once refused: the identity-mapped Deltas files are JAX's
    # bytes; the log-mapped ones decode within their mapped accuracy (the
    # maps' bits follow torch's log, tests/test_torch_logmaps.py)
    for i, s in enumerate(bad):
        f = io.BytesIO()
        mt.compress_snapshot(f, pos, vel, None, s, 2, mass=mass,
                             device="cpu")
        out = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device="cpu")
        if i in (0, 3):
            js = jsnap.SnapshotSpec(**{
                k: None if a is None else getattr(mnw, type(a).__name__)(
                    **{f.name: getattr(a, f.name)
                       for f in dataclasses.fields(a)})
                for k, a in ((f.name, getattr(s, f.name))
                             for f in dataclasses.fields(s))})
            fj = io.BytesIO()
            jsnap.compress_snapshot(fj, pos, vel, None, js, 2, mass=mass)
            assert f.getvalue() == fj.getvalue()
        elif i == 1:
            sl = np.sign(vel) * np.log10(1.0 + np.abs(vel.astype(
                np.float64)))
            got = out["vel"].numpy().astype(np.float64)
            assert np.abs(np.sign(got) * np.log10(1.0 + np.abs(got)) -
                          sl).max() <= 1e-3 + 1.2e-6
        else:
            err = np.abs(np.log10(out["mass"].numpy().astype(np.float64)) -
                         np.log10(mass))
            assert err.max() <= 1e-3 + 1.2e-6
    with pytest.raises(ValueError, match="spec.mass"):
        mt.compress_snapshot(io.BytesIO(), pos, vel, ids,
                             dataclasses.replace(spec, mass=None), 2,
                             mass=mass, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        mt.compress_snapshot(io.BytesIO(), pos, vel, ids, spec, 3,
                             device="cpu")
