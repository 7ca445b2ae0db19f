"""The torch port's log10 and symlog10 float maps against the JAX package,
on the CPU, under the contract of ROADMAP.md queue 3.

Both packages compute ``log10(x)`` as ``log(x) * f32(1 / ln 10)`` and
``exp2(y)`` as ``exp(f32(ln 2) * y)`` (XLA's lowering), and the symlog's
``|x| / t`` as ``|x| * f32(1 / t)`` (XLA's compile of a division by a
constant).  torch's ``log`` and ``exp`` are not XLA's polynomials, so
log-mapped values are compared within stated bounds, not bitwise.
Measured by running this file as a script (torch 2.13.0+cpu, jax 0.9.0):

* log10 map of 2^20 lognormal masses (0.5 dex): 12.04% of values differ,
  by at most 2 ulp (a 1-ulp difference of the logs can become 2 ulp after
  the scaling by 1 / ln 10, when the result falls into a lower binade);
* symlog map of 2^20 N(0, 300) velocities: 0.74%, 1.78%, 9.45% and
  22.87% of values differ at t = 1e-6, 1, 20 and 1e4, by at most 2 ulp,
  except near zero: XLA's ``log(1 + a)`` for small ``a`` carries an
  absolute, not a relative, error.  There 1818 values at t = 20 (mapped
  |y| < 0.44) and 9040 at t = 1e4 (|y| < 0.058) differ by more than 2
  ulp: by up to 110 and 7114 ulp, 9.0e-6 and 5.4e-4 relative, but never
  by more than 8.94e-8 and 5.22e-8 absolute, under the 2^-23 (1.19e-7)
  floor that the test allows;
* exp2 at 2^20 unmap arguments: 9.60% of values differ, by at most 1 ulp;
* bins of the same 2^16-element input: 0.0107% (log10 masses, 17 bits)
  and 0.0010% (symlog velocities, t = 20, 12 bits) differ, each by 1, and
  only where the mapped values differ.

Every decoded value, from either package's file in either package, is
within the requested accuracy in mapped space plus the unmap envelope of
``tests/test_quant.py`` (ENV_SLOPE, ENV_CONST).  Within the port, fused and
generic, batched and per-segment, and streaming and one-pass decodes are
bitwise equal.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu import __main__ as jcli
from minnow_c_tpu.drivers import gadget2 as jg2
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.quant import engine as jengine
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import __main__ as tcli
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.drivers import gadget2 as tg2
from minnow_c_tpu_torch.ops import kernels
from minnow_c_tpu_torch.quant import engine

ENV_SLOPE, ENV_CONST = 8e-8, 1.2e-6   # tests/test_quant.py TestUnmapPrecision
THRESHOLDS = [1e-6, 1.0, 20.0, 1e4]
V10, V11 = mt.semver.pack(1, 0, 0), mt.semver.pack(1, 1, 0)
MASS_DELTA = float(np.log10(1.0 + 1e-4))   # the CLI's relative 1e-4
EDGES = np.array([0.0, -0.0, 1e-40, -1e-40, np.inf, -np.inf, np.nan, 1.0,
                  -1.0, 3e38, -3e38], np.float32)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _ulps(a, b) -> np.ndarray:
    """Distance in f32 units in the last place (sign-magnitude order)."""
    def key(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(key(a) - key(b))


def _same_bits(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _mapped(x, mode, t=1.0):
    """The map in f64, the accuracy's reference."""
    x = np.asarray(x, np.float64)
    if mode == 1:
        return np.log10(x)
    return np.sign(x) * np.log10(1.0 + np.abs(x) / t)


def _within_accuracy(got, want, mode, t, delta):
    """|map(got) - map(want)| <= delta + the unmap envelope, elementwise
    (``delta`` a scalar or one per element)."""
    ym = _mapped(want, mode, t)
    err = np.abs(_mapped(_np(got), mode, t) - ym)
    bound = np.asarray(delta, np.float64) + ENV_CONST + ENV_SLOPE * np.abs(ym)
    assert (err <= bound).all(), float((err - bound).max())


# ---------------------------------------------------------------------------
# The maps themselves
# ---------------------------------------------------------------------------

def log10_map_diffs(n: int = 1 << 20) -> np.ndarray:
    """ulp distance of the port's log10 map from the JAX engine's (its
    jitted ``ufloat_prepare``) over lognormal masses of 0.5 dex."""
    rng = np.random.default_rng(0)
    m = (10 ** rng.normal(0, 0.5, n)).astype(np.float32)
    m[:5] = (1e-38, 1.0, 10.0, 3e38, 1.0000001)
    want = np.asarray(jengine.ufloat_prepare(jnp.asarray(m), 1, 0.0)[0])
    return _ulps(engine.map_float(torch.from_numpy(m), 1, 0.0).numpy(), want)


def symlog_map_diffs(t: float, n: int = 1 << 20):
    """(got, want) symlog maps of N(0, 300) velocities with the edge
    values first: the port's, and the JAX engine's jitted
    ``vel_prepare``."""
    rng = np.random.default_rng(1)
    v = rng.normal(0, 300, (1, n)).astype(np.float32)
    v[0, :EDGES.size] = EDGES
    want = np.asarray(jengine.vel_prepare(jnp.asarray(v), 2, t)[0])[0]
    return engine.map_float(torch.from_numpy(v), 2, t).numpy()[0], want


def exp2_diffs(n: int = 1 << 20):
    """(ulp distances over normal results, got, want, normal mask) of
    the port's exp2 against ``jnp.exp2`` at the unmap's arguments."""
    rng = np.random.default_rng(2)
    z = (rng.uniform(-38, 38, n) * np.log2(10.0)).astype(np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(z)))
    got = kernels.exp2_f32(torch.from_numpy(z)).numpy()
    normal = (want >= np.finfo(np.float32).tiny) & np.isfinite(want)
    return _ulps(got[normal], want[normal]), got, want, normal


def test_log10_map_within_two_ulp_of_jax():
    d = log10_map_diffs()
    assert d.max() <= 2
    assert (d != 0).mean() < 0.2          # measured 12.04%
    # the edges agree: 0 and subnormals map to -inf, inf to inf, 1 to 0,
    # negatives and NaN to a NaN (its sign bit is not compared)
    e = EDGES
    got = engine.map_float(torch.from_numpy(e), 1, 0.0).numpy()
    want = np.asarray(jengine.ufloat_prepare(jnp.asarray(e), 1, 0.0)[0])
    nan = np.isnan(want)
    assert (np.isnan(got) == nan).all()
    assert _same_bits(got[~nan], want[~nan])


@pytest.mark.parametrize("t", THRESHOLDS)
def test_symlog_map_within_contract(t):
    got, want = symlog_map_diffs(t, 1 << 18)
    fin = np.isfinite(want)
    assert (np.isnan(got) == np.isnan(want)).all()
    assert _same_bits(got[np.isinf(want)], want[np.isinf(want)])
    assert _same_bits(got[:5], want[:5])          # +-0, subnormals
    d = np.abs(got[fin].astype(np.float64) - want[fin])
    ulp = np.spacing(np.abs(want[fin]))
    # 2 ulp, or near zero the 2^-23 absolute floor (measured at most
    # 8.94e-8 on 2^20 values; see the module docstring)
    assert (d <= np.maximum(2 * ulp, 2.0 ** -23)).all()
    assert (d != 0).mean() < 0.3          # measured 0.74% to 22.87%


def test_exp2_within_one_ulp_of_jax():
    d, got, want, normal = exp2_diffs()
    assert d.max() <= 1
    assert (d != 0).mean() < 0.2          # measured 9.60%
    # flushed and overflowed results agree exactly
    assert _same_bits(got[~normal], want[~normal])


@pytest.mark.parametrize("mode,t", [(1, 0.0)] + [(2, t) for t in THRESHOLDS])
def test_unmap_error_envelope(mode, t):
    """The port's unmap meets the JAX package's envelope: re-mapped in
    f64, each value is within ENV_SLOPE * |y| + ENV_CONST of y."""
    rng = np.random.default_rng(3)
    ylim = 37.9 if mode == 1 else float(np.log10(1 + 3.0e38 / t))
    y = np.concatenate([rng.uniform(-ylim, ylim, 100_000),
                        np.linspace(-ylim, ylim, 50_000),
                        [0.0, 1.0, -1.0, 1e-30]]).astype(np.float32)
    got = engine.unmap_float(torch.from_numpy(y), mode, t).numpy().astype(
        np.float64)
    ok = np.isfinite(got) & ((got > 0) if mode == 1 else True)
    remapped = _mapped(got[ok], mode, t if mode == 2 else 1.0)
    err = np.abs(remapped - y[ok].astype(np.float64))
    assert (err <= np.abs(y[ok]) * ENV_SLOPE + ENV_CONST).all()


def bins_both(case: str):
    """The same input through both engines' quantize: (JAX's quantization,
    the port's, JAX's bins, the port's, JAX's mapped values, the
    port's), for lognormal masses (log10 map, relative 1e-4) or N(0, 300)
    velocities (symlog, t = 20, 1e-3)."""
    rng = np.random.default_rng(4)
    n = 1 << 16
    if case == "log10 masses":
        data = (10 ** rng.normal(0, 0.5, n)).astype(np.float32)
        code, mode, t = mnw.FieldCode.UNSF, 1, 0.0

        def acc(pkg):
            return pkg.FloatAccuracy(delta=MASS_DELTA, log10_scaled=1)
    else:
        data = rng.normal(0, 300, (3, n)).astype(np.float32)
        code, mode, t = mnw.FieldCode.VELC, 2, 20.0

        def acc(pkg):
            return pkg.VelocityAccuracy(delta=1e-3, sym_log10_scaled=2,
                                        sym_log10_threshold=t)
    hd = mnw.FieldHeader(code, mnw.AlgoCode.TRIM, V10, n)
    jq = jengine.quantize(mnw.Field(hd=hd, data=data, acc=acc(mnw)), seed=1)
    tq = engine.quantize(mt.Field(
        hd=mt.FieldHeader(int(code), int(mt.AlgoCode.TRIM), V10, n),
        data=data, acc=acc(mt)), seed=1, device="cpu")
    jb = np.asarray(jq.data).astype(np.int64)
    tb = tq.data.numpy().view(np.uint32).astype(np.int64)
    # the JAX engine's map runs under jit (vel_prepare / ufloat_prepare)
    jm = np.asarray(jengine.vel_prepare(jnp.asarray(data), 2, t)[0]
                    if mode == 2 else
                    jengine.ufloat_prepare(jnp.asarray(data), 1, t)[0])
    tm = engine.map_float(torch.from_numpy(data), mode, t).numpy()
    return jq.quant, tq.quant, jb, tb, jm, tm


@pytest.mark.parametrize("case", ["log10 masses", "symlog velocities"])
def test_bins_match_jax_where_mapped_values_agree(case):
    """The same ranges and depth, and bins that differ only where the
    mapped values do, by 1."""
    jq, tq, jb, tb, jm, tm = bins_both(case)
    assert (jq.x0, jq.x1, jq.depth) == (tq.x0, tq.x1, tq.depth)
    differ = jb != tb
    assert np.abs(jb - tb).max() <= 1
    assert (jm[differ] != tm[differ]).all()
    assert differ.mean() < 1e-3   # measured 0.0107% and 0.0010%


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

def log_segment(ver, n, t, seed, deltas=False, algo=mnw.AlgoCode.TRIM):
    """Lognormal masses (log10 map) and N(0, 300) velocities with a heavy
    tail (symlog map at threshold ``t``); per-particle accuracies in
    contiguous runs when ``deltas``."""
    rng = np.random.default_rng(seed)
    mass = (10 ** rng.normal(0, 0.5, n)).astype(np.float32)
    vel = np.concatenate([rng.normal(0, 300, (3, n // 2)),
                          np.sign(rng.normal(size=(3, n - n // 2))) *
                          10.0 ** rng.uniform(-3, 7, (3, n - n // 2))],
                         axis=1).astype(np.float32)
    dl = np.where(np.arange(n) < n // 4, 1e-4, 1e-3).astype(np.float32)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    F = mnw.FieldCode
    macc = mnw.FloatAccuracy(delta=MASS_DELTA, log10_scaled=1)
    vacc = mnw.VelocityAccuracy(delta=1e-3, sym_log10_scaled=2,
                                sym_log10_threshold=t)
    if deltas:
        macc = dataclasses.replace(macc, delta=0.0, deltas=dl)
        vacc = dataclasses.replace(vacc, delta=0.0, deltas=dl)
    return mnw.Seg(fields=[mnw.Field(hd=hd(F.VELC), data=vel, acc=vacc),
                           mnw.Field(hd=hd(F.UNSF), data=mass, acc=macc)])


def _check_log_segment(seg, t, seed=3):
    """Both packages' files decode in both packages within accuracy; the
    port's generic and fused decodes of each file are bitwise equal."""
    jblob = japi.compress_segment(seg, seed=seed)
    tblob = mt.compress_segment(interop.seg_from_reference(seg), seed=seed,
                                device="cpu")
    vel, mass = (f.data for f in seg.fields)
    dv, dm = (f.acc.deltas if f.acc.deltas is not None else f.acc.delta
              for f in seg.fields)
    for blob in (jblob, tblob):
        generic = mt.decompress_segment(blob, device="cpu")
        fused = mt.decompress_segment(blob, fused=True, device="cpu")
        jax_dec = japi.decompress_segment(blob)
        for dec in (generic, jax_dec):
            _within_accuracy(dec.fields[0].data, vel, 2, t, dv)
            _within_accuracy(dec.fields[1].data, mass, 1, 1.0, dm)
        for a, b in zip(generic.fields, fused.fields):
            assert _same_bits(a.data, b.data)
    return jblob, tblob


@pytest.mark.parametrize("n", [1, 2, 33, 257, 1000, 40000])
@pytest.mark.parametrize("ver", [V10, V11])
def test_log_segments_cross_decode(ver, n):
    _check_log_segment(log_segment(ver, n, 20.0, seed=n), 20.0)


@pytest.mark.parametrize("t", THRESHOLDS)
def test_symlog_thresholds_cross_decode(t):
    _check_log_segment(log_segment(V10, 3000, t, seed=5), t)


@pytest.mark.parametrize("ver", [V10, V11])
def test_log_maps_with_deltas_cross_decode(ver):
    """Log maps on Deltas fields: per-particle accuracies in mapped space,
    Trim v1.0 and v1.1, fused == generic in the port."""
    _check_log_segment(log_segment(ver, 3000, 20.0, seed=6, deltas=True),
                       20.0)


@pytest.mark.parametrize("algo", [mnw.AlgoCode.DIFF, mnw.AlgoCode.COIL,
                                  mnw.AlgoCode.OCTO])
def test_log_maps_in_delta_codecs(algo):
    """Diff, Coil and Octo decode symlog velocities and log10 masses
    through their generic paths (their fused decodes decline them)."""
    for ver in ((V10,) if algo == mnw.AlgoCode.DIFF else (V10, V11)):
        _check_log_segment(log_segment(ver, 1000, 20.0, seed=7, algo=algo),
                           20.0)


def test_velocity_flag_3_is_symlog_and_mass_flag_3_raises():
    """Any nonzero SymLog10Scaled is the symlog for velocities (stored as
    2); a log10_scaled of 3 is refused for scalar fields, with JAX's
    message."""
    seg = log_segment(V10, 500, 20.0, seed=8)
    seg.fields[0].acc = dataclasses.replace(seg.fields[0].acc,
                                            sym_log10_scaled=3)
    jblob, tblob = _check_log_segment(seg, 20.0)
    for blob in (jblob, tblob):
        assert mt.decompress_segment(blob, device="cpu").fields[0].acc \
            .sym_log10_scaled == 2
    bad = log_segment(V10, 64, 20.0, seed=8)
    bad.fields[1].acc = dataclasses.replace(bad.fields[1].acc,
                                            log10_scaled=3)
    with pytest.raises(ValueError, match="log10_scaled") as e:
        japi.compress_segment(bad)
    with pytest.raises(ValueError, match="log10_scaled") as g:
        mt.compress_segment(interop.seg_from_reference(bad), device="cpu")
    assert str(g.value) == str(e.value)


@pytest.mark.parametrize("edge", ["subnormal", "zero", "inf"])
def test_edge_masses_raise_as_jax(edge):
    """A log10-mapped mass of 0, a subnormal (flushed to 0) or +inf makes
    the mapped range infinite: both packages raise the same ValueError."""
    m = np.linspace(1, 2, 64).astype(np.float32)
    m[5] = {"subnormal": 1e-40, "zero": 0.0, "inf": np.inf}[edge]
    seg = mnw.Seg(fields=[mnw.Field(
        hd=mnw.FieldHeader(mnw.FieldCode.UNSF, mnw.AlgoCode.TRIM, V10, 64),
        data=m, acc=mnw.FloatAccuracy(delta=MASS_DELTA, log10_scaled=1))])
    with pytest.raises(ValueError, match="granularity") as e:
        japi.compress_segment(seg)
    with pytest.raises(ValueError, match="granularity") as g:
        mt.compress_segment(interop.seg_from_reference(seg), device="cpu")
    assert str(g.value) == str(e.value)


# ---------------------------------------------------------------------------
# Snapshots
# ---------------------------------------------------------------------------

def _snapshot(n, seed):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 64, (3, n)).astype(np.float32)
    vel = rng.normal(0, 300, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
    mass = (10 ** rng.normal(0, 0.5, n)).astype(np.float32)
    return pos, vel, ids, mass


def _spec(pkg, snap, t=20.0):
    return snap.SnapshotSpec(
        pos=pkg.PositionAccuracy(delta=1e-3, width=64.0),
        vel=pkg.VelocityAccuracy(delta=1e-3, sym_log10_scaled=2,
                                 sym_log10_threshold=t),
        ids=pkg.IDAccuracy(width=64),
        mass=pkg.FloatAccuracy(delta=MASS_DELTA, log10_scaled=1))


@pytest.mark.parametrize("mode", ["div", "recip"])
@pytest.mark.parametrize("n,B", [(1024, 4), (96, 3)])
def test_log_snapshot_cross_decode(mode, n, B):
    """Symlog velocities and log10 masses in both scale modes: either
    package's file, read by either package batched or per segment, is
    within accuracy; the port's batched and per-segment reads are bitwise
    equal; the stats and the file size match the JAX writer's."""
    pos, vel, ids, mass = _snapshot(n, n + B)
    fa, fb = io.BytesIO(), io.BytesIO()
    sa = jsnap.compress_snapshot(fa, pos, vel, ids, _spec(mnw, jsnap), B,
                                 seed=4, scale_mode=mode, mass=mass)
    sb = mt.compress_snapshot(fb, pos, vel, ids, _spec(mt, mt), B, seed=4,
                              scale_mode=mode, mass=mass, device="cpu")
    assert sb == sa
    for blob in (fa.getvalue(), fb.getvalue()):
        outs = [mt.decompress_snapshot(io.BytesIO(blob), batched=batched,
                                       device="cpu")
                for batched in (True, False)]
        for k in outs[0]:
            assert _same_bits(outs[0][k], outs[1][k]), k
        for out in outs + [jsnap.decompress_snapshot(io.BytesIO(blob))]:
            _within_accuracy(out["vel"], vel, 2, 20.0, 1e-3)
            _within_accuracy(out["mass"], mass, 1, 1.0, MASS_DELTA)
            assert _same_bits(np.asarray(_np(out["ids"])).view(np.uint64),
                              ids)


def test_log_snapshot_streaming_equals_one_pass():
    """The streaming writer at the one-pass file's depths writes blocks
    that decode to the one-pass values, bitwise (and the same bytes
    where the IDs' widths agree)."""
    n, B = 1024, 4
    nb = n // B
    pos, vel, ids, mass = _snapshot(n, 11)
    one = io.BytesIO()
    st = mt.compress_snapshot(one, pos, vel, None, _spec(mt, mt), B, seed=2,
                              mass=mass, device="cpu")
    depths = {k: st[f"{k}_depth"] for k in ("pos", "vel", "mass")}
    blocks = ({"pos": pos[:, b * nb:(b + 1) * nb],
               "vel": vel[:, b * nb:(b + 1) * nb],
               "mass": mass[b * nb:(b + 1) * nb]} for b in range(B))
    f = io.BytesIO()
    mt.compress_snapshot_streaming(f, blocks, _spec(mt, mt), seed=2,
                                   depths=depths, device="cpu")
    assert f.getvalue() == one.getvalue()
    got = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device="cpu")
    want = mt.decompress_snapshot(io.BytesIO(one.getvalue()), device="cpu")
    for k in want:
        assert _same_bits(got[k], want[k]), k


# ---------------------------------------------------------------------------
# The Gadget-2 CLI with per-particle masses
# ---------------------------------------------------------------------------

def _gadget2(n, seed, masses):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 64, (3, n)).astype(np.float32)
    vel = rng.normal(0, 150, (3, n)).astype(np.float32)
    ids = rng.permutation(64 ** 3)[:n].astype(np.uint64)
    hdr = jg2.Gadget2Header(npart=(0, n, 0, 0, 0, 0), mass=(0.0,) * 6,
                            time=0.5, redshift=1.5, box_size=64.0,
                            omega0=0.3, omega_lambda=0.7, hubble_param=0.7)
    buf = io.BytesIO()
    jg2.write_snapshot(buf, hdr, pos, vel, ids, mass=masses)
    return buf.getvalue(), pos, vel, ids


@pytest.mark.parametrize("mode", ["div", "recip"])
def test_gadget2_cli_log10_masses(tmp_path, capsys, mode):
    """A Gadget-2 file with all-positive per-particle masses through both
    CLIs: compress (log10 map, relative accuracy 1e-4), info, verify,
    decompress; each package's file decodes in each package with every
    mass within the relative accuracy and IDs exact."""
    n = 3000
    masses = (10 ** np.random.default_rng(1).normal(0, 0.5, n)).astype(
        np.float32)
    raw, pos, vel, ids = _gadget2(n, 2, masses)
    files = {}
    for name, cli in (("jax", jcli), ("torch", tcli)):
        d = tmp_path / name
        d.mkdir()
        (d / "snap.g2").write_bytes(raw)
        dev = [] if cli is jcli else ["--device", "cpu"]
        assert cli.main(["compress", str(d / "snap.g2"),
                         str(d / "snap.g2.min"), "--scale-mode", mode] +
                        dev) == 0
        assert cli.main(["info", str(d / "snap.g2.min")]) == 0
        assert cli.main(["verify", str(d / "snap.g2.min")]) == 0
        files[name] = (d / "snap.g2.min").read_bytes()
    capsys.readouterr()
    for blob in files.values():
        for g2, kw in ((jg2, {}), (tg2, {"device": "cpu"})):
            out = io.BytesIO()
            g2.decompress(io.BytesIO(blob), out, **kw)
            _, p2, v2, i2, m2 = tg2.read_snapshot_ext(
                io.BytesIO(out.getvalue()))
            _within_accuracy(m2, masses, 1, 1.0, MASS_DELTA)
            assert (np.abs(m2 / masses - 1) <= 1.0001e-4).all()
            assert np.array_equal(i2, ids)
            e = np.abs(p2 - pos)
            assert np.minimum(e, 64.0 - e).max() <= 1e-3
            assert np.abs(v2 - vel).max() <= 1.0


def test_gadget2_subnormal_mass_raises_as_jax():
    """A positive subnormal mass takes the log10 map (all masses > 0) and
    flushes to 0, so both drivers raise the same ValueError."""
    masses = np.linspace(1, 2, 256).astype(np.float32)
    masses[7] = 1e-40
    raw = _gadget2(256, 3, masses)[0]
    with pytest.raises(ValueError, match="granularity") as e:
        jg2.compress(io.BytesIO(raw), io.BytesIO(), num_blocks=2)
    with pytest.raises(ValueError, match="granularity") as g:
        tg2.compress(io.BytesIO(raw), io.BytesIO(), num_blocks=2,
                     device="cpu")
    assert str(g.value) == str(e.value)


if __name__ == "__main__":
    # The shares quoted in the module docstring and PERF.md section 7.
    d = log10_map_diffs()
    print(f"log10 map: {(d != 0).mean():.4%} of values differ, max "
          f"{d.max()} ulp")
    for t in THRESHOLDS:
        got, want = symlog_map_diffs(t)
        fin = np.isfinite(want)
        u = _ulps(got[fin], want[fin])
        a = np.abs(got[fin].astype(np.float64) - want[fin])
        print(f"symlog map t={t:g}: {(u != 0).mean():.4%} differ, max "
              f"{u.max()} ulp, max |difference| {a.max():.3g}")
        far = u > 2
        if far.any():
            w = np.abs(want[fin][far].astype(np.float64))
            print(f"  beyond 2 ulp: {far.sum()} values, mapped |y| < "
                  f"{w.max():.3g}, max {a[far].max():.3g} absolute, "
                  f"{(a[far] / w).max():.3g} relative")
    d = exp2_diffs()[0]
    print(f"exp2: {(d != 0).mean():.4%} differ, max {d.max()} ulp")
    for case in ("log10 masses", "symlog velocities"):
        jq, _, jb, tb, _, _ = bins_both(case)
        print(f"bins of {case} at {jq.depth} bits: "
              f"{(jb != tb).mean():.4%} differ, max {np.abs(jb - tb).max()}")
