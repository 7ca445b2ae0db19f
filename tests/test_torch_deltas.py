"""The torch port's per-particle accuracies (Deltas mode) against the JAX
package, on the CPU: the per-element-depth bin maps and bitstream, Deltas
segments of every ported codec, Deltas snapshots, and the small leftovers
of the segment layer (the Test codecs and the v0 byte format).

Inputs are made with numpy from fixed seeds and handed to both packages.
Every field here has the identity map, so the tolerance is bitwise
equality throughout: bytes, and decoded arrays compared as raw bytes.
"""

import dataclasses
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.algos import algo_coil_v1_1 as jcoil11
from minnow_c_tpu.ops import bitpack as jbitpack
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.quant import engine as jengine
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.algos import algo_coil_v1_1 as tcoil11
from minnow_c_tpu_torch.ops import bitpack, kernels
from minnow_c_tpu_torch.quant import engine
from minnow_c_tpu_torch.segment import api as tapi

V10, V11 = mt.semver.pack(1, 0, 0), mt.semver.pack(1, 1, 0)
A = mt.AlgoCode
CODECS = {"trim": (A.TRIM, V10), "trim_v1_1": (A.TRIM, V11),
          "diff": (A.DIFF, V10), "coil": (A.COIL, V10),
          "coil_v1_1": (A.COIL, V11), "octo": (A.OCTO, V10),
          "octo_v1_1": (A.OCTO, V11)}
SIZES = [1, 2, 33, 257, 1000]
EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40, -1e-40,
                  1.5e-38, 0.5, 1.0, 7.9999995, 8.0], np.float32)


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_bytes(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _u32_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(_np(a)).view(np.uint32)


# ---------------------------------------------------------------------------
# Ops: the per-element-depth bin maps and the variable-width bitstream
# ---------------------------------------------------------------------------

def test_exact_pow2_matches_jax():
    lv = np.arange(25, dtype=np.uint8)
    want = np.asarray(jkernels._exact_pow2_f32(jnp.asarray(lv)))
    got = kernels._exact_pow2_f32(torch.from_numpy(lv))
    assert _same_bytes(got, want)
    assert (got.numpy() == 2.0 ** np.arange(25)).all()


@pytest.mark.parametrize("n", [1, 33, 1000, 40000])
@pytest.mark.parametrize("x0,dx", [(0.0, 8.0), (-3.25, 0.1), (2.0, 0.0),
                                   (1e-39, 1e-38)])
def test_bin_index_matches_jax(n, x0, dx):
    """Depths 0-24 over values inside, below, above and at the edges of
    the range, with NaN, +-inf, +-0 and subnormals: the u32 bins are
    JAX's bit for bit (a NaN delta and a constant plane bin to 0)."""
    rng = np.random.default_rng(n)
    x = (x0 + dx * rng.uniform(-0.1, 1.1, n)).astype(np.float32)
    x[:min(n, EDGES.size)] = EDGES[:n]
    lv = rng.integers(0, 25, n).astype(np.uint8)
    want = np.asarray(jkernels.bin_index(jnp.asarray(x), jnp.asarray(lv),
                                         x0, dx))
    got = kernels.bin_index(torch.from_numpy(x), torch.from_numpy(lv), x0,
                            dx)
    assert _same_bytes(_bits(got), want)


@pytest.mark.parametrize("n", [1, 257, 40000])
def test_undo_bin_index_matches_jax(n):
    """Both inverses (per-element depths 0-24, and one depth) bit for bit,
    dither included."""
    rng = np.random.default_rng(n + 1)
    lv = rng.integers(0, 25, n).astype(np.uint8)
    idx = (rng.integers(0, 1 << 24, n) &
           ((1 << lv.astype(np.int64)) - 1)).astype(np.uint32)
    key = (12345, 678)
    jkey = jnp.asarray(key, dtype=jnp.uint32)
    for x0, dx in ((0.0, 1.0), (-7.5, 123.25), (1e-30, 3e-38)):
        want = jkernels.undo_bin_index(jnp.asarray(idx), jnp.asarray(lv), x0,
                                       dx, jkey)
        got = kernels.undo_bin_index(_u32_tensor(idx), torch.from_numpy(lv),
                                     x0, dx, key)
        assert _same_bytes(got, np.asarray(want))
        for level in (0, 9, 24):
            b = idx & np.uint32((1 << level) - 1)
            want = jkernels.undo_uniform_bin_index(jnp.asarray(b), level,
                                                   x0, dx, jkey)
            got = kernels.undo_uniform_bin_index(_u32_tensor(b), level, x0,
                                                 dx, key)
            assert _same_bytes(got, np.asarray(want))


@pytest.mark.parametrize("n", SIZES + [40000])
@pytest.mark.parametrize("widths", ["each", "mixed", "zeros", "wide"])
def test_var_pack_unpack_matches_jax(n, widths):
    """Per-element widths 0-32 (every width in turn, random, all 0, 25-32)
    over values with bits above their width: the words and the unpacked
    values are JAX's."""
    rng = np.random.default_rng(n)
    w = {"each": np.arange(n) % 33, "mixed": rng.integers(0, 33, n),
         "zeros": np.zeros(n), "wide": rng.integers(25, 33, n)}[widths]
    w = w.astype(np.uint8)
    x = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    n_words = bitpack.var_packed_words(w)
    assert n_words == jbitpack.var_packed_words(w)
    want = np.asarray(jbitpack.pack(jnp.asarray(x), jnp.asarray(w), n_words))
    got = bitpack.pack(_u32_tensor(x), torch.from_numpy(w), n_words)
    assert _same_bytes(_bits(got), want)
    back = bitpack.unpack(got, torch.from_numpy(w))
    if n_words:
        assert _same_bytes(_bits(back), np.asarray(
            jbitpack.unpack(jnp.asarray(want), jnp.asarray(w))))
    mask = np.where(w >= 32, 0xFFFFFFFF,
                    (1 << np.minimum(w, 31).astype(np.uint64)) - 1)
    assert (_bits(back) == (x & mask.astype(np.uint32))).all()


def test_deltas_to_depths_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.choice(np.array([1e-1, 1e-3, 1e-5, 3.0, 1e30], np.float32),
                   4000)
    for x0, x1 in ((0.0, 1.0), (-5.0, 64.0), (2.0, 2.0)):
        assert _same_bytes(engine.deltas_to_depths(d, x0, x1),
                           jengine.deltas_to_depths(d, x0, x1))
    for bad in (np.float32(np.nan), np.float32(-1e-3), np.float32(1e-9)):
        d2 = np.append(d, bad)
        with pytest.raises(ValueError, match="granularity") as e:
            jengine.deltas_to_depths(d2, 0.0, 64.0)
        with pytest.raises(ValueError, match="granularity") as g:
            engine.deltas_to_depths(d2, 0.0, 64.0)
        assert str(g.value) == str(e.value)


# ---------------------------------------------------------------------------
# Deltas segments of every codec
# ---------------------------------------------------------------------------

def deltas_fields(n: int, seed: int, runs: bool):
    """Positions in a 64-wide box (some across its seam), Gaussian
    velocities, uniform masses, lattice IDs; per-particle accuracies in
    contiguous runs (a zoom run's particles sorted by type) or drawn per
    particle."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 64, (3, n)).astype(np.float32)
    pos[0, ::7] = np.float32(63.99)
    vel = rng.normal(0, 300, (3, n)).astype(np.float32)
    mass = rng.uniform(1, 9, n).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
    levels = np.array([1e-4, 1e-3, 1e-2, 1e-1], np.float32)
    if runs:
        dl = levels[np.minimum(np.arange(n) * 4 // max(n, 1), 3)]
    else:
        dl = rng.choice(levels, n)
    return pos, vel, mass, ids, dl


def deltas_segment(algo, ver, n, seed=5, runs=False):
    pos, vel, mass, ids, dl = deltas_fields(n, seed, runs)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    F = mnw.FieldCode
    return mnw.Seg(fields=[
        mnw.Field(hd=hd(F.POSN), data=pos,
                  acc=mnw.PositionAccuracy(delta=0.0, width=64.0,
                                           deltas=dl)),
        mnw.Field(hd=hd(F.VELC), data=vel,
                  acc=mnw.VelocityAccuracy(delta=0.0, deltas=dl * 1e4)),
        mnw.Field(hd=hd(F.PTID), data=ids, acc=mnw.IDAccuracy(width=64)),
        mnw.Field(hd=hd(F.UNSF), data=mass,
                  acc=mnw.FloatAccuracy(delta=0.0, deltas=dl * 10)),
    ])


def _jax_decode(blob, fused):
    """JAX's decode, or None where it raises on an all-depth-0 Deltas
    plane (see ``test_constant_deltas_plane_decodes``)."""
    try:
        return japi.decompress_segment(blob, fused=fused)
    except TypeError:
        return None


def _check_segment(seg, seed):
    """The port's bytes equal JAX's; JAX's bytes decode in the port,
    generic and fused, to JAX's arrays bit for bit, with the reported
    per-particle accuracies.  Where JAX's decode raises (a one-particle
    field has range 0 and only depth-0 particles), the port's generic and
    fused decodes agree and give the values back exactly."""
    blob = japi.compress_segment(seg, seed=seed)
    assert mt.compress_segment(interop.seg_from_reference(seg), seed=seed,
                               device="cpu") == blob
    generic = mt.decompress_segment(blob, device="cpu")
    for fused in (False, True):
        ref = _jax_decode(blob, fused)
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        if ref is None:
            assert seg.fields[0].hd.particle_len == 1
            ref = generic
            for f, g in zip(seg.fields, got.fields):
                assert _same_bytes(np.asarray(f.data).view(np.uint32),
                                   _np(g.data).view(np.uint32))
        for a, b in zip(ref.fields, got.fields):
            assert _same_bytes(a.data, b.data), (fused, hex(a.hd.field_code))
            assert b.valid
            if getattr(a.acc, "deltas", None) is not None:
                assert _same_bytes(a.acc.deltas, b.acc.deltas)
                assert b.acc.delta == 0.0
    return blob


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(CODECS))
def test_deltas_segment_matches_jax(name, n):
    algo, ver = CODECS[name]
    _check_segment(deltas_segment(algo, ver, n, seed=n, runs=n > 100),
                   seed=n + 11)


@pytest.mark.parametrize("name", ["trim_v1_1", "coil_v1_1", "octo_v1_1"])
def test_deltas_segment_big_plane_matches_jax(name, monkeypatch):
    """n = 40000 with BIG_PLANE at 30000 in both packages: the ID planes
    of Coil v1.1 / Octo v1.1 take the 16384-element chunks (K10's plain
    version), the Deltas planes Trim's coding, and Trim v1.1's Deltas
    planes span 157 chunks in contiguous accuracy runs."""
    monkeypatch.setattr(jcoil11, "BIG_PLANE", 30000)
    monkeypatch.setattr(tcoil11, "BIG_PLANE", 30000)
    algo, ver = CODECS[name]
    _check_segment(deltas_segment(algo, ver, 40000, seed=9, runs=True),
                   seed=3)


def test_constant_deltas_plane_decodes():
    """A constant plane has range 0, so every per-particle depth is 0 and
    Trim v1.0's bitstream is empty.  The JAX package's decode raises on it
    (its unpack gathers from an empty array); the port decodes the
    constant, as Trim v1.1 does in both packages (ROADMAP.md queue 3)."""
    n = 64
    x = np.full(n, 3.0, np.float32)
    for ver in (V10, V11):
        seg = mnw.Seg(fields=[mnw.Field(
            hd=mnw.FieldHeader(mnw.FieldCode.UNSF, mnw.AlgoCode.TRIM, ver,
                               n), data=x,
            acc=mnw.FloatAccuracy(delta=0.0,
                                  deltas=np.full(n, 1e-3, np.float32)))])
        blob = japi.compress_segment(seg)
        assert mt.compress_segment(interop.seg_from_reference(seg),
                                   device="cpu") == blob
        for fused in (False, True):
            got = mt.decompress_segment(blob, fused=fused, device="cpu")
            assert (got.fields[0].data.numpy() == 3.0).all()
            if ver == V10:
                with pytest.raises(TypeError):
                    japi.decompress_segment(blob, fused=fused)
            else:
                assert _same_bytes(japi.decompress_segment(
                    blob, fused=fused).fields[0].data, got.fields[0].data)


def test_deltas_scale_modes_agree():
    """Deltas mode always bins with the division map, as in the JAX
    package: the recip scale mode writes the same bytes."""
    seg = deltas_segment(mnw.AlgoCode.TRIM, V11, 257, runs=True)
    tseg = interop.seg_from_reference(seg)
    blob = mt.compress_segment(tseg, seed=1, device="cpu")
    assert mt.compress_segment(tseg, seed=1, scale_mode="recip",
                               device="cpu") == blob
    assert japi.compress_segment(seg, seed=1, scale_mode="recip") == blob


# ---------------------------------------------------------------------------
# Deltas snapshots
# ---------------------------------------------------------------------------

def _snap_fields(n, seed):
    pos, vel, mass, ids, dl = deltas_fields(n, seed, runs=True)
    return pos, vel, mass, ids, dl


def _specs(pkg, snap, dl, which):
    """(JAX or port) snapshot specs with Deltas on ``which`` fields."""
    pos = pkg.PositionAccuracy(delta=1e-3, width=64.0)
    vel = pkg.VelocityAccuracy(delta=1.0)
    mass = pkg.FloatAccuracy(delta=1e-3)
    if "pos" in which:
        pos = pkg.PositionAccuracy(delta=0.0, width=64.0, deltas=dl)
    if "vel" in which:
        vel = pkg.VelocityAccuracy(delta=0.0, deltas=dl * 1e4)
    if "mass" in which:
        mass = pkg.FloatAccuracy(delta=0.0, deltas=dl * 10)
    return snap.SnapshotSpec(pos=pos, vel=vel, ids=pkg.IDAccuracy(width=64),
                             mass=mass)


def _same_snap(ref: dict, got: dict):
    assert sorted(ref) == sorted(got)
    for k in ref:
        assert _same_bytes(ref[k], got[k]), k


@pytest.mark.parametrize("mode", ["div", "recip"])
@pytest.mark.parametrize("which", [("pos",), ("vel", "mass")])
@pytest.mark.parametrize("n,B", [(1024, 4), (96, 3)])
def test_deltas_snapshot_matches_jax(which, mode, n, B):
    """Deltas positions, or Deltas velocities and masses, beside uniform
    fields: the file is JAX's byte for byte, the stats agree, and both
    packages read both files (batched and per segment) to JAX's arrays."""
    pos, vel, mass, ids, dl = _snap_fields(n, n + B)
    fa, fb = io.BytesIO(), io.BytesIO()
    sa = jsnap.compress_snapshot(fa, pos, vel, ids, _specs(mnw, jsnap, dl,
                                                           which), B,
                                 seed=4, scale_mode=mode, mass=mass)
    sb = mt.compress_snapshot(fb, pos, vel, ids, _specs(mt, mt, dl, which),
                              B, seed=4, scale_mode=mode, mass=mass,
                              device="cpu")
    assert fb.getvalue() == fa.getvalue()
    assert sb == sa
    for name in which:
        assert sb[f"{name}_depth"] == "per-particle"
    for batched in (True, False):
        ref = jsnap.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                        batched=batched)
        _same_snap(ref, mt.decompress_snapshot(io.BytesIO(fa.getvalue()),
                                               batched=batched,
                                               device="cpu"))
    e = np.abs(ref["pos"] - pos)
    assert (np.minimum(e, 64.0 - e) <= (dl if "pos" in which else 1e-3)
            ).all()


def test_deltas_snapshot_batched_reads_other_fields():
    """The batched reader leaves a file with a Deltas field to the
    per-segment decode, as the JAX package's does; a read that skips the
    Deltas field stays batched, and both give the same bits."""
    pos, vel, mass, ids, dl = _snap_fields(1024, 1)
    f = io.BytesIO()
    mt.compress_snapshot(f, pos, vel, ids, _specs(mt, mt, dl, ("pos",)), 4,
                         mass=mass, device="cpu")
    segs = [s for _, s in mt.segment.io.iter_segments(
        io.BytesIO(f.getvalue()))]
    from minnow_c_tpu_torch.parallel import snapshot as tsnap
    dev = torch.device("cpu")
    assert tsnap._decompress_snapshot_batched(segs, None, dev) is None
    sel = {int(mt.FieldCode.VELC), int(mt.FieldCode.UNSF),
           int(mt.FieldCode.PTID)}
    part = tsnap._decompress_snapshot_batched(segs, sel, dev)
    full = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device="cpu")
    assert sorted(part) == ["ids", "mass", "vel"]
    for k in part:
        assert _same_bytes(part[k], full[k]), k


def test_deltas_snapshot_length_mismatch_raises():
    pos, vel, mass, ids, dl = _snap_fields(128, 2)
    for snap, pkg in ((jsnap, mnw), (mt, mt)):
        kw = {} if snap is jsnap else {"device": "cpu"}
        with pytest.raises(ValueError, match="deltas length"):
            snap.compress_snapshot(io.BytesIO(), pos, vel, ids,
                                   _specs(pkg, snap, dl[:100], ("pos",)), 2,
                                   mass=mass, **kw)


@pytest.mark.parametrize("mode", ["div", "recip"])
def test_streaming_block_deltas_match_one_pass(mode):
    """Per-block ``pos_deltas`` through the streaming writer: JAX's bytes,
    and (with the uniform fields' depths pinned to the one-pass file's)
    the one-pass file's bytes and values; a spec-level deltas array is
    refused with JAX's message."""
    n, B = 1024, 4
    nb = n // B
    pos, vel, mass, ids, dl = _snap_fields(n, 7)
    one = io.BytesIO()
    st = mt.compress_snapshot(one, pos, vel, ids, _specs(mt, mt, dl,
                                                         ("pos",)), B,
                              seed=2, scale_mode=mode, mass=mass,
                              device="cpu")

    def blocks():
        for b in range(B):
            sl = slice(b * nb, (b + 1) * nb)
            yield {"pos": pos[:, sl], "vel": vel[:, sl], "ids": ids[sl],
                   "mass": mass[sl], "pos_deltas": dl[sl]}

    depths = {k: st[f"{k}_depth"] for k in ("vel", "mass")}
    spec = _specs(mt, mt, dl, ())
    fa, fb = io.BytesIO(), io.BytesIO()
    mt.compress_snapshot_streaming(fa, blocks(), spec, seed=2,
                                   depths=depths, scale_mode=mode,
                                   device="cpu")
    jsnap.compress_snapshot_streaming(fb, blocks(), _specs(mnw, jsnap, dl,
                                                           ()),
                                      seed=2, depths=depths,
                                      scale_mode=mode)
    assert fa.getvalue() == fb.getvalue()
    # the IDs' per-block widths differ from the one-pass file's global
    # ones; every float field is the one-pass file's, bit for bit
    got = mt.decompress_snapshot(io.BytesIO(fa.getvalue()), device="cpu")
    want = mt.decompress_snapshot(io.BytesIO(one.getvalue()), device="cpu")
    _same_snap(want, got)
    for pkg, snap in ((mnw, jsnap), (mt, mt)):
        kw = {} if snap is jsnap else {"device": "cpu"}
        with pytest.raises(ValueError, match="spec-level"):
            snap.compress_snapshot_streaming(
                io.BytesIO(), blocks(), _specs(pkg, snap, dl, ("pos",)),
                **kw)


# ---------------------------------------------------------------------------
# Leftovers: the Test codecs and the v0 byte format
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ver", [mt.semver.pack(0, 9, 0, mt.semver.DEV),
                                 V10])
@pytest.mark.parametrize("deltas", [False, True])
def test_test_codecs_match_jax(ver, deltas):
    seg = deltas_segment(mnw.AlgoCode.TEST, ver, 300, seed=4)
    if not deltas:
        for f in seg.fields:
            if getattr(f.acc, "deltas", None) is not None:
                f.acc = dataclasses.replace(f.acc, deltas=None, delta=1e-2)
    _check_segment(seg, seed=6)


def test_newest_test_codec_is_v1_0():
    from minnow_c_tpu.algos import registry as jreg
    from minnow_c_tpu_torch.algos import registry
    assert registry.newest(mt.AlgoCode.TEST) == \
        jreg.newest(mnw.AlgoCode.TEST) == V10


@pytest.mark.parametrize("deltas", [False, True])
def test_v0_byte_format_matches_jax(deltas):
    """to_bytes of the compressed fields is JAX's; from_bytes reads
    either package's bytes back to fields that decode to JAX's arrays."""
    seg = deltas_segment(mnw.AlgoCode.TRIM, V11, 257, seed=2)
    if not deltas:
        for f in seg.fields:
            if getattr(f.acc, "deltas", None) is not None:
                f.acc = dataclasses.replace(f.acc, deltas=None, delta=1e-2)
    jcs = japi.compress(japi.quantize(seg, seed=5))
    tcs = tapi.compress(tapi.quantize(interop.seg_from_reference(seg),
                                      seed=5, device="cpu"))
    raw = japi.to_bytes(jcs)
    assert tapi.to_bytes(tcs) == raw
    back = tapi.from_bytes(raw)
    assert tapi.to_bytes(back) == raw
    ref = japi.undo_quantize(japi.decompress(japi.from_bytes(raw)))
    got = tapi.undo_quantize(tapi.decompress(back, device="cpu"))
    for a, b in zip(ref.fields, got.fields):
        assert _same_bytes(a.data, b.data)
    assert mt.segment.from_bytes is tapi.from_bytes
    assert mt.segment.to_bytes is tapi.to_bytes
