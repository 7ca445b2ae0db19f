"""The port's measuring layer (``minnow_c_tpu_torch.bench``,
``minnow_c_tpu_torch.entry``) against the JAX package's on the CPU.

* records: ``tests/test_bench_records.py``'s cases on the port's copy,
  the real writer being the kernel suite's;
* the harness: under one fake ``time.perf_counter`` patched into both,
  the port's and the JAX package's harness take the same trial sizes and
  return the same Result; its salts never repeat, each carrying the call
  count in its low bits and the previous output's low byte above it,
  also where the JAX package's XOR of the two repeats (a salted prefix
  sum);
* every kernel suite body at n = 2^16 (rows 6 x 2^13), at salts 0, 1 and
  0xDEADBEEF, equals bitwise its ``bench_kernels.py`` body, jitted (the
  Pallas kernels in interpret mode, as the JAX package's tests run them);
* the headline's body equals bench.py's decode; the codec suite writes
  its sections; matrix config1 and config3 at reduced n on the CPU:
  within delta, IDs exact;
* ``entry.entry()`` and ``dryrun_multichip(2)`` / ``(4)``: the JAX
  package's words, headers and decodes, bitwise.

Inputs are made with numpy from seeds and handed to both packages.
"""

import importlib.util
import io
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
from minnow_c_tpu.bench import harness as jharness
from minnow_c_tpu.ops import bitpack as jbitpack
from minnow_c_tpu.ops import decode_pallas, encode_pallas, scan_pallas
from minnow_c_tpu.ops import fastpath as jfast
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.ops import rng as jrng
from minnow_c_tpu.parallel import sharding as jsharding
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.quant.engine import delta_to_depth as jdelta_to_depth
from minnow_c_tpu_torch import entry
from minnow_c_tpu_torch.bench import (codec_suite, harness, headline,
                                      kernel_suite, matrix, records)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SALTS = (0, 1, 0xDEADBEEF)
N = 1 << 16
ROW_BLOCKS, ROW_N = 2, 1 << 13


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"{name}_mod", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _i32(v: int) -> int:
    return v - (1 << 32) if v >= 1 << 31 else v


# ---------------------------------------------------------------------------
# records (tests/test_bench_records.py's cases on the port's copy)
# ---------------------------------------------------------------------------

def test_update_preserves_foreign_sections(tmp_path):
    path = str(tmp_path / "rec.json")
    records.update_sections(path, {"codecs": {"results": {"coil": 1.5}}})
    records.update_sections(path, {"meta": {"u": "GB/s"},
                                   "results": {"minmax": 400.0}})
    data = json.loads(open(path).read())
    assert data["codecs"]["results"]["coil"] == 1.5
    assert data["results"]["minmax"] == 400.0
    records.update_sections(path, {"codecs": {"results": {"coil": 25.0}}})
    data = json.loads(open(path).read())
    assert data["results"]["minmax"] == 400.0
    assert data["codecs"]["results"]["coil"] == 25.0


def test_update_replaces_only_named_section(tmp_path):
    path = str(tmp_path / "rec.json")
    records.update_sections(path, {"a": 1, "b": 2})
    records.update_sections(path, {"a": 10})
    assert records.load(path) == {"a": 10, "b": 2}


def test_load_tolerates_corrupt_file(tmp_path):
    path = str(tmp_path / "rec.json")
    with open(path, "w") as f:
        f.write("{ truncated")
    assert records.load(path) == {}
    records.update_sections(path, {"x": 1})
    assert records.load(path) == {"x": 1}


def test_atomic_write_leaves_no_tmp(tmp_path):
    path = str(tmp_path / "rec.json")
    records.update_sections(path, {"x": 1})
    assert [f for f in os.listdir(tmp_path) if f.endswith(".tmp")] == []


def test_real_writers_roundtrip(tmp_path, monkeypatch):
    """The kernel suite's writer must preserve a codecs section."""
    path = str(tmp_path / "bench_torch.json")
    records.update_sections(path, {"codecs": {"results": {"sort": 0.38}}})
    monkeypatch.setattr(harness, "BURN_IN_S", 0.0)
    kernel_suite.run("cpu", ["minmax"], path, n=4096, row_blocks=1,
                     row_n=64, target_trial_s=1e-3, max_total_s=0.05)
    data = json.loads(open(path).read())
    assert data["codecs"]["results"]["sort"] == 0.38
    assert data["results"]["minmax"] > 0
    assert data["meta"]["device"]["type"] == "cpu"


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

class _Clock:
    """A fake ``time.perf_counter``: ``tick`` a read, ``cost`` a call."""

    def __init__(self, tick: float, cost: float):
        self.t, self.tick, self.cost = 0.0, tick, cost

    def __call__(self):
        self.t += self.tick
        return self.t


@pytest.mark.parametrize("tick, cost, target, budget", [
    (0.0, 1e-3, 0.5, 30.0),     # the default policy, 1 ms a call
    (2.5e-4, 3e-3, 0.5, 30.0),  # reads cost time too
    (0.0, 0.3, 0.5, 8.0),       # the budget cuts the doubling and retrials
])
def test_harness_takes_the_jax_schedule(monkeypatch, tick, cost, target,
                                        budget):
    results = []
    for which in ("jax", "torch"):
        clock = _Clock(tick, cost)
        monkeypatch.setattr(time, "perf_counter", clock)
        calls = []
        if which == "jax":
            def fn(s, clock=clock, calls=calls):
                clock.t += clock.cost
                calls.append(1)
                return jnp.full((2,), 3, jnp.uint32) ^ s
            res = jharness.run(fn, 4096, target, budget)
        else:
            def fn(s, clock=clock, calls=calls):
                clock.t += clock.cost
                calls.append(1)
                return torch.full((2,), 3, dtype=torch.int32) ^ s
            res = harness.run(fn, 4096, target, budget, device="cpu")
        monkeypatch.undo()
        results.append((res.bytes_per_second, res.iterations,
                        res.trial_seconds, res.gb_per_second, len(calls)))
    assert results[0] == results[1]


def test_harness_salts_chain_and_never_repeat(monkeypatch):
    """Call i >= 2 gets the salt (the low byte of output i-1's first
    element) << 24 | (i - 1): it depends on the previous output, and the
    count keeps salts fresh although the outputs take five values only.
    The count's low bit alternates, so that a body that reads only the
    salt's low bit (``salted_f32``) alternates its input.  The salts
    handed back are the last trial's, read after the run."""
    clock = _Clock(0.0, 1e-3)
    monkeypatch.setattr(time, "perf_counter", clock)
    seen, outs = [], []

    def fn(s):
        clock.t += clock.cost
        seen.append(int(s))
        outs.append(torch.tensor([1.0 + 2.0 ** -23 * (len(seen) % 5),
                                  9.0]))
        return outs[-1], torch.zeros(3)
    last = []
    res = harness.run(fn, 4, 0.05, 30.0, device="cpu", salts=last)
    assert seen[:2] == [0, 0]   # the warm-up call and the first burn-in
    for i in range(2, len(seen)):
        prev = int(outs[i - 1].view(torch.int32)[0])
        assert seen[i] == _i32(((prev & 0xFF) << 24) | (i - 1))
        assert seen[i] & 1 != seen[i - 1] & 1
    assert len(set(seen[2:])) == len(seen) - 2
    assert len({float(o[0]) for o in outs}) == 5
    tail = [int(t) for t in last]
    assert len(tail) == res.iterations and len(set(tail)) == len(tail)
    assert tail[:-1] == seen[len(seen) - len(tail) + 1:]


def test_harness_salts_distinct_on_a_salted_prefix_sum(monkeypatch):
    """The kernel suite's cumsum body: the max of a prefix sum whose
    element 0 is salted follows the salt, so the JAX package's XOR of the
    output bits and the count closes a cycle within 100 calls; the port's
    salts stay distinct."""
    inp = kernel_suite.make_inputs("cpu", N, 1, 64)
    body = kernel_suite.workloads(inp)["cumsum_u32_pallas"][0]
    s, xor_chain = 0, []
    for k in range(1, 100):
        red = int(body(torch.tensor(_i32(s), dtype=torch.int32))[0])
        s = (red & 0xFFFFFFFF) ^ k
        xor_chain.append(s)
    assert len(set(xor_chain)) < len(xor_chain)
    clock = _Clock(0.0, 1e-3)
    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(harness, "BURN_IN_S", 0.1)

    def timed_body(salt):
        clock.t += clock.cost
        return body(salt)
    salts = []
    res = harness.run(timed_body, N * 4, 0.05, 30.0, device="cpu",
                      salts=salts)
    vals = torch.stack(salts)
    assert vals.numel() == res.iterations == 64
    assert vals.unique().numel() == vals.numel()


@pytest.mark.parametrize("per_iter, dev, ok", [
    (1.0, 1.0, True), (0.9, 1.0, True), (0.89, 1.0, False),
    (1.0, None, False)])
def test_check_floors_holds_an_iteration_to_its_device_time(
        monkeypatch, per_iter, dev, ok):
    """On the card, an iteration below FLOOR x its traced device time, or
    a trace without device time, fails; off the card nothing is traced."""
    monkeypatch.setattr(harness, "device_ms", lambda fn, device: dev)
    timed = {"body": (lambda s: s, per_iter)}
    assert harness.check_floors(timed, "cpu") == {}
    if ok:
        assert harness.check_floors(timed, "cuda") == {"body": dev}
    else:
        with pytest.raises(AssertionError, match="body"):
            harness.check_floors(timed, "cuda")


# ---------------------------------------------------------------------------
# kernel suite bodies against bench_kernels.py's, bitwise
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def suite():
    inp = kernel_suite.make_inputs("cpu", N, ROW_BLOCKS, ROW_N)
    bk = _load("bench_kernels")
    u32 = {k: jnp.asarray(inp[k].numpy().view(np.uint32)) for k in
           ("bins", "packed8", "packed9", "packed11", "wrows")}
    jin = {"x": jnp.asarray(inp["x"].numpy()),
           "xrows": jnp.asarray(inp["xrows"].numpy()),
           "rkeys": jnp.asarray(inp["rkeys"].numpy().astype(np.uint32)),
           **u32}
    return kernel_suite.workloads(inp), _jax_bodies(bk, jin)


def _jax_bodies(bk, j):
    """bench_kernels.py's bodies, s -> (out, reduction), at this size."""
    W, LEVEL = kernel_suite.W, kernel_suite.LEVEL
    x, bins, key = j["x"], j["bins"], jrng.field_key_arr(7, 0, 0)
    u32_red = lambda a: jnp.max(a).astype(jnp.uint32)  # noqa: E731
    f32_red = lambda a: jax.lax.bitcast_convert_type(  # noqa: E731
        jnp.max(a), jnp.uint32)
    RB, RND = ROW_BLOCKS, ROW_N
    out = {}

    def minmax(s):
        lo, hi = jkernels.minmax(bk.salted_f32(x, s))
        o = jnp.stack([lo, hi])
        return o, f32_red(o)
    out["minmax"] = minmax
    for name in ("periodic", "undo_periodic"):
        def wrap(s, op=getattr(jkernels, name)):
            o = op(bk.salted_f32(x, s), W)
            return o, f32_red(o)
        out[name] = wrap

    def bin_index(s):
        o = jkernels.uniform_bin_index(bk.salted_f32(x, s), LEVEL, 0.0, W)
        return o, u32_red(o)
    out["bin_index"] = bin_index

    def undo_bin_index(s):
        o = jkernels.undo_uniform_bin_index(
            bins ^ (s & jnp.uint32(0x3FF)), LEVEL, 0.0, W, key ^ s)
        return o, f32_red(o)
    out["undo_bin_index"] = undo_bin_index
    for width in (8, 9):
        def pack(s, width=width):
            o = jbitpack.uniform_pack((bins ^ (s & jnp.uint32(0xFF))) &
                                      jnp.uint32((1 << width) - 1), width)
            return o, u32_red(o)

        def unpack(s, width=width, packed=j[f"packed{width}"]):
            o = jbitpack.uniform_unpack(packed ^ s, width, N)
            return o, u32_red(o)
        out[f"pack_{width}bit"], out[f"unpack_{width}bit"] = pack, unpack

    def fast_compress(s):
        w = jfast.fast_uniform_encode(bk.salted_f32(x, s), LEVEL,
                                      periodic_width=W)[0]
        return w, u32_red(w)
    out["fast_compress"] = fast_compress

    def undo_fast_compress(s):
        o = jfast.fast_uniform_decode(j["packed11"] ^ s, key ^ s, LEVEL, N,
                                      0.0, W, periodic_width=W)
        return o, f32_red(o)
    out["undo_fast_compress"] = undo_fast_compress

    def fused_decode(s):
        o = decode_pallas.decode_pallas(j["packed11"], key ^ s, LEVEL, N,
                                        0.0, W, W, periodic=True,
                                        interpret=True)
        return o, f32_red(o)
    out["fused_decode_pallas"] = fused_decode

    def rows_recip_encode(s):
        xs = bk.salted_f32(j["xrows"], s)
        mn, mx = jsharding._rows_stats_raw(xs, W, True, True)
        rng_r = jnp.repeat(jnp.max((mx - mn).reshape(RB, 3), axis=1), 3)
        w = jsharding._rows_encode_recip_raw(xs, mn, rng_r, 14, W, True,
                                             True)
        return w, u32_red(w[0])
    out["rows_recip_encode"] = rows_recip_encode

    def rows_recip_encode_fused(s):
        xb = bk.salted_f32(j["xrows"], s).reshape(RB, 3, RND)
        w = encode_pallas.encode_recip_fused_blocks(
            xb, jnp.float32(W), xb[:, :, 0], 14, True, interpret=True)[0]
        return w, u32_red(w[0])
    out["rows_recip_encode_fused_1pass"] = rows_recip_encode_fused

    def rows_fused_decode(s):
        wr = j["wrows"]
        i0 = jax.lax.broadcasted_iota(jnp.uint32, wr.shape, 0)
        i1 = jax.lax.broadcasted_iota(jnp.uint32, wr.shape, 1)
        w = jnp.where((i0 == 0) & (i1 == 0), wr ^ s, wr)
        o = decode_pallas.decode_pallas_rows(
            w, j["rkeys"], 16, RND, jnp.zeros((RB * 3,), jnp.float32),
            jnp.full((RB * 3,), W, jnp.float32), box=W, periodic=True,
            interpret=True)
        return o, f32_red(o)
    out["rows_fused_decode"] = rows_fused_decode

    def cumsum(s):
        io = jax.lax.broadcasted_iota(jnp.uint32, bins.shape, 0)
        o = scan_pallas.cumsum_u32(jnp.where(io == 0, bins ^ s, bins),
                                   interpret=True)
        return o, u32_red(o)
    out["cumsum_u32_pallas"] = cumsum
    return {k: jax.jit(f) for k, f in out.items()}


@pytest.mark.parametrize("name", kernel_suite.NAMES)
def test_kernel_body_equals_the_jax_body(suite, name):
    ours, theirs = suite
    assert set(ours) == set(theirs) == set(kernel_suite.NAMES)
    body, nbytes = ours[name]
    assert nbytes == (ROW_BLOCKS * 3 * ROW_N * 4 if name.startswith("rows")
                      else N * 4)
    for salt in SALTS:
        red, out = body(torch.tensor(_i32(salt), dtype=torch.int32))
        jout, jred = theirs[name](jnp.uint32(salt))
        assert _bits(out) == _bits(jout), (name, salt)
        assert _bits(red) == _bits(jred), (name, salt)


def test_headline_body_equals_the_jax_decode():
    """bench.py's step: the fused decode of the seed-0 bins at level 11
    with key field_key(1234, 0, 0) XOR the salt (Pallas in interpret
    mode)."""
    n = N
    fn, nbytes = headline.workload("cpu", n)
    assert nbytes == n * 4
    words = jnp.asarray(headline.packed_words("cpu", n).numpy().view(
        np.uint32))
    key = jrng.field_key_arr(*headline.KEY)
    decode = jax.jit(lambda s: decode_pallas.decode_pallas(
        words, key ^ s, headline.LEVEL, n, 0.0, headline.WIDTH_BOX,
        headline.WIDTH_BOX, periodic=True, interpret=True))
    for salt in SALTS:
        got = fn(torch.tensor(_i32(salt), dtype=torch.int32))
        assert _bits(got) == _bits(decode(jnp.uint32(salt))), salt


def test_codec_suite_writes_its_sections(tmp_path, monkeypatch):
    path = str(tmp_path / "bench_torch.json")
    records.update_sections(path, {"results": {"minmax": 1.0}})
    monkeypatch.setattr(harness, "BURN_IN_S", 0.0)
    res = codec_suite.main("cpu", ["coil", "sort"], path, n=3 * 4096)
    assert set(res) == {"coil_coherent", "coil_random", "sort_coherent",
                        "sort_random"}
    assert res["coil_coherent"]["ratio"] < res["coil_random"]["ratio"] < 1
    dd = codec_suite.device_decode_rates("cpu", path, n=1 << 15,
                                         target_trial_s=1e-3,
                                         max_total_s=0.05)
    data = records.load(path)
    assert data["results"] == {"minmax": 1.0}
    assert set(data["codecs"]) == {"meta", "results", "device_decode"}
    assert all(dd[k] > 0 for k in dd if k.endswith("_GBps"))
    assert len([k for k in dd if k.endswith("_GBps")]) == 5


# ---------------------------------------------------------------------------
# matrix configs at reduced n, and the entry points
# ---------------------------------------------------------------------------

def test_matrix_config1_within_delta():
    res = matrix.config1("cpu", n=6000)
    assert res["within_delta"] and res["max_err"] <= matrix.DELTA


def test_matrix_config3_within_delta_ids_exact():
    res = matrix.config3("cpu", n=16_000, blocks=8)
    assert res["ok"] and res["max_pos_err"] <= matrix.DELTA
    assert 0 < res["ratio"] < 1


def test_entry_gives_the_jax_words():
    graft = _load("__graft_entry__")
    jstep, (jx,) = graft.entry()
    step, (x,) = entry.entry(device="cpu")
    assert _bits(x) == _bits(jx)
    got, want = step(x), jax.jit(jstep)(jx)
    for a, b in zip(got, want):
        assert _bits(a) == _bits(b)


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_gives_the_jax_words_and_decodes(n):
    got = entry.dryrun_multichip(n, device="cpu")
    mesh = jsharding.make_mesh(n)
    depth = jsharding.spmd_depth_for(delta=1e-3, width=64.0)
    blocks = n * 2
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 64.0, (blocks, 3, 256)).astype(np.float32)
    vel = rng.normal(0, 200.0, (blocks, 3, 256)).astype(np.float32)
    ids = rng.permutation(1024 * 1024 * 4)[: blocks * 256].astype(
        np.uint64).reshape(blocks, 256)
    snap = jsharding.ShardedSnapshotCodec(
        mesh=mesh, box=64.0, pos_depth=depth,
        vel_depth=jdelta_to_depth(1.0, -2000.0, 2000.0), id_grid=1024)
    enc = snap.encode(x, vel, ids)
    for a, b in zip(got["enc"], enc):
        assert _bits(a) == _bits(np.asarray(b).reshape(tuple(a.shape)))
    for a, b in zip((got["pos"], got["vel"], got["ids"]),
                    snap.decode(enc, seed=7)):
        assert _bits(a) == _bits(np.asarray(b).reshape(tuple(a.shape)))
    codec = jsharding.ShardedPositionCodec(mesh=mesh, width=64.0,
                                           depth=depth)
    words, x0, rng_b = codec.encode(x)
    for a, b in zip((got["words"], got["x0"], got["rng_b"]),
                    (words, x0, rng_b)):
        assert _bits(a) == _bits(np.asarray(b).reshape(tuple(a.shape)))
    out = codec.decode(words, x0, rng_b, seed=7)
    assert _bits(got["out"]) == _bits(
        np.asarray(out).reshape(tuple(got["out"].shape)))
    assert np.float32(got["g"]) == np.float32(codec.global_range(x))
    # the read leg: the JAX package's file, and its decode, block-major
    spec = jsnap.SnapshotSpec(pos=mnw.PositionAccuracy(delta=1e-3,
                                                       width=64.0),
                              vel=mnw.VelocityAccuracy(delta=1.0),
                              ids=mnw.IDAccuracy(width=1024))
    buf = io.BytesIO()
    jsnap.compress_snapshot(buf, np.concatenate(list(x), axis=1),
                            np.concatenate(list(vel), axis=1),
                            ids.reshape(-1), spec, num_blocks=blocks, seed=7)
    assert got["file"] == buf.getvalue()
    buf.seek(0)
    want = jsnap.decompress_snapshot(buf)
    read = got["read"]
    assert _bits(read["pos"].local) == _bits(
        want["pos"].reshape(3, blocks, 256).transpose(1, 0, 2))
    assert _bits(read["ids"].local) == _bits(want["ids"].reshape(blocks,
                                                                 256))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_plain_rows_give_the_same_bits(n):
    """``fused_rows=False`` (the codecs' plain path, which chip_smoke holds
    the card's kernels against) gives what the default path gives."""
    got = entry.dryrun_multichip(n, device="cpu")
    plain = entry.dryrun_multichip(n, device="cpu", fused_rows=False)
    for k in ("enc", "pos", "vel", "ids", "words", "x0", "rng_b", "out"):
        a, b = got[k], plain[k]
        for x, y in zip(*((t,) if isinstance(t, torch.Tensor) else t
                          for t in (a, b))):
            assert _bits(x) == _bits(y), k
    assert got["g"] == plain["g"] and got["file"] == plain["file"]
