"""The torch port's Sort (v1.0, v1.1, v1.2 and its order-free profile
v1.2.1) and Cart v1.0 codecs against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages
(``interop.seg_from_reference`` carries a segment across).  The JAX
package's Pallas scan runs in interpret mode; the port's kernel wrappers
(K3, K4, K7, K9, K10) run their plain torch versions, since the tensors are
on the CPU.  Tolerance: bitwise equality -- segment bytes, and decoded
arrays compared as raw bytes -- except for log-mapped fields, which are
held to the contract of ROADMAP.md queue 3 by what they decode to.  Where
the bytes are equal, the JAX package decoding the port's bytes is the
JAX package decoding its own; the tests decode the JAX bytes in both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.algos import algo_cart_v1_0 as jcart
from minnow_c_tpu.algos import algo_coil_v1_1 as jcoil11
from minnow_c_tpu.algos import algo_sort_v1_2 as jsort12
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.algos import algo_cart_v1_0 as tcart
from minnow_c_tpu_torch.algos import algo_coil_v1_1 as tcoil11
from minnow_c_tpu_torch.algos import algo_sort_v1_2 as tsort12
from minnow_c_tpu_torch.algos import registry
from minnow_c_tpu_torch.ops import bitpack, chunked_cuda, kernels
from test_freeze import deltas_segment
from test_torch_logmaps import _check_log_segment, log_segment

SV = mnw.semver.pack
CODECS = {"sort": (mnw.AlgoCode.SORT, SV(1, 0, 0)),
          "sort_v1_1": (mnw.AlgoCode.SORT, SV(1, 1, 0)),
          "sort_v1_2": (mnw.AlgoCode.SORT, SV(1, 2, 0)),
          "cart": (mnw.AlgoCode.CART, SV(1, 0, 0))}
ORDER_FREE = SV(1, 2, 1)
SIZES = [1, 2, 3, 31, 33, 257, 1000, 4096]
SEED = 5
W = 64.0


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _same_bytes(a, b) -> bool:
    a, b = _np(a), _np(b)
    return a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _u32_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _field(code, algo, ver, data, acc):
    return mnw.Field(hd=mnw.FieldHeader(code, algo, ver, data.shape[-1]),
                     data=data, acc=acc)


def sort_segment(algo, ver, n, seed):
    """All five field codes, with ties: a random walk in a periodic box,
    N(0, 100) velocities, IDs of a 64^3 grid, and scalar fields drawn from
    a few values each (many equal bins)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = rng.permutation(64 ** 3)[:n].astype(np.uint64)
    uf = rng.choice(np.array([1.0, 2.5, 2.5001, 7.0, 9.75], np.float32), n)
    ui = rng.choice(np.array([10, 11, 11, 500, 70_000], np.uint64), n)
    F = mnw.FieldCode
    return mnw.Seg(fields=[
        _field(F.POSN, algo, ver, pos,
               mnw.PositionAccuracy(delta=1e-3, width=W)),
        _field(F.VELC, algo, ver, vel, mnw.VelocityAccuracy(delta=0.25)),
        _field(F.PTID, algo, ver, ids, mnw.IDAccuracy(width=64)),
        _field(F.UNSF, algo, ver, uf, mnw.FloatAccuracy(delta=1e-3)),
        _field(F.UNSI, algo, ver, ui, mnw.IntAccuracy())])


def unsi_segment(algo, ver, vals):
    return mnw.Seg(fields=[_field(mnw.FieldCode.UNSI, algo, ver, vals,
                                  mnw.IntAccuracy())])


def _check(seg, seed=SEED):
    """The port's bytes equal the JAX package's, and the JAX bytes decode
    in the port (generic and fused) to the JAX package's arrays; returns
    the bytes and the port's generic decode."""
    jblob = japi.compress_segment(seg, seed=seed)
    tblob = mt.compress_segment(interop.seg_from_reference(seg), seed=seed,
                                device="cpu")
    assert tblob == jblob
    ref = japi.decompress_segment(jblob)
    decs = [mt.decompress_segment(jblob, fused=fused, device="cpu")
            for fused in (False, True)]
    for dec in decs:
        for a, b in zip(ref.fields, dec.fields):
            assert a.valid and b.valid
            assert _same_bytes(a.data, b.data), hex(a.hd.field_code)
    return jblob, decs[0]


# ---------------------------------------------------------------------------
# Cart's byte ops and plane payload
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", range(1, 33))
def test_byte_ops_match_jax(width):
    rng = np.random.default_rng(width)
    bins = rng.integers(0, 1 << width, 1000, dtype=np.uint64).astype(
        np.uint32)
    words = bitpack.uniform_pack(_u32_tensor(bins), width)
    jwords = np.asarray(words.numpy().view(np.uint32))
    t = kernels.u32_transpose_bytes(words)
    jt = jkernels.u32_transpose_bytes(jnp.asarray(jwords))
    np.testing.assert_array_equal(t.numpy(), np.asarray(jt))
    d = kernels.u8_delta_encode(t)
    np.testing.assert_array_equal(
        d.numpy(), np.asarray(jkernels.u8_delta_encode(jt)))
    u = kernels.u8_undo_delta_encode(d)
    np.testing.assert_array_equal(u.numpy(), np.asarray(
        jkernels.u8_undo_delta_encode(jnp.asarray(d.numpy()))))
    back = kernels.u32_undo_transpose_bytes(u)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), np.asarray(
        jkernels.u32_undo_transpose_bytes(jnp.asarray(u.numpy()))))
    np.testing.assert_array_equal(back.numpy().view(np.uint32), jwords)


def test_byte_ops_keep_empty_inputs():
    e8 = torch.zeros(0, dtype=torch.uint8)
    assert kernels.u8_delta_encode(e8).numel() == 0
    assert kernels.u8_undo_delta_encode(e8).numel() == 0
    assert kernels.u32_transpose_bytes(
        torch.zeros(0, dtype=torch.int32)).numel() == 0
    assert kernels.u32_undo_transpose_bytes(e8).numel() == 0


@pytest.mark.parametrize("depth", range(1, 33))
def test_cart_plane_payload_matches_jax(depth):
    """Every byte plane at every depth, and the empty plane: the payload
    equals the JAX package's and decodes back to the bins."""
    rng = np.random.default_rng(100 + depth)
    tc, jc = tcart.CartV1_0(), jcart.CartV1_0()
    for n in (0, 1, 31, 33):
        bins = rng.integers(0, 1 << depth, n, dtype=np.uint64).astype(
            np.uint32)
        if n:
            bins[0] = (1 << depth) - 1
        words, w = tc._encode_plane(_u32_tensor(bins), depth)
        jwords, jw = jc._encode_plane(jnp.asarray(bins), depth)
        assert w == jw == depth
        np.testing.assert_array_equal(words, np.asarray(jwords))
        got = tc._decode_plane(words, depth, n, "cpu")
        np.testing.assert_array_equal(got.numpy().view(np.uint32), bins)


def test_cart_magic_mismatch_raises():
    codec = registry.get(mt.AlgoCode.CART, mt.semver.pack(1, 0, 0))
    payload = np.array([1, 0x43415255, 7], np.uint32)
    with pytest.raises(ValueError, match="Cart plane magic mismatch"):
        codec._decode_plane(payload, 8, 4, "cpu")


# ---------------------------------------------------------------------------
# Segments
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", sorted(CODECS))
def test_segments_match_jax(name, n):
    _check(sort_segment(*CODECS[name], n, seed=n))


@pytest.mark.parametrize("name", sorted(CODECS))
def test_unsi_just_under_2_32_with_ties(name):
    """An UNSI range of 2^32 - 1: one plane whose bins reach 2^32 - 1, half
    of them >= 2^31, with runs of equal bins.  A signed sort of the int32
    bits would put the high half first."""
    rng = np.random.default_rng(7)
    x0 = 12345
    vals = rng.integers(0, 1 << 32, 3000, dtype=np.uint64)
    vals[::3] = vals[1]      # ties, in several places of the input
    vals[5::7] = (1 << 31)
    vals[:2] = (0, (1 << 32) - 1)
    vals += np.uint64(x0)
    _, dec = _check(unsi_segment(*CODECS[name], vals))
    assert (vals - np.uint64(x0) >= np.uint64(1 << 31)).mean() > 0.3
    np.testing.assert_array_equal(dec.fields[0].data.numpy().view(np.uint64),
                                  vals)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_unsi_above_2_32_ranked(name):
    """An UNSI range past 2^32 splits into a lo plane (sorted) and a hi
    plane (packed as Trim)."""
    rng = np.random.default_rng(8)
    vals = rng.integers(0, 1 << 40, 2000, dtype=np.uint64) + np.uint64(
        (1 << 63) - (1 << 39))
    vals[1::4] = vals[0]
    _, dec = _check(unsi_segment(*CODECS[name], vals))
    np.testing.assert_array_equal(dec.fields[0].data.numpy().view(np.uint64),
                                  vals)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_u64_ids_past_2_63(name):
    """IDs on a grid of 2^21 + 5 a side, with the top bit set: grid planes
    whose coordinates sort wide."""
    w = (1 << 21) + 5
    rng = np.random.default_rng(9)
    n = 2000
    xs, ys, zs = (rng.integers(0, w, n).astype(np.uint64) for _ in range(3))
    ids = xs + np.uint64(w) * ys + np.uint64(w * w) * zs
    ids[:3] = (0, w ** 3 - 1, (1 << 63) + 7)
    algo, ver = CODECS[name]
    seg = mnw.Seg(fields=[_field(mnw.FieldCode.PTID, algo, ver, ids,
                                 mnw.IDAccuracy(width=w))])
    _, dec = _check(seg)
    np.testing.assert_array_equal(dec.fields[0].data.numpy().view(np.uint64),
                                  ids)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_deltas_fields_match_jax(name):
    """Per-particle accuracies: Deltas-mode position and UNSF fields take
    Trim v1.0's variable-width planes under every Sort and Cart version."""
    _check(deltas_segment(*CODECS[name]), seed=888)


@pytest.mark.parametrize("name", sorted(CODECS))
def test_log_maps_within_contract(name):
    """Symlog velocities and log10 masses through Sort and Cart, held to
    ROADMAP.md queue 3's contract by decode; fused == generic."""
    algo, ver = CODECS[name]
    _check_log_segment(log_segment(ver, 1000, 20.0, seed=11, algo=algo),
                       20.0)


def test_transcode_to_sort_and_cart_matches_jax():
    seg = sort_segment(mnw.AlgoCode.TRIM, SV(1, 0, 0), 1000, seed=12)
    trim = japi.compress_segment(seg, seed=SEED)
    for algo, ver in CODECS.values():
        assert mt.transcode_segment(trim, algo, ver, device="cpu") == \
            japi.transcode_segment(trim, algo, ver)


# ---------------------------------------------------------------------------
# Sort v1.2: the order-free profile and the 16384-element chunks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_order_free_unsi_and_unsf_match_jax(n):
    """Order-free UNSI (permuted IDs, as the frozen fixture) and UNSF
    (with ties): the same bytes, and the values back in ascending order."""
    rng = np.random.default_rng(20 + n)
    ui = (rng.permutation(1 << 18)[:n] + 3).astype(np.uint64)
    _, dec = _check(unsi_segment(mnw.AlgoCode.SORT, ORDER_FREE, ui))
    np.testing.assert_array_equal(dec.fields[0].data.numpy().view(np.uint64),
                                  np.sort(ui))
    uf = rng.choice(np.array([0.5, 1.0, 1.25, 3.0], np.float32), n)
    _check(mnw.Seg(fields=[_field(mnw.FieldCode.UNSF, mnw.AlgoCode.SORT,
                                  ORDER_FREE, uf,
                                  mnw.FloatAccuracy(delta=1e-3))]))


def test_order_free_errors_match_jax():
    """A 3-dim field, and an UNSI range past 2^32, raise JAX's errors; the
    shared codec instance keeps encoding ranked streams afterwards."""
    n = 100
    seg = sort_segment(mnw.AlgoCode.SORT, ORDER_FREE, n, seed=30)
    wide = unsi_segment(mnw.AlgoCode.SORT, ORDER_FREE,
                        np.arange(n, dtype=np.uint64) << np.uint64(30))
    for bad, match in ((mnw.Seg(fields=seg.fields[:1]), "single-plane"),
                       (wide, "exceeds 2\\^32")):
        with pytest.raises(ValueError, match=match) as want:
            japi.compress_segment(bad)
        with pytest.raises(ValueError, match=match) as got:
            mt.compress_segment(interop.seg_from_reference(bad),
                                device="cpu")
        assert str(got.value) == str(want.value)
    _check(sort_segment(*CODECS["sort_v1_2"], n, seed=31))


def test_order_free_state_stays_off_the_registered_instance():
    codec = registry.get(mt.AlgoCode.SORT, mt.semver.pack(1, 2, 0))
    seg = unsi_segment(mnw.AlgoCode.SORT, ORDER_FREE,
                       np.arange(64, 0, -1, dtype=np.uint64))
    mt.compress_segment(interop.seg_from_reference(seg), device="cpu")
    assert codec._order_free is False and "_order_free" not in vars(codec)


def test_sort_v1_2_rejects_bad_chunk_log2():
    codec = registry.get(mt.AlgoCode.SORT, mt.semver.pack(1, 2, 0))
    for log2 in (7, 18):
        payload = np.array([1, 0, 0, 0, log2], np.uint32)
        with pytest.raises(ValueError, match="chunk_log2"):
            codec._decode_plane(payload, 0, 100, "cpu")


@pytest.mark.parametrize("ver", [SV(1, 2, 0), ORDER_FREE],
                         ids=["ranked", "order-free"])
def test_kernel_chunks_match_jax(ver, monkeypatch):
    """BIG_PLANE at 30000 in both packages (Coil v1.1's and Sort v1.2's
    names): 40000-element planes take the 16384-element chunks, which the
    port decodes through K10's plain version -- the sorted deltas without
    un-zigzag, the ranks with it."""
    for mod in (jcoil11, jsort12, tcoil11, tsort12):
        monkeypatch.setattr(mod, "BIG_PLANE", 30000)
    plain = chunked_cuda.decode_chunked_stream_plain
    calls = []

    def counted(*args, **kwargs):
        calls.append(kwargs.get("zigzag", args[5] if len(args) > 5 else True))
        return plain(*args, **kwargs)

    monkeypatch.setattr(chunked_cuda, "decode_chunked_stream_plain", counted)
    n = 40000
    if ver == ORDER_FREE:
        rng = np.random.default_rng(40)
        vals = (rng.permutation(1 << 20)[:n] + 3).astype(np.uint64)
        _check(unsi_segment(mnw.AlgoCode.SORT, ver, vals))
        assert calls == [False, False]      # generic and fused decode
    else:
        _check(sort_segment(mnw.AlgoCode.SORT, ver, n, seed=41))
        assert False in calls and True in calls


def test_kernel_path_equals_generic(monkeypatch):
    """On every plane of a 16384-chunk stream, K10's plain version (which
    adds ``first`` to the encoder's zero placeholder) gives the generic
    decode's bits (which zeroes element 0 first)."""
    monkeypatch.setattr(tsort12, "BIG_PLANE", 30000)
    rng = np.random.default_rng(42)
    n = 40000
    bins = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    bins[::5] = bins[3]
    order, first, deltas = tsort12.sort_plane(_u32_tensor(bins))
    ranks = tsort12.ranks_of(order)
    rz = kernels.u32_delta_zigzag(ranks)
    rz[0] = 0
    chunk = tsort12.KERNEL_CHUNK
    out = []
    for z, start, zigzag in ((deltas, first, False),
                             (rz, int(ranks[0]), True)):
        widths, body = tsort12.encode_chunked(z, chunk)
        words = np.frombuffer(body, np.uint32)
        k10 = tsort12.decode_chunked(words, widths, start, chunk, n, zigzag,
                                     "cpu")
        gen = tsort12.decode_chunked_generic(words, widths, start, chunk, n,
                                             zigzag, "cpu")
        assert _same_bytes(k10, gen)
        out.append(k10)
    assert _same_bytes(out[1], ranks)
    np.testing.assert_array_equal(
        tsort12.unpermute(*out).numpy().view(np.uint32), bins)


def test_interop_carries_sort_headers_and_patch():
    seg = unsi_segment(mnw.AlgoCode.SORT, ORDER_FREE,
                       np.arange(10, dtype=np.uint64))
    f = interop.seg_from_reference(seg).fields[0]
    assert (f.hd.algo_code, f.hd.algo_version) == (int(mnw.AlgoCode.SORT),
                                                   ORDER_FREE)
    assert mt.semver.patch(f.hd.algo_version) == tsort12.ORDER_FREE_PATCH
    acc = dataclasses.asdict(f.acc)
    assert acc == dataclasses.asdict(mt.IntAccuracy())
