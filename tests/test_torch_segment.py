"""The torch port's segment path against the JAX package and the frozen
wire, on the CPU.

The segments are the freeze test's ``reference_segment`` (numpy data from
fixed seeds), carried across with ``interop.seg_from_reference``.  The
fixture ``tests/fixtures/wire_digests.json`` is only read.  Tolerance:
bitwise equality throughout -- segment bytes, digests, and decoded arrays
compared as raw bytes.
"""

import hashlib
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.segment import api as tapi
from test_freeze import FIXTURE, deltas_segment, reference_segment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERSIONS = {"trim": mt.semver.pack(1, 0, 0),
            "trim_v1_1": mt.semver.pack(1, 1, 0)}
SEED = 777
# the freeze test's Deltas-mode segments (per-particle accuracies) and seed
DELTAS = {"trim_deltas": VERSIONS["trim"],
          "trim_v1_1_deltas": VERSIONS["trim_v1_1"]}
DELTAS_SEED = 888


def _frozen_segment(name):
    """The freeze test's segment and seed behind fixture entry ``name``."""
    if name in DELTAS:
        return deltas_segment(mnw.AlgoCode.TRIM, DELTAS[name]), DELTAS_SEED
    return reference_segment(mnw.AlgoCode.TRIM, VERSIONS[name]), SEED


def _digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        d = f.data.numpy() if isinstance(f.data, torch.Tensor) \
            else np.asarray(f.data)
        h.update(np.ascontiguousarray(d).tobytes())
    return h.hexdigest()


def _same_bytes(a, b) -> bool:
    """Decoded field data compared as raw bytes (u64 IDs decode to int64
    tensors of the same bits in the port)."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


@pytest.fixture(scope="module")
def fixture_digests():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_blobs():
    return {name: japi.compress_segment(*_frozen_segment(name))
            for name in [*VERSIONS, *DELTAS]}


def _port_blob(name, scale_mode="div"):
    seg, seed = _frozen_segment(name)
    return mt.compress_segment(interop.seg_from_reference(seg), seed=seed,
                               scale_mode=scale_mode, device="cpu")


@pytest.mark.parametrize("name", sorted([*VERSIONS, *DELTAS]))
def test_encode_matches_jax_and_fixture(name, jax_blobs, fixture_digests):
    blob = _port_blob(name)
    assert blob == jax_blobs[name]
    assert hashlib.sha256(blob).hexdigest() == \
        fixture_digests[f"{name}_encode_sha256"]
    assert len(blob) == fixture_digests[f"{name}_bytes"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted([*VERSIONS, *DELTAS]))
def test_decode_matches_fixture(name, fused, jax_blobs, fixture_digests):
    seg = mt.decompress_segment(jax_blobs[name], fused=fused, device="cpu")
    assert _digest(seg) == fixture_digests[f"{name}_decode_sha256"]


def test_port_covers_all_42_frozen_entries(fixture_digests):
    """The port's digest tests pin all 42 of the fixture's entries:
    tests/test_torch_freeze.py every one of them (Sort and Cart
    included), this file's Trim and Deltas entries and
    tests/test_torch_delta.py's delta codecs again beside the JAX
    package."""
    from test_torch_delta import CODECS
    from test_torch_freeze import NAMES

    def keys(names):
        return {f"{n}_{k}" for n in names
                for k in ("encode_sha256", "decode_sha256", "bytes")}
    assert len(fixture_digests) == 42
    assert len(keys(NAMES)) == 42 and keys(NAMES) == set(fixture_digests)
    assert keys([*VERSIONS, *DELTAS, *CODECS]) <= keys(NAMES)


@pytest.mark.parametrize("fused", [False, True])
def test_cross_decode_both_directions(fused, jax_blobs):
    """JAX bytes decode in the port, and port bytes in JAX, to the same
    arrays as the writer's own package."""
    jblob = jax_blobs["trim"]
    pblob = _port_blob("trim", "recip")  # a second stream: the recip map
    for blob in (jblob, pblob):
        ref = japi.decompress_segment(blob, fused=fused)
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        for a, b in zip(ref.fields, got.fields):
            assert _same_bytes(a.data, b.data), hex(a.hd.field_code)
            assert a.valid and b.valid


def test_recip_mode_matches_jax():
    seg = reference_segment(mnw.AlgoCode.TRIM, VERSIONS["trim"])
    assert _port_blob("trim", "recip") == japi.compress_segment(
        seg, seed=SEED, scale_mode="recip")


def _flip_block_byte(blob: bytes, block: int) -> bytes:
    """Flip one payload byte of the ``block``-th block of a segment."""
    n_blocks, n_fields = struct.unpack_from("<ii", blob, 4)
    hdr = 16 + 16 * n_fields
    lengths = [struct.unpack_from("<I", blob, hdr + 8 * i)[0]
               for i in range(n_blocks)]
    off = hdr + 8 * n_blocks + sum(lengths[:block]) + 20
    b = bytearray(blob)
    b[off] ^= 0xFF
    return bytes(b)


@pytest.mark.parametrize("fused", [False, True])
def test_corrupt_block_is_skipped_not_fatal(fused, jax_blobs):
    """A block failing its checksum invalidates only what it holds: POSN's
    Y plane comes back NaN with valid=False (as in the JAX package); the
    UNSI data block invalidates that field."""
    blob = _flip_block_byte(jax_blobs["trim"], 2)   # POSN dimY
    blob = _flip_block_byte(blob, 15)               # UNSI lo plane
    got = mt.decompress_segment(blob, fused=fused, device="cpu")
    ref = japi.decompress_segment(blob, fused=fused)
    pos = got.fields[0]
    assert not pos.valid
    assert torch.isnan(pos.data[1]).all()
    assert not torch.isnan(pos.data[0]).any()
    assert _same_bytes(pos.data, ref.fields[0].data)
    assert got.fields[1].valid and _same_bytes(got.fields[1].data,
                                               ref.fields[1].data)
    assert not got.fields[4].valid and got.fields[4].data is None


def test_corrupt_field_checksum_gives_invalid_field(jax_blobs):
    cs = tapi.wire_to_cseg(jax_blobs["trim"])
    cs.fields[2].checksum ^= 1
    qs = tapi.decompress(cs, device="cpu")
    assert [qf.valid for qf in qs.fields] == [True, True, False, True, True]
    seg = tapi.undo_quantize(qs)
    assert not seg.fields[2].valid and seg.fields[2].data is None


@pytest.mark.parametrize("fused", [False, True])
def test_field_filter_matches_full_decode(fused, jax_blobs):
    blob = jax_blobs["trim"]
    full = mt.decompress_segment(blob, fused=fused, device="cpu")
    only = mt.decompress_segment(blob, fused=fused,
                                 fields={mt.FieldCode.POSN}, device="cpu")
    assert _same_bytes(only.fields[0].data, full.fields[0].data)
    assert all(f is None for f in only.fields[1:])


def test_wide_unsi_range_matches_jax():
    """An UNSI range above 2^32 takes the split lo/hi planes."""
    n = 1000
    ui = np.random.default_rng(6).integers(
        0, 1 << 40, n, dtype=np.uint64) + np.uint64(1 << 50)
    hd = mnw.FieldHeader(mnw.FieldCode.UNSI, mnw.AlgoCode.TRIM,
                         VERSIONS["trim"], n)
    seg = mnw.Seg(fields=[mnw.Field(hd=hd, data=ui, acc=mnw.IntAccuracy())])
    blob = mt.compress_segment(interop.seg_from_reference(seg), device="cpu")
    assert blob == japi.compress_segment(seg)
    got = mt.decompress_segment(blob, device="cpu").fields[0].data
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ui)


def test_transcode_matches_jax(jax_blobs):
    v11 = VERSIONS["trim_v1_1"]
    assert mt.transcode_segment(jax_blobs["trim"], mt.AlgoCode.TRIM, v11,
                                device="cpu") \
        == japi.transcode_segment(jax_blobs["trim"], mnw.AlgoCode.TRIM, v11)


def test_unported_modes_raise():
    """Deltas mode and the log10 map, once refused, are ported: the
    Deltas field's bytes are JAX's; the log10 field decodes within its
    mapped-space accuracy (its bits follow torch's log,
    tests/test_torch_logmaps.py)."""
    n = 64
    hd = mt.FieldHeader(mt.FieldCode.UNSF, mt.AlgoCode.TRIM,
                        VERSIONS["trim"], n)
    jhd = mnw.FieldHeader(mnw.FieldCode.UNSF, mnw.AlgoCode.TRIM,
                          VERSIONS["trim"], n)
    x = np.linspace(1, 2, n, dtype=np.float32)
    dl = np.full(n, 1e-3, np.float32)
    deltas = mt.Field(hd=hd, data=x, acc=mt.FloatAccuracy(delta=0.0,
                                                          deltas=dl))
    assert mt.compress_segment(mt.Seg(fields=[deltas]), device="cpu") == \
        japi.compress_segment(mnw.Seg(fields=[mnw.Field(
            hd=jhd, data=x, acc=mnw.FloatAccuracy(delta=0.0, deltas=dl))]))
    log10 = mt.Field(hd=hd, data=x, acc=mt.FloatAccuracy(delta=1e-3,
                                                         log10_scaled=1))
    blob = mt.compress_segment(mt.Seg(fields=[log10]), device="cpu")
    got = mt.decompress_segment(blob, device="cpu").fields[0].data.numpy()
    err = np.abs(np.log10(got.astype(np.float64)) - np.log10(x))
    assert err.max() <= 1e-3 + 1.2e-6
    # u64 values past 2^63 are ported: they round-trip as u64 bits
    hd_i = mt.FieldHeader(mt.FieldCode.UNSI, mt.AlgoCode.TRIM,
                          VERSIONS["trim"], 2)
    big_v = np.array([1, 1 << 63], dtype=np.uint64)
    big = mt.Field(hd=hd_i, data=big_v, acc=mt.IntAccuracy())
    blob = mt.compress_segment(mt.Seg(fields=[big]), device="cpu")
    got = mt.decompress_segment(blob, device="cpu").fields[0].data
    np.testing.assert_array_equal(got.numpy().view(np.uint64), big_v)


# u64 fields over their whole range: the port holds them as int64 tensors of
# the same bits, and must write and read what the JAX package writes and
# reads as uint64.

def _unsi_values(case: str) -> np.ndarray:
    rng = np.random.default_rng(len(case))
    if case == "edges":
        return np.array([1, (1 << 63) + 12345, (1 << 64) - 1], np.uint64)
    if case == "one_plane_near_top":     # range <= 2^32 just below 2^64
        v = rng.integers(0, 1 << 32, 3000, dtype=np.uint64)
        v[:2] = (0, (1 << 32) - 1)
        return v + np.uint64((1 << 64) - (1 << 32))
    # two planes, range > 2^32 across 2^63
    v = rng.integers(0, 1 << 41, 3000, dtype=np.uint64)
    return v + np.uint64((1 << 63) - (1 << 40))


def _id_values(w: int, n: int = 3000) -> np.ndarray:
    """IDs on a grid of width w: x and z hugging the grid's seam, y
    anywhere, and 0, w^3 - 1 and 2^63 + 7 (an ID with its top bit set)."""
    rng = np.random.default_rng(w)
    xs = rng.integers(w - 6, w + 6, n) % w
    ys = rng.integers(0, w, n)
    zs = rng.integers(w - 3, w + 3, n) % w
    ids = np.array([int(x) + w * int(y) + w * w * int(z)
                    for x, y, z in zip(xs, ys, zs)], np.uint64)
    ids[:3] = (0, w ** 3 - 1, (1 << 63) + 7)
    return ids


def _check_u64_segment(code, algo, version, data, acc):
    """Port and JAX encodes are byte-identical, and either package's
    segment decodes in both to the input's u64 bits (generic and fused)."""
    hd = mnw.FieldHeader(code, algo, version, data.size)
    seg = mnw.Seg(fields=[mnw.Field(hd=hd, data=data, acc=acc)])
    blob = japi.compress_segment(seg)
    assert mt.compress_segment(interop.seg_from_reference(seg),
                               device="cpu") == blob
    assert np.array_equal(
        np.asarray(japi.decompress_segment(blob).fields[0].data), data)
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        assert got.fields[0].data.dtype == torch.int64
        assert np.array_equal(got.fields[0].data.numpy().view(np.uint64),
                              data)
    # an int64 tensor of the same bits is read as the same u64 values
    tseg = mt.Seg(fields=[mt.Field(
        hd=mt.FieldHeader(code, algo, version, data.size),
        data=torch.from_numpy(data.view(np.int64)),
        acc=interop.seg_from_reference(seg).fields[0].acc)])
    assert mt.compress_segment(tseg, device="cpu") == blob


@pytest.mark.parametrize("name", sorted(VERSIONS))
@pytest.mark.parametrize("case", ["edges", "one_plane_near_top",
                                  "two_planes_across_2_63"])
def test_u64_unsi_matches_jax(case, name):
    _check_u64_segment(mnw.FieldCode.UNSI, mnw.AlgoCode.TRIM, VERSIONS[name],
                       _unsi_values(case), mnw.IntAccuracy())


ID_CODECS = [("TRIM", (1, 0, 0)), ("TRIM", (1, 1, 0)), ("DIFF", (1, 0, 0)),
             ("COIL", (1, 0, 0)), ("COIL", (1, 1, 0)), ("OCTO", (1, 0, 0)),
             ("OCTO", (1, 1, 0))]


@pytest.mark.parametrize("algo, version", ID_CODECS)
@pytest.mark.parametrize("w", [(1 << 21) + 5, 2642245])
def test_u64_ptid_matches_jax(w, algo, version):
    """ID grids past 2^21 a side, up to 2642245 (the largest w with
    w^3 <= 2^64): the grid split divides u64 values, and the recombine's
    w * w * z passes 2^63."""
    _check_u64_segment(mnw.FieldCode.PTID, getattr(mnw.AlgoCode, algo),
                       mnw.semver.pack(*version), _id_values(w),
                       mnw.IDAccuracy(width=w))


def test_ptid_width_past_the_cube_root_of_2_64_matches_jax():
    """A grid of width 2^22 (w^3 > 2^64): the reference's u64 arithmetic
    wraps and still returns the IDs, and so does the port's."""
    ids = np.arange(0, 7 * 3000, 7, dtype=np.uint64)
    ids[:2] = ((1 << 63) + 7, (1 << 64) - 1)
    _check_u64_segment(mnw.FieldCode.PTID, mnw.AlgoCode.TRIM,
                       VERSIONS["trim"], ids, mnw.IDAccuracy(width=1 << 22))


@pytest.mark.parametrize("w", [(1 << 32) + 1, 1 << 32, (1 << 33) + 7,
                               (1 << 62) + 3, (1 << 63) - 1])
def test_ptid_width_past_2_32_matches_jax(w):
    """Grids wider than 2^32 a side: the reference's w * w wraps mod 2^64
    (to 0 at w = 2^32, where XLA's quotient is all ones) and its u32 bins
    keep the low 32 bits of each coordinate, so the IDs do not come back;
    the port splits, writes and reads them to the reference's bits all the
    same.  Where a dimension's range needs more than 32 bits both packages
    refuse to write the segment."""
    import jax.numpy as jnp
    from minnow_c_tpu.quant import engine as jengine
    from minnow_c_tpu_torch.quant import engine as tengine
    ids = np.random.default_rng(w % 1000).integers(0, 1 << 64, 3000,
                                                   dtype=np.uint64)
    ids[:4] = (0, w - 1, (1 << 63) + 7, (1 << 64) - 1)
    want = jengine.id_decompose(jnp.asarray(ids, dtype=jnp.uint64), w)
    got = tengine.id_decompose(torch.from_numpy(ids.view(np.int64)), w)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy().view(np.uint64),
                                      np.asarray(b))
    hd = mnw.FieldHeader(mnw.FieldCode.PTID, mnw.AlgoCode.TRIM,
                         VERSIONS["trim"], ids.size)
    seg = mnw.Seg(fields=[mnw.Field(hd=hd, data=ids,
                                    acc=mnw.IDAccuracy(width=w))])
    tseg = interop.seg_from_reference(seg)
    if w > 1 << 33:
        with pytest.raises(OverflowError):
            japi.compress_segment(seg)
        with pytest.raises(ValueError, match="width"):
            mt.compress_segment(tseg, device="cpu")
        return
    blob = japi.compress_segment(seg)
    assert mt.compress_segment(tseg, device="cpu") == blob
    ref = np.asarray(japi.decompress_segment(blob).fields[0].data)
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        np.testing.assert_array_equal(
            got.fields[0].data.numpy().view(np.uint64), ref)


def test_ptid_width_from_2_63_raises():
    """The reference's signed unwrap takes grid widths below 2^63; the port
    refuses the rest before any work."""
    from minnow_c_tpu_torch.quant import engine as tengine
    ids = torch.arange(8, dtype=torch.int64)
    for w in (0, 1 << 63, (1 << 64) - 1):
        with pytest.raises(ValueError, match="ID grid width"):
            tengine.id_decompose(ids, w)


def test_import_leaves_jax_out():
    code = ("import sys, minnow_c_tpu_torch, "
            "minnow_c_tpu_torch.parallel.snapshot, "
            "minnow_c_tpu_torch.parallel.sharding, "
            "minnow_c_tpu_torch.parallel.multihost, "
            "minnow_c_tpu_torch.algos.algo_sort_v1_0, "
            "minnow_c_tpu_torch.algos.algo_sort_v1_1, "
            "minnow_c_tpu_torch.algos.algo_sort_v1_2, "
            "minnow_c_tpu_torch.algos.algo_cart_v1_0, "
            "minnow_c_tpu_torch.drivers.illustris, "
            "minnow_c_tpu_torch.__main__, "
            "minnow_c_tpu_torch.entry, "
            "minnow_c_tpu_torch.bench.harness, "
            "minnow_c_tpu_torch.bench.records, "
            "minnow_c_tpu_torch.bench.counts, "
            "minnow_c_tpu_torch.bench.headline, "
            "minnow_c_tpu_torch.bench.kernel_suite, "
            "minnow_c_tpu_torch.bench.codec_suite, "
            "minnow_c_tpu_torch.bench.matrix, "
            "minnow_c_tpu_torch.bench.__main__; "
            "print('jax' in sys.modules, 'minnow_c_tpu' in sys.modules, "
            "'h5py' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False", "False"]


COPIED = ["types.py", "semver.py", "segment/stream.py", "segment/format.py",
          "segment/io.py", "ops/checksum.py", "ops/entropy.py",
          "algos/blocks.py", "algos/registry.py", "utils/debug.py",
          "native/minnow_native.cpp", "bench/records.py"]


@pytest.mark.parametrize("path", COPIED)
def test_host_modules_are_unchanged_copies(path):
    """Host-only modules move over unchanged (relative imports only), so
    the two packages cannot drift apart on the wire's host side."""
    with open(os.path.join(REPO, "minnow_c_tpu", path), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "minnow_c_tpu_torch", path), "rb") as f:
        assert f.read() == ref


def _entry_points():
    from minnow_c_tpu_torch.drivers import gadget2, illustris
    from minnow_c_tpu_torch.parallel import snapshot
    from minnow_c_tpu_torch.quant import engine
    return {"api.quantize": tapi.quantize, "api.decompress": tapi.decompress,
            "transcode_segment": tapi.transcode_segment,
            "compress_segment": tapi.compress_segment,
            "decompress_segment": tapi.decompress_segment,
            "compress_snapshot": snapshot.compress_snapshot,
            "compress_snapshot_streaming":
                snapshot.compress_snapshot_streaming,
            "decompress_snapshot": snapshot.decompress_snapshot,
            "gadget2.compress": gadget2.compress,
            "gadget2.decompress": gadget2.decompress,
            "decode_segments": snapshot.decode_segments,
            "illustris.compress": illustris.compress,
            "illustris.compress_multi": illustris.compress_multi,
            "illustris.decompress": illustris.decompress,
            "engine.quantize": engine.quantize}


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Every public entry point runs on the card unless the caller asks
    for the CPU."""
    import inspect
    param = inspect.signature(_entry_points()[name]).parameters["device"]
    assert param.default == "cuda"


def test_numpy_input_without_a_device_goes_to_the_card():
    """Numpy data with no ``device`` goes to ``cuda``: without a card the
    call fails as torch fails on ``.to("cuda")``, never quietly on the
    CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    n = 64
    hd = mt.FieldHeader(mt.FieldCode.UNSF, mt.AlgoCode.TRIM,
                        VERSIONS["trim"], n)
    f = mt.Field(hd=hd, data=np.linspace(1, 2, n, dtype=np.float32),
                 acc=mt.FloatAccuracy(delta=1e-3))
    with pytest.raises((AssertionError, RuntimeError)):
        mt.compress_segment(mt.Seg(fields=[f]))
    blob = mt.compress_segment(mt.Seg(fields=[f]), device="cpu")
    with pytest.raises((AssertionError, RuntimeError)):
        mt.decompress_segment(blob)
