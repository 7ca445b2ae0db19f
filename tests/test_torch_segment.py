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
from test_freeze import FIXTURE, reference_segment

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERSIONS = {"trim": mt.semver.pack(1, 0, 0),
            "trim_v1_1": mt.semver.pack(1, 1, 0)}
SEED = 777


def _digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        d = f.data.numpy() if isinstance(f.data, torch.Tensor) \
            else np.asarray(f.data)
        h.update(np.ascontiguousarray(d).tobytes())
    return h.hexdigest()


def _same_bytes(a, b) -> bool:
    """Decoded field data compared as raw bytes (u64 IDs decode to int64
    tensors in the port: same bytes below 2^63)."""
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
    return {name: japi.compress_segment(
        reference_segment(mnw.AlgoCode.TRIM, ver), seed=SEED)
        for name, ver in VERSIONS.items()}


def _port_blob(name, scale_mode="div"):
    seg = interop.seg_from_reference(
        reference_segment(mnw.AlgoCode.TRIM, VERSIONS[name]))
    return mt.compress_segment(seg, seed=SEED, scale_mode=scale_mode)


@pytest.mark.parametrize("name", sorted(VERSIONS))
def test_encode_matches_jax_and_fixture(name, jax_blobs, fixture_digests):
    blob = _port_blob(name)
    assert blob == jax_blobs[name]
    assert hashlib.sha256(blob).hexdigest() == \
        fixture_digests[f"{name}_encode_sha256"]
    assert len(blob) == fixture_digests[f"{name}_bytes"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", sorted(VERSIONS))
def test_decode_matches_fixture(name, fused, jax_blobs, fixture_digests):
    seg = mt.decompress_segment(jax_blobs[name], fused=fused)
    assert _digest(seg) == fixture_digests[f"{name}_decode_sha256"]


@pytest.mark.parametrize("fused", [False, True])
def test_cross_decode_both_directions(fused, jax_blobs):
    """JAX bytes decode in the port, and port bytes in JAX, to the same
    arrays as the writer's own package."""
    jblob = jax_blobs["trim"]
    pblob = _port_blob("trim", "recip")  # a second stream: the recip map
    for blob in (jblob, pblob):
        ref = japi.decompress_segment(blob, fused=fused)
        got = mt.decompress_segment(blob, fused=fused)
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
    got = mt.decompress_segment(blob, fused=fused)
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
    qs = tapi.decompress(cs)
    assert [qf.valid for qf in qs.fields] == [True, True, False, True, True]
    seg = tapi.undo_quantize(qs)
    assert not seg.fields[2].valid and seg.fields[2].data is None


@pytest.mark.parametrize("fused", [False, True])
def test_field_filter_matches_full_decode(fused, jax_blobs):
    blob = jax_blobs["trim"]
    full = mt.decompress_segment(blob, fused=fused)
    only = mt.decompress_segment(blob, fused=fused,
                                 fields={mt.FieldCode.POSN})
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
    blob = mt.compress_segment(interop.seg_from_reference(seg))
    assert blob == japi.compress_segment(seg)
    got = mt.decompress_segment(blob).fields[0].data
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().view(np.uint64), ui)


def test_transcode_matches_jax(jax_blobs):
    v11 = VERSIONS["trim_v1_1"]
    assert mt.transcode_segment(jax_blobs["trim"], mt.AlgoCode.TRIM, v11) \
        == japi.transcode_segment(jax_blobs["trim"], mnw.AlgoCode.TRIM, v11)


def test_unported_modes_raise():
    n = 64
    hd = mt.FieldHeader(mt.FieldCode.UNSF, mt.AlgoCode.TRIM,
                        VERSIONS["trim"], n)
    x = np.linspace(1, 2, n, dtype=np.float32)
    deltas = mt.Field(hd=hd, data=x, acc=mt.FloatAccuracy(
        delta=0.0, deltas=np.full(n, 1e-3, np.float32)))
    log10 = mt.Field(hd=hd, data=x, acc=mt.FloatAccuracy(delta=1e-3,
                                                         log10_scaled=1))
    for f in (deltas, log10):
        with pytest.raises(NotImplementedError):
            mt.compress_segment(mt.Seg(fields=[f]))
    hd_i = mt.FieldHeader(mt.FieldCode.UNSI, mt.AlgoCode.TRIM,
                          VERSIONS["trim"], 2)
    big = mt.Field(hd=hd_i, data=np.array([1, 1 << 63], dtype=np.uint64),
                   acc=mt.IntAccuracy())
    with pytest.raises(ValueError):
        mt.compress_segment(mt.Seg(fields=[big]))


def test_import_leaves_jax_out():
    code = ("import sys, minnow_c_tpu_torch; "
            "print('jax' in sys.modules, 'minnow_c_tpu' in sys.modules)")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["False", "False"]


COPIED = ["types.py", "semver.py", "segment/stream.py", "segment/format.py",
          "ops/checksum.py", "ops/entropy.py", "algos/blocks.py",
          "algos/registry.py", "utils/debug.py"]


@pytest.mark.parametrize("path", COPIED)
def test_host_modules_are_unchanged_copies(path):
    """Host-only modules move over unchanged (relative imports only), so
    the two packages cannot drift apart on the wire's host side."""
    with open(os.path.join(REPO, "minnow_c_tpu", path), "rb") as f:
        ref = f.read()
    with open(os.path.join(REPO, "minnow_c_tpu_torch", path), "rb") as f:
        assert f.read() == ref
