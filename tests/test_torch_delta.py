"""The torch port's delta codecs (Diff v1.0, Coil v1.0 / v1.1, Octo v1.0 /
v1.1) and their kernels' plain versions against the JAX package, on the
CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
The JAX package's Pallas kernels (``scan_pallas.cumsum_u32``,
``chunked_pallas.decode_chunked_stream`` / ``_floats``) run in interpret
mode; the port's kernel wrappers run their plain torch versions, since the
tensors are on the CPU.  The fixture ``tests/fixtures/wire_digests.json``
is only read.  Tolerance: bitwise equality throughout -- bytes, digests, and
decoded arrays compared as raw bytes.
"""

import hashlib
import json
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.algos import algo_coil_v1_1 as jcoil11
from minnow_c_tpu.algos import chunked as jchunked
from minnow_c_tpu.ops import chunked_pallas, scan_pallas
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu_torch import interop
from minnow_c_tpu_torch.algos import algo_coil_v1_1 as tcoil11
from minnow_c_tpu_torch.algos import chunked
from minnow_c_tpu_torch.ops import chunked_cuda, kernels, scan_cuda
from test_freeze import ALGOS, FIXTURE, reference_segment

CODECS = ["diff", "coil", "coil_v1_1", "octo", "octo_v1_1"]
CHUNK = chunked_cuda.KERNEL_CHUNK
SEED = 777


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _u32_tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.uint32).view(np.int32))


def _same_bytes(a, b) -> bool:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    return a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def _digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        d = f.data.numpy() if isinstance(f.data, torch.Tensor) \
            else np.asarray(f.data)
        h.update(np.ascontiguousarray(d).tobytes())
    return h.hexdigest()


def _u32(rng, n, bits=32):
    return rng.integers(0, 1 << bits, n, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# zigzag ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits", [8, 31, 32])
def test_zigzag_ops_match_jax(bits):
    """Full-range values make deltas of magnitude >= 2^30 and int32 wraps;
    the unzigzag must shift logically."""
    rng = np.random.default_rng(bits)
    b = _u32(rng, 5000, bits)
    b[:4] = (0, 0xFFFFFFFF >> (32 - bits), 0, 1 << (bits - 1))
    z = kernels.u32_delta_zigzag(_u32_tensor(b))
    zj = np.asarray(jkernels.u32_delta_zigzag(jnp.asarray(b)))
    np.testing.assert_array_equal(_bits(z), zj)
    zz = _u32(rng, 5000)
    np.testing.assert_array_equal(
        _bits(kernels.u32_unzigzag(_u32_tensor(zz))),
        np.asarray(jkernels.u32_unzigzag(jnp.asarray(zz))))
    back = kernels.u32_undo_delta_zigzag(z)
    np.testing.assert_array_equal(_bits(back), b)
    np.testing.assert_array_equal(
        _bits(back), np.asarray(jkernels.u32_undo_delta_zigzag(
            jnp.asarray(zj))))


# ---------------------------------------------------------------------------
# K9: the u32 scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1 << 14, (1 << 16) + (1 << 14),
                               (1 << 19) + (1 << 14) + 1000, 97])
def test_scan_plain_matches_jax(n):
    x = _u32(np.random.default_rng(n), n)
    ref = np.asarray(scan_pallas.cumsum_u32(jnp.asarray(x), interpret=True))
    np.testing.assert_array_equal(
        _bits(scan_cuda.cumsum_u32_plain(_u32_tensor(x))), ref)
    np.testing.assert_array_equal(
        _bits(scan_cuda.cumsum_u32_auto(_u32_tensor(x))), ref)


def test_scan_kernel_wrapper_needs_a_cuda_tensor():
    with pytest.raises(ValueError, match="device"):
        scan_cuda.cumsum_u32(torch.zeros(8, dtype=torch.int32))


# ---------------------------------------------------------------------------
# K10 / K11: the chunked decode
# ---------------------------------------------------------------------------

def _chunked(pattern, trim, seed=0):
    """zigzag deltas whose chunk c holds values below 2^pattern[c], packed
    as a column-major chunked body by the JAX package's pack; returns
    (body, widths, z, n)."""
    rng = np.random.default_rng(seed)
    z = np.zeros(len(pattern) * CHUNK, np.uint32)
    for c, w in enumerate(pattern):
        if w:
            z[c * CHUNK:(c + 1) * CHUNK] = _u32(rng, CHUNK, w)
            z[c * CHUNK + 3] = (1 << w) - 1
    n = z.size - trim
    zc, widths = jchunked.chunk_widths(z[:n], CHUNK)
    nat = np.frombuffer(jchunked.pack_chunks(zc, widths), dtype=np.uint32)
    parts = []
    off = 0
    for w in widths:
        wpc = CHUNK * int(w) // 32
        parts.append(chunked_pallas.body_to_cmajor(nat[off:off + wpc],
                                                   int(w), CHUNK))
        off += wpc
    return np.concatenate(parts), widths, z[:n], n


PATTERNS = [(7, 15, 7), (24,), (0, 9, 0, 3), (1, 32, 5),
            # two full width-32 chunks, three zero-width chunks trimmed by 3,
            # one element of one chunk, a ragged chunk after a zero one
            (32, 32), (0, 0, 0), (1,), (31, 0, 17)]
# elements cut from the last chunk (default 137)
TRIMS = {(32, 32): 0, (0, 0, 0): 3, (1,): CHUNK - 1, (31, 0, 17): CHUNK - 7}


@pytest.mark.parametrize("first", [12345, (1 << 32) - 5, (1 << 32) - 1])
@pytest.mark.parametrize("pattern", PATTERNS)
def test_chunked_plain_matches_jax(pattern, first):
    body, widths, _, n = _chunked(pattern, TRIMS.get(pattern, 137),
                                  len(pattern))
    ref = np.asarray(chunked_pallas.decode_chunked_stream(
        body, widths, first, CHUNK, n, interpret=True))
    got = chunked_cuda.decode_chunked_stream(_u32_tensor(body), widths,
                                             first, CHUNK, n)
    np.testing.assert_array_equal(_bits(got), ref)


def test_chunked_unpack_only_matches_jax():
    body, widths, z, n = _chunked((5, 0, 11), 64)
    ref = np.asarray(chunked_pallas.decode_chunked_stream(
        body, widths, 0, CHUNK, n, zigzag=False, prefix=False,
        interpret=True))
    got = chunked_cuda.decode_chunked_stream(_u32_tensor(body), widths, 0,
                                             CHUNK, n, zigzag=False,
                                             prefix=False)
    np.testing.assert_array_equal(_bits(got), ref)
    np.testing.assert_array_equal(_bits(got), z)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("depth", [14, 24])
def test_chunked_floats_plain_matches_jax(depth, periodic):
    """K11's plain version equals the JAX floats kernel (interpret) and the
    JAX two-stage route (bins + ``_coil11_undo_tail``), at depth 24 too,
    where every bin below 2^24 converts to f32 exactly."""
    rng = np.random.default_rng(depth)
    n = 2 * CHUNK + 513
    walk = np.cumsum(rng.integers(-40, 41, n), dtype=np.int64)
    bins = ((walk - walk.min()) % (1 << depth)).astype(np.uint32)
    bins[7] = (1 << depth) - 1
    zz = np.asarray(jkernels.u32_delta_zigzag(jnp.asarray(bins))).copy()
    zz[0] = 0
    zc, widths = jchunked.chunk_widths(zz, CHUNK)
    nat = np.frombuffer(jchunked.pack_chunks(zc, widths), dtype=np.uint32)
    body = chunked_cuda.plane_to_cmajor(nat, widths, CHUNK)
    key = (0x9E3779B9, 12345)
    W, x0, dx = 64.0, (-2.0 if periodic else 0.25), 63.0
    args = (body, widths, int(bins[0]), CHUNK, n)
    ref = np.asarray(chunked_pallas.decode_chunked_stream_floats(
        *args, np.asarray(key, np.uint32), depth, x0, dx, W, periodic,
        interpret=True))
    two_stage = np.asarray(jcoil11._coil11_undo_tail(
        jnp.asarray(bins), jnp.asarray(key, jnp.uint32), n, depth, x0, dx,
        jnp.float32(W), periodic))
    got = chunked_cuda.decode_chunked_stream_floats(
        _u32_tensor(body), *args[1:], key, depth, x0, dx, W, periodic)
    np.testing.assert_array_equal(_bits(ref), _bits(two_stage))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("periodic", [False, True])
def test_chunked_floats_high_bins_follow_the_xla_tail(periodic):
    """Bins >= 2^31 (a width-32 chunk; only a corrupt stream holds them,
    since an encoder writes bins below 2^depth <= 2^24).  The JAX package's
    two float tails part there: its XLA tail turns a bin into f32 as a u32
    (``bins.astype(jnp.float32)``, ``algo_coil_v1_1.py:166``), its Pallas
    kernel through int32 (``bins_lm.astype(jnp.int32)``,
    ``chunked_pallas.py:70``).  The port follows the XLA tail, so its fused
    and generic decodes agree: its K11 equals ``_coil11_undo_tail`` bitwise,
    and the Pallas kernel differs from both."""
    rng = np.random.default_rng(31)
    n = CHUNK + 700
    bins = (rng.integers(0, 1 << 31, n, dtype=np.uint64) +
            (1 << 31)).astype(np.uint32)
    zz = np.asarray(jkernels.u32_delta_zigzag(jnp.asarray(bins))).copy()
    zz[0] = 0
    zc, widths = jchunked.chunk_widths(zz, CHUNK)
    assert widths.max() == 32
    nat = np.frombuffer(jchunked.pack_chunks(zc, widths), dtype=np.uint32)
    body = chunked_cuda.plane_to_cmajor(nat, widths, CHUNK)
    key, depth, W = (0x9E3779B9, 12345), 24, 64.0
    x0, dx = (-2.0, 68.0) if periodic else (0.25, 63.0)
    args = (body, widths, int(bins[0]), CHUNK, n)
    xla = np.asarray(jcoil11._coil11_undo_tail(
        jnp.asarray(bins), jnp.asarray(key, jnp.uint32), n, depth, x0, dx,
        jnp.float32(W), periodic))
    pallas = np.asarray(chunked_pallas.decode_chunked_stream_floats(
        *args, np.asarray(key, np.uint32), depth, x0, dx, W, periodic,
        interpret=True))
    got = chunked_cuda.decode_chunked_stream_floats(
        _u32_tensor(body), *args[1:], key, depth, x0, dx, W, periodic)
    np.testing.assert_array_equal(_bits(got), _bits(xla))
    assert (_bits(pallas) != _bits(xla)).sum() > n // 2


def test_cmajor_helpers_match_jax():
    rng = np.random.default_rng(3)
    for w in (1, 7, 32):
        nat = _u32(rng, CHUNK * w // 32)
        cm = chunked_cuda.body_to_cmajor(nat, w, CHUNK)
        np.testing.assert_array_equal(
            cm, chunked_pallas.body_to_cmajor(nat, w, CHUNK))
        np.testing.assert_array_equal(
            chunked_cuda.body_from_cmajor(cm, w, CHUNK), nat)


@pytest.mark.parametrize("case", ["width", "short", "chunk", "n"])
def test_chunked_rejects_malformed_streams(case):
    body = torch.zeros(4096, dtype=torch.int32)
    widths, chunk, n = np.array([4], np.uint8), CHUNK, 100
    if case == "width":
        widths = np.array([33], np.uint8)
    elif case == "short":
        widths = np.array([9], np.uint8)
    elif case == "chunk":
        chunk = 1024
    else:
        n = CHUNK + 1
    with pytest.raises(ValueError):
        chunked_cuda.decode_chunked_stream(body, widths, 0, chunk, n)
    with pytest.raises(ValueError):
        chunked_cuda.decode_chunked_stream_floats(
            body, widths, 0, chunk, n, (1, 2), 12, 0.0, 1.0, 0.0, False)


# ---------------------------------------------------------------------------
# algos/chunked.py
# ---------------------------------------------------------------------------

def _diverse_stream(chunk):
    """13 chunks of 12 distinct widths (more than the JAX package's cap of
    8 on its device path), a zero chunk and a ragged tail."""
    rng = np.random.default_rng(chunk)
    ws = [0, 1, 2, 3, 5, 8, 11, 13, 17, 20, 24, 31, 32]
    z = np.concatenate([_u32(rng, chunk, w) if w else
                        np.zeros(chunk, np.uint32) for w in ws])
    return z[:-37]


@pytest.mark.parametrize("chunk", [256, CHUNK])
def test_chunk_pack_paths_match_jax(chunk):
    z = _diverse_stream(chunk)
    zc_j, w_j = jchunked.chunk_widths(z, chunk)
    ref = jchunked.pack_chunks(zc_j, w_j)
    zc, w = chunked.chunk_widths(z, chunk)
    zc_d, w_d = chunked.chunk_widths_device(_u32_tensor(z), chunk)
    np.testing.assert_array_equal(w, w_j)
    np.testing.assert_array_equal(w_d, w_j)
    assert len(np.unique(w)) > 8
    assert chunked.pack_chunks(zc, w) == ref
    assert chunked.pack_chunks_device(zc_d, w_d) == ref
    assert chunked.pack_chunks_auto(zc_d, w_d) == ref
    body = np.frombuffer(ref, dtype=np.uint32)
    want = jchunked.unpack_chunks(body, w_j, chunk)
    np.testing.assert_array_equal(chunked.unpack_chunks(body, w, chunk),
                                  want)
    np.testing.assert_array_equal(
        _bits(chunked.unpack_chunks_device(_u32_tensor(body), w, chunk)),
        want)
    assert chunked.total_words(w, chunk) == jchunked.total_words(w_j, chunk)


def test_chunk_unpack_rejects_wide_widths():
    body = np.zeros(4096, np.uint32)
    widths = np.array([3, 33], np.uint8)
    with pytest.raises(ValueError, match="> 32"):
        chunked.unpack_chunks(body, widths)
    with pytest.raises(ValueError, match="> 32"):
        chunked.unpack_chunks_device(_u32_tensor(body), widths)


# ---------------------------------------------------------------------------
# The five codecs against the JAX package and the frozen wire
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fixture_digests():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_blobs():
    return {name: japi.compress_segment(reference_segment(*ALGOS[name]),
                                        seed=SEED) for name in CODECS}


def _port_blob(name, seg=None):
    seg = seg if seg is not None else reference_segment(*ALGOS[name])
    return mt.compress_segment(interop.seg_from_reference(seg), seed=SEED,
                               device="cpu")


@pytest.mark.parametrize("name", CODECS)
def test_delta_codec_matches_jax_and_fixture(name, jax_blobs,
                                             fixture_digests):
    """Encode equals the JAX package's bytes and the frozen digests; both
    decodes give the frozen decode digest."""
    blob = _port_blob(name)
    assert blob == jax_blobs[name]
    assert hashlib.sha256(blob).hexdigest() == \
        fixture_digests[f"{name}_encode_sha256"]
    assert len(blob) == fixture_digests[f"{name}_bytes"]
    for fused in (False, True):
        assert _digest(mt.decompress_segment(blob, fused=fused,
                                             device="cpu")) == \
            fixture_digests[f"{name}_decode_sha256"], fused


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", CODECS)
def test_delta_cross_decode(name, fused, jax_blobs):
    """JAX bytes decode in the port, and port bytes in the JAX package, to
    the same arrays as the writer's own package; the JAX package's fused
    decode equals its generic one (it is what the port is held to)."""
    blob = jax_blobs[name]
    ref = japi.decompress_segment(blob, fused=fused)
    generic = japi.decompress_segment(blob)
    got = mt.decompress_segment(_port_blob(name), fused=fused, device="cpu")
    for a, b, c in zip(ref.fields, got.fields, generic.fields):
        assert _same_bytes(a.data, b.data), hex(a.hd.field_code)
        assert _same_bytes(a.data, c.data)
        assert a.valid and b.valid


def _small_segment(name, n):
    """Positions (random walk), IDs and a wide UNSI plane (range above
    2^31, so zigzag deltas pass 2^30) of ``n`` particles."""
    algo, ver = ALGOS[name]
    rng = np.random.default_rng(n)
    pos = (np.cumsum(rng.normal(0, 0.05, (3, n)), axis=1) + 32.0).astype(
        np.float32) % np.float32(64.0)
    ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
    ui = rng.integers(0, 3 << 30, n).astype(np.uint64)

    def hd(code):
        return mnw.FieldHeader(code, algo, ver, n)

    return mnw.Seg(fields=[
        mnw.Field(hd=hd(mnw.FieldCode.POSN), data=pos,
                  acc=mnw.PositionAccuracy(delta=1e-3, width=64.0)),
        mnw.Field(hd=hd(mnw.FieldCode.PTID), data=ids,
                  acc=mnw.IDAccuracy(width=64)),
        mnw.Field(hd=hd(mnw.FieldCode.UNSI), data=ui,
                  acc=mnw.IntAccuracy()),
    ])


@pytest.mark.parametrize("n", [1, 2, 31, 255, 256, 257, 513])
def test_delta_boundary_sizes_match_jax(n):
    """Every codec at the sizes around the chunk and word edges: same
    bytes, same decode, generic and fused."""
    for name in CODECS:
        seg = _small_segment(name, n)
        blob = _port_blob(name, seg)
        assert blob == japi.compress_segment(seg, seed=SEED), name
        for fused in (False, True):
            ref = japi.decompress_segment(blob, fused=fused)
            got = mt.decompress_segment(blob, fused=fused, device="cpu")
            for a, b in zip(ref.fields, got.fields):
                assert _same_bytes(a.data, b.data), (name, n, fused)


@pytest.mark.parametrize("name", ["coil_v1_1", "octo_v1_1"])
def test_kernel_chunks_match_jax(name, monkeypatch):
    """BIG_PLANE at 30000 in both packages: a 40000-particle plane takes the
    16384-element chunks, which the port decodes through K10 and (fused
    Coil v1.1) K11 -- their plain versions here."""
    monkeypatch.setattr(jcoil11, "BIG_PLANE", 30000)
    monkeypatch.setattr(tcoil11, "BIG_PLANE", 30000)
    plain = chunked_cuda.decode_chunked_stream_plain
    calls = []

    def counted(*args, **kwargs):
        calls.append(args[4])
        return plain(*args, **kwargs)

    monkeypatch.setattr(chunked_cuda, "decode_chunked_stream_plain", counted)
    seg = _small_segment(name, 40000)
    blob = _port_blob(name, seg)
    assert blob == japi.compress_segment(seg, seed=SEED)
    for fused in (False, True):
        calls.clear()
        ref = japi.decompress_segment(blob, fused=fused)
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        for a, b in zip(ref.fields, got.fields):
            assert _same_bytes(a.data, b.data), fused
        assert calls, "no plane took the 16384-element chunks"


def _flip_block_byte(blob: bytes, block: int) -> bytes:
    n_blocks, n_fields = struct.unpack_from("<ii", blob, 4)
    hdr = 16 + 16 * n_fields
    lengths = [struct.unpack_from("<I", blob, hdr + 8 * i)[0]
               for i in range(n_blocks)]
    off = hdr + 8 * n_blocks + sum(lengths[:block]) + 20
    b = bytearray(blob)
    b[off] ^= 0xFF
    return bytes(b)


@pytest.mark.parametrize("name", CODECS)
def test_delta_corrupt_block_degrades_as_jax(name, jax_blobs):
    """POSN's second data block corrupt (dimY, or Octo's loX): that plane
    comes back NaN with valid=False, as in the JAX package."""
    blob = _flip_block_byte(jax_blobs[name], 2)
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device="cpu")
        ref = japi.decompress_segment(blob, fused=fused)
        assert not got.fields[0].valid and not ref.fields[0].valid
        assert torch.isnan(got.fields[0].data).any()
        for a, b in zip(ref.fields, got.fields):
            assert _same_bytes(a.data, b.data), fused


def test_transcode_trim_to_coil_v1_1_matches_jax():
    trim = japi.compress_segment(reference_segment(*ALGOS["trim"]),
                                 seed=SEED)
    v11 = mt.semver.pack(1, 1, 0)
    assert mt.transcode_segment(trim, mt.AlgoCode.COIL, v11, device="cpu") == \
        japi.transcode_segment(trim, mnw.AlgoCode.COIL, v11)


def test_coil_v1_1_rejects_bad_chunk_log2(jax_blobs):
    """A chunk_log2 byte outside 8..17 raises ValueError, as in JAX."""
    from minnow_c_tpu_torch.algos import registry
    codec = registry.get(mt.AlgoCode.COIL, mt.semver.pack(1, 1, 0))
    payload = np.array([1, 0, 7, 4], np.uint32)  # n_chunks 1, log2 7
    with pytest.raises(ValueError, match="chunk_log2"):
        codec._decode_plane(payload, 0, 100, "cpu")
