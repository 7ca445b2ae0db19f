"""The port's CUDA kernels, its segment path, its snapshot path and its
delta codecs on a CUDA card.

Marked ``cuda``; every test skips without a card.  This file imports no
JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerance: bitwise equality throughout -- kernel against its plain torch
version on the card, and CUDA against CPU for whole segments.
"""

import io

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch.algos import algo_coil_v1_1, chunked
from minnow_c_tpu_torch.ops import (chunked_cuda, decode_cuda, encode_cuda,
                                    kernels, scan_cuda)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [1, 33, 100_003])
@pytest.mark.parametrize("width", [1, 9, 24])
def test_decode_kernel_matches_plain(dev, width, n, periodic):
    g = torch.Generator(device=dev).manual_seed(width * 1000 + n)
    bins = torch.randint(0, 1 << width, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    words = encode_cuda.pack_plain(bins, width)
    x0, dx = (-2.0, 68.0) if periodic else (1.5, 32.0)
    got = decode_cuda.decode_cuda(words, (5, 6), width, n, x0, dx, 64.0,
                                  periodic, elem0=8)
    want = decode_cuda.decode_plain(
        words, 5, 6, x0, np.float32(dx) / np.float32(2.0 ** width), 64.0, n,
        width, 8, periodic)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 31, 100_003])
@pytest.mark.parametrize("width, from_f32", [
    (1, False), (5, False), (24, False), (32, False),
    (1, True), (5, True), (24, True)])
def test_pack_kernel_matches_plain(dev, width, from_f32, n):
    g = torch.Generator(device=dev).manual_seed(width * 1000 + n)
    if from_f32:
        vals = torch.randn(n, generator=g, device=dev) * (1 << width)
        vals[::7] = float("nan")
    else:
        vals = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    got = encode_cuda.pack_cuda(vals, width, from_f32=from_f32)
    assert torch.equal(got, encode_cuda.pack_plain(vals, width,
                                                   from_f32=from_f32))


def _segment(device):
    n, W = 5000, 64.0
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    vel = rng.normal(0, 50, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 15)[:n].astype(np.int64)
    uf = rng.uniform(0, 3, n).astype(np.float32)
    v = mt.semver.pack(1, 0, 0)
    F = mt.FieldCode

    def field(code, data, acc):
        hd = mt.FieldHeader(code, mt.AlgoCode.TRIM, v, n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(device),
                        acc=acc)

    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=1e-4, width=W)),
        field(F.VELC, vel, mt.VelocityAccuracy(delta=0.1)),
        field(F.PTID, ids, mt.IDAccuracy(width=32)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=1e-5)),
    ])


@pytest.mark.parametrize("fused", [False, True])
def test_segment_on_cuda_matches_cpu(dev, fused):
    blob = mt.compress_segment(_segment(dev), seed=3)
    assert blob == mt.compress_segment(_segment("cpu"), seed=3)
    got = mt.decompress_segment(blob, fused=fused, device=dev)
    want = mt.decompress_segment(blob, fused=fused)
    for a, b in zip(got.fields, want.fields):
        assert a.data.is_cuda
        assert np.array_equal(a.data.cpu().numpy().view(np.uint8),
                              b.data.numpy().view(np.uint8))


# ---------------------------------------------------------------------------
# Rows kernels (K2, K3, K6, K7) against their plain versions
# ---------------------------------------------------------------------------

ROW_SHAPES = [(1, 32), (70_000, 32), (3, 65_568)]  # (rows, n)


def _bins(dev, rows, n, width, seed):
    """(rows, n) u32 values below 2^width (int32 bits), each row starting
    with 0 and 2^width - 1."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randint(0, 1 << width, (rows, n), generator=g, device=dev,
                      dtype=torch.int64)
    b[:, :2] = torch.tensor([0, (1 << width) - 1], device=dev)
    return kernels.i64_to_u32(b)


@pytest.mark.parametrize("rows, n", ROW_SHAPES)
@pytest.mark.parametrize("width", [1, 7, 16, 24, 32])
def test_unpack_rows_kernel_matches_plain(dev, width, rows, n):
    words = encode_cuda.pack_rows_plain(_bins(dev, rows, n, width, width),
                                        width)
    got = decode_cuda.unpack_rows_cuda(words, width, n)
    assert torch.equal(got, decode_cuda.unpack_rows_plain(words, width, n))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("rows, n", ROW_SHAPES)
@pytest.mark.parametrize("width", [1, 9, 24])
def test_decode_rows_kernel_matches_plain(dev, width, rows, n, periodic):
    words = encode_cuda.pack_rows_plain(_bins(dev, rows, n, width, n),
                                        width)
    g = torch.Generator(device=dev).manual_seed(rows)
    keys = torch.randint(0, 1 << 32, (rows, 2), generator=g, device=dev)
    x0 = torch.full((rows,), -2.0 if periodic else 1.5, device=dev)
    dx = torch.full((rows,), 68.0 if periodic else 32.0, device=dev)
    dx[::3] = 0.0
    got = decode_cuda.decode_rows_cuda(words, keys, width, n, x0, dx, 64.0,
                                       periodic)
    want = decode_cuda.decode_rows_plain(words, keys, x0, dx / 2.0 ** width,
                                         64.0, n, width, periodic)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows, n", ROW_SHAPES)
@pytest.mark.parametrize("width", [0, 1, 7, 24, 32])
def test_pack_rows_kernel_matches_plain(dev, width, rows, n):
    vals = _bins(dev, rows, n, 32, width)  # full-range u32 values
    got = encode_cuda.pack_rows_cuda(vals, width)
    assert torch.equal(got, encode_cuda.pack_rows_plain(vals, width))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("rows, n", ROW_SHAPES + [(5, 100_003)])
def test_stats_rows_kernel_matches_plain(dev, rows, n, periodic):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.rand(rows, n, generator=g, device=dev) * 64.0
    x[::5, 7] = float("nan")
    if rows > 2:
        x[1] = torch.where(x[1] < 32, 0.0, -0.0)
        x[2, ::3] = -0.0
        x[2] = -x[2]
    box = torch.full((rows,), 64.0, device=dev)
    got = encode_cuda.stats_rows_cuda(x, box, x[:, 0].contiguous(), periodic)
    want = encode_cuda.stats_rows_plain(x, box, x[:, 0].contiguous(),
                                        periodic)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# The snapshot path on CUDA
# ---------------------------------------------------------------------------

def _snapshot(n: int):
    rng = np.random.default_rng(4)
    pos = (np.cumsum(rng.normal(0, 0.05, (3, n)), axis=1) + 32.0).astype(
        np.float32) % np.float32(64.0)
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.int64)
    mass = rng.uniform(1, 3, n).astype(np.float32)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=64.0),
                           vel=mt.VelocityAccuracy(delta=0.5),
                           ids=mt.IDAccuracy(width=64),
                           mass=mt.FloatAccuracy(delta=1e-4))
    return dict(pos=pos, vel=vel, ids=ids, mass=mass), spec


@pytest.mark.parametrize("n, blocks", [(1 << 16, 8), (4000, 4)])
def test_snapshot_on_cuda_matches_cpu(dev, n, blocks):
    arrays, spec = _snapshot(n)
    f_gpu, f_cpu = io.BytesIO(), io.BytesIO()
    mt.compress_snapshot(f_gpu, spec=spec, num_blocks=blocks, seed=5,
                         **{k: torch.from_numpy(v).to(dev)
                            for k, v in arrays.items()})
    mt.compress_snapshot(f_cpu, spec=spec, num_blocks=blocks, seed=5,
                         **arrays)
    assert f_gpu.getvalue() == f_cpu.getvalue()
    for batched in (True, False):
        got = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()),
                                     batched=batched, device=dev)
        want = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()),
                                      batched=batched)
        assert set(got) == set(want) == set(arrays)
        for k in want:
            assert got[k].is_cuda
            assert np.array_equal(got[k].cpu().numpy().view(np.uint8),
                                  want[k].numpy().view(np.uint8))


def test_snapshot_on_cuda_never_reaches_a_plain_version(dev, monkeypatch):
    """With every plain version made to raise, the CUDA snapshot path still
    runs: it launches the kernels and never falls back."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on the CUDA path")

    for mod, name in ((decode_cuda, "decode_plain"),
                      (decode_cuda, "decode_rows_plain"),
                      (decode_cuda, "unpack_rows_plain"),
                      (encode_cuda, "pack_plain"),
                      (encode_cuda, "pack_rows_plain"),
                      (encode_cuda, "stats_rows_plain")):
        monkeypatch.setattr(mod, name, refuse)
    arrays, spec = _snapshot(1 << 14)
    before = (decode_cuda.decode_rows_cuda.launches,
              decode_cuda.unpack_rows_cuda.launches,
              encode_cuda.pack_rows_cuda.launches,
              encode_cuda.stats_rows_cuda.launches)
    f = io.BytesIO()
    mt.compress_snapshot(f, spec=spec, num_blocks=4, seed=1,
                         **{k: torch.from_numpy(v).to(dev)
                            for k, v in arrays.items()})
    out = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device=dev)
    after = (decode_cuda.decode_rows_cuda.launches,
             decode_cuda.unpack_rows_cuda.launches,
             encode_cuda.pack_rows_cuda.launches,
             encode_cuda.stats_rows_cuda.launches)
    assert all(a - b >= m for a, b, m in zip(after, before, (7, 3, 6, 3)))
    assert torch.equal(out["ids"].cpu(), torch.from_numpy(arrays["ids"]))


# ---------------------------------------------------------------------------
# The delta codecs: K9 scan, K10 chunked decode, K11 its float mode
# ---------------------------------------------------------------------------

CHUNK = chunked_cuda.KERNEL_CHUNK
# (per-chunk widths of the zigzag deltas, elements cut from the last chunk):
# mixed widths, one chunk, zero-width chunks, a width-32 chunk (deltas of
# magnitude >= 2^30), and a plane that ends on a chunk boundary
PATTERNS = [((7, 15, 7), 137), ((24,), 137), ((0, 9, 0, 3), 137),
            ((1, 32, 5), 137), ((0, 0), 5), ((4, 32, 32, 11), 0)]


def chunked_stream(pattern, trim, seed):
    """A chunked plane of zigzag deltas whose chunk c holds values below
    2^pattern[c] (host arrays): (body words (int32 bits, column-major),
    widths, n)."""
    rng = np.random.default_rng(seed)
    z = np.zeros(len(pattern) * CHUNK, np.uint32)
    for c, w in enumerate(pattern):
        if w:
            z[c * CHUNK:(c + 1) * CHUNK] = rng.integers(0, 1 << w, CHUNK,
                                                        dtype=np.uint64)
            z[c * CHUNK + 5] = (1 << w) - 1
    n = z.size - trim
    zc, widths = chunked.chunk_widths(z[:n], CHUNK)
    natural = np.frombuffer(chunked.pack_chunks(zc, widths), dtype="<u4")
    body = chunked_cuda.plane_to_cmajor(natural, widths, CHUNK)
    return body.astype(np.uint32).view(np.int32), widths, n


@pytest.mark.parametrize("n", [1, 97, 4096, 4097, 16387, (1 << 20) + 5])
def test_scan_kernel_matches_plain(dev, n):
    g = torch.Generator(device=dev).manual_seed(n)
    x = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g, device=dev,
                      dtype=torch.int64).to(torch.int32)  # sums wrap
    assert torch.equal(scan_cuda.cumsum_u32(x), scan_cuda.cumsum_u32_plain(x))
    assert torch.equal(scan_cuda.cumsum_u32_auto(x),
                       scan_cuda.cumsum_u32_plain(x))


@pytest.mark.parametrize("first", [0, 12345, (1 << 32) - 5])
@pytest.mark.parametrize("pattern, trim", PATTERNS)
def test_chunked_kernel_matches_plain(dev, pattern, trim, first):
    body, widths, n = chunked_stream(pattern, trim, len(pattern) + trim)
    body = torch.from_numpy(body).to(dev)
    for zigzag, prefix in ((True, True), (False, True), (False, False)):
        got = chunked_cuda.decode_chunked_stream(body, widths, first, CHUNK,
                                                 n, zigzag, prefix)
        want = chunked_cuda.decode_chunked_stream_plain(
            body, widths, first, CHUNK, n, zigzag, prefix)
        assert got.device == body.device and torch.equal(got, want), \
            (zigzag, prefix)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pattern, trim", PATTERNS[:4])
@pytest.mark.parametrize("depth", [14, 24])
def test_chunked_floats_kernel_matches_plain(dev, pattern, trim, depth,
                                             periodic):
    body, widths, n = chunked_stream(pattern, trim, depth)
    body = torch.from_numpy(body).to(dev)
    x0, dx = (-2.0, 68.0) if periodic else (0.25, 63.0)
    args = (body, widths, (1 << 24) - 3, CHUNK, n, (0xDEADBEEF, 7), depth,
            x0, dx, 64.0, periodic)
    got = chunked_cuda.decode_chunked_stream_floats(*args)
    want = chunked_cuda.decode_chunked_stream_floats_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_chunked_kernels_refuse_malformed_streams(dev):
    body = torch.zeros(4096, dtype=torch.int32, device=dev)
    before = (chunked_cuda.decode_chunked_stream.launches,
              chunked_cuda.decode_chunked_stream_floats.launches)
    with pytest.raises(ValueError, match="> 32"):
        chunked_cuda.decode_chunked_stream(body, np.array([33], np.uint8), 0,
                                           CHUNK, 10)
    with pytest.raises(ValueError, match="shorter"):
        chunked_cuda.decode_chunked_stream_floats(
            body, np.array([9], np.uint8), 0, CHUNK, 10, (1, 2), 12, 0.0,
            1.0, 0.0, False)
    assert before == (chunked_cuda.decode_chunked_stream.launches,
                      chunked_cuda.decode_chunked_stream_floats.launches)


DELTA_CODECS = {"diff": (mt.AlgoCode.DIFF, (1, 0, 0)),
                "coil": (mt.AlgoCode.COIL, (1, 0, 0)),
                "coil_v1_1": (mt.AlgoCode.COIL, (1, 1, 0)),
                "octo": (mt.AlgoCode.OCTO, (1, 0, 0)),
                "octo_v1_1": (mt.AlgoCode.OCTO, (1, 1, 0))}


def _delta_segment(name, n, device):
    """Five field types in a coherent (random-walk) order; UNSI spans more
    than 2^31, so its zigzag deltas pass 2^30."""
    algo, ver = DELTA_CODECS[name]
    rng = np.random.default_rng(11)
    pos = (np.cumsum(rng.normal(0, 0.05, (3, n)), axis=1) + 32.0).astype(
        np.float32) % np.float32(64.0)
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = np.arange(n, dtype=np.int64) + 7
    uf = rng.uniform(1, 10, n).astype(np.float32)
    ui = rng.integers(0, 3 << 30, n).astype(np.int64)
    F = mt.FieldCode

    def field(code, data, acc):
        hd = mt.FieldHeader(code, algo, mt.semver.pack(*ver), n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(device),
                        acc=acc)

    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=1e-3, width=64.0)),
        field(F.VELC, vel, mt.VelocityAccuracy(delta=0.25)),
        field(F.PTID, ids, mt.IDAccuracy(width=64)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=1e-3)),
        field(F.UNSI, ui, mt.IntAccuracy()),
    ])


@pytest.mark.parametrize("n", [5000, 40000])
@pytest.mark.parametrize("name", sorted(DELTA_CODECS))
def test_delta_segment_on_cuda_matches_cpu(dev, monkeypatch, name, n):
    """n = 40000 with BIG_PLANE at 30000: Coil v1.1 and Octo v1.1 take the
    16384-element chunks, so K10 and K11 decode them on the card."""
    monkeypatch.setattr(algo_coil_v1_1, "BIG_PLANE", 30000)
    blob = mt.compress_segment(_delta_segment(name, n, dev), seed=3)
    assert blob == mt.compress_segment(_delta_segment(name, n, "cpu"),
                                       seed=3)
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        want = mt.decompress_segment(blob, fused=fused)
        for a, b in zip(got.fields, want.fields):
            assert a.data.device.type == dev.type
            assert np.array_equal(a.data.cpu().numpy().view(np.uint8),
                                  b.data.numpy().view(np.uint8))


def test_delta_path_on_cuda_never_reaches_a_plain_version(dev, monkeypatch):
    """With every plain version made to raise, the CUDA delta codecs still
    round-trip: they launch K9, K10 and K11 and never fall back."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on the CUDA path")

    for mod, name in ((scan_cuda, "cumsum_u32_plain"),
                      (chunked_cuda, "decode_chunked_stream_plain"),
                      (chunked_cuda, "decode_chunked_stream_floats_plain"),
                      (decode_cuda, "decode_plain"),
                      (decode_cuda, "unpack_rows_plain"),
                      (encode_cuda, "pack_plain"),
                      (encode_cuda, "pack_rows_plain")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(algo_coil_v1_1, "BIG_PLANE", 30000)
    counted = (scan_cuda.cumsum_u32, chunked_cuda.decode_chunked_stream,
               chunked_cuda.decode_chunked_stream_floats)
    before = [fn.launches for fn in counted]
    n = 40000
    for name in ("diff", "coil", "coil_v1_1", "octo_v1_1"):
        seg = _delta_segment(name, n, dev)
        blob = mt.compress_segment(seg, seed=1)
        for fused in (False, True):
            out = mt.decompress_segment(blob, fused=fused, device=dev)
            assert torch.equal(out.fields[2].data, seg.fields[2].data)
            assert torch.equal(out.fields[4].data, seg.fields[4].data)
            err = (out.fields[0].data - seg.fields[0].data).abs()
            assert float(torch.minimum(err, 64.0 - err).max()) <= 1e-3
    assert all(fn.launches > b for fn, b in zip(counted, before))
