"""The port's CUDA kernels, its segment path, its snapshot path, its
delta codecs and its Sort and Cart codecs on a CUDA card.

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
from minnow_c_tpu_torch.algos import algo_coil_v1_1, algo_sort_v1_2, chunked
from minnow_c_tpu_torch.ops import (chunked_cuda, decode_cuda, encode_cuda,
                                    kernels, scan_cuda)

import gadget2_cases

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
    assert blob == mt.compress_segment(_segment("cpu"), seed=3, device="cpu")
    got = mt.decompress_segment(blob, fused=fused, device=dev)
    want = mt.decompress_segment(blob, fused=fused, device="cpu")
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
    b[:, :2] = torch.tensor([0, (1 << width) - 1], device=dev)[:n]
    return kernels.i64_to_u32(b)


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


def _same_stats(x: torch.Tensor) -> None:
    """K6 equals its plain version on the rows of ``x``, bitwise, both
    plain and unwrapped in a box of 64 around each row's element 0."""
    box = torch.full((x.shape[0],), 64.0, device=x.device)
    anchor = x[:, 0].contiguous()
    for periodic in (False, True):
        got = encode_cuda.stats_rows_cuda(x, box, anchor, periodic)
        want = encode_cuda.stats_rows_plain(x, box, anchor, periodic)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
                periodic


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("rows, n", ROW_SHAPES + [
    (5, 100_003), (3, 1), (3, 3), (3, 5), (3, 4097), (3, 65_541)])
def test_stats_rows_kernel_matches_plain(dev, rows, n, offset):
    """K6 across its slice (2^15 elements) and 16-byte edges: rows whose
    starts are not 16-byte aligned (odd n; ``offset`` 1: storage one
    element in) take a scalar head and tail around their float4s; NaN,
    rows of +-0.0, negative rows."""
    g = torch.Generator(device=dev).manual_seed(rows + n + offset)
    store = torch.rand(rows * n + offset, generator=g, device=dev) * 64.0
    x = store[offset:].view(rows, n)
    x[::4, n // 2] = float("nan")
    if rows > 2:
        x[1] = torch.where(x[1] < 32, 0.0, -0.0)
        x[2, ::3] = -0.0
        x[2] = -x[2]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    _same_stats(x)


def _edge_rows(n: int, pos: int, seed: int) -> np.ndarray:
    """Six rows with K6's edge values at index ``pos`` (not 0): +inf;
    -inf; NaN beside -inf; a subnormal anchor among subnormals (the edge a
    larger subnormal); a row whose every value wraps in a box of 64
    (anchor 1, the rest in [34, 63); the edge 33.5 wraps to the min);
    -0.0 in a negative row."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 64, (6, n)).astype(np.float32)
    x[0, pos] = np.inf
    x[1, pos] = -np.inf
    x[2, pos] = np.nan
    x[2, pos - 1] = -np.inf
    x[3] = (rng.uniform(-1, 1, n) * 1e-39).astype(np.float32)
    x[3, 0] = 3e-39
    x[3, pos] = -1.1e-38
    x[4] = rng.uniform(34, 63, n).astype(np.float32)
    x[4, 0] = 1.0
    x[4, pos] = 33.5
    x[5] = -rng.uniform(0.5, 1, n).astype(np.float32)
    x[5, pos] = -0.0
    return x


# 4 | n and 32 | n: from storage one element in, every row starts 4 bytes
# past a 16-byte boundary, so K6 reads 3 scalars, float4s over 5 slices,
# then 1 scalar
EDGE_N = 2 * (1 << 16) + 32
EDGE_AT = {"head": 1, "body": EDGE_N // 2, "tail": EDGE_N - 1}


def _edge_tensor(dev, where: str) -> torch.Tensor:
    store = torch.zeros(6 * EDGE_N + 1, device=dev)
    store[1:] = torch.from_numpy(
        _edge_rows(EDGE_N, EDGE_AT[where], len(where)).reshape(-1))
    x = store[1:].view(6, EDGE_N)
    assert x.data_ptr() % 16 == 4
    return x


@pytest.mark.parametrize("where", sorted(EDGE_AT))
def test_stats_rows_kernel_edge_rows(dev, where):
    _same_stats(_edge_tensor(dev, where))


@pytest.mark.parametrize("where", sorted(EDGE_AT))
def test_encode_recip_fused_kernel_edge_rows(dev, where):
    """K12 on the same rows as two blocks of three: its first step is K6's
    slice routine."""
    x = _edge_tensor(dev, where).view(2, 3, EDGE_N)
    anchors = x[:, :, 0].contiguous()
    for periodic in (False, True):
        for width in (12, 16):
            got = encode_cuda.encode_recip_fused_blocks_cuda(
                x, 64.0, anchors, width, periodic)
            want = encode_cuda.encode_recip_fused_blocks_plain(
                x, 64.0, anchors, width, periodic)
            for a, b in zip(got, want):
                assert torch.equal(a.view(torch.int32),
                                   b.view(torch.int32)), (periodic, width)


def test_stats_rows_kernel_on_two_streams(dev):
    """Calls queued on two streams at once, each stream with its own
    ticket counters: every result equal to the plain version."""
    g = torch.Generator(device=dev).manual_seed(5)
    xs = [torch.rand(24 + s, (1 << 18) + 3 * s, generator=g, device=dev)
          for s in range(2)]
    box = [torch.full((x.shape[0],), 64.0, device=dev) for x in xs]
    want = [encode_cuda.stats_rows_plain(x, b, x[:, 0].contiguous(), True)
            for x, b in zip(xs, box)]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize(dev)
    got = [[], []]
    for _ in range(10):
        for s, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[s].append(encode_cuda.stats_rows_cuda(
                    xs[s], box[s], xs[s][:, 0].contiguous(), True))
    torch.cuda.synchronize(dev)
    for s in range(2):
        for pair in got[s]:
            for a, b in zip(pair, want[s]):
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# The tile kernels of K1 / K2 (decode) and K4 / K7 (pack) at every width, on
# shapes whose rows cross tile edges and tiles that hold many rows
# ---------------------------------------------------------------------------

TILE = decode_cuda.DECODE_TILE
TILE_SHAPES = ROW_SHAPES + [(3, TILE - 32), (3, TILE + 32),
                            (2, 3 * TILE + 96)]


@pytest.mark.parametrize("rows, n", TILE_SHAPES)
@pytest.mark.parametrize("width", range(1, 25))
def test_decode_tiles_every_width_matches_plain(dev, width, rows, n):
    words = encode_cuda.pack_rows_plain(_bins(dev, rows, n, width, width + n),
                                        width)
    g = torch.Generator(device=dev).manual_seed(width * rows)
    keys = torch.randint(0, 1 << 32, (rows, 2), generator=g, device=dev)
    x0 = torch.rand(rows, generator=g, device=dev) * 4.0 - 2.0
    dx = 60.0 + torch.rand(rows, generator=g, device=dev) * 8.0
    periodic = width % 2 == 0
    got = decode_cuda.decode_rows_cuda(words, keys, width, n, x0, dx, 64.0,
                                       periodic)
    want = decode_cuda.decode_rows_plain(
        words, keys, x0, kernels.bin_width(dx, width), 64.0, n, width,
        periodic)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("rows, n", TILE_SHAPES)
@pytest.mark.parametrize("width", range(1, 33))
def test_unpack_rows_kernel_matches_plain(dev, width, rows, n):
    """K3 on K2's tile kernel at every width 1-32."""
    words = encode_cuda.pack_rows_plain(_bins(dev, rows, n, width, 7 * n),
                                        width)
    got = decode_cuda.unpack_rows_cuda(words, width, n)
    assert torch.equal(got, decode_cuda.unpack_rows_plain(words, width, n))


@pytest.mark.parametrize("width", [1, 9, 17, 31, 32])
def test_unpack_rows_kernel_unaligned_and_empty(dev, width):
    """K3 from words whose storage starts one word in (the 4-byte copy
    path), and zero rows (no launch)."""
    n = 3 * TILE + 96
    packed = encode_cuda.pack_rows_plain(_bins(dev, 5, n, width, width),
                                         width)
    store = torch.zeros(packed.numel() + 1, dtype=torch.int32, device=dev)
    store[1:] = packed.reshape(-1)
    words = store[1:].view(5, -1)
    assert words.data_ptr() % 16 != 0
    got = decode_cuda.unpack_rows_cuda(words, width, n)
    assert torch.equal(got, decode_cuda.unpack_rows_plain(words, width, n))
    before = decode_cuda.unpack_rows_cuda.launches
    empty = torch.zeros((0, n // 32 * width), dtype=torch.int32, device=dev)
    assert decode_cuda.unpack_rows_cuda(empty, width, n).shape == (0, n)
    assert decode_cuda.unpack_rows_cuda.launches == before


@pytest.mark.parametrize("rows, n", TILE_SHAPES)
@pytest.mark.parametrize("width", range(0, 33))
def test_pack_tiles_every_width_matches_plain(dev, width, rows, n):
    vals = _bins(dev, rows, n, 32, 100 + width)  # full-range u32 values
    got = encode_cuda.pack_rows_cuda(vals, width)
    assert torch.equal(got, encode_cuda.pack_rows_plain(vals, width))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 33, 100_003, 7_812_500])
@pytest.mark.parametrize("width", [1, 5, 9, 12, 16, 17, 23, 24])
def test_decode_kernel_ragged_and_unaligned(dev, width, n, offset):
    """K1 at ragged n, elem0 != 0, and words whose storage starts one word
    in (``offset`` 1: the 4-byte copy path)."""
    bins = _bins(dev, 1, n, width, n + width)[0]
    packed = encode_cuda.pack_plain(bins, width)
    store = torch.zeros(packed.numel() + offset, dtype=torch.int32,
                        device=dev)
    store[offset:] = packed
    words = store[offset:]
    assert (words.data_ptr() % 16 == 0) == (offset == 0)
    for elem0 in (0, 4 * 12345, (1 << 34) - 8):
        got = decode_cuda.decode_cuda(words, (9, 10), width, n, 0.5, 40.0,
                                      64.0, True, elem0)
        want = decode_cuda.decode_plain(
            words, 9, 10, 0.5, kernels.bin_width(40.0, width), 64.0, n,
            width, elem0, True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 31, 33, 100_003, 7_812_500])
@pytest.mark.parametrize("width, from_f32", [
    (w, False) for w in (1, 3, 9, 12, 16, 17, 31, 32)] + [
    (w, True) for w in (1, 9, 14, 16, 24)])
def test_pack_kernel_ragged_and_unaligned(dev, width, from_f32, n, offset):
    """K4 from u32 and from f32 at ragged n, from a tensor whose storage
    starts one element in (``offset`` 1: the 4-byte load path)."""
    g = torch.Generator(device=dev).manual_seed(n + width)
    if from_f32:
        store = torch.randn(n + offset, generator=g, device=dev) * (
            1 << width)
        store[::7] = float("nan")
    else:
        store = torch.randint(-(1 << 31), 1 << 31, (n + offset,),
                              generator=g, device=dev,
                              dtype=torch.int64).to(torch.int32)
    vals = store[offset:]
    got = encode_cuda.pack_cuda(vals, width, from_f32=from_f32)
    assert torch.equal(got, encode_cuda.pack_plain(vals, width,
                                                   from_f32=from_f32))


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
                         device="cpu", **arrays)
    assert f_gpu.getvalue() == f_cpu.getvalue()
    for batched in (True, False):
        got = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()),
                                     batched=batched, device=dev)
        want = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()),
                                      batched=batched, device="cpu")
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
# magnitude >= 2^30), a plane that ends on a chunk boundary, every width
# 0-32 in one plane, 640 chunks (more tiles than one wave of the persistent
# grid), and a plane that ends one element into its last chunk
PATTERNS = [((7, 15, 7), 137), ((24,), 137), ((0, 9, 0, 3), 137),
            ((1, 32, 5), 137), ((0, 0), 5), ((4, 32, 32, 11), 0),
            (tuple(range(33)), 137), ((11,) * 640, 1000),
            ((5, 9), CHUNK - 1)]


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


def _u32_stream(dev, n: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(-(1 << 31), 1 << 31, (n,), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)  # sums wrap


@pytest.mark.parametrize("n", [1, 31, 97, 4095, 4096, 4097, 16387,
                               (1 << 20) + 5, 1 << 24, 3 * (1 << 24) + 7])
def test_scan_kernel_matches_plain(dev, n):
    x = _u32_stream(dev, n, n)
    assert torch.equal(scan_cuda.cumsum_u32(x), scan_cuda.cumsum_u32_plain(x))
    assert torch.equal(scan_cuda.cumsum_u32_auto(x),
                       scan_cuda.cumsum_u32_plain(x))


@pytest.mark.parametrize("n", [1, 4095, 4097, (1 << 20) + 5])
def test_scan_kernel_unaligned_input(dev, n):
    """A stream whose storage starts one word in: K9's 4-byte loads."""
    store = _u32_stream(dev, n + 1, 7 * n)
    x = store[1:]
    assert x.data_ptr() % 16 != 0
    assert torch.equal(scan_cuda.cumsum_u32(x), scan_cuda.cumsum_u32_plain(x))


def test_scan_kernel_back_to_back_calls(dev):
    """50 calls in a row at 2^24 on one stream, each equal to the plain
    version: a race in the look-back, or a status word or ticket left by
    the call before, would show."""
    xs = [_u32_stream(dev, 1 << 24, s) for s in range(2)]
    want = [scan_cuda.cumsum_u32_plain(x) for x in xs]
    got = [scan_cuda.cumsum_u32(xs[k % 2]) for k in range(50)]
    for k, g in enumerate(got):
        assert torch.equal(g, want[k % 2]), k


def test_scan_kernel_on_two_streams(dev):
    """Calls queued on two streams at once, each stream with its own status
    words: every result equal to the plain version."""
    xs = [_u32_stream(dev, (1 << 22) + 9 * s, 100 + s) for s in range(2)]
    want = [scan_cuda.cumsum_u32_plain(x) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize(dev)
    got = [[], []]
    for _ in range(10):
        for s, st in enumerate(streams):
            with torch.cuda.stream(st):
                got[s].append(scan_cuda.cumsum_u32(xs[s]))
    torch.cuda.synchronize(dev)
    for s in range(2):
        for g in got[s]:
            assert torch.equal(g, want[s])


def on_card(body: np.ndarray, dev, offset: int = 0) -> torch.Tensor:
    """The body on the card; ``offset`` 1: a view one word into its
    storage (not 16-byte aligned: the kernels' 4-byte copies)."""
    store = torch.zeros(body.size + offset, dtype=torch.int32, device=dev)
    store[offset:] = torch.from_numpy(body).to(dev)
    words = store[offset:]
    assert not body.size or (words.data_ptr() % 16 == 0) == (offset == 0)
    return words


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("first", [0, 12345, (1 << 32) - 5])
@pytest.mark.parametrize("pattern, trim", PATTERNS)
def test_chunked_kernel_matches_plain(dev, pattern, trim, first, offset):
    body, widths, n = chunked_stream(pattern, trim, len(pattern) + trim)
    body = on_card(body, dev, offset)
    for zigzag, prefix in ((True, True), (False, True), (False, False)):
        got = chunked_cuda.decode_chunked_stream(body, widths, first, CHUNK,
                                                 n, zigzag, prefix)
        want = chunked_cuda.decode_chunked_stream_plain(
            body, widths, first, CHUNK, n, zigzag, prefix)
        assert got.device == body.device and torch.equal(got, want), \
            (zigzag, prefix)


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("pattern, trim", PATTERNS[:4] + PATTERNS[6:])
@pytest.mark.parametrize("depth", [14, 24])
def test_chunked_floats_kernel_matches_plain(dev, pattern, trim, depth,
                                             periodic):
    body, widths, n = chunked_stream(pattern, trim, depth)
    x0, dx = (-2.0, 68.0) if periodic else (0.25, 63.0)
    for offset in (0, 1):
        args = (on_card(body, dev, offset), widths, (1 << 24) - 3, CHUNK, n,
                (0xDEADBEEF, 7), depth, x0, dx, 64.0, periodic)
        got = chunked_cuda.decode_chunked_stream_floats(*args)
        want = chunked_cuda.decode_chunked_stream_floats_plain(*args)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("periodic", [False, True])
def test_chunked_floats_kernel_on_high_bins(dev, periodic):
    """Bins >= 2^31 (full-range deltas in width-32 chunks): K11 turns a bin
    into f32 as a u32, as its plain version and the JAX package's XLA tail
    do."""
    body, widths, n = chunked_stream((32, 32, 7), 137, 32)
    body = torch.from_numpy(body).to(dev)
    first = (1 << 31) + 12345
    bins = chunked_cuda.decode_chunked_stream_plain(body, widths, first,
                                                    CHUNK, n)
    assert (bins < 0).sum() > n // 4      # u32 bits >= 2^31
    args = (body, widths, first, CHUNK, n, (0xDEADBEEF, 7), 24, -2.0, 68.0,
            64.0, periodic)
    got = chunked_cuda.decode_chunked_stream_floats(*args)
    want = chunked_cuda.decode_chunked_stream_floats_plain(*args)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_chunked_kernel_back_to_back_calls(dev):
    """50 calls in a row on one stream, K10 and K11 in turns, each equal to
    the plain version: a race in the look-back, or a status word or ticket
    left by the call before, would show."""
    body, widths, n = chunked_stream((17,) * 1024, 5, 17)
    body = torch.from_numpy(body).to(dev)
    fargs = (body, widths, 99, CHUNK, n, (1, 2), 17, 0.25, 63.5, 64.0, True)
    want = (chunked_cuda.decode_chunked_stream_plain(body, widths, 99, CHUNK,
                                                     n),
            chunked_cuda.decode_chunked_stream_floats_plain(*fargs))
    got = [chunked_cuda.decode_chunked_stream(body, widths, 99, CHUNK, n)
           if k % 2 == 0 else
           chunked_cuda.decode_chunked_stream_floats(*fargs)
           for k in range(50)]
    for k, g in enumerate(got):
        assert torch.equal(g.view(torch.int32),
                           want[k % 2].view(torch.int32)), k


def test_chunked_kernel_on_two_streams(dev):
    """Calls queued on two streams at once, each stream with its own status
    words and tickets: every result equal to the plain version."""
    planes = [chunked_stream((9 + s,) * 300, 77 * s, s) for s in range(2)]
    planes = [(torch.from_numpy(b).to(dev), w, n) for b, w, n in planes]
    want = [chunked_cuda.decode_chunked_stream_plain(b, w, 5, CHUNK, n)
            for b, w, n in planes]
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    torch.cuda.synchronize(dev)
    got = [[], []]
    for _ in range(10):
        for s, st in enumerate(streams):
            with torch.cuda.stream(st):
                b, w, n = planes[s]
                got[s].append(chunked_cuda.decode_chunked_stream(b, w, 5,
                                                                 CHUNK, n))
    torch.cuda.synchronize(dev)
    for s in range(2):
        for g in got[s]:
            assert torch.equal(g, want[s])


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
SORT_CODECS = {"sort": (mt.AlgoCode.SORT, (1, 0, 0)),
               "sort_v1_1": (mt.AlgoCode.SORT, (1, 1, 0)),
               "sort_v1_2": (mt.AlgoCode.SORT, (1, 2, 0)),
               "cart": (mt.AlgoCode.CART, (1, 0, 0))}


def _delta_segment(name, n, device):
    """Five field types in a coherent (random-walk) order; UNSI spans more
    than 2^31, so its zigzag deltas pass 2^30 (and Sort's bins pass 2^31);
    the ID planes hold many equal bins."""
    algo, ver = {**DELTA_CODECS, **SORT_CODECS}[name]
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
                                       seed=3, device="cpu")
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        want = mt.decompress_segment(blob, fused=fused, device="cpu")
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


# ---------------------------------------------------------------------------
# Sort (v1.0, v1.1, v1.2, order-free v1.2.1) and Cart v1.0
# ---------------------------------------------------------------------------

def _same_segments(blob, dev):
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        want = mt.decompress_segment(blob, fused=fused, device="cpu")
        for a, b in zip(got.fields, want.fields):
            assert a.data.device.type == dev.type
            assert np.array_equal(a.data.cpu().numpy().view(np.uint8),
                                  b.data.numpy().view(np.uint8))


@pytest.mark.parametrize("n", [5000, 40000])
@pytest.mark.parametrize("name", sorted(SORT_CODECS))
def test_sort_segment_on_cuda_matches_cpu(dev, monkeypatch, name, n):
    """n = 40000 with BIG_PLANE at 30000: Sort v1.2 takes the
    16384-element chunks, which K10 decodes on the card."""
    monkeypatch.setattr(algo_sort_v1_2, "BIG_PLANE", 30000)
    blob = mt.compress_segment(_delta_segment(name, n, dev), seed=3)
    assert blob == mt.compress_segment(_delta_segment(name, n, "cpu"),
                                       seed=3, device="cpu")
    _same_segments(blob, dev)


@pytest.mark.parametrize("n", [5000, 40000])
def test_order_free_on_cuda_matches_cpu(dev, monkeypatch, n):
    """Sort v1.2.1 on UNSI values with ties and bins >= 2^31: the same
    bytes as the CPU's, decoding to the values in ascending order."""
    monkeypatch.setattr(algo_sort_v1_2, "BIG_PLANE", 30000)
    rng = np.random.default_rng(n)
    vals = rng.integers(0, 3 << 30, n).astype(np.int64) + 5
    vals[::4] = vals[1]
    hd = mt.FieldHeader(mt.FieldCode.UNSI, mt.AlgoCode.SORT,
                        mt.semver.pack(1, 2, 1), n)

    def seg(device):
        return mt.Seg(fields=[mt.Field(
            hd=hd, data=torch.from_numpy(vals).to(device),
            acc=mt.IntAccuracy())])

    blob = mt.compress_segment(seg(dev), seed=3)
    assert blob == mt.compress_segment(seg("cpu"), seed=3, device="cpu")
    _same_segments(blob, dev)
    got = mt.decompress_segment(blob, device=dev).fields[0].data
    assert np.array_equal(got.cpu().numpy(), np.sort(vals))


def test_sort_path_on_cuda_never_reaches_a_plain_version(dev, monkeypatch):
    """With every plain version made to raise, Sort and Cart still
    round-trip on the card: they launch K3, K4, K7, K9 and K10."""
    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on the CUDA path")

    for mod, name in ((scan_cuda, "cumsum_u32_plain"),
                      (chunked_cuda, "decode_chunked_stream_plain"),
                      (decode_cuda, "unpack_rows_plain"),
                      (encode_cuda, "pack_plain"),
                      (encode_cuda, "pack_rows_plain")):
        monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(algo_sort_v1_2, "BIG_PLANE", 30000)
    counted = (decode_cuda.unpack_rows_cuda, encode_cuda.pack_cuda,
               encode_cuda.pack_rows_cuda, scan_cuda.cumsum_u32,
               chunked_cuda.decode_chunked_stream)
    before = [fn.launches for fn in counted]
    for name in sorted(SORT_CODECS):
        seg = _delta_segment(name, 40000, dev)
        out = mt.decompress_segment(mt.compress_segment(seg, seed=1),
                                    device=dev)
        assert torch.equal(out.fields[2].data, seg.fields[2].data)
        assert torch.equal(out.fields[4].data, seg.fields[4].data)
        err = (out.fields[0].data - seg.fields[0].data).abs()
        assert float(torch.minimum(err, 64.0 - err).max()) <= 1e-3
    assert all(fn.launches > b for fn, b in zip(counted, before))


# ---------------------------------------------------------------------------
# The recip scale mode: K5, K8, K12
# ---------------------------------------------------------------------------

def _recip_plane(n: int, seed: int, periodic: bool) -> np.ndarray:
    """Values in the box with the unwrap's edges (anchor +- half and one
    ulp either side, the box edges), subnormals and signed zeros; element 0
    (the anchor) at a box edge."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 64.0, n).astype(np.float32)
    a = np.nextafter(np.float32(64.0), np.float32(0))
    edges = np.array([a, a - 32, a + 32, np.nextafter(a - 32, np.float32(0)),
                      np.nextafter(a - 32, np.float32(64)), 0.0, -0.0,
                      1e-40, -1e-40, 64.0, 31.999998, 32.0], np.float32)
    k = min(n, edges.size)
    x[:k] = edges[:k]
    if not periodic:
        x -= np.float32(20.0)
    return x


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [1, 17, 33, 1_000_005])
def test_encode_recip_kernel_matches_plain(dev, n, periodic):
    x = torch.from_numpy(_recip_plane(n, n, periodic)).to(dev)
    u = kernels.undo_periodic(x, 64.0) if periodic else x
    x0, x1 = kernels.minmax(u)
    recip = kernels.exact_recip((x1 - x0).item())
    for width in range(1, 25):
        args = (width, x0.item(), recip, 64.0 if periodic else 0.0,
                x[0].item(), periodic)
        got = encode_cuda.encode_recip_cuda(x, *args)
        assert torch.equal(got, encode_cuda.encode_recip_plain(x, *args))
    const = torch.full((n,), 7.5, device=dev)   # recip inf: bins 0
    got = encode_cuda.encode_recip_cuda(const, 12, 7.5, np.inf, 0.0, 7.5,
                                        False)
    assert not got.any()


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("rows, n", ROW_SHAPES)
@pytest.mark.parametrize("width", [1, 9, 16, 24])
def test_encode_recip_rows_kernel_matches_plain(dev, width, rows, n,
                                                periodic):
    g = torch.Generator(device=dev).manual_seed(width + rows)
    x = torch.rand(rows, n, generator=g, device=dev) * 64.0
    x[0] = torch.from_numpy(_recip_plane(n, 1, periodic)).to(dev)
    x0 = torch.rand(rows, generator=g, device=dev) * 4.0
    recip = 1.0 / (40.0 + torch.rand(rows, generator=g, device=dev) * 20.0)
    if rows > 2:
        x[1] = 7.5
        x0[1] = 7.5
        recip[1] = float("inf")     # constant row: 0 * inf = NaN -> bin 0
        x0[2] = 1e-40
    box = torch.full((rows,), 64.0, device=dev)
    args = (width, x0, recip, box, x[:, 0].contiguous(), periodic)
    got = encode_cuda.encode_recip_rows_cuda(x, *args)
    assert torch.equal(got, encode_cuda.encode_recip_rows_plain(x, *args))


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("n", [1, 33, 100_003, 7_812_500])
def test_encode_recip_kernel_ragged_and_unaligned(dev, n, offset):
    """K5 (K8's kernel at one row) at every width, at ragged n, from a
    plane whose storage starts one element in (``offset`` 1: the 4-byte
    load path)."""
    periodic = n % 2 == 1
    store = torch.zeros(n + offset, device=dev)
    store[offset:] = torch.from_numpy(_recip_plane(n, n + 3, periodic))
    x = store[offset:]
    assert (x.data_ptr() % 16 == 0) == (offset == 0)
    u = kernels.undo_periodic(x, 64.0) if periodic else x
    x0, x1 = kernels.minmax(u)
    recip = kernels.exact_recip((x1 - x0).item())
    for width in range(1, 25):
        args = (width, x0.item(), recip, 64.0 if periodic else 0.0,
                x[0].item(), periodic)
        got = encode_cuda.encode_recip_cuda(x, *args)
        assert torch.equal(got, encode_cuda.encode_recip_plain(x, *args))


# rows shorter than a tile, equal to it and longer; many rows of 32
RECIP_ROW_SHAPES = [(70_000, 32), (700, 96), (7, 4064), (7, 4096),
                    (7, 4128), (2, 1 << 21), (2, 7_812_512)]


@pytest.mark.parametrize("rows, n", RECIP_ROW_SHAPES)
@pytest.mark.parametrize("width", range(1, 25))
def test_encode_recip_rows_every_width_matches_plain(dev, width, rows, n):
    """K8 at every width over rows across tile edges, periodic at even
    widths: a constant row (recip inf), a subnormal x0 and subnormal
    values, and values on the unwrap's +-half edge."""
    periodic = width % 2 == 0
    g = torch.Generator(device=dev).manual_seed(width * 7 + n)
    x = torch.rand(rows, n, generator=g, device=dev) * 64.0
    x[0] = torch.from_numpy(_recip_plane(n, width, periodic)).to(dev)
    x[-1, ::5] = 1e-40
    x0 = torch.rand(rows, generator=g, device=dev) * 4.0
    recip = 1.0 / (40.0 + torch.rand(rows, generator=g, device=dev) * 20.0)
    if rows > 2:
        x[1] = 7.5
        x0[1] = 7.5
        recip[1] = float("inf")     # constant row: 0 * inf = NaN -> bin 0
        x0[2] = 1e-40
    box = torch.full((rows,), 64.0, device=dev)
    args = (width, x0, recip, box, x[:, 0].contiguous(), periodic)
    got = encode_cuda.encode_recip_rows_cuda(x, *args)
    assert torch.equal(got, encode_cuda.encode_recip_rows_plain(x, *args))


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("blocks, dims, n", [(1, 1, 32), (3, 3, 2048),
                                            (2, 3, 4096 * 5 + 32),
                                            (4096, 3, 64), (64, 3, 1 << 16)])
def test_encode_recip_fused_kernel_matches_plain(dev, blocks, dims, n,
                                                 periodic):
    g = torch.Generator(device=dev).manual_seed(blocks * n)
    x = torch.rand(blocks, dims, n, generator=g, device=dev) * 64.0
    x[0, 0] = torch.from_numpy(_recip_plane(n, 2, periodic)).to(dev)
    if blocks > 1:
        x[1] = 3.25                  # a constant block: range 0, recip inf
    box = 64.0 if periodic else 0.0
    anchors = x[:, :, 0].contiguous()
    for width in (1, 12, 14, 16, 24):
        got = encode_cuda.encode_recip_fused_blocks_cuda(x, box, anchors,
                                                         width, periodic)
        want = encode_cuda.encode_recip_fused_blocks_plain(
            x, box, anchors, width, periodic)
        for a, b in zip(got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("n, blocks", [(1 << 16, 8), (4000, 4)])
def test_recip_snapshot_on_cuda_matches_cpu(dev, n, blocks):
    arrays, spec = _snapshot(n)
    f_gpu, f_cpu = io.BytesIO(), io.BytesIO()
    mt.compress_snapshot(f_gpu, spec=spec, num_blocks=blocks, seed=5,
                         scale_mode="recip",
                         **{k: torch.from_numpy(v).to(dev)
                            for k, v in arrays.items()})
    mt.compress_snapshot(f_cpu, spec=spec, num_blocks=blocks, seed=5,
                         scale_mode="recip", device="cpu", **arrays)
    assert f_gpu.getvalue() == f_cpu.getvalue()
    got = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()), device=dev)
    want = mt.decompress_snapshot(io.BytesIO(f_gpu.getvalue()), device="cpu")
    for k in want:
        assert np.array_equal(got[k].cpu().numpy().view(np.uint8),
                              want[k].numpy().view(np.uint8))


def test_recip_paths_on_cuda_never_reach_a_plain_version(dev, monkeypatch,
                                                         tmp_path):
    """With every plain encode and decode version made to raise, the CUDA
    recip snapshot (32 | nb and not), the streaming writer and the CLI
    still run, through K5 and K8."""
    from minnow_c_tpu_torch import __main__ as cli
    from minnow_c_tpu_torch.drivers import gadget2

    def refuse(*args, **kwargs):
        raise AssertionError("plain version reached on the CUDA path")

    for mod, name in ((decode_cuda, "decode_plain"),
                      (decode_cuda, "decode_rows_plain"),
                      (decode_cuda, "unpack_rows_plain"),
                      (encode_cuda, "pack_plain"),
                      (encode_cuda, "pack_rows_plain"),
                      (encode_cuda, "stats_rows_plain"),
                      (encode_cuda, "encode_recip_plain"),
                      (encode_cuda, "encode_recip_rows_plain"),
                      (encode_cuda, "encode_recip_fused_blocks_plain")):
        monkeypatch.setattr(mod, name, refuse)
    k5, k8 = encode_cuda.encode_recip_cuda, encode_cuda.encode_recip_rows_cuda
    before = (k5.launches, k8.launches)
    for n, blocks in ((1 << 14, 4), (4000, 4)):
        arrays, spec = _snapshot(n)
        t = {k: torch.from_numpy(v).to(dev) for k, v in arrays.items()}
        f = io.BytesIO()
        mt.compress_snapshot(f, spec=spec, num_blocks=blocks, seed=1,
                             scale_mode="recip", **t)
        out = mt.decompress_snapshot(io.BytesIO(f.getvalue()), device=dev)
        assert torch.equal(out["ids"], t["ids"])
        nb = n // blocks
        s = io.BytesIO()
        mt.compress_snapshot_streaming(
            s, ({k: v[..., b * nb:(b + 1) * nb] for k, v in t.items()}
                for b in range(blocks)), spec, seed=1, scale_mode="recip")
        out = mt.decompress_snapshot(io.BytesIO(s.getvalue()), device=dev)
        assert torch.equal(out["ids"], t["ids"])
    assert k8.launches - before[1] >= 6 and k5.launches - before[0] >= 24
    arrays, _ = _snapshot(3000)
    hdr = gadget2.Gadget2Header(
        npart=(0, 3000, 0, 0, 0, 0), mass=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
        time=1.0, redshift=0.0, box_size=64.0, omega0=0.3,
        omega_lambda=0.7, hubble_param=0.7)
    src, comp, back = (str(tmp_path / f) for f in ("s.g2", "s.min", "b.g2"))
    with open(src, "wb") as f:
        gadget2.write_snapshot(f, hdr, arrays["pos"], arrays["vel"],
                               arrays["ids"])
    k5_before = k5.launches
    assert cli.main(["compress", src, comp, "--scale-mode", "recip",
                     "--device", "cuda"]) == 0
    assert cli.main(["decompress", comp, back, "--device", "cuda"]) == 0
    assert k5.launches - k5_before == 6
    with open(back, "rb") as f:
        _, _, _, ids = gadget2.read_snapshot(f)
    assert np.array_equal(ids.astype(np.int64), arrays["ids"])


def test_kernels_flush_subnormal_results_like_plain(dev):
    """Normal operands whose differences or sums are subnormal: the kernels
    (built with -ftz=true) flush them as the plain versions do.  K5 / K8 on
    values within 1e-37 above x0 = 1.2e-38; K1 / K2 decoding around 0 with
    x0 = -2e-38 and a bin width of 2e-38; K6 / K12 in a box of 3e-38."""
    g = torch.Generator(device=dev).manual_seed(11)
    x = 1.2e-38 + torch.rand(4096, generator=g, device=dev) * 1e-37
    x0, x1 = kernels.minmax(x)
    recip = kernels.exact_recip((x1 - x0).item())
    for width in (6, 16, 24):
        args = (width, x0.item(), recip, 0.0, x[0].item(), False)
        assert torch.equal(encode_cuda.encode_recip_cuda(x, *args),
                           encode_cuda.encode_recip_plain(x, *args))
        rows = x.reshape(2, 2048)
        r_args = (width, torch.full((2,), x0.item(), device=dev),
                  torch.full((2,), float(recip), device=dev),
                  torch.zeros(2, device=dev), rows[:, 0].contiguous(), False)
        assert torch.equal(encode_cuda.encode_recip_rows_cuda(rows, *r_args),
                           encode_cuda.encode_recip_rows_plain(rows, *r_args))
    words = _bins(dev, 2, 128, 32, 12)        # 4096 bins of 1 bit a row
    keys = torch.tensor([[5, 6], [7, 8]], device=dev)
    xs, dxs = torch.full((2,), -2e-38, device=dev), \
        torch.full((2,), 4e-38, device=dev)
    got = decode_cuda.decode_cuda(words[0], (5, 6), 1, 4096, -2e-38, 4e-38)
    want = decode_cuda.decode_plain(words[0], 5, 6, -2e-38,
                                    kernels.bin_width(4e-38, 1), 0.0, 4096,
                                    1, 0, False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert (want == 0).any()
    got = decode_cuda.decode_rows_cuda(words, keys, 1, 4096, xs, dxs)
    want = decode_cuda.decode_rows_plain(words, keys, xs,
                                         kernels.bin_width(dxs, 1), 0.0,
                                         4096, 1, False)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    tiny = torch.rand(3, 3, 4096, generator=g, device=dev) * 3e-38
    box = torch.full((9,), 3e-38, device=dev)
    rows = tiny.reshape(9, 4096)
    for a, b in zip(encode_cuda.stats_rows_cuda(rows, box, rows[:, 0].
                                                contiguous(), True),
                    encode_cuda.stats_rows_plain(rows, box, rows[:, 0].
                                                 contiguous(), True)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    anchors = tiny[:, :, 0].contiguous()
    for a, b in zip(encode_cuda.encode_recip_fused_blocks_cuda(
                        tiny, 3e-38, anchors, 12, True),
                    encode_cuda.encode_recip_fused_blocks_plain(
                        tiny, 3e-38, anchors, 12, True)):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---------------------------------------------------------------------------
# u64 fields over their whole range on the card
# ---------------------------------------------------------------------------

def _u64_field(case: str):
    """(field code, u64 values, accuracy): Unsi values around 2^63 and near
    2^64, and IDs on grids past 2^21 a side with the top bit set."""
    rng = np.random.default_rng(len(case))
    if case == "unsi_edges":
        return (mt.FieldCode.UNSI,
                np.array([1, (1 << 63) + 12345, (1 << 64) - 1], np.uint64),
                mt.IntAccuracy())
    if case == "unsi_one_plane_near_top":
        v = rng.integers(0, 1 << 32, 5000, dtype=np.uint64)
        return (mt.FieldCode.UNSI, v + np.uint64((1 << 64) - (1 << 32)),
                mt.IntAccuracy())
    if case == "unsi_two_planes_across_2_63":
        v = rng.integers(0, 1 << 41, 5000, dtype=np.uint64)
        return (mt.FieldCode.UNSI, v + np.uint64((1 << 63) - (1 << 40)),
                mt.IntAccuracy())
    w = int(case.split("_")[1])
    xs = rng.integers(w - 6, w + 6, 5000) % w
    ys = rng.integers(0, w, 5000)
    zs = rng.integers(w - 3, w + 3, 5000) % w
    ids = np.array([int(x) + w * int(y) + w * w * int(z)
                    for x, y, z in zip(xs, ys, zs)], np.uint64)
    ids[:3] = (0, w ** 3 - 1, (1 << 63) + 7)
    return mt.FieldCode.PTID, ids, mt.IDAccuracy(width=w)


@pytest.mark.parametrize("case", ["unsi_edges", "unsi_one_plane_near_top",
                                  "unsi_two_planes_across_2_63",
                                  "ptid_2097157", "ptid_2642245"])
def test_u64_segment_on_cuda_matches_cpu(dev, case):
    """Encoded from an int64 CUDA tensor of the u64 bits, decoded on the
    card: the CPU's bytes, and the u64 values back."""
    code, vals, acc = _u64_field(case)
    hd = mt.FieldHeader(code, mt.AlgoCode.TRIM, mt.semver.pack(1, 0, 0),
                        vals.size)
    t = torch.from_numpy(vals.view(np.int64))
    blob = mt.compress_segment(mt.Seg(fields=[mt.Field(hd=hd, data=t.to(dev),
                                                       acc=acc)]))
    assert blob == mt.compress_segment(
        mt.Seg(fields=[mt.Field(hd=hd, data=t, acc=acc)]), device="cpu")
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        assert got.fields[0].data.is_cuda
        assert np.array_equal(
            got.fields[0].data.cpu().numpy().view(np.uint64), vals)


@pytest.mark.parametrize("w", [(1 << 32) + 1, 1 << 32])
def test_wide_id_grid_on_cuda_matches_cpu(dev, w):
    """Grids wider than 2^32 a side, where w * w wraps mod 2^64 (to 0 at
    w = 2^32): the grid split on the card equals the CPU's, and so do the
    segment's bytes and its decode."""
    from minnow_c_tpu_torch.quant import engine
    vals = np.random.default_rng(w % 1000).integers(0, 1 << 64, 5000,
                                                    dtype=np.uint64)
    vals[:4] = (0, w - 1, (1 << 63) + 7, (1 << 64) - 1)
    t = torch.from_numpy(vals.view(np.int64))
    for a, b in zip(engine.id_decompose(t.to(dev), w),
                    engine.id_decompose(t, w)):
        assert torch.equal(a.cpu(), b)
    hd = mt.FieldHeader(mt.FieldCode.PTID, mt.AlgoCode.TRIM,
                        mt.semver.pack(1, 0, 0), vals.size)
    acc = mt.IDAccuracy(width=w)
    blob = mt.compress_segment(mt.Seg(fields=[mt.Field(hd=hd, data=t.to(dev),
                                                       acc=acc)]))
    assert blob == mt.compress_segment(
        mt.Seg(fields=[mt.Field(hd=hd, data=t, acc=acc)]), device="cpu")
    want = mt.decompress_segment(blob, device="cpu").fields[0].data
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        assert torch.equal(got.fields[0].data.cpu(), want)


# ---------------------------------------------------------------------------
# Log-mapped rows and Deltas planes (the log maps and Deltas mode)
# ---------------------------------------------------------------------------

def _mapped_rows(dev, rows, n, seed):
    """(rows, n) rows of symlog-mapped N(0, 300) velocities (t = 20) and,
    every other row, log10-mapped lognormal masses, with edge values."""
    from minnow_c_tpu_torch.quant import engine
    g = torch.Generator(device=dev).manual_seed(seed)
    v = 300.0 * torch.randn(rows, n, generator=g, device=dev)
    m = 10.0 ** (0.5 * torch.randn(rows, n, generator=g, device=dev))
    x = torch.where(torch.arange(rows, device=dev)[:, None] % 2 == 0,
                    engine.map_float(v, 2, 20.0), engine.map_float(m, 1, 0.0))
    x[0, :3] = torch.tensor([0.0, -0.0, 1e-40], device=dev)
    return x


@pytest.mark.parametrize("rows, n", [(6, 65_536), (3, 4096)])
def test_kernels_on_mapped_rows_match_plain(dev, rows, n):
    """K6 stats, K7 pack of the div bins and K2 decode of those words, each
    on log-mapped rows, equal their plain versions bitwise."""
    x = _mapped_rows(dev, rows, n, rows)
    _same_stats(x)
    box = torch.zeros(rows, device=dev)
    mn, mx = encode_cuda.stats_rows_cuda(x, box, x[:, 0].contiguous(), False)
    rng = kernels.ftz(mx - mn)
    for width in (12, 17, 24):
        bins = kernels.uniform_bin_index(x, width, mn[:, None], rng[:, None])
        words = encode_cuda.pack_rows_cuda(bins, width)
        assert torch.equal(words, encode_cuda.pack_rows_plain(bins, width))
        keys = torch.tensor([[7, 8]], device=dev).expand(rows, 2)
        got = decode_cuda.decode_rows_cuda(words, keys, width, n, mn, rng)
        want = decode_cuda.decode_rows_plain(words, keys, mn,
                                             kernels.bin_width(rng, width),
                                             0.0, n, width)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 257, 40_000])
def test_deltas_trim_v1_1_plane_on_cuda_matches_cpu(dev, n):
    """A Trim v1.1 segment with per-particle accuracies (positions,
    symlog velocities, log10 masses) encoded from CUDA tensors gives the
    CPU's bytes where the map is the identity, and decodes on CUDA
    (generic and fused) to the CPU decode of the same bytes within the
    maps' unmap; the Deltas planes pack with K7 and unpack with K3."""
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 64, (3, n)).astype(np.float32)
    mass = (10 ** rng.normal(0, 0.5, n)).astype(np.float32)
    dl = np.where(np.arange(n) < n // 4, 1e-4, 1e-3).astype(np.float32)
    v = mt.semver.pack(1, 1, 0)
    F = mt.FieldCode

    def seg(device, log):
        def field(code, data, acc):
            return mt.Field(hd=mt.FieldHeader(code, mt.AlgoCode.TRIM, v, n),
                            data=torch.from_numpy(data).to(device), acc=acc)
        return mt.Seg(fields=[
            field(F.POSN, pos, mt.PositionAccuracy(delta=0.0, width=64.0,
                                                   deltas=dl)),
            field(F.UNSF, mass, mt.FloatAccuracy(
                delta=0.0, deltas=dl, log10_scaled=1 if log else 0))])

    before = (encode_cuda.pack_rows_cuda.launches,
              decode_cuda.unpack_rows_cuda.launches)
    blob = mt.compress_segment(seg(dev, False), seed=2)
    assert blob == mt.compress_segment(seg("cpu", False), seed=2,
                                       device="cpu")
    for fused in (False, True):
        got = mt.decompress_segment(blob, fused=fused, device=dev)
        want = mt.decompress_segment(blob, fused=fused, device="cpu")
        for a, b in zip(got.fields, want.fields):
            assert a.data.is_cuda
            assert np.array_equal(a.data.cpu().numpy().view(np.uint8),
                                  b.data.numpy().view(np.uint8))
    after = (encode_cuda.pack_rows_cuda.launches,
             decode_cuda.unpack_rows_cuda.launches)
    assert n < 256 or all(a > b for a, b in zip(after, before))
    # log10 masses on Deltas: CUDA and CPU decodes of one file agree within
    # the unmap's 1-ulp exp, and both meet the per-particle accuracy
    blob = mt.compress_segment(seg(dev, True), seed=2)
    got = mt.decompress_segment(blob, fused=True, device=dev).fields[1].data
    want = mt.decompress_segment(blob, device="cpu").fields[1].data
    err = np.abs(np.log10(got.cpu().numpy().astype(np.float64)) -
                 np.log10(mass))
    assert (err <= dl + 1.2e-6).all()
    assert (torch.abs(got.cpu() - want) <= 2 * torch.finfo(
        torch.float32).eps * want.abs()).all()


def _bits_np(t) -> bytes:
    return np.ascontiguousarray(t.cpu().numpy()).tobytes()


@pytest.mark.parametrize("scale_mode", ["div", "recip"])
def test_sharded_position_codec_kernels(dev, scale_mode):
    """The block-sharded position codec on the card: its kernels (K6, K7 or
    K8, K2) give the bits of the plain path (``fused_rows=False``) and of
    the CPU, on one shard and on four logical shards of the card."""
    from minnow_c_tpu_torch.parallel import sharding
    rng = np.random.default_rng(31)
    x = rng.uniform(0, 64, (8, 3, 4096)).astype(np.float32)
    x[:2, 0] = np.mod(rng.normal(0, 2.0, (2, 4096)), 64).astype(np.float32)
    depth = sharding.spmd_depth_for(1e-3, 64.0)
    kw = dict(width=64.0, depth=depth, scale_mode=scale_mode)
    cpu = sharding.ShardedPositionCodec(
        mesh=sharding.make_mesh(2, device="cpu"), **kw)
    want = cpu.encode(x)
    want_out = cpu.decode(*want, seed=3)
    xd = torch.from_numpy(x).to(dev)
    for shards in (1, 4):
        counted = (encode_cuda.stats_rows_cuda, encode_cuda.pack_rows_cuda,
                   encode_cuda.encode_recip_rows_cuda,
                   decode_cuda.decode_rows_cuda)
        before = [f.launches for f in counted]
        fast = sharding.ShardedPositionCodec(
            mesh=sharding.make_mesh(shards), **kw)
        plain = sharding.ShardedPositionCodec(
            mesh=sharding.make_mesh(shards), fused_rows=False, **kw)
        enc = fast.encode(xd)
        out = fast.decode(*enc, seed=3)
        launched = [f.launches - b for f, b in zip(counted, before)]
        assert launched[0] == shards and launched[3] == shards
        assert launched[1 if scale_mode == "div" else 2] == shards
        assert out.is_cuda
        for a, b, c in zip(enc, plain.encode(xd), want):
            assert _bits_np(a) == _bits_np(b) == _bits_np(c)
        assert _bits_np(out) == _bits_np(plain.decode(*enc, seed=3)) == \
            _bits_np(want_out)


def test_sharded_snapshot_codec_kernels(dev):
    """The block-sharded snapshot codec on the card (K6, K7, K2, K3): its
    words, headers and decodes equal the plain path's and the CPU's."""
    from minnow_c_tpu_torch.parallel import sharding
    rng = np.random.default_rng(32)
    pos = rng.uniform(0, 64, (4, 3, 2048)).astype(np.float32)
    vel = rng.normal(0, 200, (4, 3, 2048)).astype(np.float32)
    ids = rng.permutation(1 << 24)[:4 * 2048].astype(np.uint64).reshape(
        4, 2048)
    kw = dict(box=64.0, pos_depth=16, vel_depth=12, id_grid=256)
    before = decode_cuda.unpack_rows_cuda.launches
    fast = sharding.ShardedSnapshotCodec(mesh=sharding.make_mesh(2), **kw)
    plain = sharding.ShardedSnapshotCodec(mesh=sharding.make_mesh(2),
                                          fused_rows=False, **kw)
    cpu = sharding.ShardedSnapshotCodec(
        mesh=sharding.make_mesh(2, device="cpu"), **kw)
    tens = [torch.from_numpy(a).to(dev) for a in
            (pos, vel, ids.view(np.int64))]
    enc = fast.encode(*tens)
    want = cpu.encode(pos, vel, ids)
    for a, b, c in zip(enc, plain.encode(*tens), want):
        assert _bits_np(a) == _bits_np(b) == _bits_np(c)
    out = fast.decode(enc, seed=4)
    assert decode_cuda.unpack_rows_cuda.launches - before == 2
    for a, b, c in zip(out, plain.decode(enc, seed=4),
                       cpu.decode(want, seed=4)):
        assert _bits_np(a) == _bits_np(b) == _bits_np(c)
    np.testing.assert_array_equal(out[2].cpu().numpy().view(np.uint64), ids)


@pytest.mark.parametrize("case", sorted(gadget2_cases.CASES))
def test_gadget2_decompress_lays_the_file_out_on_the_card(dev, case):
    """The driver's decompress on the card (transposes there, one copy a
    field into a pinned image of the file, one write): its file equals
    ``write_snapshot`` of host copies of the card's decode, byte for byte,
    and the JAX package's decompress of the same ``.g2.min``, by the
    digest ``test_torch_drivers.py`` holds against it.  Cases: table,
    mixed and all-positive masses, IDs read from u32 records, n not a
    multiple of 32.  The record counts as ``d2h`` the fields' bytes
    (the MASS record's alone), all of them as ``d2h_pinned``."""
    from minnow_c_tpu_torch.drivers import gadget2
    from minnow_c_tpu_torch.utils import profiling
    n, masses, _, blocks = gadget2_cases.CASES[case]
    raw = gadget2_cases.raw_file(case)
    packed = io.BytesIO()
    gadget2.compress(io.BytesIO(raw), packed, num_blocks=blocks,
                     device="cpu")
    out = io.BytesIO()
    gadget2.decompress(io.BytesIO(packed.getvalue()), out, device=dev)
    rec = profiling.operations()[-1]
    got = out.getvalue()
    f = io.BytesIO(packed.getvalue())
    hdr = gadget2.Gadget2Header.unpack(gadget2._read_record(f))
    host = {k: v.cpu().numpy()
            for k, v in mt.decompress_snapshot(f, device=dev).items()}
    want = io.BytesIO()
    gadget2.write_snapshot(want, hdr, host["pos"], host["vel"], host["ids"],
                           mass=host.get("mass"))
    assert got == want.getvalue()
    assert gadget2_cases.digest(got, case) == gadget2_cases.DIGESTS[case]
    npart, table, *_, mass0 = gadget2_cases.fields(case)
    if masses == "positive":
        *_, mass = gadget2.read_snapshot_ext(io.BytesIO(got))
        assert (np.abs(mass / mass0 - 1) <= 1.0001e-4).all()
    nm = sum(c for c, m in zip(npart, table) if c and m == 0.0)
    assert rec.name == "g2.decompress"
    assert rec.counters["d2h"] == 32 * n + 4 * nm
    assert rec.counters["d2h_pinned"] == rec.counters["d2h"]
