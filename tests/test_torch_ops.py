"""The torch port's L1 ops against the JAX package, on the CPU.

Inputs are made with numpy from fixed seeds and handed to both packages.
Where the JAX function is a Pallas kernel it runs in interpret mode, with
n >= 2^14 so that a whole kernel tile is exercised; the port's kernel
wrappers run their plain torch versions here, since the tensors are on the
CPU.  Tolerance: bitwise equality throughout (float results are compared
as their u32 bit patterns).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from minnow_c_tpu.ops import bitpack as jbitpack
from minnow_c_tpu.ops import decode_pallas, encode_pallas
from minnow_c_tpu.ops import fastpath as jfastpath
from minnow_c_tpu.ops import kernels as jkernels
from minnow_c_tpu.ops import native as jnative
from minnow_c_tpu_torch.ops import bitpack, cuda_lib, decode_cuda, encode_cuda
from minnow_c_tpu_torch.ops import kernels, scan_cuda
from minnow_c_tpu_torch.ops import fastpath
from minnow_c_tpu_torch.ops import rng as trng

TILE = 1 << 14  # the Pallas kernels' smallest tile


def _bits(a) -> np.ndarray:
    """Float or int array/tensor -> its 32-bit patterns as uint32."""
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).view(np.uint32)


def _u32_tensor(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


# ---------------------------------------------------------------------------
# dither
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ctr0", [0, 4, 1 << 14])
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_dither_matches_numpy_mirror(n, ctr0):
    key = trng.field_key(777, 3, 2)
    got = trng.dither_u16(key, n, ctr0=ctr0,
                          device="cpu").numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, trng.dither_u16_np(key, n, ctr0=ctr0))
    u = trng.uniform_dither(key, (n,), ctr0=ctr0, device="cpu")
    np.testing.assert_array_equal(
        _bits(u), _bits(trng.uniform_dither_np(key, (n,), ctr0=ctr0)))


def test_dither_rejects_unaligned_ctr0():
    with pytest.raises(ValueError):
        trng.dither_u16((1, 2), 8, ctr0=2, device="cpu")


# ---------------------------------------------------------------------------
# K1 decode: plain version vs decode_pallas (interpret) and the XLA path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [TILE, TILE + 37])
@pytest.mark.parametrize("width", [1, 11, 24])
def test_decode_plain_matches_jax(width, n, periodic):
    rng = np.random.default_rng(width * 7 + n % 5)
    bins = rng.integers(0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
    bins[:2] = (0, (1 << width) - 1)
    words = jnative.uniform_pack_host(bins, width)
    key = (0x9E3779B9, 0x7F4A7C15)
    x0, dx, box = (-2.0 if periodic else 1.5), 64.0, 64.0
    ref = np.asarray(decode_pallas.decode_pallas(
        jnp.asarray(words), jnp.asarray(key, jnp.uint32), width, n, x0, dx,
        box, periodic=periodic, interpret=True))
    xla = np.asarray(jfastpath.fast_uniform_decode(
        jnp.asarray(words), jnp.asarray(key, jnp.uint32), width, n, x0, dx,
        periodic_width=box if periodic else None))
    got = decode_cuda.decode_cuda(_u32_tensor(words), key, width, n, x0, dx,
                                  box, periodic=periodic)
    np.testing.assert_array_equal(_bits(got), _bits(ref))
    np.testing.assert_array_equal(_bits(got), _bits(xla))
    twin = fastpath.fast_uniform_decode(
        _u32_tensor(words), key, width, n, x0, dx,
        periodic_width=box if periodic else None)
    np.testing.assert_array_equal(_bits(twin), _bits(ref))


def test_decode_elem0_continues_the_stream():
    """A plane decoded from element 2^14 on equals the tail of the whole
    plane's decode (dither counters offset by elem0 / 4)."""
    width, n = 9, 2 * TILE
    bins = np.random.default_rng(5).integers(
        0, 1 << width, n, dtype=np.uint64).astype(np.uint32)
    key = (11, 22)
    full = decode_cuda.decode_cuda(
        _u32_tensor(jnative.uniform_pack_host(bins, width)), key, width, n,
        0.0, 8.0)
    tail = decode_cuda.decode_cuda(
        _u32_tensor(jnative.uniform_pack_host(bins[TILE:], width)), key,
        width, TILE, 0.0, 8.0, elem0=TILE)
    np.testing.assert_array_equal(_bits(tail), _bits(full[TILE:]))


# ---------------------------------------------------------------------------
# K4 pack: plain version vs pack_pallas (interpret) and uniform_pack
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("width", [1, 7, 13, 31, 32])
def test_pack_plain_matches_jax(width):
    n = TILE + 37
    rng = np.random.default_rng(width)
    # full-range u32 values: the pack must keep only the low `width` bits
    vals = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(encode_pallas.pack_pallas(
        jnp.asarray(vals), width, n, interpret=True))
    xla = np.asarray(jbitpack.uniform_pack(jnp.asarray(vals), width))
    got = encode_cuda.pack_cuda(_u32_tensor(vals), width)
    np.testing.assert_array_equal(_bits(got), ref)
    np.testing.assert_array_equal(_bits(got), xla)
    np.testing.assert_array_equal(
        _bits(bitpack.uniform_pack(_u32_tensor(vals), width)), ref)


def _scaled_plane(width: int, n: int) -> np.ndarray:
    """A pre-scaled f32 plane with NaN, +-inf, negatives, values >= 2^w and
    +-1 ulp around bin edges, the rest uniform in [0, 2^w)."""
    rng = np.random.default_rng(100 + width)
    nb = np.float32(1 << width)
    s = (rng.random(n, dtype=np.float32) * nb).astype(np.float32)
    edges = rng.integers(0, 1 << width, 64).astype(np.float32)
    special = np.concatenate([
        [np.nan, np.inf, -np.inf, -0.0, 0.0, -1.0, -0.5, nb, nb * 2,
         np.nextafter(nb, np.float32(0)), 1e30],
        edges, np.nextafter(edges, np.float32(-np.inf)),
        np.nextafter(edges, np.float32(np.inf))]).astype(np.float32)
    s[:special.size] = special
    return s


@pytest.mark.parametrize("width", [1, 13, 24])
def test_pack_plain_from_f32_matches_jax(width):
    n = TILE + 37
    s = _scaled_plane(width, n)
    ref = np.asarray(encode_pallas.pack_pallas(
        jnp.asarray(s), width, n, from_f32=True, interpret=True))
    got = encode_cuda.pack_cuda(torch.from_numpy(s), width, from_f32=True)
    np.testing.assert_array_equal(_bits(got), ref)
    bins = np.asarray(encode_pallas._scaled_to_bins(jnp.asarray(s), width))
    np.testing.assert_array_equal(
        kernels.scaled_to_bins(torch.from_numpy(s), width).numpy(), bins)


@pytest.mark.parametrize("width", [0, 5, 32])
def test_uniform_unpack_matches_jax(width):
    n = 1000
    vals = np.random.default_rng(width).integers(
        0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    words = jnative.uniform_pack_host(vals, width)
    ref = np.asarray(jbitpack.uniform_unpack(jnp.asarray(words), width, n))
    got = bitpack.uniform_unpack(_u32_tensor(words), width, n)
    np.testing.assert_array_equal(_bits(got), ref)


@pytest.mark.parametrize("which", ["decode", "pack"])
def test_wrappers_run_plain_only_for_cpu_tensors(which):
    """A tensor off the CPU goes to the kernel or raises; the wrappers never
    fall back to the plain version for it."""
    words = torch.zeros(64, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        if which == "decode":
            decode_cuda.decode_cuda(words, (1, 2), 8, 64, 0.0, 1.0)
        else:
            encode_cuda.pack_cuda(words, 8)


def test_pack_rejects_wide_float_planes():
    with pytest.raises(ValueError):
        encode_cuda.pack_plain(torch.zeros(64), 25, from_f32=True)


# ---------------------------------------------------------------------------
# bin maps and periodic unwrap
# ---------------------------------------------------------------------------

def _plane(seed: int, n: int = 5000):
    """Values over [x0, x0 + dx) with both ends, bin edges +-1 ulp, and an
    out-of-range value on each side."""
    rng = np.random.default_rng(seed)
    x0, dx = np.float32(-3.25), np.float32(17.5)
    x = (x0 + rng.random(n, dtype=np.float32) * dx).astype(np.float32)
    edges = (x0 + dx * (np.arange(64, dtype=np.float32) / 64)).astype(
        np.float32)
    x[:64] = edges
    x[64:128] = np.nextafter(edges, np.float32(np.inf))
    x[128:192] = np.nextafter(edges, np.float32(-np.inf))
    x[192:196] = (x0, x0 + dx, x0 - 1, x0 + dx + 1)
    return x, float(x0), float(dx)


@pytest.mark.parametrize("level", [1, 12, 24])
def test_bin_index_matches_jax(level):
    x, x0, dx = _plane(level)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        _bits(kernels.uniform_bin_index(xt, level, x0, dx)),
        np.asarray(jkernels.uniform_bin_index(jnp.asarray(x), level, x0,
                                              dx)))
    np.testing.assert_array_equal(
        _bits(kernels.uniform_bin_index_recip(xt, level, x0, dx)),
        np.asarray(jkernels.uniform_bin_index_recip(jnp.asarray(x), level,
                                                    x0, dx)))


@pytest.mark.parametrize("recip", [False, True])
def test_constant_plane_bins_to_zero(recip):
    """dx == 0 makes delta NaN; the bin must be 0 (masked before the cast,
    NaN -> int is undefined in torch)."""
    fn = kernels.uniform_bin_index_recip if recip \
        else kernels.uniform_bin_index
    got = fn(torch.full((100,), 2.5), 7, 2.5, 0.0)
    assert got.dtype == torch.int32 and not got.any()


def test_undo_periodic_matches_jax():
    W = 64.0
    rng = np.random.default_rng(3)
    x = ((rng.normal(0, 2.0, 5000) + 1.0) % W).astype(np.float32)
    x[0] = np.float32(63.5)
    np.testing.assert_array_equal(
        _bits(kernels.undo_periodic(torch.from_numpy(x), W)),
        _bits(jkernels.undo_periodic(jnp.asarray(x), W)))
    y = (x - np.float32(1.0)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(kernels.periodic(torch.from_numpy(y), W)),
        _bits(jkernels.periodic(jnp.asarray(y), W)))


def test_u64_undo_periodic_matches_jax():
    L = 512
    ids = np.random.default_rng(4).integers(0, 40, 3000)
    ids = np.where(ids > 20, ids + L - 40, ids).astype(np.uint64)
    ids[0] = 505
    ref = np.asarray(jkernels.u64_undo_periodic(jnp.asarray(ids), L))
    got = kernels.u64_undo_periodic(torch.from_numpy(ids.astype(np.int64)),
                                    L)
    np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))
    np.testing.assert_array_equal(
        kernels.u64_periodic(got, L).numpy(),
        np.asarray(jkernels.u64_periodic(jnp.asarray(ref), L)).astype(
            np.int64))


def _u64_values(seed: int, d: int = 1) -> np.ndarray:
    """Random u64 values plus the edges of the range and of a divisor d."""
    v = np.random.default_rng(seed).integers(0, 1 << 64, 20000,
                                             dtype=np.uint64)
    edges = [0, 1, 2, (1 << 32) - 1, 1 << 32, (1 << 63) - 1, 1 << 63,
             (1 << 63) + 1, (1 << 64) - 2, (1 << 64) - 1]
    edges += [m * d + e for m in (1, 2, 3, (1 << 64) // d - 1,
                                  (1 << 64) // d) for e in (-1, 0, 1)]
    return np.concatenate([v, np.array([e % (1 << 64) for e in edges],
                                       np.uint64)])


# 1 and the ID grid widths at their edges: 2^21 + 5, 2642245 (the largest w
# with w^3 <= 2^64), 2^22 - 1; divisors past 2^32, and on both sides of 2^62
# and 2^63 (the squares of wide grids wrap there)
@pytest.mark.parametrize("d", [1, 2, 3, 7, (1 << 21) + 5, 2642245,
                               (1 << 22) - 1, (1 << 32) + 1, (1 << 61) + 1,
                               (1 << 62) + 3, (1 << 63) - 1, 1 << 63,
                               (1 << 63) + 5, (1 << 64) - 1])
def test_u64_divmod_matches_numpy(d):
    x = _u64_values(d, d)
    q, r = kernels.u64_divmod(torch.from_numpy(x.view(np.int64)), d)
    np.testing.assert_array_equal(q.numpy().view(np.uint64),
                                  x // np.uint64(d))
    np.testing.assert_array_equal(r.numpy().view(np.uint64),
                                  x % np.uint64(d))


def test_u64_divmod_range():
    x = torch.arange(4, dtype=torch.int64)
    for d in (0, -1, 1 << 64):
        with pytest.raises(ValueError, match="u64 divisor"):
            kernels.u64_divmod(x, d)


def test_u64_order_shift_and_wrap_match_numpy():
    """Unsigned min / max / compare / logical shift through the helpers, and
    int64 add, subtract, multiply and left shift wrapping as u64 does."""
    x, y = _u64_values(1), _u64_values(2)
    tx, ty = (torch.from_numpy(a.view(np.int64)) for a in (x, y))
    pairs = np.stack([x, y])
    low = pairs >> np.uint64(1)          # no value with its top bit set
    for a in (pairs, low, low.T.copy()):
        for dim in (0, 1):
            mn, mx = kernels.u64_minmax(torch.from_numpy(a.view(np.int64)),
                                        dim)
            np.testing.assert_array_equal(mn.numpy().view(np.uint64),
                                          a.min(axis=dim))
            np.testing.assert_array_equal(mx.numpy().view(np.uint64),
                                          a.max(axis=dim))
    np.testing.assert_array_equal(kernels.u64_ge(tx, ty).numpy(), x >= y)
    for c in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        np.testing.assert_array_equal(
            kernels.u64_ge(tx, kernels.u64_to_i64(c)).numpy(),
            x >= np.uint64(c))
    for k in (1, 31, 32, 63):
        np.testing.assert_array_equal(
            kernels.u64_shr(tx, k).numpy().view(np.uint64),
            x >> np.uint64(k))
    with np.errstate(over="ignore"):
        for got, want in ((tx + ty, x + y), (tx - ty, x - y),
                          (tx * ty, x * y), (tx << 32, x << np.uint64(32)),
                          (tx * 2642245 ** 2, x * np.uint64(2642245 ** 2))):
            np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    # int64 -> int32 keeps the low 32 bits (the u32 cast of ID bins), and
    # u32_to_i64 leaves an int64 input as it was
    np.testing.assert_array_equal(tx.to(torch.int32).numpy().view(np.uint32),
                                  x.astype(np.uint32))
    before = tx.clone()
    np.testing.assert_array_equal(kernels.u32_to_i64(tx).numpy(),
                                  (x & np.uint64(0xFFFFFFFF)).astype(np.int64))
    assert torch.equal(tx, before)
    for v in (0, 1, (1 << 63) - 1, 1 << 63, (1 << 64) - 1):
        assert kernels.i64_to_u64(kernels.u64_to_i64(v)) == v
        assert kernels.i64_to_u64(torch.tensor(kernels.u64_to_i64(v))) == v


def test_fast_uniform_encode_matches_jax():
    """div mode through the pack wrapper's from_f32 path, recip through the
    recip bin map; both against the JAX package's XLA encode."""
    W = 64.0
    x = np.random.default_rng(8).uniform(0, W, TILE + 99).astype(np.float32)
    for mode in ("div", "recip"):
        w_ref, x0_ref, r_ref = jfastpath.fast_uniform_encode(
            jnp.asarray(x), 15, periodic_width=W, scale_mode=mode)
        words, x0, r = fastpath.fast_uniform_encode(
            torch.from_numpy(x), 15, periodic_width=W, scale_mode=mode)
        np.testing.assert_array_equal(_bits(words), np.asarray(w_ref))
        assert _bits(x0.reshape(1)) == _bits(np.float32(x0_ref).reshape(1))
        assert _bits(r.reshape(1)) == _bits(np.float32(r_ref).reshape(1))


# The plans of the tile kernels (K1 / K2 decode, K4 / K7 pack) against a
# brute-force model of the flat stream: every element in exactly one tile
# that one block visits, its bits inside its tile's words and the stream's,
# 16-byte copies only from 16-byte boundaries, the in-tile row split exact.

PLAN_SHAPES = [(1, 32), (70_000, 32), (3, 65_568), (1, 33), (1, 100_003)] + \
    [(3, 100_000 + 32 * k) for k in (1, 3, 17, 128)]


def _plan_check(plan, width, total, ptr, rows_n=None):
    tile, tiles, wpt = plan["tile"], plan["tiles"], plan["words_per_tile"]
    n_words = -(-total * width // 32)
    assert wpt == tile // 32 * width and wpt % 4 == 0
    seen = np.zeros(tiles, np.int64)
    for b in range(plan["grid"]):
        seen[b::plan["grid"]] += 1
    assert (seen == 1).all() and plan["grid"] <= tiles
    e = np.arange(total, dtype=np.int64)
    t = e // tile
    assert t.max() == tiles - 1
    lo, hi = e * width, e * width + width - 1
    assert (lo >= t * wpt * 32).all()
    assert (hi < np.minimum((t + 1) * wpt, n_words) * 32).all()
    assert plan["vec16"] == (ptr % 16 == 0)
    if plan["vec16"]:
        assert all((ptr + k * wpt * 4) % 16 == 0 for k in range(tiles))
    if rows_n is not None:   # the kernel's 32-bit row split of each quad
        n = rows_n
        magic = cuda_lib.row_magic(n)
        e0 = np.arange(tiles, dtype=np.int64) * tile
        i = np.arange(0, tile, 4, dtype=np.int64)
        off = ((e0 % n)[:, None] + i[None, :]).reshape(-1)
        keep = (np.repeat(e0, i.size) + np.tile(i, tiles)) < total
        off = off[keep]
        assert off.max() < 1 << 32
        q = (off * magic) >> 32
        r = off - q * n
        q = np.where(r >= n, q + 1, q)
        r = np.where(r >= n, r - n, r)
        assert (q == off // n).all() and (r == off % n).all()


@pytest.mark.parametrize("width", range(1, 33))
def test_tile_plans_cover_the_stream(width):
    for rows, n in PLAN_SHAPES:
        total = rows * n
        for ptr in (1 << 20, (1 << 20) + 4, (1 << 20) + 8):
            plan = encode_cuda.pack_plan(width, total, ptr, 132)
            _plan_check(plan, width, total, ptr)
            assert plan["tile"] % 1024 == 0
            assert plan["smem_bytes"] >= (plan["tile"] +
                                          plan["tile"] // 32) * 4
            if width > 24:
                continue
            plan = decode_cuda.decode_plan(width, total, ptr, 132)
            _plan_check(plan, width, total, ptr,
                        rows_n=n if n % 32 == 0 else None)
            assert plan["tile"] % 128 == 0
            assert plan["smem_bytes"] == 2 * (plan["words_per_tile"] +
                                              4) * 4 <= 48 * 1024


# K8's row finding (csrc/pack.cuh RecipBins, rows.cuh) against a brute-force
# model: per tile one 64-bit division for the first row and its offset, then
# per 4-element chunk past that row the 32-bit magic division; every chunk
# must land on the row and offset of its first element, and lie in one row.

@pytest.mark.parametrize("rows, n", [(70_000, 32), (5000, 96), (40, 4064),
                                     (40, 4096), (40, 4128), (3, 1 << 21),
                                     (3, 7_812_512)])
def test_recip_rows_split_matches_brute_force(rows, n):
    total = rows * n
    plan = encode_cuda.pack_plan(16, total, 1 << 20, 132)
    tile, tiles = plan["tile"], plan["tiles"]
    magic = cuda_lib.row_magic(n)
    e0 = np.arange(tiles, dtype=np.int64) * tile
    row0 = e0 // n                      # the tile's first row, once a tile
    off0 = e0 - row0 * n
    i = np.arange(0, tile, 4, dtype=np.int64)
    e = (e0[:, None] + i[None, :]).reshape(-1)
    keep = e < total
    off = (off0[:, None] + i[None, :]).reshape(-1)[keep]
    row = np.repeat(row0, i.size)[keep]
    e = e[keep]
    assert off.max() < 1 << 32
    past = off >= n                     # chunks past the tile's first row
    q = (off[past] * magic) >> 32       # __umulhi
    r = off[past] - q * n
    q = np.where(r >= n, q + 1, q)
    r = np.where(r >= n, r - n, r)
    row[past] += q
    off[past] = r
    assert (row == e // n).all() and (off == e % n).all()
    assert ((e + 3) // n == e // n).all()


def test_row_magic_range():
    assert cuda_lib.row_magic(2) == 1 << 31
    assert cuda_lib.row_magic(1 << 31) == 2
    assert cuda_lib.row_magic(7_812_512) == (1 << 32) // 7_812_512
    for n in (0, 1, (1 << 31) + 1):
        with pytest.raises(ValueError):
            cuda_lib.row_magic(n)


# K9's plan (csrc/scan.cu) against a model of its tiles: every element in
# exactly one tile, taken by ticket by a persistent grid no larger than the
# tile count, one status word a tile, 16-byte loads only from 16-byte
# boundaries, int32 in-tile offsets, 32-bit tickets.

SCAN_NS = [1, 2, 31, 4095, 4096, 4097, 8191, 8192, 8193, (1 << 20) + 5,
           1 << 24, 3 * (1 << 24) + 7, (1 << 31) - 1, 1 << 31, (1 << 31) + 1,
           (1 << 31) + 4097, 1 << 40, ((1 << 31) - 1) * 4096]


@pytest.mark.parametrize("n", SCAN_NS)
def test_scan_plan_covers_the_stream(n):
    for ptr in (1 << 20, (1 << 20) + 4, (1 << 20) + 8, (1 << 20) + 12):
        plan = scan_cuda.scan_plan(n, ptr, 132)
        tile, tiles, grid = plan["tile"], plan["tiles"], plan["grid"]
        assert tile == 128 * 32 and plan["vec16"] == (ptr % 16 == 0)
        assert (tiles - 1) * tile < n <= tiles * tile < (1 << 31) * tile
        assert 1 <= grid == min(tiles, 132 * scan_cuda.BLOCKS_PER_SM)
        assert tiles + grid - 1 < 1 << 32          # the last ticket
        assert plan["status_words"] == 1 + tiles
        last = n - (tiles - 1) * tile       # the ragged last tile's count
        assert 1 <= last <= tile
        if plan["vec16"]:
            assert (ptr + 4 * tile) % 16 == 0   # every tile then is
    with pytest.raises(ValueError):
        scan_cuda.scan_plan(((1 << 31) - 1) * 4096 + 1, 1 << 20, 132)


def test_scan_status_words_per_stream():
    """K9's status words: one buffer a device and stream, kept between
    calls, grown only when n grows (the C entry point clears it)."""
    scan_cuda._scratch.clear()
    words = scan_cuda.status_words((0, 7), 5, "cpu")
    assert words.numel() == 5 and words.dtype == torch.int64
    assert scan_cuda.status_words((0, 7), 3, "cpu") is words
    assert scan_cuda.status_words((0, 7), 5, "cpu") is words
    other = scan_cuda.status_words((0, 8), 5, "cpu")
    assert other is not words
    grown = scan_cuda.status_words((0, 7), 9, "cpu")
    assert grown.numel() == 9 and grown is not words
    assert scan_cuda.status_words((0, 7), 4, "cpu") is grown
    scan_cuda._scratch.clear()
