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
from minnow_c_tpu_torch.ops import bitpack, decode_cuda, encode_cuda, kernels
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
    got = trng.dither_u16(key, n, ctr0=ctr0).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, trng.dither_u16_np(key, n, ctr0=ctr0))
    u = trng.uniform_dither(key, (n,), ctr0=ctr0)
    np.testing.assert_array_equal(
        _bits(u), _bits(trng.uniform_dither_np(key, (n,), ctr0=ctr0)))


def test_dither_rejects_unaligned_ctr0():
    with pytest.raises(ValueError):
        trng.dither_u16((1, 2), 8, ctr0=2)


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
