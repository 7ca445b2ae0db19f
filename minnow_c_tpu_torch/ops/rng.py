"""Deterministic random number generation for decode dithering.

Two generators live here:

1. ``Xoroshiro128Plus`` -- a numpy, bit-exact replica of the reference RNG
   (``src/rand.c``: splitmix64 seeding rand.c:114-121, xoroshiro128+ step
   with rotl constants 55/14/36 rand.c:80-90, the 2^64 jump rand.c:96-112,
   24-bit-mantissa uniform floats rand.c:60-64, rejection-sampled bounded
   ints rand.c:45-58).  Host-side utility kept for parity with the
   reference's RNG contract -- ``seed(seed, n)`` produces n non-overlapping
   streams for parallel decode, exactly like ``rand_Seed``.

2. ``uniform_dither`` -- the stream-format dither source: an explicitly
   specified counter-based Threefry (see the section comment below), so it
   is stateless, order-independent, and identical on CPU, CUDA, host
   numpy and the JAX package.  The reference seeds its decode dither from
   ``clock()`` (quant.c:639), which makes decode nondeterministic; we carry a
   seed in the stream header and derive per-field, per-element randomness
   by key derivation.  This is a deliberate, documented divergence
   (SURVEY.md "known reference defects").
"""

from __future__ import annotations

import numpy as np
import torch

_MASK64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def _rotl(x: np.ndarray, k: int) -> np.ndarray:
    k = np.uint64(k)
    return (x << k) | (x >> (np.uint64(64) - k))


def splitmix64(state: int, n: int) -> np.ndarray:
    """Generate n splitmix64 outputs, advancing from ``state``
    (rand.c:114-121)."""
    out = np.empty(n, dtype=np.uint64)
    s = np.uint64(state)
    inc = np.uint64(0x9E3779B97F4A7C15)
    m1 = np.uint64(0xBF58476D1CE4E5B9)
    m2 = np.uint64(0x94D049BB133111EB)
    with np.errstate(over="ignore"):
        for i in range(n):
            s = s + inc
            z = s
            z = (z ^ (z >> np.uint64(30))) * m1
            z = (z ^ (z >> np.uint64(27))) * m2
            out[i] = z ^ (z >> np.uint64(31))
    return out


def _xoro_step(s0, s1):
    """One xoroshiro128+ generator step (xorshiftNext, rand.c:80-90);
    the single source of truth for both the vectorized and the
    per-stream (jump) paths.  Works on scalars or arrays."""
    with np.errstate(over="ignore"):
        result = s0 + s1
        s1 = s1 ^ s0
        s0 = _rotl(s0, 55) ^ s1 ^ ((s1 << np.uint64(14)) & _MASK64)
        s1 = _rotl(s1, 36)
    return s0, s1, result


class Xoroshiro128Plus:
    """Vectorized xoroshiro128+ over n parallel streams.

    ``Xoroshiro128Plus(seed, n)`` matches ``rand_Seed(seed, n)``
    (rand.c:22-39): stream 0 is splitmix64-seeded, stream i is stream i-1
    jumped forward 2^64 steps.
    """

    _JUMP = (np.uint64(0xBEAC0467EBA5FACB), np.uint64(0xD86B048B86AA9922))

    def __init__(self, seed: int, n: int = 1):
        s = splitmix64(seed, 2)
        self.s0 = np.empty(n, dtype=np.uint64)
        self.s1 = np.empty(n, dtype=np.uint64)
        self.s0[0], self.s1[0] = s[0], s[1]
        for i in range(1, n):
            self.s0[i], self.s1[i] = self.s0[i - 1], self.s1[i - 1]
            self._jump_one(i)

    def _jump_one(self, i: int) -> None:
        """Advance stream i by 2^64 steps (xorshiftJump, rand.c:96-112)."""
        j0 = np.uint64(0)
        j1 = np.uint64(0)
        one = np.uint64(1)
        for jump in self._JUMP:
            for b in range(64):
                if jump & (one << np.uint64(b)):
                    j0 ^= self.s0[i]
                    j1 ^= self.s1[i]
                self._next_one(i)
        self.s0[i], self.s1[i] = j0, j1

    def _next_one(self, i: int) -> np.uint64:
        s0, s1, result = _xoro_step(self.s0[i], self.s1[i])
        self.s0[i], self.s1[i] = s0, s1
        return result

    def next_u64(self) -> np.ndarray:
        """One xoroshiro128+ step on every stream (xorshiftNext,
        rand.c:80-90).  Returns shape (n,) uint64."""
        self.s0, self.s1, result = _xoro_step(self.s0, self.s1)
        return result

    def uint64(self, count: int) -> np.ndarray:
        """Draw ``count`` values from stream 0 (single-stream convenience)."""
        assert self.s0.shape[0] == 1
        out = np.empty(count, dtype=np.uint64)
        for i in range(count):
            out[i] = self.next_u64()[0]
        return out

    def floats(self, count: int) -> np.ndarray:
        """24-bit-mantissa uniforms in [0, 1) from stream 0
        (rand_Float, rand.c:60-64)."""
        bits = self.uint64(count) & np.uint64(0xFFFFFF)
        return (bits.astype(np.float32) / np.float32(1 << 24))

    def uint63_lim(self, lim: int) -> int:
        """Rejection-sampled bounded draw (rand_Uint63Lim, rand.c:45-58)."""
        lim_u = np.uint64(lim)
        high = np.uint64(1) << np.uint64(63)
        mask = ~high & _MASK64
        with np.errstate(over="ignore"):
            max_v = high - np.uint64(1) - high % lim_u
        v = self.next_u64()[0] & mask
        while v > max_v:
            v = self.next_u64()[0] & mask
        return int(v % lim_u)

    def bool_(self) -> bool:
        """rand_Bool (rand.c:66-68) -- note the reference tests bit 1."""
        return bool(self.next_u64()[0] & np.uint64(2))


# ---------------------------------------------------------------------------
# Counter-based dither: explicit Threefry-2x32
# ---------------------------------------------------------------------------
#
# The dither RNG is part of the *stream format* (decode must reproduce the
# same floats forever), so it cannot depend on any library's internals.  We
# define it explicitly:
#
#   key   = (k0, k1) = split64(mix64(mix64(seed) ^ (field << 8 | dim)))
#   (a, b) = threefry2x32_13(key, counter=(i >> 2, tag))
#   h_i   = [a & 0xffff, a >> 16, b & 0xffff, b >> 16][i & 3]
#   u_i   = f32(h_i) * 2^-16                      (16-bit grain, [0, 1))
#
# threefry2x32_13 is the 13-round Threefry recommended by Salmon et al.
# (2011) as the reduced-round variant with safety margin.  The dither uses a
# 16-bit grain (the reference's rand_Float uses 24, rand.c:60-64): the
# error bound |x - x'| <= delta is independent of grain, which only sets the
# smoothness of the in-bin distribution, and four u16 lanes per counter
# quadruple decode throughput.
# Identical implementations exist here for numpy (host oracle) and torch,
# and in the CUDA decode kernel (csrc/decode.cu); all are tested bit-equal
# with each other and with the JAX package.
# The key derivation replaces the reference's jump-separated sequential
# streams (rand.c:93-112): any (field, dim, element) is addressable
# independently, which is what makes vectorized and sharded decode
# possible.

_TF_ROT = (13, 15, 26, 6, 17, 29, 16, 24)
_TF_PARITY = 0x1BD11BDA
_TF_ROUNDS = 13


def _mix64(z: int) -> int:
    """splitmix64 finalizer on a python int (host-side key derivation)."""
    z = (z + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


def field_key(seed: int, field_index: int, dim: int = 0):
    """Derive the (k0, k1) dither key for one field/dimension (host-side
    python ints)."""
    z = _mix64(_mix64(int(seed)) ^ ((int(field_index) << 8) | int(dim)))
    return (z & 0xFFFFFFFF, (z >> 32) & 0xFFFFFFFF)


def _threefry2x32(k0, k1, c0, c1, xp):
    """Threefry-2x32 with ``_TF_ROUNDS`` (=13) rounds; ``xp`` is numpy.
    All inputs uint32 arrays/scalars; returns (x0, x1) uint32."""
    u32 = xp.uint32
    k0 = xp.asarray(k0, dtype=xp.uint32)
    k1 = xp.asarray(k1, dtype=xp.uint32)
    k2 = k0 ^ k1 ^ u32(_TF_PARITY)
    x0 = xp.asarray(c0, dtype=xp.uint32) + k0
    x1 = xp.asarray(c1, dtype=xp.uint32) + k1
    ks = (k0, k1, k2)

    def rot(x, r):
        return (x << u32(r)) | (x >> u32(32 - r))

    for r in range(_TF_ROUNDS):
        x0 = x0 + x1
        x1 = rot(x1, _TF_ROT[r % 8]) ^ x0
        if r % 4 == 3:
            j = r // 4 + 1
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + u32(j)
    return x0, x1


def dither_u16_np(key, n: int, tag: int = 0, ctr0: int = 0) -> np.ndarray:
    """numpy mirror of ``dither_u16`` (bit-exact host oracle)."""
    if ctr0 % 4:
        raise ValueError(f"ctr0 {ctr0} must be a multiple of 4")
    k0, k1 = key
    q = (n + 3) // 4
    ctr = np.arange(q, dtype=np.uint32) + np.uint32(ctr0 // 4)
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(np.uint32(k0), np.uint32(k1), ctr,
                             np.uint32(tag), np)
    return np.stack([a & np.uint32(0xFFFF), a >> np.uint32(16),
                     b & np.uint32(0xFFFF), b >> np.uint32(16)],
                    axis=1).reshape(-1)[:n]


def threefry_bits_np(key, n: int, tag: int = 0) -> np.ndarray:
    """n uint32 random words (two per counter); shares counter space
    with ``dither_u16_np`` for the same (key, tag)."""
    k0, k1 = key
    half = (n + 1) // 2
    ctr = np.arange(half, dtype=np.uint32)
    with np.errstate(over="ignore"):
        a, b = _threefry2x32(np.uint32(k0), np.uint32(k1), ctr,
                             np.uint32(tag), np)
    return np.stack([a, b], axis=1).reshape(-1)[:n]


def uniform_dither_np(key, shape, ctr0: int = 0) -> np.ndarray:
    """numpy mirror of ``uniform_dither`` (bit-exact host oracle)."""
    n = int(np.prod(shape)) if shape else 1
    h = dither_u16_np(key, n, ctr0=ctr0)
    return (h.astype(np.float32) * np.float32(1.0 / (1 << 16))
            ).reshape(shape)


# torch dither.  u32 arithmetic runs on int64 masked to 32 bits: torch has
# few uint32 ops, and int32 ``>>`` is arithmetic.
_M32 = 0xFFFFFFFF


def _threefry2x32_torch(k0, k1, c0: torch.Tensor, c1: int):
    """``_threefry2x32`` on an int64 counter tensor holding u32 values; the
    second counter word ``c1`` is a python int, and ``k0``, ``k1`` are
    python ints or int64 tensors of u32 values that broadcast against
    ``c0`` (one key per row).  Returns (x0, x1) as int64 tensors of u32
    values."""
    k2 = (k0 ^ k1 ^ _TF_PARITY) & _M32
    ks = (k0, k1, k2)
    x0 = (c0 + k0) & _M32
    x1 = torch.zeros_like(x0) + ((k1 + c1) & _M32)
    for r in range(_TF_ROUNDS):
        x0.add_(x1).bitwise_and_(_M32)
        rot = _TF_ROT[r % 8]
        x1 = (((x1 << rot) & _M32) | (x1 >> (32 - rot))).bitwise_xor_(x0)
        if r % 4 == 3:
            j = r // 4 + 1
            x0.add_(ks[j % 3]).bitwise_and_(_M32)
            x1.add_((ks[(j + 1) % 3] + j) & _M32).bitwise_and_(_M32)
    return x0, x1


def dither_u16(key, n: int, tag: int = 0, ctr0: int = 0, *,
               device) -> torch.Tensor:
    """n uint16-valued dither lanes as an int32 tensor on ``device``: four
    per Threefry call.  ``ctr0`` offsets the element index for a plane that
    continues a longer stream (element i uses counter (ctr0 + i) >> 2).

    ``ctr0`` must be a multiple of 4: the lane phase always starts at half
    0 of counter ctr0//4, so an unaligned offset would silently return the
    WRONG dither lanes (a stream-format violation).

    ``key`` is a (k0, k1) pair of integers, or of integer tensors on
    ``device`` (a (2,) tensor is one): the key words' low 32 bits count,
    and a tensor key is never read to the host."""
    if ctr0 % 4:
        raise ValueError(f"ctr0 {ctr0} must be a multiple of 4 "
                         "(4 dither lanes share one Threefry counter)")
    k0, k1 = (k.to(torch.int64) & _M32 if isinstance(k, torch.Tensor)
              else int(k) & _M32 for k in key)
    q = (n + 3) // 4
    ctr = (torch.arange(q, dtype=torch.int64, device=device)
           + ctr0 // 4) & _M32
    a, b = _threefry2x32_torch(k0, k1, ctr, int(tag) & _M32)
    h = torch.stack([a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16], dim=1)
    return h.reshape(-1)[:n].to(torch.int32)


def uniform_dither(key, shape, ctr0: int = 0, *,
                   device) -> torch.Tensor:
    """Uniform [0, 1) with 16-bit granularity, exactly representable in f32
    -- the stream-format dither source (see the section comment above).
    ``key`` is a (k0, k1) pair from ``field_key``; ``ctr0`` the global
    element offset of the first element."""
    n = 1
    for s in shape:
        n *= int(s)
    h = dither_u16(key, n, ctr0=ctr0, device=device)
    return (h.to(torch.float32) * (1.0 / (1 << 16))).reshape(shape)


def uniform_dither_rows(keys: torch.Tensor, n: int) -> torch.Tensor:
    """The dither of R independent streams of ``n`` elements as (R, n) f32:
    row r uses key ``keys[r]`` (an (R, 2) integer tensor of u32 values)
    and counters from 0, as the rows decode draws it."""
    k = keys.to(torch.int64) & _M32
    q = (n + 3) // 4
    ctr = torch.arange(q, dtype=torch.int64, device=keys.device)[None, :]
    a, b = _threefry2x32_torch(k[:, :1], k[:, 1:], ctr, 0)
    h = torch.stack([a & 0xFFFF, a >> 16, b & 0xFFFF, b >> 16], dim=2)
    h = h.reshape(k.shape[0], -1)[:, :n]
    return h.to(torch.float32) * (1.0 / (1 << 16))
