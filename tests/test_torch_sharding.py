"""The port's block-sharded codecs (``parallel/sharding.py``) on CPU
meshes, and against the JAX package's on its 8-device CPU mesh.

The first half mirrors every test of ``tests/test_sharding.py`` through
the port.  The second holds the port against the JAX package on numpy
data from fixed seeds: the words and headers of both codecs on meshes of
1, 2 and 8 shards, in the div and recip scale modes, at the spmd and
adaptive depths; each package decodes the other's words; IDs past 2^63
on a 2^21 grid; ``global_range``.  Tolerance: none -- arrays are compared
as their raw bytes (u32 words as int32 and u64 as int64 in the port).
"""

import numpy as np
import pytest
import torch

from minnow_c_tpu.parallel import sharding as jsh
from minnow_c_tpu.quant.engine import delta_to_depth
from minnow_c_tpu_torch.parallel.sharding import (
    ShardedPositionCodec,
    ShardedSnapshotCodec,
    adaptive_depth_for,
    block_split,
    make_mesh,
    spmd_depth_for,
)

W = 64.0


def mesh(n):
    return make_mesh(n, device="cpu")


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _np(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def make_blocks(B=16, nb=512, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, W, (B, 3, nb)).astype(np.float32)


def periodic_err(out, x):
    err = np.abs(_np(out).reshape(x.shape) - x)
    return np.minimum(err, W - err).max()


class TestShardedPositionCodec:
    def test_eight_device_mesh(self):
        codec = ShardedPositionCodec(mesh=mesh(8), width=W,
                                     depth=spmd_depth_for(1e-3, W))
        x = make_blocks()
        words, x0, rng_b = codec.encode(x)
        assert periodic_err(codec.decode(words, x0, rng_b, seed=5),
                            x) <= 1e-3

    def test_adaptive_depth_smaller(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(10.0, 14.0, (8, 3, 256)).astype(np.float32)
        codec = ShardedPositionCodec(mesh=mesh(4), width=W,
                                     depth=spmd_depth_for(1e-3, W))
        d_adapt = adaptive_depth_for(codec, x, 1e-3)
        assert d_adapt < spmd_depth_for(1e-3, W)
        codec2 = ShardedPositionCodec(mesh=mesh(4), width=W, depth=d_adapt)
        words, x0, rng_b = codec2.encode(x)
        assert periodic_err(codec2.decode(words, x0, rng_b), x) <= 1e-3

    def test_blocks_dither_independently(self):
        codec = ShardedPositionCodec(mesh=mesh(2), width=W,
                                     depth=spmd_depth_for(1e-2, W))
        x = np.tile(make_blocks(B=1, nb=256), (4, 1, 1))  # identical blocks
        words, x0, rng_b = codec.encode(x)
        out = _np(codec.decode(words, x0, rng_b, seed=3)).reshape(x.shape)
        assert not np.array_equal(out[0], out[1])

    def test_fused_rows_decode_bit_identical(self):
        depth = spmd_depth_for(1e-3, W)
        x = make_blocks(B=16, nb=512, seed=7)
        ref_codec = ShardedPositionCodec(mesh=mesh(8), width=W, depth=depth,
                                         fused_rows=False)
        fused_codec = ShardedPositionCodec(mesh=mesh(8), width=W,
                                           depth=depth, fused_rows=True)
        words, x0, rng_b = ref_codec.encode(x)
        fwords, fx0, frng = fused_codec.encode(x)
        assert _bits(fwords) == _bits(words)
        assert _bits(fx0) == _bits(x0) and _bits(frng) == _bits(rng_b)
        assert _bits(fused_codec.decode(words, x0, rng_b, seed=5)) == \
            _bits(ref_codec.decode(words, x0, rng_b, seed=5))

    def test_decode_deterministic_across_mesh_sizes(self):
        x = make_blocks(B=8, nb=256)
        results = []
        for n_dev in (1, 2, 8):
            codec = ShardedPositionCodec(mesh=mesh(n_dev), width=W,
                                         depth=spmd_depth_for(1e-3, W))
            words, x0, rng_b = codec.encode(x)
            results.append(_bits(codec.decode(words, x0, rng_b, seed=11)))
        assert results[0] == results[1] == results[2]

    def test_blocks_must_divide_over_the_mesh(self):
        codec = ShardedPositionCodec(mesh=mesh(4), width=W, depth=16)
        with pytest.raises(ValueError, match="do not divide"):
            codec.encode(make_blocks(B=6, nb=64))


class TestBlockSplit:
    def test_split_3d(self):
        x = np.arange(3 * 64, dtype=np.float32).reshape(3, 64)
        b = block_split(x, 4)
        assert b.shape == (4, 3, 16)
        np.testing.assert_array_equal(b[0], x[:, :16])
        t = block_split(torch.from_numpy(x), 4)
        np.testing.assert_array_equal(t.numpy(), b)

    def test_split_1d(self):
        x = np.arange(64, dtype=np.uint64)
        b = block_split(x, 8)
        assert b.shape == (8, 8)

    def test_indivisible_asserts(self):
        with pytest.raises(AssertionError):
            block_split(np.zeros((3, 10)), 3)


def make_snap(B=16, nb=512, seed=0, grid=1024):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, W, (B, 3, nb)).astype(np.float32)
    vel = rng.normal(0, 200, (B, 3, nb)).astype(np.float32)
    ids = rng.permutation(grid * grid * 4)[: B * nb].astype(
        np.uint64).reshape(B, nb)
    return pos, vel, ids


def snap_codec(m, **kw):
    return ShardedSnapshotCodec(
        mesh=m, box=W, pos_depth=spmd_depth_for(1e-3, W),
        vel_depth=delta_to_depth(1.0, -2000.0, 2000.0), id_grid=1024, **kw)


class TestShardedSnapshotCodec:
    def test_full_snapshot_roundtrip(self):
        codec = snap_codec(mesh(8))
        pos, vel, ids = make_snap()
        dpos, dvel, dids = codec.decode(codec.encode(pos, vel, ids), seed=5)
        assert periodic_err(dpos, pos) <= 1e-3
        assert np.abs(_np(dvel).reshape(vel.shape) - vel).max() <= 1.0
        np.testing.assert_array_equal(_np(dids).view(np.uint64), ids)

    def test_pos_stream_matches_position_codec(self):
        codec = snap_codec(mesh(4))
        pos, vel, ids = make_snap(B=8, nb=256, seed=3)
        enc = codec.encode(pos, vel, ids)
        dpos, _, _ = codec.decode(enc, seed=9)
        pcodec = ShardedPositionCodec(mesh=mesh(4), width=W,
                                      depth=spmd_depth_for(1e-3, W))
        words, x0, rng_b = pcodec.encode(pos)
        assert _bits(enc[0]) == _bits(words)
        assert _bits(dpos) == _bits(pcodec.decode(words, x0, rng_b, seed=9))

    def test_vel_streams_distinct_from_pos(self):
        codec = snap_codec(mesh(2))
        pos, _, ids = make_snap(B=4, nb=256, seed=4)
        posv = np.clip(pos, 1.0, W - 1.0)  # same array for both fields
        dpos, dvel, _ = codec.decode(codec.encode(posv, posv, ids), seed=2)
        assert _bits(dpos) != _bits(dvel)

    def test_fused_rows_bit_identical(self):
        ref = snap_codec(mesh(8), fused_rows=False)
        fus = snap_codec(mesh(8), fused_rows=True)
        pos, vel, ids = make_snap(B=8, nb=512, seed=6)
        enc = ref.encode(pos, vel, ids)
        for x, y in zip(enc, fus.encode(pos, vel, ids)):
            assert _bits(x) == _bits(y)
        for x, y in zip(ref.decode(enc, seed=7), fus.decode(enc, seed=7)):
            assert _bits(x) == _bits(y)

    def test_decode_deterministic_across_mesh_sizes(self):
        pos, vel, ids = make_snap(B=8, nb=256, seed=8)
        outs = []
        for n_dev in (1, 4):
            codec = snap_codec(mesh(n_dev))
            outs.append([_bits(a) for a in codec.decode(
                codec.encode(pos, vel, ids), seed=1)])
        assert outs[0] == outs[1]

    def test_misaligned_block_size_rejected(self):
        codec = snap_codec(mesh(2))
        pos, vel, ids = make_snap(B=4, nb=256, seed=1)
        with pytest.raises(ValueError, match="multiple of 32"):
            codec.encode(pos[:, :, :100], vel[:, :, :100], ids[:, :100])
        pcodec = ShardedPositionCodec(mesh=mesh(2), width=W,
                                      depth=spmd_depth_for(1e-3, W))
        with pytest.raises(ValueError, match="multiple of 32"):
            pcodec.encode(pos[:, :, :100])

    def test_degenerate_depths_rejected(self):
        with pytest.raises(ValueError, match="depths"):
            ShardedSnapshotCodec(mesh=mesh(2), box=W, pos_depth=0,
                                 vel_depth=10, id_grid=1024)
        with pytest.raises(ValueError, match="id_grid"):
            ShardedSnapshotCodec(mesh=mesh(2), box=W, pos_depth=16,
                                 vel_depth=10, id_grid=1)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("profile", ["spmd", "adaptive"])
@pytest.mark.parametrize("scale_mode", ["div", "recip"])
@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_position_codec_matches_jax(n_dev, scale_mode, profile):
    rng = np.random.default_rng(100 + n_dev)
    # a cluster that straddles the box edge in x, and one well inside
    x = rng.uniform(0, W, (8, 3, 256)).astype(np.float32)
    x[:4, 0] = np.mod(rng.normal(0, 3.0, (4, 256)), W).astype(np.float32)
    x[4:] = rng.uniform(20.0, 30.0, (4, 3, 256)).astype(np.float32)
    jcodec = jsh.ShardedPositionCodec(mesh=jsh.make_mesh(n_dev), width=W,
                                      depth=16, scale_mode=scale_mode)
    tcodec = ShardedPositionCodec(mesh=mesh(n_dev), width=W, depth=16,
                                  scale_mode=scale_mode)
    if profile == "spmd":
        depth = spmd_depth_for(1e-3, W)
        assert depth == jsh.spmd_depth_for(1e-3, W)
    else:
        g = tcodec.global_range(x)
        assert np.float32(g) == np.float32(jcodec.global_range(x))
        depth = adaptive_depth_for(tcodec, x, 1e-3)
        assert depth == jsh.adaptive_depth_for(jcodec, x, 1e-3)
    jcodec = jsh.ShardedPositionCodec(mesh=jsh.make_mesh(n_dev), width=W,
                                      depth=depth, scale_mode=scale_mode)
    tcodec = ShardedPositionCodec(mesh=mesh(n_dev), width=W, depth=depth,
                                  scale_mode=scale_mode)
    jenc = [np.asarray(a) for a in jcodec.encode(x)]
    tenc = tcodec.encode(x)
    for a, b in zip(tenc, jenc):
        assert _bits(a) == _bits(b)
    want = np.asarray(jcodec.decode(*jenc, seed=13))
    assert _bits(tcodec.decode(*jenc, seed=13)) == _bits(want)
    words = tenc[0].numpy().view(np.uint32)
    assert _bits(jcodec.decode(words, tenc[1].numpy(), tenc[2].numpy(),
                               seed=13)) == _bits(want)
    assert periodic_err(want, x) <= 1e-3


@pytest.mark.parametrize("scale_mode, fused_rows",
                         [("div", None), ("recip", None), ("recip", False)],
                         ids=["div", "recip", "recip-plain"])
@pytest.mark.parametrize("ids_kind", ["lattice", "past_2_63"])
def test_snapshot_codec_matches_jax(ids_kind, scale_mode, fused_rows):
    B, nb = 8, 256
    pos, vel, _ = make_snap(B=B, nb=nb, seed=21)
    rng = np.random.default_rng(22)
    if ids_kind == "lattice":
        grid = 1024
        ids = rng.integers(0, grid ** 3, B * nb, dtype=np.uint64)
    else:  # u64 IDs with the top bit set, on the widest grid
        grid = 1 << 21
        ids = rng.integers(1 << 63, (1 << 64) - 1, B * nb, dtype=np.uint64,
                           endpoint=True)
    ids = ids.reshape(B, nb)
    kw = dict(box=W, pos_depth=spmd_depth_for(1e-3, W),
              vel_depth=delta_to_depth(1.0, -2000.0, 2000.0), id_grid=grid,
              scale_mode=scale_mode)
    jcodec = jsh.ShardedSnapshotCodec(mesh=jsh.make_mesh(4), **kw)
    tcodec = ShardedSnapshotCodec(mesh=mesh(4), fused_rows=fused_rows, **kw)
    jenc = [np.asarray(a) for a in jcodec.encode(pos, vel, ids)]
    tenc = tcodec.encode(pos, vel, ids)
    assert len(tenc) == len(jenc) == 8
    for a, b in zip(tenc, jenc):
        assert _bits(a) == _bits(b)
    want = [np.asarray(a) for a in jcodec.decode(tuple(jenc), seed=3)]
    for a, b in zip(tcodec.decode(tuple(jenc), seed=3), want):
        assert _bits(a) == _bits(b)
    tnp = [a.numpy() for a in tenc]
    for i in (0, 3, 6):
        tnp[i] = tnp[i].view(np.uint32)
    tnp[7] = tnp[7].view(np.uint64)
    for a, b in zip(jcodec.decode(tuple(tnp), seed=3), want):
        assert _bits(a) == _bits(b)
    if ids_kind == "lattice":
        np.testing.assert_array_equal(want[2], ids)
