"""The pipeline's entry points, the counterparts of the JAX repository's
``__graft_entry__.py``.

``entry()`` -- the forward step of the flagship pipeline (position
fast-uniform encode: unwrap -> stats -> bin -> pack) on 8192 positions,
one card.

``dryrun_multichip(n)`` -- the full sharded encode and decode step on an
n-shard mesh (``parallel.sharding.make_mesh(n)``: on one card, n logical
shards of it), with the header stats reduced over the shards, then a
chained snapshot file written and read back through the multihost reader
with its blocks over the same mesh.
"""

from __future__ import annotations

import io

import numpy as np
import torch

WIDTH = 64.0
DEPTH = 16
N_ENTRY = 8192


def entry(device="cuda"):
    """(encode_step, (x,)): ``encode_step(x)`` maps (3, n) f32 positions to
    (words (3, n * DEPTH / 32), x0 (3,), the shared range); ``x`` is
    uniform in the box from numpy seed 0, on ``device``."""
    from .ops import bitpack, kernels

    def encode_step(x):
        xu = kernels.undo_periodic(x, WIDTH)
        x0, x1 = kernels.minmax(xu)
        rng_b = kernels.ftz(x1 - x0).amax()
        bins = kernels.uniform_bin_index(xu, DEPTH, x0[:, None], rng_b)
        return bitpack.uniform_pack_rows(bins, DEPTH), x0, rng_b

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(0, WIDTH, (3, N_ENTRY)).astype(
        np.float32)).to(device)
    return encode_step, (x,)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _periodic_err(got: np.ndarray, want: np.ndarray) -> float:
    err = np.abs(got - want)
    return float(np.minimum(err, WIDTH - err).max())


def dryrun_multichip(n_devices: int, device="cuda",
                     fused_rows=None) -> dict:
    """The sharded encode + decode on ``make_mesh(n_devices)`` over 2
    blocks of 256 particles a shard (numpy seed 0), the error bounds
    checked (positions within 1e-3 periodic, velocities within 1.0, IDs
    exact; AssertionError otherwise).  ``fused_rows`` goes to the sharded
    codecs (False: their kernels' plain versions).  Returns what it computed: the
    snapshot codec's encoding ``enc`` and decode ``pos`` / ``vel`` /
    ``ids``, the position codec's ``words`` / ``x0`` / ``rng_b`` and
    decode ``out``, the global range ``g``, the snapshot file's bytes
    ``file`` and its multihost read ``read``."""
    from . import IDAccuracy, PositionAccuracy, VelocityAccuracy
    from .parallel import snapshot as snap_mod
    from .parallel.sharding import (ShardedPositionCodec,
                                    ShardedSnapshotCodec, make_mesh,
                                    spmd_depth_for)
    from .quant.engine import delta_to_depth

    mesh = make_mesh(n_devices, device=device)
    depth = spmd_depth_for(delta=1e-3, width=WIDTH)
    blocks = n_devices * 2
    n_b = 256
    rng = np.random.default_rng(0)
    x = rng.uniform(0, WIDTH, (blocks, 3, n_b)).astype(np.float32)
    vel = rng.normal(0, 200.0, (blocks, 3, n_b)).astype(np.float32)
    ids = rng.permutation(1024 * 1024 * 4)[: blocks * n_b].astype(
        np.uint64).reshape(blocks, n_b)

    # the full snapshot step (Posn + Velc + Ptid), each way
    snap = ShardedSnapshotCodec(
        mesh=mesh, box=WIDTH, pos_depth=depth,
        vel_depth=delta_to_depth(1.0, -2000.0, 2000.0), id_grid=1024,
        fused_rows=fused_rows)
    enc = snap.encode(x, vel, ids)
    dpos, dvel, dids = snap.decode(enc, seed=7)
    _check(_periodic_err(dpos.cpu().numpy().reshape(x.shape), x) <= 1e-3,
           "multichip pos round-trip error over 1e-3")
    _check(np.abs(dvel.cpu().numpy().reshape(vel.shape) - vel).max() <= 1.0,
           "multichip vel out of delta")
    _check(np.array_equal(dids.cpu().numpy().view(np.uint64), ids),
           "multichip IDs not lossless")

    # the position codec and the adaptive profile's range over the shards
    codec = ShardedPositionCodec(mesh=mesh, width=WIDTH, depth=depth,
                                 fused_rows=fused_rows)
    words, x0, rng_b = codec.encode(x)
    out = codec.decode(words, x0, rng_b, seed=7)
    _check(_periodic_err(out.cpu().numpy().reshape(x.shape), x) <= 1e-3,
           "multichip round-trip error over 1e-3")
    g = codec.global_range(x)
    _check(0 < g <= WIDTH, f"multichip global range {g} outside (0, box]")

    # the file-backed read leg: a chained snapshot file read back through
    # the multihost reader with its blocks over the same mesh
    spec = snap_mod.SnapshotSpec(
        pos=PositionAccuracy(delta=1e-3, width=WIDTH),
        vel=VelocityAccuracy(delta=1.0), ids=IDAccuracy(width=1024))
    pos_cat = np.concatenate(list(x), axis=1)
    vel_cat = np.concatenate(list(vel), axis=1)
    buf = io.BytesIO()
    snap_mod.compress_snapshot(buf, pos_cat, vel_cat, ids.reshape(-1), spec,
                               num_blocks=blocks, seed=7, device=device)
    blob = buf.getvalue()
    buf.seek(0)
    got = snap_mod.decompress_snapshot_multihost(buf, mesh=mesh,
                                                 device=device)
    _check(got["num_blocks"] == blocks, "multihost read lost blocks")
    gids = got["ids"].local.cpu().numpy().view(np.uint64).reshape(-1)
    _check(np.array_equal(gids, ids.reshape(-1)),
           "multihost-read IDs not lossless")
    gpos = got["pos"].local.cpu().numpy()
    _check(_periodic_err(gpos, x) <= 1e-3, "multihost-read pos error")
    return {"enc": enc, "pos": dpos, "vel": dvel, "ids": dids,
            "words": words, "x0": x0, "rng_b": rng_b, "out": out, "g": g,
            "file": blob, "read": got}
