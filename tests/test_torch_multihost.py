"""The port's multi-process layer: two gloo processes on the CPU run the
block-sharded codecs, the multihost writer and the multihost reader,
mirroring ``tests/test_multihost.py``'s worker.

Each process holds half of the blocks in a ``multihost.BlockShards`` over
a 4-shard CPU mesh.  Its decodes must equal its slice of a one-process
decode bitwise; the file the two write must equal, byte for byte, the
port's and the JAX package's single-host ``compress_snapshot`` of the
concatenated data; each rank's read must equal its slice of
``decompress_snapshot`` bitwise without reading a foreign segment body.
Two ID sets: lattice IDs, and u64 IDs with the top bit set (on a 2^22
grid, whose cube covers every u64); the lattice IDs also with a mass
field.  The workers import no JAX.
"""

import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import minnow_c_tpu as mnw
from minnow_c_tpu.parallel import snapshot as jsnap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = 64.0

WORKER = r"""
import os, sys
proc_id, coord, tmp, kind = (int(sys.argv[1]), sys.argv[2], sys.argv[3],
                             sys.argv[4])
sys.path.insert(0, os.getcwd())
import io
import numpy as np
import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch.parallel import multihost, snapshot as snap_mod
from minnow_c_tpu_torch.parallel.sharding import (
    ShardedPositionCodec, ShardedSnapshotCodec, make_mesh, spmd_depth_for)
from minnow_c_tpu_torch.quant.engine import delta_to_depth
from minnow_c_tpu_torch.segment import io as seg_io

multihost.initialize(coord, 2, proc_id)
assert multihost.process_count() == 2

W = 64.0
data = np.load(os.path.join(tmp, "data.npz"))
gx, gv, gi, grid = data["gx"], data["gv"], data["gi"], int(data["grid"])
gm = data["gm"] if "gm" in data.files else None
lo, hi = proc_id * 4, (proc_id + 1) * 4
mesh = make_mesh(4, device="cpu")    # 4 shards here, 8 over both ranks
one = make_mesh(8, device="cpu")     # the one-process reference


def bits(t):
    return np.ascontiguousarray(np.asarray(t)).tobytes()


# ---- the position codec on block-major ROWS from each process
codec = ShardedPositionCodec(mesh=mesh, width=W,
                             depth=spmd_depth_for(1e-3, W))
ref_codec = ShardedPositionCodec(mesh=one, width=W,
                                 depth=spmd_depth_for(1e-3, W))
xg = multihost.global_block_array(gx[lo:hi].reshape(12, 256), mesh)
words, x0, rng_b = codec.encode(xg)
assert (words.first, words.total, x0.first, x0.total) == (
    12 * proc_id, 24, 4 * proc_id, 8)
out = codec.decode(words, x0, rng_b, seed=5)
mine = multihost.local_block_slice(out, mesh).reshape(4, 3, 256)
err = np.abs(mine - gx[lo:hi]); err = np.minimum(err, W - err)
assert err.max() <= 1e-3, err.max()
ref = ref_codec.decode(*ref_codec.encode(gx), seed=5).numpy()
assert bits(mine) == bits(ref.reshape(8, 3, 256)[lo:hi])
# the adaptive profile's range: one all-reduce, the same on both ranks
g = codec.global_range(xg)
assert np.float32(g) == np.float32(ref_codec.global_range(gx))

# ---- the snapshot codec: velocity keys count the blocks of both ranks
snap = ShardedSnapshotCodec(
    mesh=mesh, box=W, pos_depth=spmd_depth_for(1e-3, W),
    vel_depth=delta_to_depth(1.0, -1000.0, 1000.0),
    id_grid=min(grid, 1 << 21))
ref_snap = ShardedSnapshotCodec(
    mesh=one, box=W, pos_depth=spmd_depth_for(1e-3, W),
    vel_depth=delta_to_depth(1.0, -1000.0, 1000.0),
    id_grid=min(grid, 1 << 21))
vg = multihost.global_block_array(gv[lo:hi].reshape(12, 256), mesh)
ig = multihost.global_block_array(gi[lo:hi], mesh)
dpos, dvel, dids = snap.decode(snap.encode(xg, vg, ig), seed=5)
rpos, rvel, rids = ref_snap.decode(ref_snap.encode(gx, gv, gi), seed=5)
mpos = multihost.local_block_slice(dpos, mesh).reshape(4, 3, 256)
assert bits(mpos) == bits(mine)      # the position codec's streams
assert bits(multihost.local_block_slice(dvel)) == bits(
    rvel.numpy()[12 * proc_id:12 * (proc_id + 1)])
assert bits(multihost.local_block_slice(dids)) == bits(
    rids.numpy()[lo:hi])
mvel = multihost.local_block_slice(dvel).reshape(4, 3, 256)
assert np.abs(mvel - gv[lo:hi]).max() <= 1.0
if kind == "lattice":
    assert np.array_equal(multihost.local_block_slice(dids).view(np.uint64),
                          gi[lo:hi])

# ---- the distributed file write: each process compresses its own blocks
def slab(blocks):   # (B_local, d, nb) -> (d, B_local*nb); (B_local, nb) -> n
    if blocks.ndim == 3:
        return np.concatenate(list(blocks), axis=1)
    return blocks.reshape(-1)

spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=W),
                       vel=mt.VelocityAccuracy(delta=1.0),
                       ids=mt.IDAccuracy(width=grid),
                       mass=None if gm is None else mt.FloatAccuracy(1e-3))
path = os.path.join(tmp, "multi.min")
fp = open(path, "wb") if proc_id == 0 else None
st = snap_mod.compress_snapshot_multihost(
    fp, slab(gx[lo:hi]), slab(gv[lo:hi]), slab(gi[lo:hi]), spec,
    num_blocks_local=4, seed=5, device="cpu",
    mass=None if gm is None else slab(gm[lo:hi]))
if fp is not None:
    fp.close()
assert st["num_blocks"] == 8, st
with open(path, "rb") as f:
    blob = f.read()
full = snap_mod.decompress_snapshot(io.BytesIO(blob), device="cpu")
ferr = np.abs(full["pos"].numpy() - slab(gx))
ferr = np.minimum(ferr, W - ferr)
assert ferr.max() <= 1e-3, ferr.max()
assert np.abs(full["vel"].numpy() - slab(gv)).max() <= 1.0
assert np.array_equal(full["ids"].numpy().view(np.uint64), gi.reshape(-1))
if proc_id == 0:
    buf = io.BytesIO()
    one_st = snap_mod.compress_snapshot(
        buf, slab(gx), slab(gv), slab(gi), spec, num_blocks=8, seed=5,
        device="cpu", mass=None if gm is None else slab(gm))
    assert buf.getvalue() == blob, "file differs from the one-host file"
    assert {k: v for k, v in one_st.items()} == st, (one_st, st)
    print("FILE_PARITY_OK", flush=True)

# ---- the distributed read: each rank reads only its own segment bodies
class SpanRecordingFile:
    def __init__(self, f):
        self.f = f; self.spans = []
    def read(self, n=-1):
        off = self.f.tell(); data = self.f.read(n)
        self.spans.append((off, len(data))); return data
    def seek(self, *a): return self.f.seek(*a)
    def tell(self): return self.f.tell()

with open(path, "rb") as f:
    rf = SpanRecordingFile(f)
    got = snap_mod.decompress_snapshot_multihost(rf, mesh=mesh, device="cpu")
assert got["num_blocks"] == 8 and got["blocks_local"] == 4
assert got["n_per_block"] == 256
n_slab = 4 * 256
for name in ("pos", "vel"):
    assert bits(got["local"][name]) == bits(
        full[name][:, proc_id * n_slab:(proc_id + 1) * n_slab])
assert bits(got["local"]["ids"]) == bits(
    full["ids"][proc_id * n_slab:(proc_id + 1) * n_slab])
offs = []
with open(path, "rb") as f:
    off = 0
    for hd in seg_io.iter_headers(f):
        offs.append((off + seg_io.IO_HEADER_BYTES, hd.segment_bytes))
        off = hd.next_io_header
foreign = [offs[i] for i in range(8) if not lo <= i < hi]
for (fo, fl) in foreign:
    for (ro, rl) in rf.spans:
        assert not (ro < fo + fl and fo < ro + rl), \
            f"read ({ro},{rl}) overlaps foreign body ({fo},{fl})"
assert (got["ids"].first, got["ids"].total) == (lo, 8)
assert np.array_equal(multihost.local_block_slice(got["ids"], mesh),
                      gi[lo:hi].view(np.int64))
g_pos = multihost.local_block_slice(got["pos"], mesh)
assert bits(g_pos) == bits(np.stack(
    [got["local"]["pos"][:, b * 256:(b + 1) * 256].numpy()
     for b in range(4)]))
print("READ_OK", proc_id, flush=True)

with open(os.path.join(tmp, f"ok{proc_id}"), "w") as f:
    f.write(repr(g))
print("WORKER_OK", proc_id, flush=True)
"""


def _data(kind: str):
    rng = np.random.default_rng(0)
    gx = rng.uniform(0, W, (8, 3, 256)).astype(np.float32)
    gv = rng.normal(0, 200, (8, 3, 256)).astype(np.float32)
    if kind.startswith("lattice"):
        grid = 1024
        gi = rng.permutation(1024 * 1024 * 2)[:8 * 256].astype(np.uint64)
    else:
        grid = 1 << 22
        gi = rng.integers(1 << 63, (1 << 64) - 1, 8 * 256, dtype=np.uint64,
                          endpoint=True)
    gm = rng.uniform(0.5, 2.0, (8, 256)).astype(np.float32) \
        if kind.endswith("_mass") else None
    return gx, gv, gi.reshape(8, 256), grid, gm


def _slab(blocks):
    if blocks.ndim == 3:
        return np.concatenate(list(blocks), axis=1)
    return blocks.reshape(-1)


@pytest.mark.parametrize("kind", ["lattice", "past_2_63", "lattice_mass"])
def test_two_process_codecs_writer_reader(tmp_path, kind):
    gx, gv, gi, grid, gm = _data(kind)
    np.savez(tmp_path / "data.npz", gx=gx, gv=gv, gi=gi, grid=grid,
             **({} if gm is None else {"gm": gm}))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(i), f"localhost:{port}",
         str(tmp_path), kind],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO) for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=45)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i}:\n{out[-3000:]}"
        assert f"WORKER_OK {i}" in out and f"READ_OK {i}" in out
    assert "FILE_PARITY_OK" in outs[0]
    assert (tmp_path / "ok0").read_text() == (tmp_path / "ok1").read_text()

    # the two processes' file == the JAX package's single-host file
    spec = jsnap.SnapshotSpec(pos=mnw.PositionAccuracy(delta=1e-3, width=W),
                              vel=mnw.VelocityAccuracy(delta=1.0),
                              ids=mnw.IDAccuracy(width=grid),
                              mass=None if gm is None else
                              mnw.FloatAccuracy(1e-3))
    buf = io.BytesIO()
    jsnap.compress_snapshot(buf, _slab(gx), _slab(gv), _slab(gi), spec,
                            num_blocks=8, seed=5,
                            mass=None if gm is None else _slab(gm))
    assert (tmp_path / "multi.min").read_bytes() == buf.getvalue()


def test_one_process_multihost_writer_takes_each_stats_once(monkeypatch):
    """Without a process group the multihost writer writes
    ``compress_snapshot``'s bytes and stats for positions, symlog
    velocities, IDs and log10 masses, and takes each float field's upload
    and stats pass once: the depth rule syncs inside the encoder's own
    stats step."""
    import minnow_c_tpu_torch as mt
    from minnow_c_tpu_torch.parallel import rows
    from minnow_c_tpu_torch.parallel import snapshot as tsnap
    gx, gv, gi, grid, _ = _data("lattice")
    mass = np.random.default_rng(1).uniform(0.5, 2.0, 8 * 256).astype(
        np.float32)
    spec = mt.SnapshotSpec(
        pos=mt.PositionAccuracy(delta=1e-3, width=W),
        vel=mt.VelocityAccuracy(delta=1e-3, sym_log10_scaled=1,
                                sym_log10_threshold=10.0),
        ids=mt.IDAccuracy(width=grid),
        mass=mt.FloatAccuracy(delta=1e-3, log10_scaled=1))
    args = (_slab(gx), _slab(gv), _slab(gi), spec)
    stats_calls = []
    stats = rows.stats
    monkeypatch.setattr(rows, "stats", lambda *a, **kw: (
        stats_calls.append(a[0].shape), stats(*a, **kw))[1])
    multi, one = io.BytesIO(), io.BytesIO()
    st = tsnap.compress_snapshot_multihost(multi, *args, num_blocks_local=8,
                                           seed=5, mass=mass, device="cpu")
    assert stats_calls == [(24, 256), (24, 256), (8, 256)]
    one_st = tsnap.compress_snapshot(one, *args, num_blocks=8, seed=5,
                                     mass=mass, device="cpu")
    assert multi.getvalue() == one.getvalue()
    assert st == one_st


def test_single_process_helpers_are_identities():
    """Without a process group every collective is the identity and a
    container spans the whole axis."""
    import torch
    from minnow_c_tpu_torch.parallel import multihost
    from minnow_c_tpu_torch.parallel.sharding import make_mesh
    assert multihost.process_count() == 1
    assert multihost.allgather_max_f32(1.5) == 1.5
    np.testing.assert_array_equal(multihost.allgather_i64([3, 4]),
                                  [[3, 4]])
    assert multihost.allgather_bytes([b"a", b"bc"]) == [b"a", b"bc"]
    multihost.barrier()
    multihost.initialize("localhost:1", 1, 0)  # one process: no group
    ids = np.array([[1, 2], [1 << 63, 5]], dtype=np.uint64)
    g = multihost.global_block_array(ids, make_mesh(2, device="cpu"))
    assert (g.first, g.total, g.local.dtype) == (0, 2, torch.int64)
    np.testing.assert_array_equal(
        multihost.local_block_slice(g).view(np.uint64), ids)


@pytest.mark.parametrize("exempt_first", [False, True])
@pytest.mark.parametrize("width", [1024, 1 << 22])
def test_id_unwrap_anchored_matches_jax(width, exempt_first):
    """The anchored ID unwrap of the multihost writer, on IDs around the
    anchor's grid cell (with wraps) and with the top bit set."""
    import jax.numpy as jnp
    import torch
    from minnow_c_tpu_torch.parallel import snapshot as tsnap
    rng = np.random.default_rng(width)
    ids = np.concatenate([
        rng.integers(0, width ** 3 if width < 1 << 21 else 1 << 62, 500,
                     dtype=np.uint64),
        rng.integers(1 << 63, (1 << 64) - 1, 500, dtype=np.uint64,
                     endpoint=True)])
    anchor = np.array([width - 3, 2, width // 2], dtype=np.int64)
    want = np.asarray(jsnap._id_unwrap_anchored(
        jnp.asarray(ids), width, jnp.asarray(anchor.astype(np.uint64)),
        exempt_first=exempt_first))
    got = tsnap._id_unwrap_anchored(torch.from_numpy(ids.view(np.int64)),
                                    width, anchor, exempt_first)
    np.testing.assert_array_equal(got.numpy(), want)
