"""The port's spans, per-operation records and byte counters
(``minnow_c_tpu_torch.utils.profiling``) on the snapshot path.

The Gadget-2 driver and the snapshot entry points run on a small snapshot
under ``torch.profiler`` (host activity): every span the path names is on
the timeline, each inside its parent; each outermost entry point leaves one
record, whose counters read 0 where no copy crosses to a card.  The last
test runs on a card (marked ``cuda``): there the counters hold every byte
the path moves between host and card.  This file imports no JAX."""

import io

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch.drivers import gadget2
from minnow_c_tpu_torch.parallel import snapshot
from minnow_c_tpu_torch.segment import format as wire
from minnow_c_tpu_torch.segment import io as seg_io
from minnow_c_tpu_torch.utils import profiling

BOX = 64.0
N = 4096
BLOCKS = 2

# the spans the benchmark's readers ask for by name
BENCHMARK_READS = ("pos.binpack", "vel.binpack", "pos.entropy",
                   "vel.entropy", "ids.entropy", "serialize", "decode.parse")

# child -> parent, for every span of a write and of a read
WRITE = {"g2.parse": "g2.compress", "snapshot.compress": "g2.compress",
         "ids.upload": "ids.decompose", "ids.gather": "ids.pack",
         **{f"{f}.{step}": "snapshot.compress"
            for f in ("pos", "vel", "mass")
            for step in ("upload", "stats", "binpack", "gather", "entropy",
                         "wrap")},
         **{f"ids.{step}": "snapshot.compress"
            for step in ("decompose", "pack", "entropy", "wrap")},
         "serialize": "snapshot.compress",
         "segments.write": "snapshot.compress"}
READ = {"snapshot.decompress": "g2.decompress",
        "g2.download": "g2.decompress", "g2.records": "g2.decompress",
        "decode.read": "snapshot.decompress",
        "decode.parse": "snapshot.decompress",
        **{f"decode.{f}{step}": "snapshot.decompress"
           for f in ("pos", "vel", "ids", "mass")
           for step in ("", ".entropy")},
        **{f"decode.{f}.upload": f"decode.{f}"
           for f in ("pos", "vel", "ids", "mass")}}


def gadget2_file() -> bytes:
    """A format-1 file of N particles with per-particle masses."""
    rng = np.random.default_rng(5)
    pos = rng.uniform(0, BOX, (3, N)).astype(np.float32)
    vel = rng.normal(0, 150, (3, N)).astype(np.float32)
    ids = rng.permutation(32 ** 3)[:N].astype(np.uint64)
    mass = rng.uniform(0.5, 4.0, N).astype(np.float32)
    hdr = gadget2.Gadget2Header(
        npart=(0, N, 0, 0, 0, 0), mass=(0.0,) * 6, time=0.5, redshift=1.5,
        box_size=BOX, omega0=0.3, omega_lambda=0.7, hubble_param=0.7)
    buf = io.BytesIO()
    gadget2.write_snapshot(buf, hdr, pos, vel, ids, mass=mass)
    return buf.getvalue()


def spans(fn):
    """Run ``fn`` under the profiler: its result and {span name: [(start,
    end), ...]} of every record_function span."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    by = {}
    for e in prof.events():
        by.setdefault(e.name, []).append((e.time_range.start,
                                          e.time_range.end))
    return out, by


def new_records(fn):
    """The records that ``fn`` leaves, and its result."""
    before = profiling.operations()
    out = fn()
    recs = profiling.operations()
    last = [i for i, r in enumerate(recs) if before and r is before[-1]]
    return recs[last[0] + 1 if last else 0:], out


def compress(raw: bytes, device="cpu") -> bytes:
    out = io.BytesIO()
    gadget2.compress(io.BytesIO(raw), out, num_blocks=BLOCKS, device=device)
    return out.getvalue()


def decompress(packed: bytes, device="cpu") -> bytes:
    out = io.BytesIO()
    gadget2.decompress(io.BytesIO(packed), out, device=device)
    return out.getvalue()


def block_bytes(packed: bytes, start: int = 0):
    """A snapshot file's stored block bytes (its segments from offset
    ``start``): those of its payload blocks (every block of a field but its
    first, the meta block), and of all."""
    payload = every = 0
    fp = io.BytesIO(packed)
    fp.seek(start)
    for _, seg in seg_io.iter_segments(fp):
        for f in wire.deserialize(seg).fields:
            payload += sum(map(len, f.blocks[1:]))
            every += sum(map(len, f.blocks))
    return payload, every


def driver_block_bytes(packed: bytes):
    """``block_bytes`` of a driver's file, past its Gadget-2 header."""
    fp = io.BytesIO(packed)
    gadget2._read_record(fp)
    return block_bytes(packed, fp.tell())


def segment_bytes(packed: bytes, driver: bool = False) -> int:
    """The bytes of a snapshot file's segment bodies (a driver's file: past
    its Gadget-2 header)."""
    fp = io.BytesIO(packed)
    if driver:
        gadget2._read_record(fp)
    return sum(len(seg) for _, seg in seg_io.iter_segments(fp))


@pytest.fixture(scope="module")
def files():
    raw = gadget2_file()
    return raw, compress(raw)


@pytest.mark.parametrize("op", ["write", "read"])
def test_driver_spans_nest(files, op):
    raw, packed = files
    nesting = WRITE if op == "write" else READ
    _, by = spans(lambda: compress(raw) if op == "write"
                  else decompress(packed))
    names = set(nesting) | set(nesting.values())
    assert names <= set(by), sorted(names - set(by))
    for child, parent in nesting.items():
        for s, e in by[child]:
            assert any(ps <= s and e <= pe for ps, pe in by[parent]), \
                (child, parent)
    if op == "read":    # the driver's download and records follow the read
        (ds, de), = by["snapshot.decompress"]
        for name in ("g2.download", "g2.records"):
            assert all(s >= de for s, _ in by[name]), name


def test_benchmark_span_names_stay(files):
    raw, packed = files
    _, w = spans(lambda: compress(raw))
    _, r = spans(lambda: decompress(packed))
    for name in BENCHMARK_READS:
        assert name in w or name in r, name


@pytest.mark.parametrize("op", ["write", "read"])
def test_one_record_per_driver_operation(files, op):
    raw, packed = files
    recs, _ = new_records(lambda: compress(raw) if op == "write"
                          else decompress(packed))
    name = "g2.compress" if op == "write" else "g2.decompress"
    assert [r.name for r in recs] == [name]
    rec = recs[0]
    assert rec.start < rec.end
    # no copy crosses to a card on the CPU; a read's file lands in
    # ordinary memory; a write counts its packed bins and the blocks its
    # pool tasks took (a read, those its pool tasks decoded, and the
    # segment bodies it took as views of the caller's bytes), and in a
    # 64-wide box the room rule makes no field deeper
    c = dict(rec.counters)
    if op == "write":
        assert c.pop("packed_bits") > 0 and c.pop("depth_room") == 0
        assert c.pop("pooled_sum_bytes") > 0
    assert c == ({"h2d": 0, "d2h": 0} if op == "write" else
                 {"h2d": 0, "d2h": 0, "d2h_pinned": 0,
                  "pooled_decode_bytes": driver_block_bytes(packed)[0],
                  "viewed_segment_bytes": segment_bytes(packed, True)})


def test_one_record_per_snapshot_operation():
    rng = np.random.default_rng(1)
    pos = rng.uniform(0, BOX, (3, N)).astype(np.float32)
    ids = rng.permutation(N).astype(np.uint64)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=BOX),
                           ids=mt.IDAccuracy(width=16))
    fp = io.BytesIO()
    recs, st = new_records(lambda: mt.compress_snapshot(
        fp, pos, None, ids, spec, num_blocks=BLOCKS, device="cpu"))
    assert [r.name for r in recs] == ["snapshot.compress"]
    assert recs[0].counters == {
        "packed_bits": N * (3 * st["pos_depth"] + sum(st["id_widths"])),
        "depth_room": 0, "pooled_sum_bytes": block_bytes(fp.getvalue())[0],
        "h2d": 0, "d2h": 0}
    fp.seek(0)
    recs, out = new_records(lambda: mt.decompress_snapshot(fp,
                                                           device="cpu"))
    assert [r.name for r in recs] == ["snapshot.decompress"]
    # a read that leaves its fields where they were decoded still says so
    assert recs[0].counters == {
        "h2d": 0, "d2h": 0,
        "pooled_decode_bytes": block_bytes(fp.getvalue())[0],
        "viewed_segment_bytes": segment_bytes(fp.getvalue())}
    assert torch.equal(out["ids"], torch.from_numpy(ids.view(np.int64)))
    recs, _ = new_records(lambda: snapshot.compress_snapshot_streaming(
        io.BytesIO(), iter([{"pos": pos}]), spec, device="cpu"))
    assert [r.name for r in recs] == ["snapshot.compress"]


def test_packed_bits_are_depths_and_widths_times_elements():
    """A write's ``packed_bits``: each float field's depth and each ID
    dimension's width times its elements."""
    rng = np.random.default_rng(2)
    pos = rng.uniform(0, BOX, (3, N)).astype(np.float32)
    vel = rng.normal(0, 150, (3, N)).astype(np.float32)
    ids = rng.permutation(32 ** 3)[:N].astype(np.uint64)
    mass = rng.uniform(0.5, 4.0, N).astype(np.float32)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=BOX),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=32),
                           mass=mt.FloatAccuracy(delta=1e-3))
    recs, st = new_records(lambda: mt.compress_snapshot(
        io.BytesIO(), pos, vel, ids, spec, num_blocks=BLOCKS, mass=mass,
        device="cpu"))
    want = N * (3 * st["pos_depth"] + 3 * st["vel_depth"] +
                sum(max(w, 1) for w in st["id_widths"]) + st["mass_depth"])
    assert recs[0].counters["packed_bits"] == want


@pytest.mark.parametrize("writer", ["compress_snapshot", "streaming"])
def test_pooled_sum_bytes_are_the_payload_blocks(writer):
    """A write's ``pooled_sum_bytes``, on its record from the start, are
    the stored bytes of every payload block: at least 0.999 of the file's
    block bytes, the meta blocks the rest.  A field in the Deltas coding
    takes no pool task: a write of it alone reads 0."""
    n = 1 << 16
    rng = np.random.default_rng(6)
    pos = rng.uniform(0, BOX, (3, n)).astype(np.float32)
    vel = rng.normal(0, 150, (3, n)).astype(np.float32)
    ids = rng.permutation(64 ** 3)[:n].astype(np.uint64)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=BOX),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=64))
    fp = io.BytesIO()
    if writer == "streaming":
        half = n // BLOCKS
        blocks = ({"pos": pos[:, s:s + half], "vel": vel[:, s:s + half],
                   "ids": ids[s:s + half]} for s in range(0, n, half))
        recs, _ = new_records(lambda: snapshot.compress_snapshot_streaming(
            fp, blocks, spec, device="cpu"))
    else:
        recs, _ = new_records(lambda: mt.compress_snapshot(
            fp, pos, vel, ids, spec, num_blocks=BLOCKS, device="cpu"))
    c = recs[0].counters
    assert list(c)[:3] == ["packed_bits", "depth_room", "pooled_sum_bytes"]
    payload, every = block_bytes(fp.getvalue())
    assert c["pooled_sum_bytes"] == payload
    assert payload / every >= 0.999

    deltas = mt.SnapshotSpec(pos=mt.PositionAccuracy(
        delta=1e-3, width=BOX, deltas=np.full(n, 1e-3, np.float32)))
    recs, _ = new_records(lambda: mt.compress_snapshot(
        io.BytesIO(), pos, None, None, deltas, num_blocks=BLOCKS,
        device="cpu"))
    assert recs[0].counters["pooled_sum_bytes"] == 0


@pytest.mark.parametrize("read", ["batched", "per_segment", "deltas"])
def test_pooled_decode_bytes_are_the_payload_blocks(read):
    """A batched read's ``pooled_decode_bytes``, on its record from the
    start, are the stored bytes of every payload block: at least 0.999 of
    the file's block bytes, the meta blocks the rest.  A read that runs
    per segment, asked to or on a Deltas-mode file, takes no pool task
    and reads 0."""
    n = 1 << 16
    rng = np.random.default_rng(7)
    pos = rng.uniform(0, BOX, (3, n)).astype(np.float32)
    vel = rng.normal(0, 150, (3, n)).astype(np.float32)
    ids = rng.permutation(64 ** 3)[:n].astype(np.uint64)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(
        delta=1e-3, width=BOX,
        deltas=np.full(n, 1e-3, np.float32) if read == "deltas" else None),
        vel=mt.VelocityAccuracy(delta=1.0), ids=mt.IDAccuracy(width=64))
    fp = io.BytesIO()
    mt.compress_snapshot(fp, pos, vel, ids, spec, num_blocks=4,
                         device="cpu")
    fp.seek(0)
    recs, _ = new_records(lambda: mt.decompress_snapshot(
        fp, batched=read != "per_segment", device="cpu"))
    c = recs[0].counters
    assert list(c)[:4] == ["h2d", "d2h", "pooled_decode_bytes",
                           "viewed_segment_bytes"]
    payload, every = block_bytes(fp.getvalue())
    if read == "batched":
        assert c["pooled_decode_bytes"] == payload
        assert payload / every >= 0.999
    else:
        assert c["pooled_decode_bytes"] == 0


@pytest.mark.parametrize("box, deeper", [(64.0, 0), (256.0, 1)])
def test_depth_room_counts_the_fields_it_deepens(monkeypatch, capsys, box,
                                                 deeper):
    """Positions spanning a 256 box at 1e-3 need the room rule's extra bit
    (depth 19 where the reference takes 18); a 64-wide box has room at
    depth 16, and velocities at 1 km/s have room to spare.  The
    ``MINNOW_PROFILE`` line shows both counters."""
    rng = np.random.default_rng(3)
    pos = rng.uniform(0, box, (3, N)).astype(np.float32)
    vel = rng.normal(0, 150, (3, N)).astype(np.float32)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=box),
                           vel=mt.VelocityAccuracy(delta=1.0))
    monkeypatch.setenv("MINNOW_PROFILE", "1")
    recs, st = new_records(lambda: mt.compress_snapshot(
        io.BytesIO(), pos, vel, None, spec, num_blocks=BLOCKS,
        device="cpu"))
    assert st["pos_depth"] == (19 if deeper else 16)
    c = recs[0].counters
    assert c["depth_room"] == deeper
    assert c["packed_bits"] == 3 * N * (st["pos_depth"] + st["vel_depth"])
    line, = capsys.readouterr().err.splitlines()
    assert f"  packed_bits {c['packed_bits'] / 1e6:.1f} Mbit  " \
        f"depth_room {deeper}  " in line


def test_count_outside_an_operation_is_a_no_op():
    n = len(profiling.operations())
    profiling.count("h2d", 5)
    assert len(profiling.operations()) == n
    with profiling.operation("unit"):
        profiling.count("h2d", 3)
        with profiling.operation("inner"):
            profiling.count("h2d", 4)
    rec = profiling.operations()[-1]
    assert rec.name == "unit" and rec.counters == {"h2d": 7}
    profiling.count("h2d", 5)
    assert rec.counters == {"h2d": 7}


def test_records_are_bounded():
    for _ in range(profiling.MAX_RECORDS + 3):
        with profiling.operation("many"):
            pass
    assert len(profiling.operations()) == profiling.MAX_RECORDS


def test_record_kept_when_the_operation_raises():
    with pytest.raises(ValueError):
        with profiling.operation("fails"):
            profiling.count("d2h", 1)
            raise ValueError("x")
    rec = profiling.operations()[-1]
    assert rec.name == "fails" and rec.counters == {"d2h": 1}
    with profiling.operation("after"):
        pass
    assert profiling.operations()[-1].name == "after"


def test_profile_line_only_with_the_variable(files, monkeypatch, capsys):
    raw, _ = files
    monkeypatch.delenv("MINNOW_PROFILE", raising=False)
    compress(raw)
    with profiling.operation("quiet"):
        profiling.count("h2d", 10)
    got = capsys.readouterr()
    assert got.out == "" and got.err == ""

    monkeypatch.setenv("MINNOW_PROFILE", "1")
    with profiling.operation("unit"):
        profiling.count("h2d", 2_000_000)
        with profiling.operation("nested"):
            profiling.count("d2h", 288_100_000)
    recs, _ = new_records(lambda: compress(raw))
    pooled = recs[0].counters["pooled_sum_bytes"]
    got = capsys.readouterr()
    assert got.out == ""
    lines = got.err.splitlines()
    assert len(lines) == 2
    head, counters = lines[0].split(" ms")
    assert head.startswith("[minnow] unit: ")
    float(head.rsplit(" ", 1)[1])
    assert counters == "  h2d 2.0 MB  d2h 288.1 MB"
    assert lines[1].startswith("[minnow] g2.compress: ")
    assert lines[1].endswith(" ms  packed_bits 0.5 Mbit  depth_room 0  "
                             f"pooled_sum_bytes {pooled / 1e6:.1f} MB  "
                             "h2d 0.0 MB  d2h 0.0 MB")


def test_decompress_lands_nothing_in_pinned_memory_on_the_cpu(
        files, monkeypatch, capsys):
    """On the CPU the driver lays the read's file out in ordinary memory:
    its record and its ``MINNOW_PROFILE`` line read ``d2h_pinned`` 0, and
    the line shows the segment bodies the read took as views beside the
    payload blocks its pool decoded."""
    _, packed = files
    monkeypatch.setenv("MINNOW_PROFILE", "1")
    recs, _ = new_records(lambda: decompress(packed))
    assert recs[0].counters["d2h_pinned"] == 0
    line, = capsys.readouterr().err.splitlines()
    assert line.startswith("[minnow] g2.decompress: ")
    pooled = recs[0].counters["pooled_decode_bytes"]
    assert pooled == driver_block_bytes(packed)[0]
    viewed = recs[0].counters["viewed_segment_bytes"]
    assert viewed == segment_bytes(packed, True)
    assert line.endswith(" ms  h2d 0.0 MB  d2h 0.0 MB  pooled_decode_bytes "
                         f"{pooled / 1e6:.1f} MB  viewed_segment_bytes "
                         f"{viewed / 1e6:.1f} MB  d2h_pinned 0.0 MB")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["write", "read"])
def test_counters_hold_the_copies_on_a_card(files, op):
    """Raw fields cross once (up for a write, down for a read); the packed
    words cross the other way; the per-block stats, keys and origins add a
    few hundred bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    raw, packed = files
    recs, _ = new_records(lambda: compress(raw, "cuda") if op == "write"
                          else decompress(packed, "cuda"))
    c = recs[0].counters
    fields = N * (3 * 4 + 3 * 4 + 8 + 4)
    one, other = ("h2d", "d2h") if op == "write" else ("d2h", "h2d")
    assert fields <= c[one] <= fields + 1024
    # a block's words: its depths and ID widths over 32 bits a word
    assert 0 < c[other] < fields
    if op == "read":    # the fields, and only they, land in pinned memory
        assert c["d2h"] == fields and c["d2h_pinned"] == c["d2h"]
