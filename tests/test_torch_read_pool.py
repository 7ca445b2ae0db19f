"""The batched snapshot read's host wire in the pool, against the
per-segment read and the JAX package's reader.

The batched reader parses each segment's layout (``format.layout``),
checks every stored block's checksum in a pool task on a view of the
segment bytes, and LZ4-decodes (or copies) each (segment, dim) payload
straight into its row of one host array (``entropy.decode_into``).  Its
decodes must equal the per-segment path's and the JAX package's bit for
bit, on files with LZ4 and raw payload blocks, for every field subset, a
box query and the multihost reader's local slabs; on a corrupt file its
outcome (a fallback to the per-segment path, ValueError, or the decoded
fields) must be the JAX package's.  The port runs on the CPU.
"""

import io
import itertools
import struct

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu_torch.algos.blocks import FLAG_LZ4
from minnow_c_tpu_torch.ops import entropy
from minnow_c_tpu_torch.parallel import snapshot as tsnap
from minnow_c_tpu_torch.segment import format as wire
from minnow_c_tpu_torch.segment import io as seg_io
from minnow_c_tpu_torch.utils import profiling
from test_snapshot import make_snapshot

N, BLOCKS = 4096, 4
NAMES = ("pos", "vel", "ids", "mass")
CPU = torch.device("cpu")


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _same(ref: dict, got: dict) -> None:
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(np.shape(ref[k])), k
        assert _bits(got[k]) == _bits(ref[k]), k


@pytest.fixture(scope="module")
def blob() -> bytes:
    """pos + vel + ids + mass, 4 segments of 1024 particles; block b's x
    moves by 8 b, so that the blocks' bounding boxes are apart.  The
    masses repeat every 8 particles, so LZ4 stores their payloads; the
    other fields' payloads are stored raw."""
    pos, vel, ids = make_snapshot(n=N)
    pos[0] = (pos[0] + np.float32(8.0) * (np.arange(N) // 1024)) % 64.0
    mass = (0.5 + 0.25 * (np.arange(N) % 8)).astype(np.float32)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=64.0),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=1024),
                           mass=mt.FloatAccuracy(delta=1e-4))
    fp = io.BytesIO()
    mt.compress_snapshot(fp, pos, vel, ids, spec, num_blocks=BLOCKS, seed=3,
                         mass=mass, device="cpu")
    return fp.getvalue()


def _segments(blob: bytes):
    """(offset of the segment's bytes in the file, the bytes), in order."""
    fp = io.BytesIO(blob)
    out = []
    for hd, seg in seg_io.iter_segments(fp):
        out.append((fp.tell() - len(seg), seg))
    return out


def _read(blob: bytes, **kw):
    """The port's batched read, and the stored bytes its pool decoded."""
    with profiling.operation("test.read"):
        got = mt.decompress_snapshot(io.BytesIO(blob), device="cpu", **kw)
    return got, profiling.operations()[-1].counters["pooled_decode_bytes"]


def test_file_has_lz4_and_raw_payload_blocks(blob):
    """The cases below decode both kinds of payload block."""
    flags = set()
    for _, seg in _segments(blob):
        for f in wire.layout(seg).fields:
            for b in f.blocks[1:]:
                flags.add(struct.unpack_from("<IIBB", seg, b.offset)[3])
    assert flags == {0, FLAG_LZ4}


SUBSETS = [None] + [set(c) for r in range(1, 5)
                    for c in itertools.combinations(NAMES, r)]


@pytest.mark.parametrize("fields", SUBSETS,
                         ids=lambda s: "all" if s is None else "+".join(
                             n for n in NAMES if n in s))
def test_pooled_read_matches_per_segment_and_jax(blob, fields):
    got, pooled = _read(blob, fields=fields)
    _same(mt.decompress_snapshot(io.BytesIO(blob), batched=False,
                                 fields=fields, device="cpu"), got)
    _same(jsnap.decompress_snapshot(io.BytesIO(blob), fields=fields), got)
    # the pool decoded every payload block of the wanted fields
    want = set(NAMES) if fields is None else fields
    codes = {tsnap._FIELD_BY_NAME[n] for n in want}
    assert pooled == sum(b.length for _, seg in _segments(blob)
                         for f in wire.layout(seg).fields
                         if f.field_code in codes for b in f.blocks[1:])


@pytest.mark.parametrize("segment", [1, 2])
def test_pooled_box_query_matches(blob, segment):
    """A query box around one segment's bounding box reads it alone."""
    hdr = list(seg_io.iter_headers(io.BytesIO(blob)))[segment]
    box = (hdr.origin, hdr.width)
    got, pooled = _read(blob, box=box, periodic=64.0)
    assert got["pos"].shape == (3, N // BLOCKS) and pooled > 0
    _same(mt.decompress_snapshot(io.BytesIO(blob), batched=False, box=box,
                                 periodic=64.0, device="cpu"), got)
    _same(jsnap.decompress_snapshot(io.BytesIO(blob), box=box,
                                    periodic=64.0), got)


@pytest.mark.parametrize("rank", [0, 1])
def test_multihost_local_slabs_match(blob, rank, monkeypatch):
    """Process ``rank`` of two reads its half of the segments through the
    pooled path: its local slabs are that half of the whole read."""
    monkeypatch.setattr(tsnap.mh, "process_count", lambda: 2)
    monkeypatch.setattr(tsnap.mh, "process_index", lambda: rank)
    with profiling.operation("test.read"):
        out = tsnap.decompress_snapshot_multihost(io.BytesIO(blob),
                                                  device="cpu")
    assert profiling.operations()[-1].counters["pooled_decode_bytes"] > 0
    whole = jsnap.decompress_snapshot(io.BytesIO(blob))
    half = N // 2
    cut = slice(rank * half, (rank + 1) * half)
    _same({k: np.asarray(v)[..., cut] for k, v in whole.items()},
          out["local"])
    assert out["blocks_local"] == BLOCKS // 2


# ---------------------------------------------------------------------------
# entropy.decode_into against entropy.decode
# ---------------------------------------------------------------------------

def _streams():
    rng = np.random.default_rng(11)
    smooth = np.cumsum(rng.integers(0, 3, 50_000)).astype(np.uint32)
    return {"smooth": smooth.view(np.uint8),
            "random": rng.integers(0, 256, 40_000, dtype=np.uint8),
            "runs": np.repeat(rng.integers(0, 256, 64, dtype=np.uint8), 97),
            "short": np.arange(5, dtype=np.uint8),
            "empty": np.zeros(0, np.uint8)}


@pytest.mark.parametrize("name", sorted(_streams()))
def test_decode_into_matches_decode(name):
    raw = _streams()[name]
    comp = entropy.encode_view(raw)
    out = np.full(raw.size, 0xAB, np.uint8)
    entropy.decode_into(comp, out)
    np.testing.assert_array_equal(out, entropy.decode(comp, raw.size))
    np.testing.assert_array_equal(out, raw)
    if raw.size % 4 == 0:   # into a row of words, as the reader does
        rows = np.zeros((3, raw.size // 4), "<u4")
        entropy.decode_into(comp, rows[1])
        assert rows[1].tobytes() == raw.tobytes()
        assert not rows[0].any() and not rows[2].any()


def _raises(fn):
    try:
        fn()
    except Exception as e:  # the class is what is compared
        return type(e)
    return None


@pytest.mark.parametrize("fault", ["truncated", "garbage", "too_small",
                                   "too_large"])
def test_decode_into_raises_as_decode_does(fault):
    raw = _streams()["smooth"]
    comp = entropy.encode_view(raw)
    src, size = comp, raw.size
    if fault == "truncated":
        src = comp[:comp.size // 2]
    elif fault == "garbage":
        src = np.full(64, 0xFF, np.uint8)
    elif fault == "too_small":
        size = raw.size - 4
    else:
        size = raw.size + 4
    want = _raises(lambda: entropy.decode(src, size))
    assert want is ValueError
    assert _raises(lambda: entropy.decode_into(
        src, np.empty(size, np.uint8))) is want


def test_decode_into_refuses_a_strided_destination():
    raw = _streams()["smooth"]
    rows = np.zeros((raw.size // 4, 2), "<u4")
    with pytest.raises(ValueError):
        entropy.decode_into(entropy.encode_view(raw), rows[:, 0])


# ---------------------------------------------------------------------------
# Corrupt files: one flipped byte in each block kind of the 4-segment file
# ---------------------------------------------------------------------------

# (field, block): the meta block (0) and each payload dim of each field
BLOCK_FLIPS = [(name, b) for name, dims in (("pos", 3), ("vel", 3),
                                            ("ids", 3), ("mass", 1))
               for b in range(1 + dims)]
# offsets in segment 2's header: its block count, a field header, a block
# header's length and its checksum
HEADER_FLIPS = [4, 20, 16 + 16 * 4 + 8, 16 + 16 * 4 + 8 * 5 + 4]


def _outcome(fn):
    try:
        out = fn()
    except Exception as e:  # the class is what is compared
        return ("raised", type(e).__name__, isinstance(e, ValueError))
    return ("ok", {k: _bits(v) for k, v in sorted(out.items())})


def _flipped(blob: bytes, where) -> bytes:
    start, seg = _segments(blob)[2]
    if isinstance(where, int):
        off = where
    else:
        name, b = where
        code = tsnap._FIELD_BY_NAME[name]
        field, = [f for f in wire.layout(seg).fields if f.field_code == code]
        span = field.blocks[b]
        off = span.offset + span.length // 2
    out = bytearray(blob)
    out[start + off] ^= 0xFF
    return bytes(out)


@pytest.mark.parametrize("leave_out", [False, True],
                         ids=["all_fields", "field_left_out"])
@pytest.mark.parametrize("where", BLOCK_FLIPS + HEADER_FLIPS,
                         ids=lambda w: f"{w[0]}{w[1]}" if isinstance(w, tuple)
                         else f"header{w}")
def test_corrupt_file_outcome_is_jax(blob, where, leave_out):
    """Every flip makes the batched read fall back to the per-segment path;
    the outcome (ValueError, or the decoded fields) is the JAX package's,
    also where ``fields=`` leaves the flipped field out."""
    bad = _flipped(blob, where)
    fields = None
    if leave_out:
        hit = where[0] if isinstance(where, tuple) else "pos"
        fields = {n for n in NAMES if n != hit}
    want = _outcome(lambda: jsnap.decompress_snapshot(io.BytesIO(bad),
                                                      fields=fields))
    got = _outcome(lambda: mt.decompress_snapshot(io.BytesIO(bad),
                                                  fields=fields,
                                                  device="cpu"))
    assert got == want, (got if got[0] == "raised" else "ok",
                         want if want[0] == "raised" else "ok")
    segs = [s for _, s in _segments(bad)]
    codes = None if fields is None else tsnap._parse_want(fields)
    assert tsnap._decompress_snapshot_batched(segs, codes, CPU) is None
