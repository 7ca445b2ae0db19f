"""The snapshot writer's stored blocks and part-list segments, on the CPU.

``compress_snapshot`` hands each (block, dim) payload to one pool task
that takes its LZ4, prelude, pad and checksum (``_stored_block``), builds
each segment's header alone (``format.serialize_parts``) and writes the
parts in order (``io.write_segments``).  The JAX package's writer is the
path this replaces: each block wrapped and copied (``_wrap_precompressed``),
joined by ``serialize``, written as bytes.  The files must be equal byte
for byte; so must every forked host function's output and the JAX
package's copy of it.
"""

import io

import numpy as np
import pytest

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.algos import blocks as jblocks
from minnow_c_tpu.ops import entropy as jentropy
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.segment import format as jfmt
from minnow_c_tpu.segment import io as jio
from minnow_c_tpu_torch.algos import blocks as tblocks
from minnow_c_tpu_torch.ops import entropy
from minnow_c_tpu_torch.ops.checksum import CHECKSUM_INIT, checksum, \
    checksum_py
from minnow_c_tpu_torch.parallel import snapshot as tsnap
from minnow_c_tpu_torch.segment import format as wire
from minnow_c_tpu_torch.segment import io as seg_io
from test_snapshot import make_snapshot

BOX = 64.0


def _walk(n, seed):
    """make_snapshot's fields (a random walk: LZ4 shrinks the positions)."""
    return dict(zip(("pos", "vel", "ids"), make_snapshot(n=n, seed=seed)))


def _uniform(n, seed):
    """Uniform positions and IDs spread over a 2^20 grid: their packed
    bins are noise, so LZ4 does not shrink them and the raw words are
    stored."""
    rng = np.random.default_rng(seed)
    return dict(pos=rng.uniform(0, BOX, (3, n)).astype(np.float32),
                ids=rng.integers(0, 1 << 60, n, dtype=np.uint64))


def _with_mass(make, value=None):
    def f(n, seed):
        out = make(n, seed)
        rng = np.random.default_rng(seed + 1)
        out["mass"] = (np.full(n, value, np.float32) if value is not None
                       else rng.uniform(0.5, 3.0, n).astype(np.float32))
        return out
    return f


SPEC = dict(pos=("PositionAccuracy", dict(delta=1e-3, width=BOX)),
            vel=("VelocityAccuracy", dict(delta=1.0)),
            ids=("IDAccuracy", dict(width=1 << 20)),
            mass=("FloatAccuracy", dict(delta=1e-3)))

# name -> (fields, particles, blocks, scale mode)
CASES = {
    "walk_1_block": (_walk, 8192, 1, "div"),
    "walk_3_blocks": (_walk, 3 * 4096, 3, "div"),
    "walk_mass_3_blocks_recip": (_with_mass(_walk), 3 * 4096, 3, "recip"),
    "raw_fallback_3_blocks": (_uniform, 3 * 2048, 3, "div"),
    # a constant field has depth 0: every payload is empty, its blocks
    # preludes alone
    "constant_mass_3_blocks": (_with_mass(_uniform, 2.5), 3 * 2048, 3,
                               "div"),
    "constant_mass_recip": (_with_mass(_walk, 0.75), 4096, 1, "recip"),
}


def _spec(pkg, snap, names):
    return snap.SnapshotSpec(**{k: getattr(pkg, SPEC[k][0])(**SPEC[k][1])
                                for k in names})


def _blocks(file: bytes):
    """Every stored block of a snapshot file, in file order."""
    return [b for _, seg in seg_io.iter_segments(io.BytesIO(file))
            for f in wire.deserialize(seg).fields for b in f.blocks]


@pytest.mark.parametrize("case", sorted(CASES))
def test_compress_snapshot_writes_the_wrapped_blocks_bytes(case):
    """The part-list path writes the file of the JAX package's writer,
    which wraps, joins and writes each block as bytes."""
    make, n, blocks, mode = CASES[case]
    arrays = make(n, 11)
    given = {k: arrays.get(k) for k in ("pos", "vel", "ids", "mass")}
    fa, fb = io.BytesIO(), io.BytesIO()
    sa = jsnap.compress_snapshot(
        fa, spec=_spec(mnw, jsnap, arrays), num_blocks=blocks, seed=5,
        scale_mode=mode, **given)
    sb = mt.compress_snapshot(
        fb, spec=_spec(mt, tsnap, arrays), num_blocks=blocks, seed=5,
        scale_mode=mode, device="cpu", **given)
    assert fb.getvalue() == fa.getvalue()
    assert sb == sa and sb["bytes"] == len(fb.getvalue())
    # the case holds what it is named for
    stored = _blocks(fb.getvalue())
    flags = [b[9] for b in stored if b[8]]      # payload blocks (width > 0)
    if case.startswith("raw"):
        assert 0 in flags
    if case.startswith("constant"):
        assert any(len(b) == 16 for b in stored)
    if case.startswith("walk"):
        assert tblocks.FLAG_LZ4 in flags


def _words(kind):
    rng = np.random.default_rng(3)
    if kind == "lz4":
        return np.repeat(rng.integers(0, 1 << 10, 300, dtype=np.uint32), 7)
    if kind == "empty":
        return np.zeros(0, np.uint32)
    n = 1001 if kind == "raw_padded" else 1000
    return rng.integers(0, 1 << 32, n, dtype=np.uint32)


@pytest.mark.parametrize("kind, n_parts", [("lz4", None), ("raw_padded", 3),
                                           ("raw_pad_free", 2),
                                           ("empty", 1)])
def test_stored_block_checksum_chains_through_its_parts(kind, n_parts):
    """A stored block's parts are ``encode_block``'s block, and its
    checksum, chained through each part by ``init``, is the checksum of
    their concatenation; a prelude-only block and a pad-free one too."""
    words = _words(kind)
    blk = tsnap._stored_block(words, 13, accel=1)
    joined = b"".join(blk.parts)
    assert joined == jblocks.encode_block(words, 13) == \
        tblocks.encode_block(words, 13)
    assert all(len(p) for p in blk.parts)
    if n_parts is not None:
        assert len(blk.parts) == n_parts
    c = CHECKSUM_INIT
    for p in blk.parts:
        c = checksum(p, init=c)
    assert blk.checksum == c == checksum_py(joined) == checksum(joined)
    assert len(blk) == len(joined)
    # no copy: the raw choice stores a view of the words, LZ4's a view of
    # its own output buffer
    if kind.startswith("raw"):
        assert np.shares_memory(blk.parts[1], words)
    elif kind == "lz4":
        assert blk.parts[1].base.size == entropy.compress_bound(words.nbytes)


def _fields(stored: bool):
    """Three fields: one with a meta block and two payloads, one with no
    block at all, one whose only payload is empty; as stored blocks or as
    their bytes."""
    rng = np.random.default_rng(8)
    payloads = [rng.integers(0, 1 << 12, 777, dtype=np.uint32),
                np.repeat(np.arange(64, dtype=np.uint32), 9),
                np.zeros(0, np.uint32)]
    blocks = [tsnap._stored_block(p, 12, 1) for p in payloads]
    if not stored:
        blocks = [b"".join(b.parts) for b in blocks]
    meta = tblocks.encode_block(b"\x01" * 40)
    return [wire.WireField(1, 2, 3, [meta] + blocks[:2]),
            wire.WireField(4, 2, 3, []),
            wire.WireField(5, 2, 3, [blocks[2]])]


def test_block_headers_hold_the_checksums_of_their_blocks():
    """A segment built from parts joins to the JAX package's serialize of
    the same blocks as bytes, and each block header's checksum is the
    checksum of that block's bytes in the joined segment."""
    seg = b"".join(wire.serialize_parts(_fields(True), 4242))
    as_bytes = _fields(False)
    assert seg == jfmt.serialize(
        [jfmt.WireField(f.field_code, f.algo_code, f.version, f.blocks)
         for f in as_bytes], 4242)
    nblocks = int.from_bytes(seg[4:8], "little")
    nfields = int.from_bytes(seg[8:12], "little")
    off = 16 + 16 * nfields + 8 * nblocks
    for i in range(nblocks):
        h = 16 + 16 * nfields + 8 * i
        length = int.from_bytes(seg[h:h + 4], "little")
        assert int.from_bytes(seg[h + 4:h + 8], "little") == \
            checksum(seg[off:off + length])
        off += length
    assert off == len(seg)
    assert jfmt.deserialize(seg).fields[2].blocks[0] == as_bytes[2].blocks[0]


# ---------------------------------------------------------------------------
# The forked host functions against the JAX package's copies
# ---------------------------------------------------------------------------

def _serialize_case(name):
    fields = _fields(False)
    if name == "empty_segment":
        return [], 0
    if name == "empty_block":
        fields[1].blocks = [b""]
    return fields, 100


@pytest.mark.parametrize("name", ["fields", "empty_segment", "empty_block"])
def test_serialize_matches_jax(name):
    fields, n = _serialize_case(name)
    want = jfmt.serialize([jfmt.WireField(f.field_code, f.algo_code,
                                          f.version, f.blocks)
                           for f in fields], n)
    assert wire.serialize(fields, n) == want
    assert b"".join(wire.serialize_parts(fields, n)) == want


def test_serialize_rejects_unaligned_blocks_as_jax_does():
    for ser, wf in ((jfmt.serialize, jfmt.WireField),
                    (wire.serialize, wire.WireField),
                    (wire.serialize_parts, wire.WireField)):
        with pytest.raises(ValueError, match="8-aligned"):
            ser([wf(1, 2, 3, [b"x" * 12])], 1)


@pytest.mark.parametrize("geometry", [False, True])
@pytest.mark.parametrize("as_parts", [False, True])
def test_write_segments_matches_jax(as_parts, geometry):
    """Segments given as bytes or as part lists write the JAX package's
    chained file of the same bytes, through both writers."""
    segs = [wire.serialize_parts(_fields(True), n) for n in (7, 8, 9)]
    flat = [b"".join(s) for s in segs]
    geo = [((float(i), 0.5, 0.25), (1.0, 2.0, 3.0)) for i in range(3)] \
        if geometry else None
    want = io.BytesIO()
    jio.write_segments(want, flat, geo)
    got = io.BytesIO()
    seg_io.write_segments(got, segs if as_parts else flat, geo)
    assert got.getvalue() == want.getvalue()
    streamed = io.BytesIO()
    assert seg_io.write_segments_streaming(
        streamed, zip(segs if as_parts else flat,
                      geo or [None] * 3)) == 3
    assert streamed.getvalue() == want.getvalue()
    assert [seg_io.segment_nbytes(s) for s in segs] == list(map(len, flat))


@pytest.mark.parametrize("kind", ["lz4", "raw_padded", "empty"])
def test_entropy_matches_jax(kind):
    words = _words(kind)
    want = jentropy.encode(words)
    assert entropy.encode(words) == want
    assert entropy.encode_view(words).tobytes() == want
    assert entropy.encode_blocks([words, words[:5]]) == \
        jentropy.encode_blocks([words, words[:5]])
    got = entropy.decode_blocks([want, want], [words.nbytes] * 2)
    for a, b in zip(got, jentropy.decode_blocks([want, want],
                                                [words.nbytes] * 2)):
        assert a.tobytes() == b.tobytes() == words.tobytes()


def test_entropy_pool_map_keeps_order():
    items = list(range(50))
    assert entropy.pool_map(lambda a, b: a * b, items, items[::-1]) == \
        [a * b for a, b in zip(items, items[::-1])]
    assert entropy.pool_map(str, [3]) == ["3"]
    assert entropy.pool_map(str, []) == []
