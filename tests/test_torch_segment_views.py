"""A snapshot read's segment bodies as views of the caller's bytes
(``segment.io.iter_segment_views``), against the copy path and the JAX
package's reader.

``decompress_snapshot`` takes each segment body as a ``memoryview`` of the
bytes an ``io.BytesIO`` holds (its value: the caller's ``bytes`` itself
while the stream shares it); any other stream, a file on disk or one that
gives only ``read``, ``seek`` and ``tell``, is read by ``iter_segments`` as
it is.  On each source its decodes must equal the copy path's
(``iter_segments`` and ``decode_segments``) and the JAX package's bit for
bit, its record's ``viewed_segment_bytes`` must say which source it took,
it must leave the stream where ``iter_segments`` leaves it and hold nothing
of the caller's bytes once it returns, and it must raise ValueError where
``iter_segments`` does.  The port runs on the CPU.
"""

import dataclasses
import io
import sys

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu.drivers import gadget2 as jg2
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.segment import io as jio
from minnow_c_tpu_torch.drivers import gadget2 as tg2
from minnow_c_tpu_torch.parallel import snapshot as tsnap
from minnow_c_tpu_torch.segment import io as seg_io
from minnow_c_tpu_torch.utils import profiling

import gadget2_cases
from test_snapshot import make_snapshot

N, BLOCKS, BOX = 4096, 4, 64.0
SOURCES = ["shared", "written", "disk", "stream"]
VIEWED = {"shared": True, "written": True, "disk": False, "stream": False}


class PlainStream:
    """A stream with only ``read``, ``seek`` and ``tell``, all that
    ``iter_segments`` asks of one; its ``seek`` returns nothing."""

    def __init__(self, data: bytes):
        self._inner = io.BytesIO(data)

    def read(self, n=-1):
        return self._inner.read(n)

    def seek(self, *a):
        self._inner.seek(*a)

    def tell(self):
        return self._inner.tell()

    def close(self):
        self._inner.close()


def _open(kind: str, blob: bytes, start: int, tmp_path):
    """The stream of source ``kind`` over ``blob``, at ``start``."""
    if kind == "shared":
        fp = io.BytesIO(blob)
    elif kind == "written":
        fp = io.BytesIO()
        fp.write(blob)
    elif kind == "disk":
        path = tmp_path / "snap.min"
        path.write_bytes(blob)
        fp = open(path, "rb")
    else:
        fp = PlainStream(blob)
    fp.seek(start)
    return fp


def _uniform():
    pos, vel, ids = make_snapshot(n=N)
    pos[0] = (pos[0] + np.float32(8.0) * (np.arange(N) // 1024)) % BOX
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=BOX),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=1024))
    fp = io.BytesIO()
    mt.compress_snapshot(fp, pos, vel, ids, spec, num_blocks=BLOCKS, seed=3,
                         device="cpu")
    return fp.getvalue()


def _mixed():
    """Segments of 1000, 1500 and 1596 particles, each with its own
    depths: the batched read gives up and decodes per segment."""
    pos, vel, ids = make_snapshot(n=N, seed=1)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=BOX),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=1024))
    cuts = [0, 1000, 2500, N]
    fp = io.BytesIO()
    tsnap.compress_snapshot_streaming(
        fp, ({"pos": pos[:, a:b], "vel": vel[:, a:b], "ids": ids[a:b]}
             for a, b in zip(cuts, cuts[1:])), spec, seed=5, device="cpu")
    return fp.getvalue()


def _gadget2():
    """A driver's ``.g2.min``: its chain starts past the Gadget-2 header
    record."""
    raw = gadget2_cases.raw_file("mixed_4096")
    out = io.BytesIO()
    tg2.compress(io.BytesIO(raw), out, num_blocks=2, device="cpu")
    return out.getvalue()


def _box(blob: bytes):
    hd = list(seg_io.iter_headers(io.BytesIO(blob)))[2]
    return hd.origin, hd.width


@pytest.fixture(scope="module")
def files():
    uniform = _uniform()
    g2 = _gadget2()
    head = io.BytesIO(g2)
    tg2._read_record(head)
    # case -> (file, where its chain starts, decompress_snapshot's options)
    return {"uniform": (uniform, 0, {}),
            "mixed": (_mixed(), 0, {}),
            "box": (uniform, 0, {"box": _box(uniform), "periodic": BOX}),
            "fields": (uniform, 0, {"fields": {"pos", "ids"}}),
            "gadget2": (g2, head.tell(), {})}


def _copy_path(blob: bytes, start: int, kw: dict):
    """The copy path's segments, and where it leaves the stream."""
    fp = io.BytesIO(blob)
    fp.seek(start)
    if "box" in kw:
        segs = [s for _, s in seg_io.iter_segments_intersecting(
            fp, *kw["box"], kw["periodic"])]
    else:
        segs = [s for _, s in seg_io.iter_segments(fp)]
    return segs, fp.tell()


def _bits(t) -> bytes:
    if isinstance(t, torch.Tensor):
        t = t.numpy()
    return np.ascontiguousarray(np.asarray(t)).tobytes()


def _same(ref: dict, got: dict) -> None:
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == tuple(np.shape(ref[k])), k
        assert _bits(got[k]) == _bits(ref[k]), k


def _span(buf):
    """[first, last) address of a buffer's bytes."""
    a = np.frombuffer(buf, np.uint8)
    return a.ctypes.data, a.ctypes.data + a.size


def _apart(out: dict, span) -> bool:
    lo, hi = span
    for t in out.values():
        st = t.untyped_storage()
        if st.data_ptr() < hi and lo < st.data_ptr() + st.nbytes():
            return False
    return True


@pytest.mark.parametrize("case", ["uniform", "mixed", "box", "fields",
                                  "gadget2"])
@pytest.mark.parametrize("kind", SOURCES)
def test_views_read_matches_copy_path_and_jax(files, kind, case, tmp_path,
                                              monkeypatch):
    blob, start, kw = files[case]
    segs, tell = _copy_path(blob, start, kw)
    want = tsnap.decode_segments(segs, True,
                                 tsnap._parse_want(kw.get("fields")), "cpu")
    jfp = io.BytesIO(blob)
    jfp.seek(start)
    _same(jsnap.decompress_snapshot(jfp, **kw), want)

    held = []   # the whole file's bytes the reader took, if any
    take = seg_io._held_bytes
    monkeypatch.setattr(seg_io, "_held_bytes",
                        lambda fp: held.append(take(fp)) or held[-1])
    fp = _open(kind, blob, start, tmp_path)
    refs = sys.getrefcount(blob)
    got = mt.decompress_snapshot(fp, device="cpu", **kw)
    _same(want, got)
    if case == "mixed":   # the per-segment path ran on the views
        assert profiling.operations()[-1].counters[
            "pooled_decode_bytes"] == 0
    assert profiling.operations()[-1].counters["viewed_segment_bytes"] == (
        sum(map(len, segs)) if VIEWED[kind] else 0)
    assert fp.tell() == tell
    # no output shares the caller's bytes, and nothing holds them
    whole = held.pop()
    assert (whole is None) == (not VIEWED[kind])
    assert (whole is blob) == (kind == "shared")
    assert _apart(got, _span(blob if whole is None else whole))
    del whole
    assert sys.getrefcount(blob) == refs
    if isinstance(fp, io.BytesIO):
        fp.seek(0)
        fp.write(b"\0" * 64)
        fp.truncate(16)
    fp.close()
    _same(want, got)


@pytest.mark.parametrize("kind", SOURCES)
def test_driver_read_matches_jax(files, kind, tmp_path):
    """The driver reads its header record first, then the chain from
    there; its Gadget-2 file is the JAX package's."""
    blob, _, _ = files["gadget2"]
    out = io.BytesIO()
    fp = _open(kind, blob, 0, tmp_path)
    tg2.decompress(fp, out, device="cpu")
    fp.close()
    want = io.BytesIO()
    jg2.decompress(io.BytesIO(blob), want)
    assert out.getvalue() == want.getvalue()


@pytest.mark.parametrize("kind", SOURCES)
def test_shared_bodies_are_the_callers_bytes(files, kind, tmp_path):
    blob, _, _ = files["uniform"]
    fp = _open(kind, blob, 0, tmp_path)
    bodies = [b for _, b in seg_io.iter_segment_views(fp)]
    assert all(isinstance(b, memoryview) == VIEWED[kind] for b in bodies)
    if kind == "shared":
        assert all(b.obj is blob for b in bodies)
    elif kind == "written":   # one copy of the whole file, not one a body
        assert len({id(b.obj) for b in bodies}) == 1
        assert bodies[0].obj is not blob
    del bodies
    fp.close()


@pytest.mark.parametrize("case", ["uniform", "mixed", "gadget2"])
@pytest.mark.parametrize("kind", SOURCES)
@pytest.mark.parametrize("box", [False, True])
def test_pairs_match_jax_iter_segments(files, kind, case, box, tmp_path):
    """The new reader's (header, body) pairs and end position are the JAX
    package's ``iter_segments`` (``iter_segments_intersecting``), byte for
    byte: it is a new name in a forked module, which the text check of
    ``test_host_modules_are_unchanged_copies`` does not see."""
    blob, start, _ = files[case]
    q = files["box"][2]["box"] if box else None
    jfp = io.BytesIO(blob)
    jfp.seek(start)
    want = list(jio.iter_segments_intersecting(jfp, *q, BOX) if box
                else jio.iter_segments(jfp))
    fp = _open(kind, blob, start, tmp_path)
    got = list(seg_io.iter_segment_views(fp, q, BOX if box else None))
    assert [(dataclasses.astuple(h), bytes(b)) for h, b in got] == \
        [(dataclasses.astuple(h), b) for h, b in want]
    assert fp.tell() == jfp.tell()
    del got
    fp.close()


def _corrupt(blob: bytes, how: str) -> bytes:
    """The file cut inside its second segment's body, or its first
    header's SegmentBytes out of range."""
    hd = next(seg_io.iter_headers(io.BytesIO(blob)))
    if how == "truncated":
        return blob[:hd.next_io_header + seg_io.IO_HEADER_BYTES + 100]
    b = bytearray(blob)
    b[32:40] = (1 << 62).to_bytes(8, "little")
    return bytes(b)


@pytest.mark.parametrize("how", ["truncated", "segment_bytes"])
@pytest.mark.parametrize("kind", SOURCES)
def test_corrupt_chain_raises_as_iter_segments(files, kind, how, tmp_path):
    blob = _corrupt(files["uniform"][0], how)
    with pytest.raises(ValueError) as want:
        list(seg_io.iter_segments(io.BytesIO(blob)))
    fp = _open(kind, blob, 0, tmp_path)
    with pytest.raises(ValueError) as got:
        mt.decompress_snapshot(fp, device="cpu")
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        jsnap.decompress_snapshot(io.BytesIO(blob))
    fp.close()
