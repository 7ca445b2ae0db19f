"""The port's decoders on corrupt input, against the JAX package's.

A port of every case of ``tests/test_fuzz.py``: mutated, truncated and
garbage segment bytes, a header that lies about its field count, unknown
block flags, a field with too few blocks, and whole snapshot files.  Each
case runs through both packages, and the port's outcome must equal the
JAX package's: the same error class, or the same decoded arrays, bit for
bit.  The corrupt-input contract the JAX package states is ValueError
(EOFError, KeyError in the segment layer) or a decode; the file layer
adds a multi-field snapshot, whose checksum-failed fields must raise
ValueError in the port too.  The port runs on the CPU.
"""

import io

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.segment import api as japi
from minnow_c_tpu.segment import format as jfmt
from minnow_c_tpu_torch.algos import blocks as tblocks
from minnow_c_tpu_torch.parallel import snapshot as tsnap
from test_fuzz import base_blob
from test_segment import make_seg


def _bits(a):
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        a = a.numpy()
    return np.ascontiguousarray(np.asarray(a)).tobytes()


def _outcome(fn):
    """("ok", decoded arrays as bytes) or ("raised", the error's class
    name, whether it is a ValueError).  Each package has its own copy of
    the host layer's error classes, so the names are compared."""
    try:
        out = fn()
    except Exception as e:  # the class is what is compared
        return ("raised", type(e).__name__, isinstance(e, ValueError))
    if isinstance(out, dict):
        return ("ok", {k: _bits(v) for k, v in sorted(out.items())})
    return ("ok", [None if f is None else _bits(f.data)
                   for f in out.fields])


def _check_segment(blob: bytes) -> None:
    for fused in (False, True):
        want = _outcome(lambda: japi.decompress_segment(blob, fused=fused))
        got = _outcome(lambda: mt.decompress_segment(blob, fused=fused,
                                                     device="cpu"))
        assert got == want, (fused, got if got[0] == "raised" else "ok",
                             want if want[0] == "raised" else "ok")


def _check_file(blob: bytes) -> None:
    want = _outcome(lambda: jsnap.decompress_snapshot(io.BytesIO(blob)))
    got = _outcome(lambda: tsnap.decompress_snapshot(io.BytesIO(blob),
                                                     device="cpu"))
    assert got == want, (got if got[0] == "raised" else "ok",
                         want if want[0] == "raised" else "ok")
    if want[0] == "raised":
        assert want[2], want  # the contract: ValueError or a decode


@pytest.fixture(scope="module")
def blob():
    b = base_blob()
    rng = np.random.default_rng(0)
    n = 600
    pos = rng.uniform(0, 8.0, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 16)[:n].astype(np.uint64)
    v = mt.semver.pack(1, 1, 0)
    seg = mt.Seg(fields=[
        mt.Field(hd=mt.FieldHeader(mt.FieldCode.POSN, mt.AlgoCode.TRIM, v,
                                   n),
                 data=pos, acc=mt.PositionAccuracy(delta=1e-2, width=8.0)),
        mt.Field(hd=mt.FieldHeader(mt.FieldCode.PTID, mt.AlgoCode.TRIM, v,
                                   n),
                 data=ids, acc=mt.IDAccuracy(width=64)),
    ])
    assert mt.compress_segment(seg, seed=1, device="cpu") == b
    return b


def test_single_byte_mutations(blob):
    rng = np.random.default_rng(1)
    offsets = list(range(0, 120, 4)) + \
        list(rng.integers(0, len(blob), 60))
    for off in offsets:
        b = bytearray(blob)
        b[off % len(blob)] ^= rng.integers(1, 256)
        _check_segment(bytes(b))


def test_truncations(blob):
    for cut in (0, 1, 4, 15, 16, 63, 64, len(blob) // 2, len(blob) - 1):
        _check_segment(blob[:cut])


def test_garbage():
    rng = np.random.default_rng(2)
    for n in (0, 3, 16, 64, 4096):
        _check_segment(rng.integers(0, 256, n).astype(np.uint8).tobytes())


def test_header_field_count_lies(blob):
    b = bytearray(blob)
    b[8:12] = (10 ** 6).to_bytes(4, "little")
    _check_segment(bytes(b))


def test_unknown_block_flags_rejected():
    blk = bytearray(tblocks.encode_block(b"x" * 32, width=8,
                                         try_entropy=False))
    blk[9] |= 0x02  # a reserved flag bit
    with pytest.raises(ValueError, match="unknown block flag"):
        tblocks.decode_block(bytes(blk))


def test_fused_decode_short_block_list_degrades():
    seg, _, _, _ = make_seg(n=4096)
    blob = japi.compress_segment(seg, seed=1)
    parsed = jfmt.deserialize(blob)
    fields = [jfmt.WireField(f.field_code, f.algo_code, f.version,
                             f.blocks[:1] if i == 0 else f.blocks)
              for i, f in enumerate(parsed.fields)]
    cut = jfmt.serialize(fields, parsed.particle_num)
    out = mt.decompress_segment(cut, fused=True, device="cpu")
    assert out.fields[0] is None or out.fields[0].data is None \
        or not getattr(out.fields[0], "valid", True)
    _check_segment(cut)


def _file(pos, vel, ids, spec) -> bytes:
    buf = io.BytesIO()
    jsnap.compress_snapshot(buf, pos, vel, ids, spec, num_blocks=2, seed=1)
    tbuf = io.BytesIO()
    tsnap.compress_snapshot(tbuf, pos, vel, ids, spec, num_blocks=2, seed=1,
                            device="cpu")
    assert tbuf.getvalue() == buf.getvalue()
    return buf.getvalue()


def test_file_layer_mutations_and_truncations():
    """The JAX package's own file case: a positions-only 2-block file,
    bytes flipped over the headers and at every 509th offset, and cut
    every 251 bytes."""
    rng = np.random.default_rng(0)
    n = 2048
    pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=64.0))
    blob = _file(pos, None, None, spec)
    for i in list(range(96)) + list(range(96, len(blob), 509)):
        b = bytearray(blob)
        b[i] ^= 0xFF
        _check_file(bytes(b))
    for cut in range(0, len(blob), 251):
        _check_file(blob[:cut])


# The multi-field file: a byte flipped at every 35th offset, over the meta,
# payload and checksum of both blocks' three fields, in three cases of
# every 105th.  A flip inside a field's payload fails that field's
# checksum: the field decodes to no data, and the reader must raise
# ValueError, as the JAX package's does.
STEP = 105


@pytest.mark.parametrize("start", [0, 35, 70])
def test_file_layer_multi_field(start):
    rng = np.random.default_rng(0)
    n = 2048
    pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 20)[:n].astype(np.uint64)
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=1e-3, width=64.0),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=1 << 10))
    blob = _file(pos, vel, ids, spec)
    for i in range(start, len(blob), STEP):
        b = bytearray(blob)
        b[i] ^= 0xFF
        _check_file(bytes(b))
