"""The frozen wire through the torch port: all 42 entries of
``tests/fixtures/wire_digests.json``, encode and decode (generic and
fused), on the CPU.

The segments are ``tests/test_freeze.py``'s generators (its reference
segment, its Deltas-mode segment and its Sort v1.2 order-free stream),
rebuilt here from the port's own types with the same numpy recipe and
seeds; ``test_generators_match_the_freeze_test`` holds them to the freeze
test's through ``interop.seg_from_reference``.  The fixture is only read.
Tolerance: bitwise -- SHA-256 of the segment bytes and of the decoded
arrays' raw bytes, and the byte counts.
"""

import hashlib
import json

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch import interop
from test_freeze import (ALGOS, DELTAS_ALGOS, FIXTURE, deltas_segment,
                         reference_segment)

SV = mt.semver.pack
A = mt.AlgoCode
F = mt.FieldCode
# fixture name -> (algo code, version), as tests/test_freeze.py names them
TORCH_ALGOS = {
    "trim": (A.TRIM, SV(1, 0, 0)), "diff": (A.DIFF, SV(1, 0, 0)),
    "coil": (A.COIL, SV(1, 0, 0)), "octo": (A.OCTO, SV(1, 0, 0)),
    "sort": (A.SORT, SV(1, 0, 0)), "sort_v1_1": (A.SORT, SV(1, 1, 0)),
    "trim_v1_1": (A.TRIM, SV(1, 1, 0)), "coil_v1_1": (A.COIL, SV(1, 1, 0)),
    "sort_v1_2": (A.SORT, SV(1, 2, 0)), "octo_v1_1": (A.OCTO, SV(1, 1, 0)),
    "cart": (A.CART, SV(1, 0, 0))}
TORCH_DELTAS = {"trim_deltas": (A.TRIM, SV(1, 0, 0)),
                "trim_v1_1_deltas": (A.TRIM, SV(1, 1, 0))}
ORDER_FREE = "sort_v1_2_orderfree"
NAMES = [*TORCH_DELTAS, *TORCH_ALGOS, ORDER_FREE]


def torch_reference_segment(algo, ver):
    """test_freeze.reference_segment with the port's types."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(12345)
    steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.uint64)
    uf = rng.uniform(1, 10, n).astype(np.float32)
    ui = (rng.integers(0, 1000, n) + 5_000_000).astype(np.uint64)

    def hd(code):
        return mt.FieldHeader(code, algo, ver, n)

    return mt.Seg(fields=[
        mt.Field(hd=hd(F.POSN), data=pos,
                 acc=mt.PositionAccuracy(delta=1e-3, width=W)),
        mt.Field(hd=hd(F.VELC), data=vel,
                 acc=mt.VelocityAccuracy(delta=0.25)),
        mt.Field(hd=hd(F.PTID), data=ids, acc=mt.IDAccuracy(width=512)),
        mt.Field(hd=hd(F.UNSF), data=uf, acc=mt.FloatAccuracy(delta=1e-3)),
        mt.Field(hd=hd(F.UNSI), data=ui, acc=mt.IntAccuracy()),
    ])


def torch_deltas_segment(algo, ver):
    """test_freeze.deltas_segment with the port's types."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(54321)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    uf = rng.uniform(1, 9, n).astype(np.float32)
    deltas = rng.choice(
        np.array([1e-1, 1e-2, 1e-3], dtype=np.float32), n)

    def hd(code):
        return mt.FieldHeader(code, algo, ver, n)

    return mt.Seg(fields=[
        mt.Field(hd=hd(F.POSN), data=pos,
                 acc=mt.PositionAccuracy(delta=0.0, width=W, deltas=deltas)),
        mt.Field(hd=hd(F.UNSF), data=uf,
                 acc=mt.FloatAccuracy(delta=0.0, deltas=deltas)),
    ])


def torch_order_free_segment():
    """test_freeze.current_digests' Sort v1.2.1 stream: one UNSI field of
    permuted values, with the port's types."""
    rng = np.random.default_rng(54321)
    n = 4096
    ui = (rng.permutation(1 << 18)[:n] + 3).astype(np.uint64)
    hd = mt.FieldHeader(F.UNSI, A.SORT, SV(1, 2, 1), n)
    return mt.Seg(fields=[mt.Field(hd=hd, data=ui, acc=mt.IntAccuracy())])


def frozen(name):
    """(segment, seed) behind fixture entry ``name``."""
    if name == ORDER_FREE:
        return torch_order_free_segment(), 777
    if name in TORCH_DELTAS:
        return torch_deltas_segment(*TORCH_DELTAS[name]), 888
    return torch_reference_segment(*TORCH_ALGOS[name]), 777


def _digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        h.update(np.ascontiguousarray(f.data.numpy()).tobytes())
    return h.hexdigest()


@pytest.fixture(scope="module")
def fixture_digests():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def blobs():
    return {name: mt.compress_segment(*frozen(name), device="cpu")
            for name in NAMES}


def test_names_cover_the_fixture(fixture_digests):
    keys = {f"{n}_{k}" for n in NAMES
            for k in ("encode_sha256", "decode_sha256", "bytes")}
    assert len(fixture_digests) == 42 and keys == set(fixture_digests)


def test_generators_match_the_freeze_test():
    """The port-typed generators give the freeze test's segments: same
    headers, accuracies and data bytes."""
    assert {k: (int(a), v) for k, (a, v) in TORCH_ALGOS.items()} == \
        {k: (int(a), v) for k, (a, v) in ALGOS.items()}
    assert {k: (int(a), v) for k, (a, v) in TORCH_DELTAS.items()} == \
        {k: (int(a), v) for k, (a, v) in DELTAS_ALGOS.items()}
    pairs = [(torch_reference_segment(*TORCH_ALGOS[k]),
              reference_segment(*ALGOS[k])) for k in ALGOS]
    pairs += [(torch_deltas_segment(*TORCH_DELTAS[k]),
               deltas_segment(*DELTAS_ALGOS[k])) for k in DELTAS_ALGOS]
    for mine, ref in pairs:
        ref = interop.seg_from_reference(ref)
        for a, b in zip(mine.fields, ref.fields):
            assert a.hd == b.hd
            assert type(a.acc) is type(b.acc)
            for k in vars(a.acc):
                assert np.array_equal(getattr(a.acc, k), getattr(b.acc, k))
            assert a.data.dtype == b.data.dtype
            assert a.data.tobytes() == b.data.tobytes()


@pytest.mark.parametrize("name", NAMES)
def test_encode_matches_fixture(name, blobs, fixture_digests):
    blob = blobs[name]
    assert hashlib.sha256(blob).hexdigest() == \
        fixture_digests[f"{name}_encode_sha256"]
    assert len(blob) == fixture_digests[f"{name}_bytes"]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_decode_matches_fixture(name, fused, blobs, fixture_digests):
    seg = mt.decompress_segment(blobs[name], fused=fused, device="cpu")
    assert all(isinstance(f.data, torch.Tensor) for f in seg.fields)
    assert _digest(seg) == fixture_digests[f"{name}_decode_sha256"]
