"""The port's CUDA kernels and its segment path on a CUDA card.

Marked ``cuda``; every test skips without a card.  This file imports no
JAX, so it also runs where JAX is missing:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

Tolerance: bitwise equality throughout -- kernel against its plain torch
version on the card, and CUDA against CPU for whole segments.
"""

import numpy as np
import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("n", [1, 33, 100_003])
@pytest.mark.parametrize("width", [1, 9, 24])
def test_decode_kernel_matches_plain(dev, width, n, periodic):
    g = torch.Generator(device=dev).manual_seed(width * 1000 + n)
    bins = torch.randint(0, 1 << width, (n,), generator=g, device=dev,
                         dtype=torch.int32)
    words = encode_cuda.pack_plain(bins, width)
    x0, dx = (-2.0, 68.0) if periodic else (1.5, 32.0)
    got = decode_cuda.decode_cuda(words, (5, 6), width, n, x0, dx, 64.0,
                                  periodic, elem0=8)
    want = decode_cuda.decode_plain(
        words, 5, 6, x0, np.float32(dx) / np.float32(2.0 ** width), 64.0, n,
        width, 8, periodic)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("n", [1, 31, 100_003])
@pytest.mark.parametrize("width, from_f32", [
    (1, False), (5, False), (24, False), (32, False),
    (1, True), (5, True), (24, True)])
def test_pack_kernel_matches_plain(dev, width, from_f32, n):
    g = torch.Generator(device=dev).manual_seed(width * 1000 + n)
    if from_f32:
        vals = torch.randn(n, generator=g, device=dev) * (1 << width)
        vals[::7] = float("nan")
    else:
        vals = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
    got = encode_cuda.pack_cuda(vals, width, from_f32=from_f32)
    assert torch.equal(got, encode_cuda.pack_plain(vals, width,
                                                   from_f32=from_f32))


def _segment(device):
    n, W = 5000, 64.0
    rng = np.random.default_rng(9)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    vel = rng.normal(0, 50, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 15)[:n].astype(np.int64)
    uf = rng.uniform(0, 3, n).astype(np.float32)
    v = mt.semver.pack(1, 0, 0)
    F = mt.FieldCode

    def field(code, data, acc):
        hd = mt.FieldHeader(code, mt.AlgoCode.TRIM, v, n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(device),
                        acc=acc)

    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=1e-4, width=W)),
        field(F.VELC, vel, mt.VelocityAccuracy(delta=0.1)),
        field(F.PTID, ids, mt.IDAccuracy(width=32)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=1e-5)),
    ])


@pytest.mark.parametrize("fused", [False, True])
def test_segment_on_cuda_matches_cpu(dev, fused):
    blob = mt.compress_segment(_segment(dev), seed=3)
    assert blob == mt.compress_segment(_segment("cpu"), seed=3)
    got = mt.decompress_segment(blob, fused=fused, device=dev)
    want = mt.decompress_segment(blob, fused=fused)
    for a, b in zip(got.fields, want.fields):
        assert a.data.is_cuda
        assert np.array_equal(a.data.cpu().numpy().view(np.uint8),
                              b.data.numpy().view(np.uint8))
