"""Per-codec encode / decode throughput, the counterpart of the JAX
package's ``bench_codecs.py``: the six codecs at their newest versions on
25,165,824 POSN values (~100 MB), coherent and random inputs.

``main`` times the warm end-to-end wall through the public segment API
(``compress_segment`` / ``decompress_segment(fused=True)``): device
kernels, host orchestration, LZ4 and (de)serialization, what a user gets
per segment; median of ``REPS``.  The decoded output stays on the card;
a small data-dependent read bounds the decode.

``device_decode_rates`` times the delta family's device phases alone
through the harness, words staged on the card and element 0 of each body
salted: Diff's K3 unpack, un-zigzag, K9 prefix sum and torch dither tail;
Coil v1.1's K10 (bins) and K11 (floats); Sort v1.2's order-free K10
stream and its ranked profile (two K10 streams and the un-permute
gather; its rank stream unsalted, so that every rank stays in the
plane).  Decoded values are not meaningful once salted (the width tables
stay), but every call is real dependent work.  Each phase's time an
iteration is held at no less than ``harness.FLOOR`` x its device time a
call, traced after all of them (``harness.check_floors``).

Both write the "codecs" section of a records file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import semver
from ..algos import chunked
from ..algos.algo_coil_v1_0 import delta_zigzag_first
from ..algos.algo_coil_v1_1 import KERNEL_CHUNK
from ..algos.algo_diff_v1_0 import diff_plane_device
from ..algos.algo_sort_v1_0 import ranks_of, sort_plane, unpermute
from ..ops import bitpack, chunked_cuda, kernels
from ..ops import rng as _rng
from ..segment import api
from ..types import (AlgoCode, Field, FieldCode, FieldHeader,
                     PositionAccuracy, Seg)
from . import counts, harness
from . import records as _records
from .kernel_suite import salted_at0

N = 25_165_824  # 3 x 8,388,608 values = 100.66 MB f32
W = 64.0
DELTA = 1e-3
REPS = 3
DEVICE_DEPTH = 14   # device_decode_rates' bins

ALGOS = (
    ("trim", AlgoCode.TRIM, semver.pack(1, 0, 0)),
    ("diff", AlgoCode.DIFF, semver.pack(1, 0, 0)),
    ("coil", AlgoCode.COIL, semver.pack(1, 1, 0)),
    ("octo", AlgoCode.OCTO, semver.pack(1, 1, 0)),
    ("sort", AlgoCode.SORT, semver.pack(1, 2, 0)),
    ("cart", AlgoCode.CART, semver.pack(1, 0, 0)),
)


def make_inputs(n: int = N) -> dict:
    """bench_codecs.py's planes (numpy seed 7): a coherent random walk
    wrapped into the box and uniform random positions, (3, n // 3) f32."""
    m = n // 3
    rng = np.random.default_rng(7)
    steps = rng.normal(0, 0.003, (3, m)).astype(np.float32)
    coherent = ((np.cumsum(steps, axis=1) + W / 2) % W).astype(np.float32)
    random = rng.uniform(0, W, (3, m)).astype(np.float32)
    return {"coherent": coherent, "random": random}


def _barrier(seg: Seg) -> None:
    """A tiny data-dependent read that bounds the decode's device work."""
    seg.fields[0].data[..., :1].cpu()


def _median(fn) -> float:
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def main(device="cuda", names=None, records: str = None,
         n: int = N) -> dict:
    """End-to-end encode / decode of the named codecs (all by default) on
    both inputs; prints a line each, writes ``codecs.meta`` and
    ``codecs.results``.  Returns the results."""
    names = [a[0] for a in ALGOS] if not names else list(names)
    algos = [a for a in ALGOS if a[0] in names]
    if len(algos) != len(names):
        raise ValueError(f"unknown codecs in {names}")
    dev = torch.device(device)
    t_suite = time.perf_counter()
    inputs = make_inputs(n)
    results = {}
    for name, algo, ver in algos:
        for kind, pos in inputs.items():
            raw = pos.nbytes
            seg = Seg(fields=[Field(
                hd=FieldHeader(FieldCode.POSN, algo, ver, pos.shape[1]),
                data=torch.from_numpy(pos).to(dev),
                acc=PositionAccuracy(delta=DELTA, width=W))])
            counts.reset()
            t0 = time.perf_counter()
            blob = api.compress_segment(seg, seed=3, device=dev)
            warm_enc = time.perf_counter() - t0
            t0 = time.perf_counter()
            _barrier(api.decompress_segment(blob, fused=True, device=dev))
            warm_dec = time.perf_counter() - t0
            launches = counts.read()
            enc = _median(lambda: api.compress_segment(seg, seed=3,
                                                       device=dev))
            dec = _median(lambda: _barrier(api.decompress_segment(
                blob, fused=True, device=dev)))
            results[f"{name}_{kind}"] = {
                "encode_s": enc, "decode_s": dec,
                "encode_GBps": raw / enc / 1e9,
                "decode_GBps": raw / dec / 1e9,
                "ratio": len(blob) / raw, "warm_enc_s": warm_enc,
                "warm_dec_s": warm_dec, "launches": launches}
            print(f"{name:>5} {kind:>8}: enc {raw / enc / 1e9:7.3f} GB/s  "
                  f"dec {raw / dec / 1e9:7.3f} GB/s  ratio "
                  f"{len(blob) / raw:.4f}  launches {launches}", flush=True)
    meta = {"workload": f"POSN field, {n} f32 values, delta={DELTA}, warm "
                        "end-to-end wall via compress_segment / "
                        "decompress_segment(fused=True), host LZ4 and "
                        "(de)serialization included, median of "
                        f"{REPS}; decoded output on the device",
            "device": harness.describe_device(device),
            "launches": "each codec's one warm encode + fused decode",
            "suite_s": time.perf_counter() - t_suite,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
    if records is not None:
        _update(records, {"meta": meta, "results": results})
    return results


def _update(path: str, part: dict) -> None:
    codecs = _records.load(path).get("codecs", {})
    codecs.update(part)
    _records.update_sections(path, {"codecs": codecs})


def _staged(z: torch.Tensor, dev):
    """A u32 stream chunked at the kernels' 16384 elements: (column-major
    body on ``dev``, width table)."""
    widths, body = chunked.pack_cmajor(z, KERNEL_CHUNK)
    return (torch.from_numpy(np.ascontiguousarray(
        body, dtype=np.uint32).view(np.int32)).to(dev), widths)


def device_decode_rates(device="cuda", records: str = None, n: int = N,
                        target_trial_s: float = harness.TARGET_TRIAL_S,
                        max_total_s: float = harness.MAX_TOTAL_S) -> dict:
    """The delta family's device decode phases in GB/s of decoded 4-byte
    values (n a call), each with its launches; writes
    ``codecs.device_decode``."""
    dev = torch.device(device)
    rng = np.random.default_rng(3)
    walk = np.cumsum(rng.integers(-40, 41, n), dtype=np.int64)
    walk -= walk.min()
    bins_np = (walk % (1 << DEVICE_DEPTH)).astype(np.uint32)
    bins = torch.from_numpy(bins_np.view(np.int32)).to(dev)
    key = _rng.field_key(7, 0, 0)
    out, bodies = {}, {}

    def timed(name, fn):
        counts.reset()
        r = harness.run(fn, n * 4, target_trial_s, max_total_s, device)
        out[name + "_GBps"] = r.gb_per_second
        out[name + "_launches"] = counts.read()
        out[name + "_ms_per_iter"] = r.trial_seconds / r.iterations * 1e3
        bodies[name] = (fn, out[name + "_ms_per_iter"])
        print(f"{name}: {r.gb_per_second:.3f} GB/s  launches "
              f"{out[name + '_launches']}", flush=True)

    # Diff: K3 unpack of the zigzag deltas, un-zigzag, K9, dither tail
    z = kernels.u32_delta_zigzag(bins)[1:]
    width = max(1, int(kernels.u32_to_i64(z).max()).bit_length())
    first = int(bins_np[0])
    dwords = bitpack.uniform_pack(z, width)
    dbuf = dwords.clone()
    timed("diff_device_decode", lambda s: diff_plane_device(
        salted_at0(dbuf, dwords, s), first, key, n, DEVICE_DEPTH, 0.0, W,
        W, True, width))

    # Coil v1.1: K10 (bins), K11 (floats)
    cfirst, cz = delta_zigzag_first(bins)
    body, widths = _staged(cz, dev)
    cbuf = body.clone()
    timed("coil_device_decode", lambda s: chunked_cuda.decode_chunked_stream(
        salted_at0(cbuf, body, s), widths, cfirst, KERNEL_CHUNK, n))
    timed("coil_device_decode_floats",
          lambda s: chunked_cuda.decode_chunked_stream_floats(
              salted_at0(cbuf, body, s), widths, cfirst, KERNEL_CHUNK, n,
              key, DEVICE_DEPTH, 0.0, W, W, True))

    # Sort v1.2: the order-free stream of sorted deltas (K10 without the
    # un-zigzag), and the ranked profile (two K10 streams and the gather)
    order, sfirst, deltas = sort_plane(bins)
    sbody, swidths = _staged(deltas, dev)
    sbuf = sbody.clone()

    def sorted_stream(s):
        return chunked_cuda.decode_chunked_stream(
            salted_at0(sbuf, sbody, s), swidths, sfirst, KERNEL_CHUNK, n,
            zigzag=False)
    timed("sort_orderfree_device_decode", sorted_stream)
    rfirst, rz = delta_zigzag_first(ranks_of(order))
    rbody, rwidths = _staged(rz, dev)

    def ranked(s):
        # the rank stream stays unsalted: a salted rank would index past
        # the plane (XLA's gather clamps; torch's raises)
        ranks = chunked_cuda.decode_chunked_stream(
            rbody, rwidths, rfirst, KERNEL_CHUNK, n)
        return unpermute(sorted_stream(s), ranks)
    timed("sort_device_decode", ranked)
    for name, ms in harness.check_floors(bodies, device).items():
        out[name + "_device_ms"] = ms
        print(f"{name}: device {ms:.4f} ms a call (torch.profiler)",
              flush=True)
    if records is not None:
        _update(records, {"device_decode": {
            **out, "device": harness.describe_device(device), "n_elems": n,
            "depth": DEVICE_DEPTH,
            "unit": "GB/s of decoded 4-byte values per card",
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime())}})
    return out

