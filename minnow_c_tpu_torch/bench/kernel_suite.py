"""Kernel microbench suite, the counterpart of the JAX package's
``bench_kernels.py``: the reference's compress_util_bench.c workloads, one
for one, plus the batched rows kernels and the u32 prefix sum, on the
card.

Reference workloads (100 MB of f32 / u32 input each):
  minMaxBench            test/compress_util_bench.c:13-29
  periodic/undoPeriodic  compress_util_bench.c:31-76
  binIndex/undoBinIndex  compress_util_bench.c:78-150
  pack/unpack 8-bit aligned + 9-bit straddling
                         compress_util_bench.c:152-232
  (mock) fast compress / undo fast compress (level 11)
                         compress_util_bench.c:234-298

Each workload is one body ``fn(salt)`` timed by ``harness.run``: it salts
its input as the JAX body does, runs the port's op, and returns the max
reduction of its output (the next salt's source) with the output.  At a
given salt each body computes what its JAX body computes, bit for bit.
Throughput is GB/s of the workload's nominal input (N * 4 bytes; the rows
workloads' 64 x 3 rows of 2^17 f32), per card.  After all the timing,
each body is traced and its time an iteration held at no less than
``harness.FLOOR`` x its device time a call (``harness.check_floors``).
Writes the "meta" and "results" sections of a records file.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..ops import bitpack, fastpath, kernels, native
from ..ops import rng as _rng
from ..ops.decode_cuda import decode_cuda, decode_rows_cuda
from ..ops.encode_cuda import (encode_recip_fused_blocks_cuda,
                               encode_recip_rows_cuda, stats_rows_cuda)
from ..ops.scan_cuda import cumsum_u32_auto
from . import counts, harness
from . import records as _records

W = 64.0
N = 25_165_824        # ~100 MB of f32, bench_kernels.py's N
LEVEL = 11            # compress_util_bench.c:247
ROW_BLOCKS = 64       # the rows workloads: ROW_BLOCKS x 3 rows of ROW_N
ROW_N = 1 << 17
ROWS_DEPTH = 14       # the rows recip encodes' depth
ROWS_WIDTH = 16       # the rows decode's width
KEY = (7, 0, 0)       # field_key(seed, field, dim) of the dither workloads

NAMES = ("minmax", "periodic", "undo_periodic", "bin_index",
         "undo_bin_index", "pack_8bit", "unpack_8bit", "pack_9bit",
         "unpack_9bit", "fast_compress", "undo_fast_compress",
         "fused_decode_pallas", "rows_recip_encode",
         "rows_recip_encode_fused_1pass", "rows_fused_decode",
         "cumsum_u32_pallas")

SEMANTICS = (
    "one harness iteration = one body call: its salt launches (a full XOR "
    "pass over the input for the salted_f32 and pack / unpack bodies, an "
    "element-0 update for rows_fused_decode and cumsum_u32_pallas, a key "
    "XOR for the dither bodies), the op, and the max reduction of its "
    "output (a launch of its own, and for u32 outputs a sign-flip pass "
    "before it) from which the harness derives the next salt; XLA fuses "
    "the JAX bodies' salt and reduction into the op, torch runs each as a "
    "launch of its own.  fused_decode_pallas is K1, rows_fused_decode K2, "
    "rows_recip_encode K6 + K8 (the reciprocal on the card), "
    "rows_recip_encode_fused_1pass K12, cumsum_u32_pallas K9, the pack "
    "bodies and fast_compress K4; the rest are the port's torch ops, as "
    "the JAX package runs them in XLA.")

_I32_MIN = -(1 << 31)


def salted_f32(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Flip the mantissa LSB of every element by the salt's low bit
    (bench_kernels.py:109-121): perturbs values by <= 1 ulp."""
    return (x.view(torch.int32) ^ (s & 1)).view(torch.float32)


def u32_red(a: torch.Tensor) -> torch.Tensor:
    """The largest u32 value of ``a`` (int32 bits), as int32 bits: the
    order goes through the sign-flipped bits."""
    return (a ^ _I32_MIN).amax() ^ _I32_MIN


def f32_red(a: torch.Tensor) -> torch.Tensor:
    """The bits of the largest f32 value of ``a``."""
    return a.amax().view(torch.int32)


def salted_at0(buf: torch.Tensor, base: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """``base`` with its first element XOR the salt, written into the
    working copy ``buf`` (one element update; the JAX bodies'
    ``where(iota == 0, x ^ s, x)``)."""
    buf.view(-1)[0] = base.view(-1)[0] ^ s
    return buf


def _host_u32(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        a.astype(np.uint32)).view(np.int32)).to(dev)


def make_inputs(device="cuda", n: int = N, row_blocks: int = ROW_BLOCKS,
                row_n: int = ROW_N) -> dict:
    """The suite's inputs on ``device``, from numpy seed 0 in
    bench_kernels.py's order: the plane ``x``, the level-11 ``bins`` and
    their 8-, 9- and 11-bit packs, then the rows workloads' ``xrows``,
    dither keys ``rkeys`` and 16-bit words ``wrows``."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, W, n).astype(np.float32)
    bins = rng.integers(0, 1 << LEVEL, n, dtype=np.uint64).astype(np.uint32)
    inp = {"x": torch.from_numpy(x).to(dev), "bins": _host_u32(bins, dev),
           "n": n, "row_blocks": row_blocks, "row_n": row_n}
    for width, mask in ((8, 0xFF), (9, 0x1FF), (LEVEL, None)):
        b = bins if mask is None else bins & np.uint32(mask)
        inp[f"packed{width}"] = _host_u32(
            native.uniform_pack_host(b, width), dev)
    rows = row_blocks * 3
    inp["xrows"] = torch.from_numpy(
        rng.uniform(0, W, (rows, row_n)).astype(np.float32)).to(dev)
    inp["rkeys"] = torch.from_numpy(rng.integers(
        0, 1 << 32, (rows, 2), dtype=np.int64)).to(dev)
    inp["wrows"] = _host_u32(rng.integers(
        0, 1 << 32, (rows, row_n * ROWS_WIDTH // 32), dtype=np.int64), dev)
    return inp


def workloads(inp: dict) -> dict:
    """Name -> (body fn(salt) -> (reduction, output), nominal bytes a
    call), in bench_kernels.py's order."""
    x, bins = inp["x"], inp["bins"]
    n, dev = inp["n"], x.device
    key = torch.tensor(_rng.field_key(*KEY), dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)
    box = torch.full((1,), W, dtype=torch.float32, device=dev)
    nbytes = n * 4
    out = {}

    def add(name, body, size=nbytes):
        out[name] = (body, size)

    def minmax(s):
        o = torch.stack(kernels.minmax(salted_f32(x, s)))
        return f32_red(o), o
    add("minmax", minmax)

    def periodic(s):
        o = kernels.periodic(salted_f32(x, s), W)
        return f32_red(o), o
    add("periodic", periodic)

    def undo_periodic(s):
        o = kernels.undo_periodic(salted_f32(x, s), W)
        return f32_red(o), o
    add("undo_periodic", undo_periodic)

    def bin_index(s):
        o = kernels.uniform_bin_index(salted_f32(x, s), LEVEL, 0.0, W)
        return u32_red(o), o
    add("bin_index", bin_index)

    def undo_bin_index(s):
        o = kernels.undo_uniform_bin_index(bins ^ (s & 0x3FF), LEVEL, 0.0,
                                           W, key ^ s)
        return f32_red(o), o
    add("undo_bin_index", undo_bin_index)

    for width in (8, 9):
        packed = inp[f"packed{width}"]

        def pack(s, width=width):
            o = bitpack.uniform_pack(
                (bins ^ (s & 0xFF)) & ((1 << width) - 1), width)
            return u32_red(o), o
        add(f"pack_{width}bit", pack)

        def unpack(s, width=width, packed=packed):
            o = bitpack.uniform_unpack(packed ^ s, width, n)
            return u32_red(o), o
        add(f"unpack_{width}bit", unpack)

    def fast_compress(s):
        o = fastpath.fast_uniform_encode(salted_f32(x, s), LEVEL,
                                         periodic_width=W)[0]
        return u32_red(o), o
    add("fast_compress", fast_compress)

    packed11 = inp[f"packed{LEVEL}"]

    def undo_fast_compress(s):
        o = fastpath.fast_uniform_decode(packed11 ^ s, key ^ s, LEVEL, n,
                                         0.0, W, periodic_width=W)
        return f32_red(o), o
    add("undo_fast_compress", undo_fast_compress)

    def fused_decode(s):
        o = decode_cuda(packed11, key ^ s, LEVEL, n, zero, box, W,
                        periodic=True)
        return f32_red(o), o
    add("fused_decode_pallas", fused_decode)

    # the batched rows kernels: ROW_BLOCKS x 3 rows of ROW_N
    xrows, rkeys, wrows = inp["xrows"], inp["rkeys"], inp["wrows"]
    rb, row_n = inp["row_blocks"], inp["row_n"]
    rows = rb * 3
    rows_bytes = rows * row_n * 4
    boxes = torch.full((rows,), W, dtype=torch.float32, device=dev)

    def rows_recip_encode(s):
        xs = salted_f32(xrows, s)
        anchor = xs[:, 0].contiguous()
        mn, mx = stats_rows_cuda(xs, boxes, anchor, True)
        rng_r = kernels.ftz(mx - mn).reshape(rb, 3).amax(dim=1)
        recip = kernels.ftz(torch.ones_like(rng_r) / kernels.ftz(rng_r))
        o = encode_recip_rows_cuda(xs, ROWS_DEPTH, mn,
                                   recip.repeat_interleave(3), boxes,
                                   anchor, True)
        return u32_red(o[0]), o
    add("rows_recip_encode", rows_recip_encode, rows_bytes)

    def rows_recip_encode_fused(s):
        xb = salted_f32(xrows, s).reshape(rb, 3, row_n)
        o = encode_recip_fused_blocks_cuda(
            xb, W, xb[:, :, 0].contiguous(), ROWS_DEPTH, True)[0]
        return u32_red(o[0]), o
    add("rows_recip_encode_fused_1pass", rows_recip_encode_fused, rows_bytes)

    wbuf = wrows.clone()
    rx0 = torch.zeros(rows, dtype=torch.float32, device=dev)
    rdx = torch.full((rows,), W, dtype=torch.float32, device=dev)

    def rows_fused_decode(s):
        o = decode_rows_cuda(salted_at0(wbuf, wrows, s), rkeys, ROWS_WIDTH,
                             row_n, rx0, rdx, box=W, periodic=True)
        return f32_red(o), o
    add("rows_fused_decode", rows_fused_decode, rows_bytes)

    vbuf = bins.clone()

    def cumsum(s):
        o = cumsum_u32_auto(salted_at0(vbuf, bins, s))
        return u32_red(o), o
    add("cumsum_u32_pallas", cumsum)
    return out


def run(device="cuda", names=None, records: str = None, n: int = N,
        row_blocks: int = ROW_BLOCKS, row_n: int = ROW_N,
        target_trial_s: float = harness.TARGET_TRIAL_S,
        max_total_s: float = harness.MAX_TOTAL_S) -> dict:
    """Time the named workloads (all by default) on ``device``; print one
    line each and write the records' "meta" and "results" sections.
    Returns {"meta": ..., "results": {name: GB/s}}."""
    names = list(NAMES if not names else names)
    unknown = sorted(set(names) - set(NAMES))
    if unknown:
        raise ValueError(f"unknown kernel workloads {unknown}")
    t_suite = time.perf_counter()
    inp = make_inputs(device, n, row_blocks, row_n)
    bodies = workloads(inp)
    results, per_iter, launches, timed = {}, {}, {}, {}
    for name in names:
        fn, nbytes = bodies[name]
        counts.reset()
        res = harness.run(fn, nbytes, target_trial_s, max_total_s, device)
        launches[name] = counts.read()
        results[name] = res.gb_per_second
        per_iter[name] = res.trial_seconds / res.iterations * 1e3
        timed[name] = (fn, per_iter[name])
        print(f"{name:30s} {res.gb_per_second:9.3f} GB/s "
              f"{per_iter[name]:9.4f} ms/iter  launches {launches[name]}",
              flush=True)
    dev_ms = harness.check_floors(timed, device)
    for name, ms in dev_ms.items():
        print(f"{name:30s} device {ms:.4f} ms a call (torch.profiler)",
              flush=True)
    out = {
        "meta": {
            "unit": "GB/s of the nominal input per card (n_elems * 4 "
                    "bytes; rows workloads rows * row_n * 4)",
            "device": harness.describe_device(device),
            "n_elems": n, "level": LEVEL,
            "rows": [row_blocks * 3, row_n], "rows_depth": ROWS_DEPTH,
            "rows_width": ROWS_WIDTH,
            "target_trial_s": target_trial_s, "max_total_s": max_total_s,
            "semantics": SEMANTICS,
            "host_reads": "none per call in these bodies (fast_compress "
                          "is the div map; the recip map's host reads "
                          "are matrix config2's)",
            "ms_per_iter": per_iter, "device_ms": dev_ms,
            "launches": launches,
            "suite_s": time.perf_counter() - t_suite,
            "timestamp": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                       time.gmtime()),
        },
        "results": results,
    }
    if records is not None:
        _records.update_sections(records, out)
    return out
