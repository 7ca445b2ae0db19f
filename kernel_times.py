"""Times the rows stats (K6), the rows unpack (K3), the recip-mode pack
kernels (K5, K8, K12), the u32 scan (K9) and the chunked decode (K10, with
its float mode K11) of one tree of the torch port on one CUDA card, each
beside the kernel or library call it is held to, under two warm-ups.

    python3 kernel_times.py [--tree DIR] [--rounds N]

``--tree`` is a checkout whose ``minnow_c_tpu_torch`` is imported (default:
the one beside this script); its kernels are built there from its own
``csrc/``.  Comparing two versions of the code means running this script
once for each tree, in one session on one card, in turns (a, b, b, a).

The inputs are made on the card from fixed seeds, at the shapes of
chip_smoke.py's kernels line:

* K6: 192 rows of 2^21 positions (box 64, periodic), and
  ``torch.aminmax(rows, dim=1)`` on them (the nearest library call: no
  unwrap); ``K6 vel``: 192 rows of N(0, 300) velocities, not periodic;
* K3: 64 rows of 2^21 bins packed at 9 bits (the snapshot's ID rows), and
  at 1, 17 and 32 bits (``K3 w<width>``);
* K9: 2^24 u32 values, and ``torch.cumsum(x, 0, dtype=torch.int32)``;
* K8: the 192 position rows (each row's x0 and exact recip from its
  unwrapped range) at 16 bits, and K7 packing the same bins;
* K5: one plane of 2^24 positions at 16 bits, and K4 packing the same bins;
* K12: the same positions as (64, 3, 2^21) blocks at 16 bits;
* K10 and K11 (``K10 A``, ``K11 A``): a chunked plane of 1024 chunks of
  16384 at 17 bits (chip_smoke.py's Coil v1.1 position plane), with
  un-zigzag and prefix, K11 at depth 17, periodic; ``K10 B``, ``K11 B``:
  8192 chunks at 17 bits (one field plane of a 512^3 snapshot in one
  segment); ``K10 w<width>``: 1024 chunks at 1, 9, 24 and 32 bits.  The
  bodies are random words (any word is a valid body), each call checked
  bitwise against its plain version first.

Each time is chip_smoke.py's: CUDA events around one call, median of 5,
after a warm-up.  The warm-up is either one call (``one_call``) or calls
until 20 ms have passed (``20ms``); before each ``one_call`` timing the
card idles 0.2 s, as it does between the host-bound phases of a path.
Every round times each kernel both ways; the rounds' medians are listed.
No torch.profiler trace runs before the last event time.  Then one trace
per call gives its device time: for K9 its kernel, the memset before it
where the tree has one, and torch.cumsum's kernels; for K3, K6, K6 vel,
torch.aminmax, K12, K10 and K11 all the card's activity in the call
(kernels, memsets, the table's copies).  Last, the host time per call of
the K3, K6, K9 and K10 wrappers (K10: one chunk of 16384 at 17 bits) and
of torch.aminmax and torch.cumsum, on 32 elements (``host_us``): the host
work that a single call's event time holds besides its device time.
``bound_ms``: the K10 and K11 calls' bytes (the body read once, the table
once, the output written once) over 3.35 TB/s.

Prints the card's name and power limit, then one JSON object.  Needs a
CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

BOX = 64.0
ROWS, ROW_N = 192, 1 << 21
PLANE_N = 1 << 24
WIDTH = 16
ID_WIDTH = 9                    # the snapshot's ID rows
ID_WIDTHS = (1, ID_WIDTH, 17, 32)
CHUNK = 16384
CHUNKS_A, CHUNKS_B = 1024, 8192
DELTA_WIDTH = 17                # chip_smoke.py's Coil v1.1 position plane
DELTA_WIDTHS = (1, 9, 24, 32)
PEAK_BYTES_S = 3.35e12


def event_ms(fn, warm_s: float, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` calls, after calls
    that last ``warm_s`` seconds (one call at least)."""
    t = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t >= warm_s:
            break
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, names=("",), calls: int = 5) -> dict:
    """Device time per call of the card's activity (kernels, memsets)
    whose name holds each of ``names`` (the default: all of it), in one
    torch.profiler trace of ``calls`` calls (None where the trace holds
    none), and the names of the activities counted."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in names:
        hits = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and name in e.key]
        total = sum(e.device_time_total for e in hits)
        out[name] = total / calls / 1e3 if total > 0 else None
        out[name + " counted"] = sorted(e.key[:80] for e in hits)
    return out


def host_us(fn, calls: int = 2000) -> float:
    """Host time per call of ``fn`` in microseconds: ``calls`` calls in a
    row, then one synchronize, on inputs so small that the card never
    holds the host back."""
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / calls * 1e6


def tiny_calls(dev):
    """The K3, K6 and K9 wrappers and their library calls on 32 elements
    (one row), and the K10 wrapper on one chunk, for ``host_us``."""
    from minnow_c_tpu_torch.ops import (decode_cuda, encode_cuda, kernels,
                                        scan_cuda)
    x = torch.rand(1, 32, device=dev)
    box, anchor = torch.full((1,), BOX, device=dev), x[:, 0].contiguous()
    words = encode_cuda.pack_rows_cuda(kernels.i64_to_u32(torch.zeros(
        1, 32, dtype=torch.int64, device=dev)), ID_WIDTH)
    u = torch.zeros(32, dtype=torch.int32, device=dev)
    from minnow_c_tpu_torch.ops import chunked_cuda
    body, widths = chunked_body(1, DELTA_WIDTH, dev)
    return {
        "K10": lambda: chunked_cuda.decode_chunked_stream(body, widths, 7,
                                                          CHUNK, CHUNK),
        "K6": lambda: encode_cuda.stats_rows_cuda(x, box, anchor, True),
        "K6 library": lambda: torch.aminmax(x, dim=1),
        "K3": lambda: decode_cuda.unpack_rows_cuda(words, ID_WIDTH, 32),
        "K9": lambda: scan_cuda.cumsum_u32(u),
        "K9 library": lambda: torch.cumsum(u, 0, dtype=torch.int32),
    }


def chunked_body(chunks: int, width: int, dev, seed: int = 5):
    """Random packed words of ``chunks`` chunks at ``width`` bits on the
    card, and the host width table."""
    g = torch.Generator(device=dev).manual_seed(seed + width)
    words = torch.randint(-(1 << 31), 1 << 31, (chunks * CHUNK // 32 * width,),
                          generator=g, device=dev, dtype=torch.int64)
    return words.to(torch.int32), np.full(chunks, width, np.uint8)


def chunked_calls(dev) -> tuple:
    """The K10 / K11 calls by name, each checked bitwise against its plain
    version, and their bounds in ms."""
    from minnow_c_tpu_torch.ops import chunked_cuda
    calls, plains, bounds = {}, {}, {}

    def add(name, chunks, width, floats):
        body, widths = chunked_body(chunks, width, dev)
        n = chunks * CHUNK
        if floats:
            args = (body, widths, 12345, CHUNK, n, (0x9E3779B9, 77),
                    DELTA_WIDTH, -2.0, 68.0, BOX, True)
            calls[name] = lambda: chunked_cuda.decode_chunked_stream_floats(
                *args)
            plains[name] = lambda: \
                chunked_cuda.decode_chunked_stream_floats_plain(*args)
        else:
            calls[name] = lambda: chunked_cuda.decode_chunked_stream(
                body, widths, 12345, CHUNK, n)
            plains[name] = lambda: chunked_cuda.decode_chunked_stream_plain(
                body, widths, 12345, CHUNK, n)
        nbytes = body.numel() * 4 + widths.nbytes + n * 4
        bounds[name] = nbytes / PEAK_BYTES_S * 1e3

    for label, chunks in (("A", CHUNKS_A), ("B", CHUNKS_B)):
        add(f"K10 {label}", chunks, DELTA_WIDTH, False)
        add(f"K11 {label}", chunks, DELTA_WIDTH, True)
    for width in DELTA_WIDTHS:
        add(f"K10 w{width}", CHUNKS_A, width, False)
    for name in calls:
        got, want = calls[name](), plains[name]()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"{name} != its plain version")
        del got, want
    return calls, bounds


def inputs(dev):
    """The kernels' inputs and the calls to time, by name."""
    from minnow_c_tpu_torch.ops import (decode_cuda, encode_cuda, kernels,
                                        scan_cuda)
    g = torch.Generator(device=dev).manual_seed(42)
    deltas = torch.randint(-(1 << 31), 1 << 31, (PLANE_N,), generator=g,
                           device=dev, dtype=torch.int64).to(torch.int32)
    rows = torch.rand(ROWS, ROW_N, generator=g, device=dev) * BOX
    anchors = rows[:, 0].contiguous()
    x0, x1 = kernels.minmax(kernels.undo_periodic(rows, BOX))
    recip = torch.from_numpy(kernels.exact_recip(
        kernels.ftz(x1 - x0).cpu().numpy())).to(dev)
    box = torch.full((ROWS,), BOX, device=dev)
    k8 = (WIDTH, x0, recip, box, anchors, True)
    bins8 = kernels.recip_scaled_bins(rows, x0[:, None], recip[:, None],
                                      box[:, None], anchors[:, None], WIDTH,
                                      True)
    plane = rows[:PLANE_N // ROW_N].reshape(-1)
    u0, u1 = kernels.minmax(kernels.undo_periodic(plane, BOX))
    k5 = (WIDTH, u0.item(), float(kernels.exact_recip((u1 - u0).item())),
          BOX, plane[0].item(), True)
    bins5 = kernels.recip_scaled_bins(plane, *k5[1:5], WIDTH, True)
    blocks = rows.reshape(ROWS // 3, 3, ROW_N)
    k12 = (BOX, anchors.reshape(ROWS // 3, 3), WIDTH, True)
    vel = 300.0 * torch.randn(ROWS, ROW_N, generator=g, device=dev)
    vel_anchors = vel[:, 0].contiguous()
    unpack = {}
    for width in ID_WIDTHS:
        bins = torch.randint(0, 1 << width, (ROWS // 3, ROW_N), generator=g,
                             device=dev, dtype=torch.int64)
        unpack[width] = encode_cuda.pack_rows_cuda(kernels.i64_to_u32(bins),
                                                   width)
    calls = {
        "K6": lambda: encode_cuda.stats_rows_cuda(rows, box, anchors, True),
        "K6 vel": lambda: encode_cuda.stats_rows_cuda(vel, box, vel_anchors,
                                                      False),
        "K6 library": lambda: torch.aminmax(rows, dim=1),
        **{("K3" if w == ID_WIDTH else f"K3 w{w}"):
           (lambda w=w: decode_cuda.unpack_rows_cuda(unpack[w], w, ROW_N))
           for w in ID_WIDTHS},
        "K9": lambda: scan_cuda.cumsum_u32(deltas),
        "K9 library": lambda: torch.cumsum(deltas, 0, dtype=torch.int32),
        "K8": lambda: encode_cuda.encode_recip_rows_cuda(rows, *k8),
        "K8 K7": lambda: encode_cuda.pack_rows_cuda(bins8, WIDTH),
        "K5": lambda: encode_cuda.encode_recip_cuda(plane, *k5),
        "K5 K4": lambda: encode_cuda.pack_cuda(bins5, WIDTH),
        "K12": lambda: encode_cuda.encode_recip_fused_blocks_cuda(blocks,
                                                                  *k12),
    }
    # each kernel packs the same words as the kernel beside it
    for a, b in (("K8", "K8 K7"), ("K5", "K5 K4")):
        if not torch.equal(calls[a](), calls[b]()):
            raise AssertionError(f"{a} != {b} on the same input")
    # and K6, K3 equal their plain versions
    for name, plain in (
            ("K6", lambda: encode_cuda.stats_rows_plain(rows, box, anchors,
                                                        True)),
            ("K6 vel", lambda: encode_cuda.stats_rows_plain(
                vel, box, vel_anchors, False)),
            ("K3", lambda: decode_cuda.unpack_rows_plain(
                unpack[ID_WIDTH], ID_WIDTH, ROW_N))):
        got, want = calls[name](), plain()
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(got, want)):
            raise AssertionError(f"{name} != its plain version")
        del got, want
    return calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(
        os.path.abspath(__file__)))
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA card", file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from minnow_c_tpu_torch.ops import cuda_lib
    if not cuda_lib.__file__.startswith(tree):
        raise RuntimeError(f"imported {cuda_lib.__file__}, not from {tree}")
    t = time.perf_counter()
    cuda_lib.lib()
    build_s = time.perf_counter() - t
    dev = torch.device("cuda")
    calls = inputs(dev)
    delta_calls, bounds = chunked_calls(dev)
    calls.update(delta_calls)
    rounds = {"one_call": {k: [] for k in calls},
              "20ms": {k: [] for k in calls}}
    for _ in range(args.rounds):
        for name, fn in calls.items():
            time.sleep(0.2)
            rounds["one_call"][name].append(event_ms(fn, 0.0))
            rounds["20ms"][name].append(event_ms(fn, 0.02))
    dev_ms = device_ms(calls["K9"], ("scan_kernel", "Memset"))
    dev_ms.update(device_ms(calls["K9 library"], ("Scan",)))
    device = {"K9": dev_ms}
    for name in ("K3", "K6", "K6 vel", "K6 library", "K12", *delta_calls):
        device[name] = device_ms(calls[name])
    host = {k: host_us(fn) for k, fn in tiny_calls(dev).items()}
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    print(json.dumps({"tree": tree, "build_s": round(build_s, 1),
                      "rounds": args.rounds, "ms": rounds,
                      "device_ms": device, "host_us": host,
                      "bound_ms": bounds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
