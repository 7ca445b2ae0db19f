#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (minnow_c_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the CUDA toolkit) and the repository checkout;
imports nothing of JAX.  Phases, one progress line each; any failure raises
and the script exits non-zero:

1. device: card name, power limit, kernel build time; the registers and
   spills of the tile kernels (K1 / K2 decode and K3 unpack, K4 / K7 pack,
   K5 / K8 recip pack, K12, K9 scan), of K6 stats and of K10 / K11 (with
   their blocks resident an SM), and the SASS instructions of the tile
   kernels' inner loops;
2. each CUDA kernel (K1 fused decode, K4 pack, the rows kernels K2
   decode, K3 unpack, K6 stats, K7 pack, the delta kernels K9 scan, K10
   chunked decode, K11 its float mode, and the recip-mode encodes K5, K8 and
   K12) against its plain torch version on the card, bitwise, over widths
   (K1 and K2 at every width 1-24, K3 at every width 1-32, K4 and K7 at
   every width 0-32), row counts, rows that cross tile edges, ragged sizes,
   unaligned inputs and edge values, subnormals included (they flush to
   zeros of their sign, as on XLA); K6 across its slices and 16-byte edges
   (odd n, rows from storage one element in) and, with K12, on rows of
   +-inf, NaN, subnormals, values that all wrap and -0.0, each edge value
   in a row's scalar head, float4 body and scalar tail; K3 from words one
   word off 16 bytes and on zero rows; K9 up to 3 * 2^24 + 7 elements,
   from aligned and unaligned
   storage, and 50 calls in a row at 2^24; K10 at every width 0-32, over
   640 chunks, ending one element into its last chunk and from a body one
   word off 16 bytes, K11 on bins >= 2^31, and 50 calls of K10 and K11 in
   turns; K5 at every width at ragged n
   up to 7,812,500 from aligned and unaligned storage; K8 at every width
   1-24 over rows shorter than, equal to and longer than a tile; K4's
   kernel at 2 * 16384 bins as the counterpart of K13 (pack_pallas_tiles);
3. the frozen wire: Trim v1.0 / v1.1 (with and without per-particle
   accuracies), Diff v1.0, Coil v1.0 / v1.1, Octo v1.0 / v1.1, Sort v1.0 /
   v1.1 / v1.2 (and its order-free stream, v1.2.1) and Cart v1.0 segments
   encoded from CUDA tensors and decoded on CUDA (generic and fused) match
   all 42 entries of tests/fixtures/wire_digests.json; u64 fields
   over their whole range (Unsi values past 2^63 and up to 2^64 - 1, IDs on
   grids past 2^21 a side with the top bit set) encoded from CUDA tensors
   equal the CPU's bytes and decode on CUDA to the same u64 bits;
4. the segment path at full size: one segment of 2^24 particles (a 256^3
   N-body snapshot: lattice positions with Gaussian displacements,
   Gaussian velocities, shuffled lattice IDs) through compress_segment and
   decompress_segment on CUDA, with error bounds, exact IDs, fused ==
   generic, launch counts, wall times, rates and peak memory; then K1 and
   K4 timed against their plain versions at that path's shapes;
5. the snapshot path at full size: a 512^3 snapshot (2^27 particles, made
   as in phase 4, plus masses) in 64 blocks through compress_snapshot and
   decompress_snapshot(batched=True) on CUDA, with error bounds, exact IDs,
   the first and last block equal to decompress_segment bitwise, launch
   counts, wall times, rates, peak memory and the device's busy share (a
   torch.profiler trace of the card); then K2, K3, K6 and K7 timed
   against their plain versions at that path's shapes and alone in a
   torch.profiler trace, K2 and K7 also at every width the path decodes
   and packs, K3 at 1, 9, 17 and 32 bits, K6 also on the velocity rows
   (not periodic), and torch.aminmax beside K6;
6. the delta path at full size: the 2^24-particle snapshot of phase 4 in
   Lagrangian (ID) order through Diff v1.0, Coil v1.1 and Octo v1.1, each
   compressed and decompressed (generic and fused) on CUDA, with error
   bounds, exact IDs, fused == generic, ratios, wall times, rates, peak
   memory and launch counts; then K9, K10 and K11 timed against their plain
   versions at that path's shapes, torch.cumsum beside K9, K9 alone and
   K10 and K11 with their table copy and memset in a torch.profiler trace;
7. the recip scale mode at full size: (a) phase 5's snapshot through
   compress_snapshot(scale_mode="recip") (K8) and the batched read, with
   error bounds, exact IDs and a file size within 0.1% of phase 5's;
   (b) its first 16 blocks through compress_snapshot_streaming at (a)'s
   depths, decoding to (a)'s values bitwise; (c) a 250^3 Gadget-2 file
   through the CLI (compress --scale-mode recip, info, verify, decompress:
   2 blocks of 7,812,500, so K5 per row, K4 and K1); (d) phase 4's
   position planes through fast_uniform_encode(scale_mode="recip") (K5);
   (e) K5, K8 and K12 timed against their plain versions, K5 beside K4
   and K8 beside K7 on the same bins (K8 at 16 and 12 bits over 192 rows
   and at 14 over 64, in turns), K8 alone in a torch.profiler trace, and
   K12's one-pass encode of phase 5's position blocks against the split
   CUDA path (K6, the host's recip, K8);
8. per-particle accuracies and the log maps at full size, in the recip
   scale mode: (a) phase 5's
   snapshot with positions at per-particle accuracies in contiguous runs
   (a zoom run's particles sorted by type: the first 1/8 at 1e-4, the next
   3/8 at 1e-3, the rest at 1e-2; Trim v1.1 block by block, K7 and K3 on
   the chunk bodies), symlog velocities (t = 20, delta 1e-3) and
   lognormal masses (0.5 dex) log10-mapped at log10(1 + 1e-4) (K6 and K8
   on the mapped rows), through
   compress_snapshot, the full read (per segment, as a file with a Deltas
   field is read) and the batched read of the other fields (K2, K3), with
   error bounds in mapped space, exact IDs and batched == per segment;
   then the path's kernels against their plain versions at its shapes:
   K7 and K3 on the Deltas chunk buckets of one block per accuracy, K6 and
   K8 on the mapped rows, K2 on K8's words (unmapped, == the batched read)
   and K1 on one velocity row;
   (b) its first 16 blocks streamed with per-block pos_deltas, decoding to
   (a)'s values bitwise; the maps on 2^20 values on the card against the
   CPU (shares of mapped values, bins and unmapped values that differ);
   (c) a 250^3 Gadget-2 file with a MASS record through the CLI (compress
   --scale-mode recip, info, verify, decompress), masses within their
   relative accuracy; K6, K5 and K1 against their plain versions on the
   mapped masses (K1's decode, unmapped, == the CLI's masses);
9. the Sort and Cart codecs at full size, on phase 6's 2^24 particles in
   ID order: (a) Sort v1.0, v1.1, v1.2 and Cart v1.0 round trips of the
   segment on CUDA (positions within their delta, periodic distance,
   velocities within theirs, IDs exact), encode and decode walls (median
   of 3), ratios beside Trim's and Coil v1.1's and launch counts; (b) the
   order-free profile (v1.2.1) on a 2^24 UNSI field of permuted IDs, whose
   decode equals the sorted input bitwise, and on an UNSF field (the x
   velocities), within its delta of the sorted input; (c) the card's bytes
   equal to the port's CPU bytes for each codec on the first 2^21
   particles (Sort v1.2 at 16384-element chunks); (d) the path's kernels
   against their plain versions, bitwise, at its shapes: K9 on Sort v1.0's
   delta stream, K7 and K3 on its width buckets, K4 on Sort v1.0's 24-bit
   rank stream and on Cart's plane, K10 on Sort v1.2's sorted-delta stream
   (no un-zigzag) and rank stream (un-zigzag), then the ranked un-permute
   gather alone and Cart's decode split into undo-delta, undo-transpose
   and unpack (CUDA events);
10. the block-sharded codecs and the multihost layer: (a) BASELINE config
   4's shape, 8 blocks of 12,582,912 uniform positions (100,663,296
   particles, 1.21 GB, box 64, delta 1e-3) through ShardedPositionCodec on
   a one-shard mesh at the spmd and adaptive depths in the div and recip
   modes (K6, K7 or K8, K2), with the error over the whole output, encode
   and decode walls (median of 3), rates, peak memory and launch counts;
   words, headers and decodes equal to the plain path (fused_rows=False)
   and to a 4-shard logical mesh on the card, bitwise; (b) phase 5's
   512^3 fields through ShardedSnapshotCodec (K6, K7, K2, K3): positions
   within delta, velocities within theirs, IDs exact, positions equal to
   (a)'s codec bitwise, everything equal to the plain path bitwise;
   (c) MH_RANKS processes on the card, spawned by this script
   (``--multihost-worker``), join a gloo group and write phase 5's
   snapshot through compress_snapshot_multihost, 32 blocks each: the
   file's sha256 equals the single-host compress_snapshot file's, and
   each rank's decompress_snapshot_multihost equals its slice of
   decompress_snapshot bitwise (a worker that fails or outlives
   MH_TIMEOUT fails the phase);
11. the measuring layer (``minnow_c_tpu_torch.bench``): its harness
   (trials of 0.05 s in a 3 s budget, after its 3 s burn-in) on the
   headline (K1 with its dither key on the card) and the kernel suite's
   rows_fused_decode (K2), rows_recip_encode (K6 + K8) and
   cumsum_u32_pallas (K9) at the suites' sizes: each time per iteration
   at least 0.9 x the kernels' torch.profiler device time a call (traced
   before phase 10, after which this script's traces came back empty),
   each rate of the kernels' own bytes at most 1.05 x 3.35 TB/s, the last
   trial's salts all distinct; entry.dryrun_multichip(4) on 4 logical
   shards of the card within its bounds; K1 with its key on the card ==
   the host-key launch == plain bitwise at the headline's shape.

The phases run in the order 1, 2, 3, 4, 6, 9, 7(c), 7(d), 5, 7(a), 7(b),
7(e), 8, 10, 11: a torch.profiler trace (phase 5's busy share, the
kernels' device times) leaves the card's tracing hooks in place, which
can add to every later CUDA-event time, so the paths whose kernels take
well under a millisecond are timed before the first trace.  The script
prints the floor of a single timed call (two events with nothing between)
before the first trace and after the last.

The launch counts of each path are set to 0 just before the path runs and
read just after.  The last line is {"ok": true, "device": {...}}; the line
before it lists the kernels with their launch counts (K1 and K4 from phase
4, the rows kernels from phase 5, the delta kernels from phase 6, K5 from
phase 7(c), K8 from 7(a), K12 from its one-pass run in 7(e), K13 as K4's
kernel), on phase 8's path ((a) + (b) + (c)), on phase 9's ((a) +
(b)), on phase 10's ((a) + (b) + (c), both ranks) and on phase 11's,
errors, times,
bounds
(the bytes each input read once and each output written once at 3.35
TB/s, or the float operations at 67 TFLOP/s, whichever is longer), the
share of the bound reached, and the library call's time where one
computes the same function.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from kernel_times import device_ms as device_all_ms
from kernel_times import event_ms

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "wire_digests.json")
SIDE = 256                 # particles per box side: 2^24 in all
BOX = 64.0                 # periodic box width
POS_DELTA, VEL_DELTA = 1e-3, 1.0
SEED = 42
SNAP_SIDE, SNAP_BLOCKS = 512, 64   # phase 5: 2^27 particles, 2^21 a block
MASS_DELTA = 1e-4
STREAM_BLOCKS = 16         # phase 7(b): the first 16 of phase 5's blocks
CLI_SIDE = 250             # phase 7(c): 15,625,000 particles


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def max_abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest absolute difference; u32 words compare as their values."""
    if got.dtype == torch.int32:
        got, want = (t.to(torch.int64) & 0xFFFFFFFF for t in (got, want))
    return float((got.double() - want.double()).abs().max().item()) \
        if got.numel() else 0.0


def cuda_ms(fn, reps: int = 5) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after 20 ms of
    warm-up calls (``kernel_times.event_ms``)."""
    return event_ms(fn, 0.02, reps)


# The card's published peaks (H100 SXM data sheet, at its 700 W limit): HBM
# bytes per second and float32 operations per second outside the tensor
# cores.  The integer lanes (the Threefry cipher, shifts, masks) have no
# rate in that table, so a bound counts bytes and float operations only.
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
# Each timed kernel's work at its timed shape: name -> (bytes each input is
# read once plus each output written once, float operations).
WORK = {}


def note_work(name: str, inputs, outputs, flops: float = 0.0) -> None:
    WORK[name] = (sum(t.numel() * t.element_size() for t in inputs) +
                  sum(t.numel() * t.element_size() for t in outputs), flops)


def bound(name: str):
    """(bound_ms, bound_by) of a kernel's noted work: the larger of its
    bytes over the memory rate and its float operations over the f32
    rate."""
    nbytes, flops = WORK[name]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, flops / PEAK_F32_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_ms(fn, kernel: str, per_call: bool = False):
    """Device time per launch of the CUDA kernels whose name holds
    ``kernel`` in a torch.profiler trace of 5 calls, over the launches the
    trace holds (``per_call``: per call of ``fn``, which launches each such
    kernel once: over the launches of the kernel the trace holds most of);
    None where none of three traces holds device time (a trace can come
    back without some or all of the card's activity)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if kernel in e.key]
        total = sum(e.device_time_total for e in hits)
        if total > 0:
            count = max(e.count for e in hits) if per_call else \
                sum(e.count for e in hits)
            return total / count / 1e3
    return None


def kernel_report(build_log: str) -> None:
    """Registers and spills of the tile kernels at the main path's widths
    (from nvcc -Xptxas -v) and the SASS instructions of their inner loops
    (cuobjdump), as progress lines."""
    import re
    from minnow_c_tpu_torch.ops import cuda_lib
    for fn, spill, regs in re.findall(
            r"Compiling entry function '(\S*(?:_tiles|_fused|scan|"
            r"stats_rows|decode_chunk)_kernel\S*)'.*?(\d+) bytes spill "
            r"stores.*?"
            r"Used (\d+) registers", build_log, re.S):
        w = re.search(r"(decode_tiles|pack_tiles|pack_recip_tiles|"
                      r"encode_recip_fused|scan|stats_rows|decode_chunk)"
                      r"_kernel"
                      r"(?:ILi(\d+)E(?:Lb(\d))?)?", fn)
        if not w or (w.group(2) and int(w.group(2)) not in (9, 12, 14, 16)):
            continue
        # pack_tiles<W, true>: from f32; decode_tiles<W, false>: K3's bins
        flag = {("pack_tiles", "1"): "(f32)", ("decode_tiles", "0"): "(bins)"}
        kind = w.group(1) + flag.get((w.group(1), w.group(3)), "") + (
            f"<{w.group(2)}>" if w.group(2) else "")
        if w.group(1) == "decode_chunk":  # K11 (floats) or K10 (bins)
            kind += "(floats)" if "ILb1" in fn else "(bins)"
        log(f"phase 1: ptxas: {kind}: {regs} registers, {spill} bytes "
            "spilled")
    lib = cuda_lib.lib()
    log(f"phase 1: decode_chunk (K10 / K11): "
        f"{lib.mnw_chunked_blocks_per_sm(0)} / "
        f"{lib.mnw_chunked_blocks_per_sm(1)} blocks resident an SM")
    tool = os.path.join(os.path.dirname(os.path.dirname(cuda_lib._nvcc())),
                        "bin", "cuobjdump")
    try:
        sass = subprocess.run([tool, "-sass", cuda_lib.LIB_PATH],
                              capture_output=True, text=True, timeout=300,
                              check=True).stdout
    except (OSError, subprocess.SubprocessError) as e:
        log(f"phase 1: SASS not read ({e})")
        return
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0]
        w = re.search(
            r"(decode|pack|pack_recip)_tiles_kernelILi(\d+)E(Lb\d)?", name)
        if not w or w.group(2) not in ("9", "12", "16") or \
                (w.group(1) == "pack" and w.group(3) != "Lb0"):
            continue
        bins = w.group(1) == "decode" and w.group(3) == "Lb0"
        if (w.group(2) == "9") != bins:
            continue
        ins = [(int(a, 16), i) for a, i in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", part)]
        # the inner loop: the shortest backward branch around the work
        # (decode: the FFMAs of one quad; K3's bins and pack: the 16-byte
        # store)
        mark = "FFMA" if w.group(1) == "decode" and not bins else "STG"
        loops = []
        for addr, i in ins:
            m = re.search(r"BRA (0x[0-9a-f]+)", i)
            if m and int(m.group(1), 16) < addr:
                body = [j for a, j in ins if int(m.group(1), 16) <= a <= addr]
                if any(mark in j for j in body) and \
                        not any("BAR" in j for j in body):
                    loops.append(len(body))
        per = "one quad (4 elements)" if w.group(1) == "decode" else \
            "4 output words"
        log(f"phase 1: SASS: {w.group(1)}_tiles{'(bins)' if bins else ''}"
            f"<{w.group(2)}>: "
            f"{len(ins)} instructions, inner loop "
            f"{min(loops) if loops else 'not found'} per {per}")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_decode_kernel(dev, g) -> float:
    """K1 against its plain version, bitwise, at every width 1-24: n of
    32 and 2^20 + 37, edge bins, periodic and subnormal planes, elem0 0
    and 2^14; then at the ragged n 1, 33, 100_003 and 7_812_500 from
    words whose storage starts 16-byte aligned or one word in (the
    kernel's 4-byte copy path), with elem0 near the counter's wrap."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    worst = 0.0
    cases = 0
    for width in range(1, 25):
        for n in (32, (1 << 20) + 37):
            top = (1 << width) - 1
            bins = torch.randint(0, top + 1, (n,), generator=g, device=dev,
                                 dtype=torch.int64)
            bins[:4] = 0
            bins[4:8] = top
            bins[-3:] = top
            words = encode_cuda.pack_plain(bins.to(torch.int32), width)
            # periodic: values span [-2, 66) so both rewraps happen; the
            # third case has a subnormal x0 and bin width (flushed to 0),
            # the fourth subnormal sums near 0 at width 1 (flushed to 0)
            for periodic, x0, dx in ((False, 1.5, 32.0), (True, -2.0, 68.0),
                                     (False, 1e-40, 1e-36),
                                     (False, -2e-38, 4e-38)):
                for elem0 in (0, 1 << 14):
                    key = (0x12345678 + width, 0x9ABCDEF0 + n)
                    got = decode_cuda.decode_cuda(words, key, width, n, x0,
                                                  dx, BOX, periodic, elem0)
                    want = decode_cuda.decode_plain(
                        words, *key, x0, kernels.bin_width(dx, width), BOX,
                        n, width, elem0, periodic)
                    torch.cuda.synchronize()
                    worst = max(worst, max_abs_err(got, want))
                    if not torch.equal(bits(got), bits(want)):
                        raise AssertionError(
                            f"K1 != plain: width={width} n={n} "
                            f"periodic={periodic} elem0={elem0}")
                    cases += 1
    for width in (1, 9, 12, 14, 16, 17, 24):
        for n in (1, 33, 100_003, 7_812_500):
            bins = torch.randint(0, 1 << width, (n,), generator=g,
                                 device=dev, dtype=torch.int64)
            packed = encode_cuda.pack_plain(bins.to(torch.int32), width)
            for offset in (0, 1):
                store = torch.zeros(packed.numel() + offset,
                                    dtype=torch.int32, device=dev)
                store[offset:] = packed
                words = store[offset:]
                elem0 = (1 << 34) - 8 if offset else 4 * 12345
                got = decode_cuda.decode_cuda(words, (3, 4), width, n, 0.5,
                                              40.0, BOX, True, elem0)
                want = decode_cuda.decode_plain(
                    words, 3, 4, 0.5, kernels.bin_width(40.0, width), BOX, n,
                    width, elem0, True)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_err(got, want))
                if not torch.equal(bits(got), bits(want)):
                    raise AssertionError(f"K1 != plain: width={width} n={n} "
                                         f"offset={offset}")
                cases += 1
    log(f"phase 2: K1 decode == plain bitwise in {cases} cases, widths "
        f"1-24, ragged n, unaligned words (max_abs_err {worst})")
    return worst


def edge_plane(width: int, n: int, g, dev) -> torch.Tensor:
    """Pre-scaled f32 plane: uniform in [0, 2^w) plus NaN, +-inf,
    negatives, values >= 2^w and +-1 ulp around bin edges."""
    nb = float(1 << width)
    s = torch.rand(n, generator=g, device=dev) * nb
    edges = torch.randint(0, 1 << width, (64,), generator=g,
                          device=dev).to(torch.float32)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0,
                            -1.0, -0.5, nb, 2 * nb, 1e30], device=dev)
    special = torch.cat([
        special, edges,
        torch.nextafter(edges, torch.full_like(edges, -float("inf"))),
        torch.nextafter(edges, torch.full_like(edges, float("inf"))),
        torch.nextafter(torch.tensor([nb], device=dev),
                        torch.zeros(1, device=dev))])
    s[:special.numel()] = special
    return s


def check_pack_kernel(dev, g) -> float:
    from minnow_c_tpu_torch.ops import encode_cuda
    worst = 0.0
    cases = 0
    for n in (1, 37, 100_003, (1 << 20) + 37):
        # offset 1: the input's storage starts one element in (4-byte loads)
        for offset in (0, 1):
            vals = torch.randint(-(1 << 31), 1 << 31, (n + offset,),
                                 generator=g, device=dev,
                                 dtype=torch.int64).to(torch.int32)[offset:]
            for width in range(1, 33):
                got = encode_cuda.pack_cuda(vals, width)
                want = encode_cuda.pack_plain(vals, width)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"K4 != plain: u32 width={width} "
                                         f"n={n} offset={offset}")
                cases += 1
            for width in range(1, 25):
                m = n if n > 300 else 300
                s = torch.cat([torch.zeros(offset, device=dev),
                               edge_plane(width, m, g, dev)])[offset:]
                got = encode_cuda.pack_cuda(s, width, from_f32=True)
                want = encode_cuda.pack_plain(s, width, from_f32=True)
                torch.cuda.synchronize()
                worst = max(worst, max_abs_err(got, want))
                if not torch.equal(got, want):
                    raise AssertionError(f"K4 != plain: from_f32 "
                                         f"width={width} offset={offset}")
                cases += 1
    log(f"phase 2: K4 pack == plain bitwise in {cases} cases, widths 1-32 "
        f"(f32 1-24), ragged n, unaligned inputs (max_abs_err {worst})")
    return worst


def u32_rows(rows: int, n: int, width: int, g, dev) -> torch.Tensor:
    """(rows, n) u32 values below 2^width as int32 bits, each row starting
    with 0 and 2^width - 1."""
    from minnow_c_tpu_torch.ops import kernels
    b = torch.randint(0, 1 << width, (rows, n), generator=g, device=dev,
                      dtype=torch.int64)
    b[:, :2] = torch.tensor([0, (1 << width) - 1], device=dev)
    return kernels.i64_to_u32(b)


def check_rows_kernels(dev, g) -> dict:
    """K2, K3, K6 and K7 against their plain versions, bitwise, over widths
    and row counts past the 65535 limit of a grid's y dimension."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    tile = decode_cuda.DECODE_TILE
    shapes = ((1, 32), (70_000, 32), (3, (1 << 20) + 32), (192, 4096),
              (3, tile - 32), (3, tile + 32), (2, 3 * tile + 96))
    worst = {"K2": 0.0, "K3": 0.0, "K6": 0.0, "K7": 0.0}
    cases = 0

    def same(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        if isinstance(got, tuple):
            for a, b in zip(got, want):
                same(name, a, b, what)
            return
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{name} != plain: {what}")
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases += 1

    def same_stats(x, what):
        """K6 on the rows of x, plain and unwrapped in a box of BOX."""
        box = torch.full((x.shape[0],), BOX, device=dev)
        anchor = x[:, 0].contiguous()
        for periodic in (False, True):
            same("K6", encode_cuda.stats_rows_cuda(x, box, anchor, periodic),
                 encode_cuda.stats_rows_plain(x, box, anchor, periodic),
                 f"{what} periodic={periodic}")

    for rows, n in shapes:
        vals = u32_rows(rows, n, 32, g, dev)
        for width in range(0, 33):      # K7 at every width
            same("K7", encode_cuda.pack_rows_cuda(vals, width),
                 encode_cuda.pack_rows_plain(vals, width),
                 f"width={width} rows={rows} n={n}")
        for width in range(1, 33):      # K3 at every width, K2 at 1-24
            words = encode_cuda.pack_rows_plain(
                u32_rows(rows, n, width, g, dev), width)
            same("K3", decode_cuda.unpack_rows_cuda(words, width, n),
                 decode_cuda.unpack_rows_plain(words, width, n),
                 f"width={width} rows={rows} n={n}")
            if width > 24:
                continue
            keys = torch.randint(0, 1 << 32, (rows, 2), generator=g,
                                 device=dev)
            for periodic in (False, True):
                x0 = torch.full((rows,), -2.0 if periodic else 1.5,
                                device=dev)
                dx = torch.full((rows,), 68.0 if periodic else 32.0,
                                device=dev)
                if not periodic:    # subnormal x0, bin width or sums
                    x0[::2] = 1e-40
                    dx[::2] = 1e-36
                    x0[1::4] = -2e-38
                    dx[1::4] = 4e-38
                same("K2", decode_cuda.decode_rows_cuda(
                    words, keys, width, n, x0, dx, BOX, periodic),
                    decode_cuda.decode_rows_plain(
                        words, keys, x0, kernels.bin_width(dx, width), BOX,
                        n, width, periodic),
                    f"width={width} rows={rows} n={n} periodic={periodic}")
        x = torch.rand(rows, n, generator=g, device=dev) * BOX
        x[::5, 3] = float("nan")
        x[:, 5::7] = 1e-40
        x[:, 6::11] = -1e-40
        if rows > 2:
            x[1] = torch.where(x[1] < BOX / 2, 0.0, -0.0)
            x[2, ::3] = -0.0
            x[2] = -x[2]
        same_stats(x, f"rows={rows} n={n}")
    # K3 from words whose storage starts one word in (4-byte copies), and
    # zero rows (no launch)
    n = 3 * tile + 96
    for width in (1, 9, 17, 31, 32):
        packed = encode_cuda.pack_rows_plain(u32_rows(5, n, width, g, dev),
                                             width)
        store = torch.zeros(packed.numel() + 1, dtype=torch.int32, device=dev)
        store[1:] = packed.reshape(-1)
        words = store[1:].view(5, -1)
        same("K3", decode_cuda.unpack_rows_cuda(words, width, n),
             decode_cuda.unpack_rows_plain(words, width, n),
             f"unaligned words width={width}")
        before = decode_cuda.unpack_rows_cuda.launches
        if decode_cuda.unpack_rows_cuda(words[:0], width, n).shape != \
                (0, n) or decode_cuda.unpack_rows_cuda.launches != before:
            raise AssertionError("K3 on zero rows")
    # K6 across its slices (2^15) and 16-byte edges: odd n and storage one
    # element in give every row a scalar head and tail around its float4s
    for rows, n in ((3, 1), (3, 3), (3, 5), (3, 4097), (3, 65_541),
                    (70_000, 32)):
        for offset in (0, 1):
            store = torch.rand(rows * n + offset, generator=g,
                               device=dev) * BOX
            x = store[offset:].view(rows, n)
            x[::4, n // 2] = float("nan")
            x[1, ::3] = -0.0
            x[2] = -x[2].abs()
            same_stats(x, f"rows={rows} n={n} offset={offset}")
    # the edge rows with their edge values in the scalar head, the float4
    # body (slice 2 of 5) and the scalar tail
    for where in EDGE_AT:
        same_stats(edge_rows(where, dev), f"edge rows, edge in the {where}")
    log(f"phase 2: K2, K3, K6, K7 == plain bitwise in {cases} comparisons "
        f"(max_abs_err {worst})")
    return worst


# K6's edge rows: 4 | n and 32 | n, so from storage one element in every
# row starts 4 bytes past a 16-byte boundary: 3 scalars, float4s over 5
# slices of 2^15, then 1 scalar
EDGE_N = 2 * (1 << 16) + 32
EDGE_AT = {"head": 1, "body": EDGE_N // 2, "tail": EDGE_N - 1}


def edge_rows(where: str, dev) -> torch.Tensor:
    """Six rows of EDGE_N with K6's edge values at EDGE_AT[where], from
    storage one element in: +inf; -inf; NaN beside -inf; a subnormal
    anchor among subnormals; a row whose every value wraps in a box of 64
    (anchor 1, the rest in [34, 63), 33.5 at the edge, which wraps to the
    min); -0.0 in a negative row."""
    pos, n = EDGE_AT[where], EDGE_N
    rng = np.random.default_rng(len(where))
    x = rng.uniform(0, BOX, (6, n)).astype(np.float32)
    x[0, pos] = np.inf
    x[1, pos] = -np.inf
    x[2, pos] = np.nan
    x[2, pos - 1] = -np.inf
    x[3] = (rng.uniform(-1, 1, n) * 1e-39).astype(np.float32)
    x[3, 0] = 3e-39
    x[3, pos] = -1.1e-38
    x[4] = rng.uniform(34, 63, n).astype(np.float32)
    x[4, 0] = 1.0
    x[4, pos] = 33.5
    x[5] = -rng.uniform(0.5, 1, n).astype(np.float32)
    x[5, pos] = -0.0
    store = torch.zeros(6 * n + 1, device=dev)
    store[1:] = torch.from_numpy(x.reshape(-1)).to(dev)
    return store[1:].view(6, n)


def recip_plane(n: int, g, dev, periodic: bool) -> torch.Tensor:
    """Raw floats in the box with the recip map's hazards: the unwrap's
    edges (anchor +- half and one ulp either side, the box edges), with
    the anchor (element 0) at a box edge, subnormals and signed zeros;
    shifted below 0 when not periodic."""
    x = torch.rand(n, generator=g, device=dev) * BOX
    a = float(np.nextafter(np.float32(BOX), np.float32(0)))
    h = BOX / 2
    edges = torch.tensor([a, a - h, a + h,
                          float(np.nextafter(np.float32(a - h),
                                             np.float32(0))),
                          float(np.nextafter(np.float32(a - h),
                                             np.float32(BOX))),
                          0.0, -0.0, 1e-40, -1e-40, BOX], device=dev)
    k = min(n, edges.numel())
    x[:k] = edges[:k]
    x[k::97] = 1e-40
    return x if periodic else x - 20.0


def check_recip_kernels(dev, g) -> dict:
    """K5 over widths 1-24 and ragged n (1, < 32, 32 does not divide n);
    K8 over row counts past 65535 and rows with a constant plane (recip
    inf), a subnormal x0 and the unwrap's edges; K12 over block counts
    past the co-resident grid, with a constant block; bitwise against
    their plain versions."""
    from minnow_c_tpu_torch.ops import encode_cuda, kernels
    worst = {"K5": 0.0, "K8": 0.0, "K12": 0.0}
    cases = 0

    def same(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            if not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"{name} != plain: {what}")
            worst[name] = max(worst[name], max_abs_err(a, b))
        cases += 1

    for n in (1, 17, 33, 100_003, (1 << 20) + 37, 7_812_500):
        for periodic, offset in ((False, 0), (True, 0), (True, 1)):
            # offset 1: storage one element in, 4-byte loads
            store = torch.empty(n + offset, device=dev)
            store[offset:] = recip_plane(n, g, dev, periodic)
            x = store[offset:]
            u = kernels.undo_periodic(x, BOX) if periodic else x
            x0, x1 = kernels.minmax(u)
            recip = kernels.exact_recip((x1 - x0).item())
            for width in range(1, 25):
                args = (width, x0.item(), recip, BOX if periodic else 0.0,
                        x[0].item(), periodic)
                same("K5", encode_cuda.encode_recip_cuda(x, *args),
                     encode_cuda.encode_recip_plain(x, *args),
                     f"width={width} n={n} periodic={periodic} "
                     f"offset={offset}")
        const = torch.full((n,), 7.5, device=dev)
        same("K5", encode_cuda.encode_recip_cuda(const, 12, 7.5, np.inf, 0.0,
                                                 7.5, False),
             torch.zeros_like(encode_cuda.encode_recip_plain(
                 const, 12, 7.5, np.inf, 0.0, 7.5, False)),
             f"constant plane n={n}")
    # normal values whose differences from x0 are subnormal (flushed)
    tiny = 1.2e-38 + torch.rand(4096, generator=g, device=dev) * 1e-37
    t0, t1 = kernels.minmax(tiny)
    t_recip = kernels.exact_recip((t1 - t0).item())
    for width in (6, 16, 24):
        args = (width, t0.item(), t_recip, 0.0, tiny[0].item(), False)
        same("K5", encode_cuda.encode_recip_cuda(tiny, *args),
             encode_cuda.encode_recip_plain(tiny, *args),
             f"subnormal differences width={width}")
        rows = tiny.reshape(2, 2048)
        r_args = (width, t0.expand(2).contiguous(),
                  torch.full((2,), float(t_recip), device=dev),
                  torch.zeros(2, device=dev), rows[:, 0].contiguous(), False)
        same("K8", encode_cuda.encode_recip_rows_cuda(rows, *r_args),
             encode_cuda.encode_recip_rows_plain(rows, *r_args),
             f"subnormal differences width={width}")
    # rows shorter than a tile, equal to it and longer; many rows of 32
    for rows, n in ((1, 32), (70_000, 32), (700, 96), (7, 4064), (7, 4096),
                    (7, 4128), (3, (1 << 20) + 32), (2, 1 << 21),
                    (2, 7_812_512), (192, 4096)):
        for periodic in (False, True):
            x = torch.rand(rows, n, generator=g, device=dev) * BOX
            x[0] = recip_plane(n, g, dev, periodic)
            x[-1, ::5] = 1e-40
            x0 = torch.rand(rows, generator=g, device=dev) * 4.0
            recip = 1.0 / (40.0 + 20.0 * torch.rand(rows, generator=g,
                                                    device=dev))
            if rows > 2:
                x[1] = 7.5
                x0[1] = 7.5
                recip[1] = float("inf")
                x0[2] = 1e-40
            box = torch.full((rows,), BOX, device=dev)
            for width in range(1, 25):
                args = (width, x0, recip, box, x[:, 0].contiguous(), periodic)
                same("K8", encode_cuda.encode_recip_rows_cuda(x, *args),
                     encode_cuda.encode_recip_rows_plain(x, *args),
                     f"width={width} rows={rows} n={n} periodic={periodic}")
    for blocks, dims, n in ((1, 1, 32), (3, 3, 2048), (4096, 3, 64),
                            (64, 3, 1 << 16)):
        for periodic in (False, True):
            x = torch.rand(blocks, dims, n, generator=g, device=dev) * BOX
            x[0, 0] = recip_plane(n, g, dev, periodic)
            if blocks > 1:
                x[1] = 3.25
            anchors = x[:, :, 0].contiguous()
            box = BOX if periodic else 0.0
            for width in (1, 12, 14, 16, 24):
                same("K12", encode_cuda.encode_recip_fused_blocks_cuda(
                    x, box, anchors, width, periodic),
                    encode_cuda.encode_recip_fused_blocks_plain(
                        x, box, anchors, width, periodic),
                    f"width={width} blocks={blocks} dims={dims} n={n} "
                    f"periodic={periodic}")
    for where in EDGE_AT:   # K6's edge rows as two blocks of three
        x = edge_rows(where, dev).view(2, 3, EDGE_N)
        anchors = x[:, :, 0].contiguous()
        for periodic in (False, True):
            for width in (12, 16):
                same("K12", encode_cuda.encode_recip_fused_blocks_cuda(
                    x, BOX, anchors, width, periodic),
                    encode_cuda.encode_recip_fused_blocks_plain(
                        x, BOX, anchors, width, periodic),
                    f"edge rows, edge in the {where}, width={width} "
                    f"periodic={periodic}")
    tiny = torch.rand(3, 3, 4096, generator=g, device=dev) * 3e-38
    for width in (1, 12):   # a box of 3e-38: subnormal unwraps
        anchors = tiny[:, :, 0].contiguous()
        same("K12", encode_cuda.encode_recip_fused_blocks_cuda(
            tiny, 3e-38, anchors, width, True),
            encode_cuda.encode_recip_fused_blocks_plain(
                tiny, 3e-38, anchors, width, True),
            f"box 3e-38 width={width}")
    log(f"phase 2: K5, K8, K12 == plain bitwise in {cases} comparisons "
        f"(max_abs_err {worst})")
    return worst


def check_tiles_pack(dev, g) -> float:
    """K13 (pack_pallas_tiles) computes K4's function: K4's kernel at
    2 * 16384 bins against pack_plain, bitwise."""
    from minnow_c_tpu_torch.ops import encode_cuda
    worst = 0.0
    for width in (1, 7, 14, 17, 24, 31):
        bins = u32_rows(1, 2 * 16384, width, g, dev)[0]
        got = encode_cuda.pack_cuda(bins, width)
        want = encode_cuda.pack_plain(bins, width)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K13 (K4's kernel) != plain: width={width}")
        worst = max(worst, max_abs_err(got, want))
    log(f"phase 2: K13 as K4's kernel == plain bitwise at 2*16384 bins, "
        f"widths 1, 7, 14, 17, 24, 31 (max_abs_err {worst})")
    return worst


def chunked_stream(pattern, trim, seed, first=None):
    """A chunked plane of 16384-element chunks whose chunk c holds zigzag
    deltas below 2^pattern[c], made on the host with the port's chunk pack:
    (body words as int32 bits (column-major), widths, n)."""
    from minnow_c_tpu_torch.algos import chunked
    from minnow_c_tpu_torch.ops import chunked_cuda
    chunk = chunked_cuda.KERNEL_CHUNK
    rng = np.random.default_rng(seed)
    z = np.zeros(len(pattern) * chunk, np.uint32)
    for c, w in enumerate(pattern):
        if w:
            z[c * chunk:(c + 1) * chunk] = rng.integers(
                0, 1 << w, chunk, dtype=np.uint64)
            z[c * chunk + 5] = (1 << w) - 1
    n = z.size - trim
    zc, widths = chunked.chunk_widths(z[:n], chunk)
    natural = np.frombuffer(chunked.pack_chunks(zc, widths), dtype="<u4")
    body = chunked_cuda.plane_to_cmajor(natural, widths, chunk)
    return body.astype(np.uint32).view(np.int32), widths, n


def check_delta_kernels(dev, g) -> dict:
    """K9 over sizes with full-range values (the sums wrap); K10 and K11
    over mixed widths, zero-width and width-32 chunks (deltas of magnitude
    >= 2^30), ragged and whole last chunks, `first` near 2^32, depth 24,
    periodic or not; bitwise against their plain versions."""
    from minnow_c_tpu_torch.ops import chunked_cuda, scan_cuda
    worst = {"K9": 0.0, "K10": 0.0, "K11": 0.0}
    cases = 0

    def same(name, got, want, what):
        nonlocal cases
        torch.cuda.synchronize()
        if not torch.equal(bits(got), bits(want)):
            raise AssertionError(f"{name} != plain: {what}")
        worst[name] = max(worst[name], max_abs_err(got, want))
        cases += 1

    for n in (1, 31, 97, 4095, 4096, 4097, (1 << 20) + 5, 1 << 24,
              3 * (1 << 24) + 7):
        for offset in (0, 1):   # 1: storage one word in, 4-byte loads
            store = torch.randint(-(1 << 31), 1 << 31, (n + offset,),
                                  generator=g, device=dev,
                                  dtype=torch.int64).to(torch.int32)
            x = store[offset:]
            same("K9", scan_cuda.cumsum_u32(x), scan_cuda.cumsum_u32_plain(x),
                 f"n={n} offset={offset}")
    # 50 calls in a row on one stream: a race in the look-back, or a status
    # word or ticket left by the call before, would show
    xs = [torch.randint(-(1 << 31), 1 << 31, (1 << 24,), generator=g,
                        device=dev, dtype=torch.int64).to(torch.int32)
          for _ in range(2)]
    want = [scan_cuda.cumsum_u32_plain(x) for x in xs]
    got = [scan_cuda.cumsum_u32(xs[k % 2]) for k in range(50)]
    for k, y in enumerate(got):
        same("K9", y, want[k % 2], f"call {k} of 50 at n=2^24")
    del xs, want, got
    chunk = chunked_cuda.KERNEL_CHUNK
    # every width 0-32 in one plane; 640 chunks (more tiles than one wave of
    # blocks); a plane ending one element into its last chunk; full-range
    # deltas in width-32 chunks (bins >= 2^31 for K11)
    for pattern, trim in (((7, 15, 7), 137), ((24,), 137),
                          ((0, 9, 0, 3), 137), ((1, 32, 5), 137),
                          ((0, 0), 5), ((4, 32, 32, 11), 0),
                          ((11,) * 64, 1000), (tuple(range(33)), 137),
                          ((11,) * 640, 1000), ((5, 9), chunk - 1),
                          ((32, 32, 7), 137)):
        body, widths, n = chunked_stream(pattern, trim, len(pattern) + trim)
        store = torch.zeros(body.size + 1, dtype=torch.int32, device=dev)
        store[1:] = torch.from_numpy(body).to(dev)
        for first in (0, (1 << 32) - 5):
            # offset 1: the body one word into its storage, off 16 bytes
            for offset in (0, 1):
                b = store[1:] if offset else store[1:].clone()
                for zigzag, prefix in ((True, True), (False, True),
                                       (False, False)):
                    same("K10", chunked_cuda.decode_chunked_stream(
                        b, widths, first, chunk, n, zigzag, prefix),
                        chunked_cuda.decode_chunked_stream_plain(
                            b, widths, first, chunk, n, zigzag, prefix),
                        f"pattern={pattern[:8]} first={first} "
                        f"offset={offset} zigzag={zigzag} prefix={prefix}")
        body = store[1:].clone()
        del store
        if pattern == (32, 32, 7):  # bins >= 2^31: an unsigned conversion
            high = chunked_cuda.decode_chunked_stream_plain(
                body, widths, (1 << 31) + 5, chunk, n)
            if (high < 0).sum().item() < n // 4:
                raise AssertionError("phase 2: too few bins >= 2^31")
            for periodic in (False, True):
                args = (body, widths, (1 << 31) + 5, chunk, n, (7, 8), 24,
                        -2.0, 68.0, BOX, periodic)
                same("K11", chunked_cuda.decode_chunked_stream_floats(*args),
                     chunked_cuda.decode_chunked_stream_floats_plain(*args),
                     f"pattern={pattern[:8]} bins >= 2^31 "
                     f"periodic={periodic}")
        for depth in (14, 24):
            for periodic, x0, dx in ((False, 0.25, 63.0), (True, -2.0, 68.0),
                                     (False, 1e-40, 1e-36),
                                     (False, -2e-38, 4e-38)):
                args = (body, widths, (1 << 24) - 3, chunk, n,
                        (0xDEADBEEF, depth), depth, x0, dx, BOX, periodic)
                same("K11", chunked_cuda.decode_chunked_stream_floats(*args),
                     chunked_cuda.decode_chunked_stream_floats_plain(*args),
                     f"pattern={pattern} depth={depth} periodic={periodic}")
    # 50 calls in a row, K10 and K11 in turns, on 1024 chunks at 17 bits
    body, widths, n = chunked_stream((17,) * 1024, 5, 17)
    body = torch.from_numpy(body).to(dev)
    fargs = (body, widths, 99, chunk, n, (1, 2), 17, 0.25, 63.5, BOX, True)
    want = (chunked_cuda.decode_chunked_stream_plain(body, widths, 99, chunk,
                                                     n),
            chunked_cuda.decode_chunked_stream_floats_plain(*fargs))
    got = [chunked_cuda.decode_chunked_stream(body, widths, 99, chunk, n)
           if k % 2 == 0 else
           chunked_cuda.decode_chunked_stream_floats(*fargs)
           for k in range(50)]
    for k, y in enumerate(got):
        same("K11" if k % 2 else "K10", y, want[k % 2],
             f"call {k} of 50 at 1024 chunks")
    log(f"phase 2: K9, K10, K11 == plain bitwise in {cases} comparisons, "
        "K10 at every width 0-32 and from a body one word off 16 bytes, "
        "K11 on bins >= 2^31, 50 calls in a row of each "
        f"(max_abs_err {worst})")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the frozen wire on CUDA
# ---------------------------------------------------------------------------

def reference_segment(mt, algo: int, version: int, dev):
    """The freeze test's segment (tests/test_freeze.py:reference_segment),
    rebuilt here with numpy and moved to the card."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(12345)
    steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 100, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 18)[:n].astype(np.int64)
    uf = rng.uniform(1, 10, n).astype(np.float32)
    ui = (rng.integers(0, 1000, n) + 5_000_000).astype(np.int64)

    def field(code, data, acc):
        hd = mt.FieldHeader(code, algo, version, n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(dev), acc=acc)

    F = mt.FieldCode
    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=1e-3, width=W)),
        field(F.VELC, vel, mt.VelocityAccuracy(delta=0.25)),
        field(F.PTID, ids, mt.IDAccuracy(width=512)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=1e-3)),
        field(F.UNSI, ui, mt.IntAccuracy()),
    ])


def deltas_segment(mt, algo: int, version: int, dev):
    """The freeze test's Deltas-mode segment
    (tests/test_freeze.py:deltas_segment: per-particle accuracies on
    positions and a scalar field), rebuilt here with numpy and moved to the
    card."""
    n, W = 4096, 64.0
    rng = np.random.default_rng(54321)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    uf = rng.uniform(1, 9, n).astype(np.float32)
    deltas = rng.choice(np.array([1e-1, 1e-2, 1e-3], dtype=np.float32), n)

    def field(code, data, acc):
        hd = mt.FieldHeader(code, algo, version, n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(dev), acc=acc)

    F = mt.FieldCode
    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=0.0, width=W,
                                               deltas=deltas)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=0.0, deltas=deltas)),
    ])


def order_free_segment(mt, algo: int, version: int, dev):
    """The freeze test's Sort v1.2.1 stream (tests/test_freeze.py
    current_digests: one UNSI field of permuted values), rebuilt here with
    numpy and moved to the card."""
    rng = np.random.default_rng(54321)
    n = 4096
    ui = (rng.permutation(1 << 18)[:n] + 3).astype(np.int64)
    hd = mt.FieldHeader(mt.FieldCode.UNSI, algo, version, n)
    return mt.Seg(fields=[mt.Field(hd=hd, data=torch.from_numpy(ui).to(dev),
                                   acc=mt.IntAccuracy())])


def decode_digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        h.update(np.ascontiguousarray(f.data.cpu().numpy()).tobytes())
    return h.hexdigest()


def check_frozen_wire(mt, dev) -> None:
    with open(FIXTURE) as f:
        want = json.load(f)
    A = mt.AlgoCode
    v10, v11 = mt.semver.pack(1, 0, 0), mt.semver.pack(1, 1, 0)
    v12, v121 = mt.semver.pack(1, 2, 0), mt.semver.pack(1, 2, 1)
    matched = 0
    for name, algo, version in (
            ("trim", A.TRIM, v10), ("trim_v1_1", A.TRIM, v11),
            ("diff", A.DIFF, v10), ("coil", A.COIL, v10),
            ("coil_v1_1", A.COIL, v11), ("octo", A.OCTO, v10),
            ("octo_v1_1", A.OCTO, v11), ("sort", A.SORT, v10),
            ("sort_v1_1", A.SORT, v11), ("sort_v1_2", A.SORT, v12),
            ("cart", A.CART, v10), ("trim_deltas", A.TRIM, v10),
            ("trim_v1_1_deltas", A.TRIM, v11),
            ("sort_v1_2_orderfree", A.SORT, v121)):
        if name.endswith("_deltas"):
            blob = mt.compress_segment(
                deltas_segment(mt, algo, version, dev), seed=888)
        elif name.endswith("_orderfree"):
            blob = mt.compress_segment(
                order_free_segment(mt, algo, version, dev), seed=777)
        else:
            blob = mt.compress_segment(
                reference_segment(mt, algo, version, dev), seed=777)
        enc = hashlib.sha256(blob).hexdigest()
        if enc != want[f"{name}_encode_sha256"] or \
                len(blob) != want[f"{name}_bytes"]:
            raise AssertionError(f"{name}: encode digest or size differs "
                                 f"({enc}, {len(blob)} B)")
        for fused in (False, True):
            seg = mt.decompress_segment(blob, fused=fused, device=dev)
            if any(f.data.device.type != "cuda" for f in seg.fields):
                raise AssertionError(f"{name}: decode left the card")
            dig = decode_digest(seg)
            if dig != want[f"{name}_decode_sha256"]:
                raise AssertionError(f"{name}: decode digest differs "
                                     f"(fused={fused}): {dig}")
        matched += 3
        log(f"phase 3: {name} encode {enc[:16]}.. ({len(blob)} B) and "
            "decode (generic, fused) match the frozen digests on CUDA")
    if matched != len(want):
        raise AssertionError(f"phase 3: {matched} of the fixture's "
                             f"{len(want)} entries checked")
    log(f"phase 3: all {matched} of the fixture's entries match on CUDA")


def u64_cases():
    """u64 fields over their whole range: Unsi values at 1, 2^63 + 12345
    and 2^64 - 1, a range below 2^32 just under 2^64 (one plane), a range
    past 2^32 across 2^63 (two planes); IDs on grids of 2^21 + 5 and
    2642245 (the largest w with w^3 <= 2^64) a side, x and z across the
    grid's seam, with 0, w^3 - 1 and 2^63 + 7 among them."""
    rng = np.random.default_rng(SEED)
    yield "Unsi edges", None, np.array(
        [1, (1 << 63) + 12345, (1 << 64) - 1], np.uint64)
    yield "Unsi one plane near 2^64", None, rng.integers(
        0, 1 << 32, 1 << 16, dtype=np.uint64) + np.uint64(-(1 << 32) % 2**64)
    yield "Unsi two planes across 2^63", None, rng.integers(
        0, 1 << 41, 1 << 16, dtype=np.uint64) + np.uint64((1 << 63) - 2**40)
    for w in ((1 << 21) + 5, 2642245):
        n = 1 << 16
        xs, zs = (rng.integers(w - k, w + k, n) % w for k in (6, 3))
        ys = rng.integers(0, w, n)
        ids = (xs.astype(np.uint64) + np.uint64(w) * ys.astype(np.uint64) +
               np.uint64(w * w) * zs.astype(np.uint64))
        ids[:3] = (0, w ** 3 - 1, (1 << 63) + 7)
        yield f"Ptid width {w}", w, ids


def check_u64_segments(mt, dev) -> None:
    """Each u64 case as a Trim segment encoded from an int64 CUDA tensor of
    its bits and decoded on CUDA (generic and fused): the expected u64
    values, and the bytes of the same encode on the CPU."""
    for name, w, vals in u64_cases():
        code, acc = (mt.FieldCode.UNSI, mt.IntAccuracy()) if w is None else \
            (mt.FieldCode.PTID, mt.IDAccuracy(width=w))
        hd = mt.FieldHeader(code, mt.AlgoCode.TRIM, mt.semver.pack(1, 0, 0),
                            vals.size)
        t = torch.from_numpy(vals.view(np.int64))
        blob = mt.compress_segment(mt.Seg(fields=[mt.Field(
            hd=hd, data=t.to(dev), acc=acc)]))
        if blob != mt.compress_segment(mt.Seg(fields=[mt.Field(
                hd=hd, data=t, acc=acc)]), device="cpu"):
            raise AssertionError(f"phase 3: {name}: CUDA encode != CPU")
        for fused in (False, True):
            got = mt.decompress_segment(blob, fused=fused).fields[0].data
            if not got.is_cuda or not np.array_equal(
                    got.cpu().numpy().view(np.uint64), vals):
                raise AssertionError(f"phase 3: {name}: decode (fused="
                                     f"{fused}) != the u64 values")
        log(f"phase 3: {name}: {vals.size} u64 values encoded from CUDA, "
            f"== the CPU encode ({len(blob)} B), decoded on CUDA (generic, "
            "fused) to the same u64 bits")


# ---------------------------------------------------------------------------
# Phase 4: the main path at full size
# ---------------------------------------------------------------------------

def snapshot(mt, dev):
    """A 256^3 N-body snapshot made on the card from a fixed seed: lattice
    positions + N(0, 0.5) displacements wrapped into the box, N(0, 300)
    velocities, lattice IDs; particles in shuffled order."""
    g = torch.Generator(device=dev).manual_seed(SEED)
    n = SIDE ** 3
    ids = torch.randperm(n, generator=g, device=dev)
    lat = torch.stack([ids % SIDE, (ids // SIDE) % SIDE, ids // SIDE ** 2])
    pos = (lat.to(torch.float32) + 0.5) * (BOX / SIDE) + 0.5 * torch.randn(
        3, n, generator=g, device=dev)
    pos = torch.remainder(pos, BOX)
    pos = torch.where(pos >= BOX, pos - BOX, pos)
    vel = 300.0 * torch.randn(3, n, generator=g, device=dev)

    def hd(code):
        return mt.FieldHeader(code, mt.AlgoCode.TRIM, mt.semver.pack(1, 0, 0),
                              n)

    F = mt.FieldCode
    return mt.Seg(fields=[
        mt.Field(hd=hd(F.POSN), data=pos,
                 acc=mt.PositionAccuracy(delta=POS_DELTA, width=BOX)),
        mt.Field(hd=hd(F.VELC), data=vel,
                 acc=mt.VelocityAccuracy(delta=VEL_DELTA)),
        mt.Field(hd=hd(F.PTID), data=ids, acc=mt.IDAccuracy(width=SIDE)),
    ])


def timed(fn):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t, torch.cuda.max_memory_allocated()


def timed_busy(fn):
    """``timed(fn)`` inside a torch.profiler trace of the card alone, plus
    the device's busy seconds in it: the union of the intervals of its
    kernels, copies and sets; None where the trace holds none."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, wall, peak = timed(fn)
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in prof.events()
                              if e.device_type == DeviceType.CUDA):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    return out, wall, peak, busy / 1e6 if busy > 0 else None


def check_main_path(mt, dev):
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda
    seg = snapshot(mt, dev)
    n = SIDE ** 3
    raw = n * (3 * 4 + 3 * 4 + 8)
    torch.cuda.synchronize()

    decode_cuda.decode_cuda.launches = 0
    encode_cuda.pack_cuda.launches = 0
    blob, t_enc, m_enc = timed(lambda: mt.compress_segment(seg, seed=SEED))
    # no device given: the entry points run on the card by default
    fused, t_fus, m_fus = timed(
        lambda: mt.decompress_segment(blob, fused=True))
    generic, t_gen, m_gen = timed(
        lambda: mt.decompress_segment(blob, fused=False))
    launches = {"K1": decode_cuda.decode_cuda.launches,
                "K4": encode_cuda.pack_cuda.launches}

    for name, t, m in (("encode", t_enc, m_enc),
                       ("decode fused", t_fus, m_fus),
                       ("decode generic", t_gen, m_gen)):
        log(f"phase 4: {name}: {t:.4f} s wall, {raw / t / 1e9:.3f} GB/s of "
            f"raw f32/u64 bytes, peak device memory {m / 2**30:.3f} GiB")
    log(f"phase 4: {n} particles, {raw} raw bytes -> {len(blob)} compressed "
        f"bytes (ratio {raw / len(blob):.3f})")
    log(f"phase 4: launches in the main path: {launches}")

    pos, vel, ids = (f.data for f in seg.fields)
    for out in (fused, generic):
        d = (out.fields[0].data.double() - pos.double()).abs()
        d = torch.minimum(d, BOX - d)
        dv = (out.fields[1].data.double() - vel.double()).abs()
        if d.max().item() > POS_DELTA or dv.max().item() > VEL_DELTA:
            raise AssertionError(f"error bound broken: position "
                                 f"{d.max().item()}, velocity "
                                 f"{dv.max().item()}")
        if not torch.equal(out.fields[2].data, ids):
            raise AssertionError("IDs did not come back exactly")
    log(f"phase 4: max position error {d.max().item():.6g} <= {POS_DELTA}, "
        f"max velocity error {dv.max().item():.6g} <= {VEL_DELTA}, "
        "IDs exact")
    for a, b in zip(fused.fields, generic.fields):
        if not torch.equal(bits(a.data), bits(b.data)):
            raise AssertionError("fused decode != generic decode")
    if len(blob) >= raw:
        raise AssertionError("compressed segment is not smaller than raw")
    if launches["K1"] < 6 or launches["K4"] < 9:
        raise AssertionError(f"main path missed a kernel: {launches}")
    log("phase 4: fused == generic bitwise; compressed < raw; "
        "K1 >= 6 and K4 >= 9 launches")
    return seg, launches


def time_kernels(mt, seg, dev):
    """Each kernel against its plain version at the main path's shapes:
    the first position plane's bins (n = 2^24, its depth)."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda
    from minnow_c_tpu_torch.quant import engine
    qf = engine.quantize(seg.fields[0], seed=SEED)
    width, n = qf.quant.depth, qf.data.shape[1]
    bins = qf.data[0].contiguous()
    words = encode_cuda.pack_cuda(bins, width)
    key, x0, dx = (1, 2), 0.25, 63.5
    dx_bin = np.float32(dx) / np.float32(2.0 ** width)

    def k1():
        return decode_cuda.decode_cuda(words, key, width, n, x0, dx, BOX,
                                       True)

    def k1_plain():
        return decode_cuda.decode_plain(words, *key, x0, dx_bin, BOX, n,
                                        width, 0, True)

    def k4():
        return encode_cuda.pack_cuda(bins, width)

    def k4_plain():
        return encode_cuda.pack_plain(bins, width)

    err1 = max_abs_err(k1(), k1_plain())
    err4 = max_abs_err(k4(), k4_plain())
    if err1 or err4:
        raise AssertionError(f"kernel != plain at full size: {err1}, {err4}")
    # the decode's float work: grain and bin builds, bin + u, the FMA (2),
    # the rewrap's compare and add: 7 an element
    note_work("K1", [words], [k1()], 7.0 * n)
    note_work("K4", [bins], [words])
    t = {name: cuda_ms(fn) for name, fn in
         (("K1", k1), ("K1 plain", k1_plain), ("K4", k4),
          ("K4 plain", k4_plain))}
    for k in ("K1", "K4"):
        log(f"phase 4: {k} at width {width}, n {n}: {t[k]:.4f} ms, plain "
            f"torch {t[k + ' plain']:.4f} ms (CUDA events, median of 5)")
    return t, err1, err4


# ---------------------------------------------------------------------------
# Phase 5: the snapshot path at full size
# ---------------------------------------------------------------------------

def snapshot_fields(dev):
    """A 512^3 snapshot made on the card as in phase 4, plus masses uniform
    in [0.5, 2)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    n = SNAP_SIDE ** 3
    ids = torch.randperm(n, generator=g, device=dev)
    pos = torch.empty(3, n, device=dev)
    for d in range(3):  # one lattice axis at a time bounds the int64 temps
        lat = (ids // SNAP_SIDE ** d) % SNAP_SIDE
        pos[d] = (lat.to(torch.float32) + 0.5) * (BOX / SNAP_SIDE) + \
            0.5 * torch.randn(n, generator=g, device=dev)
    pos = torch.remainder(pos, BOX)
    pos = torch.where(pos >= BOX, pos - BOX, pos)
    vel = 300.0 * torch.randn(3, n, generator=g, device=dev)
    mass = 0.5 + 1.5 * torch.rand(n, generator=g, device=dev)
    return pos, vel, ids, mass


def reset_counts() -> None:
    for fn in launch_counted().values():
        fn.launches = 0


def launch_counted():
    from minnow_c_tpu_torch.bench import counts
    return counts.counters()


def snap_spec(mt):
    return mt.SnapshotSpec(
        pos=mt.PositionAccuracy(delta=POS_DELTA, width=BOX),
        vel=mt.VelocityAccuracy(delta=VEL_DELTA),
        ids=mt.IDAccuracy(width=SNAP_SIDE),
        mass=mt.FloatAccuracy(delta=MASS_DELTA))


def field_errors(label: str, out: dict, want: dict) -> dict:
    """Largest error of each float field of ``out`` against ``want``
    (periodic distance for positions), checked against its delta; IDs
    exact."""
    worst = {}
    for name, delta in (("pos", POS_DELTA), ("vel", VEL_DELTA),
                        ("mass", MASS_DELTA)):
        got, ref = out[name], want[name]
        err = 0.0
        for d in range(got.shape[0] if got.dim() == 2 else 1):
            a = (got[d] if got.dim() == 2 else got).double()
            b = (ref[d] if ref.dim() == 2 else ref).double()
            e = (a - b).abs()
            if name == "pos":
                e = torch.minimum(e, BOX - e)
            err = max(err, e.max().item())
        if not err <= delta:
            raise AssertionError(f"{label}: {name} error {err} > {delta}")
        worst[name] = err
    if not torch.equal(out["ids"], want["ids"]):
        raise AssertionError(f"{label}: IDs did not come back exactly")
    return worst


def check_snapshot_path(mt, dev):
    from minnow_c_tpu_torch.segment import io as seg_io
    pos, vel, ids, mass = snapshot_fields(dev)
    n = pos.shape[1]
    nb = n // SNAP_BLOCKS
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    spec = snap_spec(mt)
    torch.cuda.synchronize()

    reset_counts()
    buf = io.BytesIO()
    stats, t_enc, m_enc, b_enc = timed_busy(lambda: mt.compress_snapshot(
        buf, pos, vel, ids, spec, SNAP_BLOCKS, seed=SEED, mass=mass))
    blob = buf.getvalue()
    out, t_dec, m_dec, b_dec = timed_busy(lambda: mt.decompress_snapshot(
        io.BytesIO(blob), batched=True))
    launches = {k: fn.launches for k, fn in launch_counted().items()}

    for name, t, m, b in (("compress_snapshot", t_enc, m_enc, b_enc),
                          ("decompress_snapshot(batched)", t_dec, m_dec,
                           b_dec)):
        busy = "not measured" if b is None else \
            f"{b:.4f} s ({100 * b / t:.2f}%)"
        log(f"phase 5: {name}: {t:.4f} s wall, {raw / t / 1e9:.3f} GB/s of "
            f"raw f32/u64 bytes, peak device memory {m / 2**30:.3f} GiB, "
            f"device busy {busy} (torch.profiler)")
    log(f"phase 5: {n} particles in {SNAP_BLOCKS} blocks, {raw} raw bytes "
        f"-> {len(blob)} file bytes (ratio {raw / len(blob):.3f}); depths "
        f"{ {k: v for k, v in stats.items() if k not in ('bytes',)} }")
    log(f"phase 5: launches in the snapshot path: {launches}")

    worst = field_errors("phase 5", out, dict(pos=pos, vel=vel, ids=ids,
                                              mass=mass))
    log(f"phase 5: max errors {worst} within (pos {POS_DELTA}, vel "
        f"{VEL_DELTA}, mass {MASS_DELTA}); IDs exact")

    segs = [s for _, s in seg_io.iter_segments(io.BytesIO(blob))]
    for b in (0, SNAP_BLOCKS - 1):
        seg = mt.decompress_segment(segs[b], fused=True, device=dev)
        sl = slice(b * nb, (b + 1) * nb)
        for f, key in zip(seg.fields, ("pos", "vel", "ids", "mass")):
            want = out[key][..., sl]
            if not torch.equal(bits(f.data), bits(want)):
                raise AssertionError(f"phase 5: batched {key} of block {b} "
                                     "!= decompress_segment")
    if len(blob) >= raw:
        raise AssertionError("phase 5: file is not smaller than raw")
    floor = {"K2": 7, "K3": 3, "K6": 3, "K7": 6}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"snapshot path missed a kernel: {launches} "
                             f"(want at least {floor})")
    log(f"phase 5: blocks 0 and {SNAP_BLOCKS - 1} == decompress_segment "
        "bitwise; file < "
        f"raw; launches at least {floor}")
    del out, buf, blob, segs
    return (pos, vel, ids, mass, stats), launches


def time_rows_kernels(mt, data, dev):
    """K2, K3, K6 and K7 against their plain versions at the snapshot
    path's shapes: the 192 position rows of 2^21 (stats, pack), one
    dimension's 64 rows (decode) and one ID dimension's 64 rows
    (unpack)."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    from minnow_c_tpu_torch.parallel import snapshot as snap
    from minnow_c_tpu_torch.quant import engine
    pos, _, ids, _, stats = data
    B, nb = SNAP_BLOCKS, pos.shape[1] // SNAP_BLOCKS
    rows = pos.reshape(3, B, nb).transpose(0, 1).reshape(3 * B, nb)
    box = torch.full((3 * B,), BOX, device=dev)
    anchor = rows[:, 0].contiguous()
    depth = stats["pos_depth"]
    x0, rng = snap._batched_stats_pos(rows.reshape(B, 3, nb), BOX)
    bins = kernels.uniform_bin_index(
        kernels.undo_periodic(rows, BOX), depth, x0.reshape(-1, 1),
        rng.repeat_interleave(3)[:, None])
    words = encode_cuda.pack_rows_cuda(bins, depth).reshape(B, 3, -1)[:, 0]
    words = words.contiguous()
    keys = torch.tensor([1, 2], device=dev).expand(B, 2)
    x0d = x0[:, 0].contiguous()
    dxd = rng.contiguous()
    qd = engine.id_decompose(ids, SNAP_SIDE)[0][0].reshape(B, nb)
    wid = stats["id_widths"][0]
    id_words = encode_cuda.pack_rows_cuda(
        kernels.i64_to_u32(qd - qd.amin(dim=1, keepdim=True)), wid)

    fns = {
        "K6": (lambda: encode_cuda.stats_rows_cuda(rows, box, anchor, True),
               lambda: encode_cuda.stats_rows_plain(rows, box, anchor, True),
               f"rows {3 * B}, n {nb}"),
        "K7": (lambda: encode_cuda.pack_rows_cuda(bins, depth),
               lambda: encode_cuda.pack_rows_plain(bins, depth),
               f"rows {3 * B}, n {nb}, width {depth}"),
        "K2": (lambda: decode_cuda.decode_rows_cuda(
                   words, keys, depth, nb, x0d, dxd, BOX, True),
               lambda: decode_cuda.decode_rows_plain(
                   words, keys, x0d, dxd / 2.0 ** depth, BOX, nb, depth,
                   True),
               f"rows {B}, n {nb}, width {depth}"),
        "K3": (lambda: decode_cuda.unpack_rows_cuda(id_words, wid, nb),
               lambda: decode_cuda.unpack_rows_plain(id_words, wid, nb),
               f"rows {B}, n {nb}, width {wid}"),
    }
    times, errs = {}, {}
    for k, (fast, plain, shape) in fns.items():
        errs[k] = max_abs_err(fast(), plain()) if k != "K6" else max(
            max_abs_err(a, b) for a, b in zip(fast(), plain()))
        if errs[k]:
            raise AssertionError(f"{k} != plain at the snapshot's shapes")
        times[k] = cuda_ms(fast)
        times[k + " plain"] = cuda_ms(plain)
        log(f"phase 5: {k} at {shape}: {times[k]:.4f} ms, plain torch "
            f"{times[k + ' plain']:.4f} ms (CUDA events, median of 5)")
    note_work("K6", [rows, box, anchor], list(fns["K6"][0]()),
              6.0 * rows.numel())
    note_work("K7", [bins], [fns["K7"][0]()])
    note_work("K2", [words, keys.contiguous(), x0d, dxd], [fns["K2"][0]()],
              7.0 * B * nb)
    note_work("K3", [id_words], [fns["K3"][0]()])
    # the nearest library call to K6: the rows' min and max without the
    # unwrap (it also orders -0 and +0 otherwise)
    times["K6 library"] = cuda_ms(lambda: torch.aminmax(rows, dim=1))
    log(f"phase 5: torch.aminmax(rows, dim=1) beside K6: "
        f"{times['K6 library']:.4f} ms (nearest call, no unwrap, differs "
        "on +-0; CUDA events, median of 5)")
    # K6 on the velocity rows, which the writer does not unwrap
    vel = data[1].reshape(3, B, nb).transpose(0, 1).reshape(3 * B, nb)
    v_anchor = vel[:, 0].contiguous()
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip(
            encode_cuda.stats_rows_cuda(vel, box, v_anchor, False),
            encode_cuda.stats_rows_plain(vel, box, v_anchor, False))):
        raise AssertionError("K6 != plain on the velocity rows")
    times["K6 vel"] = cuda_ms(
        lambda: encode_cuda.stats_rows_cuda(vel, box, v_anchor, False))
    log(f"phase 5: K6 at the {3 * B} velocity rows (not periodic): "
        f"{times['K6 vel']:.4f} ms (CUDA events, median of 5)")
    del vel, v_anchor
    for k, kernel in (("K2", "decode_tiles"), ("K7", "pack_tiles"),
                      ("K3", "decode_tiles"), ("K6", "stats_rows")):
        times[k + " device"] = device_ms(fns[k][0], kernel)
        log(f"phase 5: {k} device time alone (torch.profiler, 5 calls): "
            f"{times[k + ' device']} ms against {times[k]:.4f} ms with its "
            "wrapper (CUDA events)")
    times["K2 widths"], times["K7 widths"], times["K3 widths"] = \
        time_rows_widths(stats, B, nb, {"K2": times["K2"],
                                        "K7": times["K7"]}, depth, dev)
    return times, errs


def time_rows_widths(stats, B: int, nb: int, at_depth: dict, depth: int,
                     dev):
    """K2 and K7 at every width the snapshot path decodes and packs:
    K2 over 64 rows of 2^21 at the velocity and mass depths, K7 over the
    192 velocity rows and the 64 mass and ID rows, on random bins; K3 over
    64 rows at 1, 9 (the ID rows'), 17 and 32 bits; each checked against
    its plain version, then timed (CUDA events, median of 5).
    ``at_depth`` holds the times at the position depth."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    k2 = {f"{depth} bits, {B} rows": at_depth["K2"]}
    k7 = {f"{depth} bits, {3 * B} rows": at_depth["K7"]}
    keys = torch.randint(0, 1 << 32, (B, 2), generator=g, device=dev)
    x0 = torch.rand(B, generator=g, device=dev)
    dx = torch.full((B,), 600.0, device=dev)
    for width in (stats["vel_depth"], stats["mass_depth"]):
        words = encode_cuda.pack_rows_cuda(u32_rows(B, nb, width, g, dev),
                                           width)
        fast = lambda: decode_cuda.decode_rows_cuda(  # noqa: E731
            words, keys, width, nb, x0, dx)
        want = decode_cuda.decode_rows_plain(
            words, keys, x0, kernels.bin_width(dx, width), 0.0, nb, width)
        if not torch.equal(bits(fast()), bits(want)):
            raise AssertionError(f"K2 != plain at width {width}")
        del want
        k2[f"{width} bits, {B} rows"] = cuda_ms(fast)
    for width, rows in ((stats["vel_depth"], 3 * B),
                        (stats["mass_depth"], B),
                        (stats["id_widths"][0], B)):
        vals = u32_rows(rows, nb, width, g, dev)
        if not torch.equal(encode_cuda.pack_rows_cuda(vals, width),
                           encode_cuda.pack_rows_plain(vals, width)):
            raise AssertionError(f"K7 != plain at width {width}")
        k7[f"{width} bits, {rows} rows"] = cuda_ms(
            lambda: encode_cuda.pack_rows_cuda(vals, width))
        del vals
    k3 = {}
    for width in (1, 9, 17, 32):
        words = encode_cuda.pack_rows_cuda(u32_rows(B, nb, width, g, dev),
                                           width)
        if not torch.equal(decode_cuda.unpack_rows_cuda(words, width, nb),
                           decode_cuda.unpack_rows_plain(words, width, nb)):
            raise AssertionError(f"K3 != plain at width {width}")
        k3[f"{width} bits, {B} rows"] = cuda_ms(
            lambda: decode_cuda.unpack_rows_cuda(words, width, nb))
        del words
    log(f"phase 5: K2 at n {nb} by width: "
        f"{ {k: round(v, 4) for k, v in k2.items()} } ms; K7 by width: "
        f"{ {k: round(v, 4) for k, v in k7.items()} } ms; K3 by width: "
        f"{ {k: round(v, 4) for k, v in k3.items()} } ms (CUDA events, "
        "median of 5)")
    return k2, k7, k3


# ---------------------------------------------------------------------------
# Phase 6: the delta path at full size
# ---------------------------------------------------------------------------

# codec, version, and the least launches each must make in one compress +
# fused + generic decode of the three fields (9 planes; Octo: 3 Morton
# planes)
DELTA_CODECS = (("Diff v1.0", "DIFF", (1, 0, 0), {"K9": 18, "K3": 6}),
                ("Coil v1.1", "COIL", (1, 1, 0), {"K10": 12, "K11": 6}),
                ("Octo v1.1", "OCTO", (1, 1, 0), {"K10": 6}))


def lagrangian_fields(mt, dev):
    """Phase 4's snapshot in Lagrangian (ID) order: IDs 0..n-1, the order
    in which neighbouring particles are close and the delta codecs pay
    off."""
    base = snapshot(mt, dev)
    pos, vel, ids = (f.data for f in base.fields)
    order = torch.argsort(ids)
    return pos[:, order].contiguous(), vel[:, order].contiguous(), ids[order]


def check_delta_path(mt, dev):
    pos, vel, ids = lagrangian_fields(mt, dev)
    n = ids.numel()
    raw = n * (3 * 4 + 3 * 4 + 8)
    if not torch.equal(ids, torch.arange(n, device=dev)):
        raise AssertionError("phase 6: IDs are not in Lagrangian order")
    launches = {}
    F = mt.FieldCode
    for label, algo, ver, floor in DELTA_CODECS:
        def hd(code):
            return mt.FieldHeader(code, getattr(mt.AlgoCode, algo),
                                  mt.semver.pack(*ver), n)

        seg = mt.Seg(fields=[
            mt.Field(hd=hd(F.POSN), data=pos,
                     acc=mt.PositionAccuracy(delta=POS_DELTA, width=BOX)),
            mt.Field(hd=hd(F.VELC), data=vel,
                     acc=mt.VelocityAccuracy(delta=VEL_DELTA)),
            mt.Field(hd=hd(F.PTID), data=ids,
                     acc=mt.IDAccuracy(width=SIDE))])
        torch.cuda.synchronize()
        reset_counts()
        blob, t_enc, m_enc = timed(lambda: mt.compress_segment(seg,
                                                               seed=SEED))
        fused, t_fus, m_fus = timed(
            lambda: mt.decompress_segment(blob, fused=True, device=dev))
        generic, t_gen, m_gen = timed(
            lambda: mt.decompress_segment(blob, fused=False, device=dev))
        counts = {k: fn.launches for k, fn in launch_counted().items()}
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v

        for name, t, m in (("encode", t_enc, m_enc),
                           ("decode fused", t_fus, m_fus),
                           ("decode generic", t_gen, m_gen)):
            log(f"phase 6: {label} {name}: {t:.4f} s wall, "
                f"{raw / t / 1e9:.3f} GB/s of raw f32/u64 bytes, peak "
                f"device memory {m / 2**30:.3f} GiB")
        log(f"phase 6: {label}: {n} particles, {raw} raw bytes -> "
            f"{len(blob)} compressed bytes (ratio {raw / len(blob):.3f}); "
            f"launches {counts}")
        for out in (fused, generic):
            d = (out.fields[0].data.double() - pos.double()).abs()
            d = torch.minimum(d, BOX - d)
            dv = (out.fields[1].data.double() - vel.double()).abs()
            if d.max().item() > POS_DELTA or dv.max().item() > VEL_DELTA:
                raise AssertionError(f"phase 6: {label} error bound broken: "
                                     f"position {d.max().item()}, velocity "
                                     f"{dv.max().item()}")
            if not torch.equal(out.fields[2].data, ids):
                raise AssertionError(f"phase 6: {label} IDs did not come "
                                     "back exactly")
        for a, b in zip(fused.fields, generic.fields):
            if not torch.equal(bits(a.data), bits(b.data)):
                raise AssertionError(f"phase 6: {label} fused != generic")
        if len(blob) >= raw:
            raise AssertionError(f"phase 6: {label} is not smaller than raw")
        if any(counts[k] < v for k, v in floor.items()):
            raise AssertionError(f"phase 6: {label} missed a kernel: "
                                 f"{counts} (want at least {floor})")
        log(f"phase 6: {label}: max position error {d.max().item():.6g} <= "
            f"{POS_DELTA}, max velocity error {dv.max().item():.6g} <= "
            f"{VEL_DELTA}, IDs exact, fused == generic bitwise, launches at "
            f"least {floor}")
        del seg, blob, fused, generic, d, dv
    if not all(launches[k] > 0 for k in ("K9", "K10", "K11")):
        raise AssertionError(f"phase 6 missed a delta kernel: {launches}")
    return (pos, vel, ids), launches


def time_delta_kernels(mt, data, dev):
    """K9, K10 and K11 against their plain versions at the delta path's
    shapes: one position plane of 2^24 bins (K9 over its deltas, as Diff
    decodes it; K10 and K11 over its Coil v1.1 payload of 1024 chunks)."""
    from minnow_c_tpu_torch.algos import algo_coil_v1_1 as c11
    from minnow_c_tpu_torch.ops import chunked_cuda, kernels, scan_cuda
    from minnow_c_tpu_torch.quant import engine
    pos = data[0]
    n = pos.shape[1]
    hd = mt.FieldHeader(mt.FieldCode.POSN, mt.AlgoCode.COIL,
                        mt.semver.pack(1, 1, 0), n)
    qf = engine.quantize(mt.Field(hd=hd, data=pos, acc=mt.PositionAccuracy(
        delta=POS_DELTA, width=BOX)), seed=SEED)
    depth = qf.quant.depth
    bins = qf.data[0].contiguous()
    deltas = kernels.u32_unzigzag(kernels.u32_delta_zigzag(bins))
    first, chunk, widths, body = c11._parse(
        c11.CoilV1_1()._encode_plane(bins, depth)[0])
    body = torch.from_numpy(body.astype(np.uint32).view(np.int32)).to(dev)
    plane = (widths, first, chunk, n, depth)
    k10, k11 = chunked_calls(body, *plane)
    fns = {
        "K9": (lambda: scan_cuda.cumsum_u32(deltas),
               lambda: scan_cuda.cumsum_u32_plain(deltas), f"n {n}"),
        "K10": (*k10, f"{widths.size} chunks of {chunk}, widths "
                f"{int(widths.min())}-{int(widths.max())} (mean "
                f"{float(widths.mean()):.2f}), {body.numel()} words"),
        "K11": (*k11, f"the same plane, depth {depth}, periodic"),
    }
    if not torch.equal(fns["K9"][0](), bins) or \
            not torch.equal(fns["K10"][0](), bins):
        raise AssertionError("phase 6: K9 / K10 do not give the bins back")
    times, errs = {}, {}
    for k, (fast, plain, shape) in fns.items():
        errs[k] = max_abs_err(fast(), plain())
        if errs[k]:
            raise AssertionError(f"{k} != plain at the delta path's shapes")
        times[k] = cuda_ms(fast)
        times[k + " plain"] = cuda_ms(plain)
        log(f"phase 6: {k} at {shape}: {times[k]:.4f} ms, plain torch "
            f"{times[k + ' plain']:.4f} ms (CUDA events, median of 5)")
    table = torch.from_numpy(np.asarray(widths, np.uint8))
    note_work("K9", [deltas], [bins])
    note_work("K10", [body, table], [bins])
    note_work("K11", [body, table], [fns["K11"][0]()], 7.0 * n)
    # the library's prefix sum on the same deltas: int32 sums wrap as the
    # u32 scan's do
    times["K9 library"] = cuda_ms(
        lambda: torch.cumsum(deltas, 0, dtype=torch.int32))
    log(f"phase 6: torch.cumsum(deltas, 0, dtype=torch.int32) beside K9: "
        f"{times['K9 library']:.4f} ms (CUDA events, median of 5)")
    return times, errs, deltas, body, plane


def chunked_calls(body, widths, first, chunk, n, depth):
    """((K10, its plain version), (K11, its plain version)) on one chunked
    plane: K10 with un-zigzag and prefix, K11 periodic."""
    from minnow_c_tpu_torch.ops import chunked_cuda
    fargs = (body, widths, first, chunk, n, (1, 2), depth, 0.25, 63.5, BOX,
             True)
    return ((lambda: chunked_cuda.decode_chunked_stream(body, widths, first,
                                                        chunk, n),
             lambda: chunked_cuda.decode_chunked_stream_plain(
                 body, widths, first, chunk, n)),
            (lambda: chunked_cuda.decode_chunked_stream_floats(*fargs),
             lambda: chunked_cuda.decode_chunked_stream_floats_plain(
                 *fargs)))


# ---------------------------------------------------------------------------
# Phase 9: the Sort and Cart codecs at full size
# ---------------------------------------------------------------------------

# codec, version, and the least launches each must make in one compress +
# decode of the three fields (9 planes)
SORT_CODECS = (("Sort v1.0", "SORT", (1, 0, 0),
                {"K7": 9, "K4": 9, "K3": 9, "K9": 9}),
               ("Sort v1.1", "SORT", (1, 1, 0),
                {"K7": 18, "K3": 18, "K9": 18}),
               ("Sort v1.2", "SORT", (1, 2, 0), {"K7": 18, "K10": 18}),
               ("Cart v1.0", "CART", (1, 0, 0), {"K4": 9}))
ORDER_FREE = (1, 2, 1)
CUT = 1 << 21          # phase 9(c): reaches Sort v1.2's 16384-element chunks


def median_walls(fn, reps: int = 3):
    """(first result, median wall seconds, largest peak memory) of ``reps``
    calls of ``fn``, each timed as ``timed`` times it."""
    runs = [timed(fn) for _ in range(reps)]
    return (runs[0][0], float(np.median([r[1] for r in runs])),
            max(r[2] for r in runs))


def counts() -> dict:
    return {k: fn.launches for k, fn in launch_counted().items()}


def three_fields(mt, data, algo: str, ver, n=None):
    """Phase 6's position, velocity and ID fields (the first ``n``
    particles) as one segment under ``algo`` at version ``ver``."""
    pos, vel, ids = data
    n = ids.numel() if n is None else n
    F = mt.FieldCode

    def hd(code):
        return mt.FieldHeader(code, getattr(mt.AlgoCode, algo),
                              mt.semver.pack(*ver), n)

    return mt.Seg(fields=[
        mt.Field(hd=hd(F.POSN), data=pos[:, :n],
                 acc=mt.PositionAccuracy(delta=POS_DELTA, width=BOX)),
        mt.Field(hd=hd(F.VELC), data=vel[:, :n],
                 acc=mt.VelocityAccuracy(delta=VEL_DELTA)),
        mt.Field(hd=hd(F.PTID), data=ids[:n],
                 acc=mt.IDAccuracy(width=SIDE))])


def scalar_fields(mt, perm, x):
    """(b)'s order-free segments: an UNSI field of permuted IDs and an UNSF
    field, each on its own, at Sort v1.2.1."""
    def seg(code, data, acc):
        hd = mt.FieldHeader(code, mt.AlgoCode.SORT,
                            mt.semver.pack(*ORDER_FREE), data.numel())
        return mt.Seg(fields=[mt.Field(hd=hd, data=data, acc=acc)])
    return (("UNSI", seg(mt.FieldCode.UNSI, perm, mt.IntAccuracy())),
            ("UNSF", seg(mt.FieldCode.UNSF, x,
                         mt.FloatAccuracy(delta=VEL_DELTA))))


def check_sort_path(mt, data, dev):
    """(a) Sort v1.0, v1.1, v1.2 and Cart v1.0 round trips of phase 6's
    2^24-particle segment, and (b) the order-free profile on a 2^24 UNSI
    field of permuted IDs and an UNSF field, on CUDA: bounds, exact IDs,
    walls (median of 3), ratios beside Trim's and Coil v1.1's, launch
    counts.  Returns the launches of (a) + (b)."""
    pos, vel, ids = data
    n = ids.numel()
    raw = n * (3 * 4 + 3 * 4 + 8)
    sizes = {label: len(mt.compress_segment(three_fields(mt, data, algo, v),
                                            seed=SEED))
             for label, algo, v in (("Trim v1.0", "TRIM", (1, 0, 0)),
                                    ("Coil v1.1", "COIL", (1, 1, 0)))}
    torch.cuda.synchronize()
    reset_counts()
    launches = {k: 0 for k in launch_counted()}
    for label, algo, ver, floor in SORT_CODECS:
        seg = three_fields(mt, data, algo, ver)
        before = counts()
        blob, t_enc, m_enc = median_walls(
            lambda: mt.compress_segment(seg, seed=SEED))
        out, t_dec, m_dec = median_walls(
            lambda: mt.decompress_segment(blob, device=dev))
        runs = {k: v - before[k] for k, v in counts().items()}
        d = (out.fields[0].data.double() - pos.double()).abs()
        d = torch.minimum(d, BOX - d).max().item()
        dv = (out.fields[1].data.double() - vel.double()).abs().max().item()
        if d > POS_DELTA or dv > VEL_DELTA or \
                not torch.equal(out.fields[2].data, ids):
            raise AssertionError(f"phase 9(a): {label}: position error {d}, "
                                 f"velocity error {dv}, or IDs not exact")
        if any(runs[k] < 3 * v for k, v in floor.items()):
            raise AssertionError(f"phase 9(a): {label} missed a kernel: "
                                 f"{runs} (want at least 3 x {floor})")
        sizes[label] = len(blob)
        log(f"phase 9(a): {label}: encode {t_enc:.4f} s, decode {t_dec:.4f} "
            f"s wall (median of 3; {raw / t_enc / 1e9:.3f} and "
            f"{raw / t_dec / 1e9:.3f} GB/s of raw f32/u64 bytes), peak "
            f"device memory {max(m_enc, m_dec) / 2**30:.3f} GiB; {n} "
            f"particles, {raw} raw bytes -> {len(blob)} (ratio "
            f"{raw / len(blob):.3f}; Trim v1.0 {raw / sizes['Trim v1.0']:.3f}"
            f", Coil v1.1 {raw / sizes['Coil v1.1']:.3f}); max position "
            f"error {d:.6g} <= {POS_DELTA}, velocity {dv:.6g} <= "
            f"{VEL_DELTA}, IDs exact; launches in 3 + 3 runs {runs}")
        del seg, blob, out
    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    perm = torch.randperm(n, generator=g, device=dev) + 3
    for label, seg in scalar_fields(mt, perm, vel[0]):
        x = seg.fields[0].data
        blob, t_enc, m_enc = median_walls(
            lambda: mt.compress_segment(seg, seed=SEED))
        out, t_dec, m_dec = median_walls(
            lambda: mt.decompress_segment(blob, device=dev))
        got = out.fields[0].data
        if label == "UNSI":
            err = 0.0
            if not torch.equal(got, torch.arange(n, device=dev) + 3):
                raise AssertionError("phase 9(b): order-free UNSI decode != "
                                     "the sorted input")
        else:
            err = (got.double() - torch.sort(x).values.double()).abs()
            err = err.max().item()
            if err > VEL_DELTA:
                raise AssertionError(f"phase 9(b): order-free UNSF error "
                                     f"{err} > {VEL_DELTA}")
        fraw = n * x.element_size()
        log(f"phase 9(b): order-free {label} of {n}: encode {t_enc:.4f} s, "
            f"decode {t_dec:.4f} s wall (median of 3), peak device memory "
            f"{max(m_enc, m_dec) / 2**30:.3f} GiB; {fraw} raw bytes -> "
            f"{len(blob)} (ratio {fraw / len(blob):.3f}); decode == the "
            f"sorted input " + ("bitwise" if label == "UNSI" else
                                f"within {err:.6g} <= {VEL_DELTA}"))
        del blob, out
    launches = counts()
    log(f"phase 9: launches on its path ((a) + (b)): {launches}")
    if not all(launches[k] > 0 for k in ("K3", "K4", "K7", "K9", "K10")):
        raise AssertionError(f"phase 9 missed a kernel: {launches}")
    return launches, perm


def check_sort_cut(mt, data, perm) -> None:
    """(c) Each codec's bytes from the card equal the port's CPU bytes on
    the first 2^21 particles (Sort v1.2 at 16384-element chunks), and the
    order-free profile's on 2^21 of (b)'s fields."""
    cut = [t[..., :CUT].contiguous() for t in data]
    cases = [(label, three_fields(mt, cut, algo, ver))
             for label, algo, ver, _ in SORT_CODECS]
    cases += [(f"order-free {k}", s)
              for k, s in scalar_fields(mt, perm[:CUT], data[1][0, :CUT])]
    for label, seg in cases:
        on_card = mt.compress_segment(seg, seed=SEED)
        for f in seg.fields:
            f.data = f.data.cpu()
        if on_card != mt.compress_segment(seg, seed=SEED, device="cpu"):
            raise AssertionError(f"phase 9(c): {label}: card bytes != CPU "
                                 f"bytes at {CUT} particles")
        log(f"phase 9(c): {label}: {len(on_card)} bytes from the card == "
            f"the CPU's at {CUT} particles")


def check_sort_kernels(mt, data, dev) -> dict:
    """(d) The path's kernels against their plain versions, bitwise, at its
    shapes, on one position plane of 2^24 bins: K9 on Sort v1.0's delta
    stream, K7 and K3 on its width buckets, K4 on Sort v1.0's rank stream
    and on Cart's plane, K10 on Sort v1.2's sorted-delta stream (no
    un-zigzag) and rank stream (un-zigzag); CUDA-event times beside them,
    the un-permute gather alone and Cart's decode in its three steps.
    Returns each kernel's largest error."""
    from minnow_c_tpu_torch.algos import algo_sort_v1_0 as s10
    from minnow_c_tpu_torch.algos import algo_sort_v1_2 as s12
    from minnow_c_tpu_torch.algos import algo_cart_v1_0 as c10
    from minnow_c_tpu_torch.algos import chunked
    from minnow_c_tpu_torch.ops import (bitpack, chunked_cuda, decode_cuda,
                                        encode_cuda, kernels, scan_cuda)
    from minnow_c_tpu_torch.quant import engine
    pos = data[0]
    n = pos.shape[1]
    hd = mt.FieldHeader(mt.FieldCode.POSN, mt.AlgoCode.SORT,
                        mt.semver.pack(1, 0, 0), n)
    qf = engine.quantize(mt.Field(hd=hd, data=pos, acc=mt.PositionAccuracy(
        delta=POS_DELTA, width=BOX)), seed=SEED)
    depth = qf.quant.depth
    bins = qf.data[0].contiguous()
    del qf
    order, first, deltas = s10.sort_plane(bins)
    ranks = s10.ranks_of(order)
    sorted_vals = bins[order]
    rank_width = s10._bits_for(n - 1)
    errs, times = {}, {}

    def same(k, fast, plain, where, want=None):
        got, ref = fast(), plain()
        if not torch.equal(bits(got), bits(ref)) or \
                (want is not None and not torch.equal(got, want)):
            raise AssertionError(f"phase 9(d): {k} != plain {where}")
        errs[k] = max(errs.get(k, 0.0), max_abs_err(got, ref))
        t, tp = cuda_ms(fast), cuda_ms(plain)
        times[f"{k} {where}"] = (t, tp)
        log(f"phase 9(d): {k} {where}: {t:.4f} ms, plain torch {tp:.4f} ms "
            "(CUDA events, median of 5); == plain bitwise")

    d = deltas.clone()
    d[0] = first
    same("K9", lambda: scan_cuda.cumsum_u32(d),
         lambda: scan_cuda.cumsum_u32_plain(d),
         f"on Sort v1.0's delta stream of {n}", sorted_vals)
    zc, widths = chunked.chunk_widths_device(deltas)
    for wv in (int(w) for w in np.unique(widths) if w):
        rows = zc[torch.from_numpy(np.nonzero(widths == wv)[0]).to(dev)]
        where = f"on its chunk rows {tuple(rows.shape)} at {wv} bits"
        same("K7", lambda: encode_cuda.pack_rows_cuda(rows, wv),
             lambda: encode_cuda.pack_rows_plain(rows, wv), where)
        words = encode_cuda.pack_rows_cuda(rows, wv)
        same("K3", lambda: decode_cuda.unpack_rows_cuda(words, wv, 256),
             lambda: decode_cuda.unpack_rows_plain(words, wv, 256), where,
             rows)
    same("K4", lambda: encode_cuda.pack_cuda(ranks, rank_width),
         lambda: encode_cuda.pack_plain(ranks, rank_width),
         f"on Sort v1.0's rank stream at {rank_width} bits")
    same("K4", lambda: encode_cuda.pack_cuda(bins, depth),
         lambda: encode_cuda.pack_plain(bins, depth),
         f"on Cart's plane at {depth} bits")
    rz = kernels.u32_delta_zigzag(ranks)
    rz[0] = 0
    for label, z, start, zz, want in (
            ("sorted-delta", deltas, first, False, sorted_vals),
            ("rank", rz, int(ranks[0]), True, ranks)):
        w, body = s12.encode_chunked(z, s12.KERNEL_CHUNK)
        body = torch.from_numpy(np.frombuffer(body, np.uint32).view(
            np.int32).copy()).to(dev)
        same("K10", lambda: chunked_cuda.decode_chunked_stream(
            body, w, start, s12.KERNEL_CHUNK, n, zigzag=zz),
            lambda: chunked_cuda.decode_chunked_stream_plain(
                body, w, start, s12.KERNEL_CHUNK, n, zigzag=zz),
            f"on Sort v1.2's {label} stream ({w.size} chunks, zigzag={zz})",
            want)
    if not torch.equal(s10.unpermute(sorted_vals, ranks), bins):
        raise AssertionError("phase 9(d): the un-permute gather != the bins")
    gather = cuda_ms(lambda: s10.unpermute(sorted_vals, ranks))
    words = encode_cuda.pack_cuda(bins, depth)
    body = c10.transpose_delta(words)
    und = kernels.u8_undo_delta_encode(body)
    if not torch.equal(kernels.u32_undo_transpose_bytes(und), words):
        raise AssertionError("phase 9(d): Cart's undo != its packed words")
    split = [cuda_ms(lambda: kernels.u8_undo_delta_encode(body)),
             cuda_ms(lambda: kernels.u32_undo_transpose_bytes(und)),
             cuda_ms(lambda: bitpack.uniform_unpack(words, depth, n))]
    log(f"phase 9(d): the ranked un-permute gather of {n} u32 bins: "
        f"{gather:.4f} ms; Cart's decode of one plane ({words.numel()} "
        f"words at {depth} bits): undo-delta {split[0]:.4f} ms, "
        f"undo-transpose {split[1]:.4f} ms, unpack {split[2]:.4f} ms (CUDA "
        "events, median of 5)")
    return errs


# ---------------------------------------------------------------------------
# Phase 7: the recip scale mode at full size
# ---------------------------------------------------------------------------

def report(label: str, raw: int, *runs) -> None:
    for name, t, m in runs:
        log(f"{label}: {name}: {t:.4f} s wall, {raw / t / 1e9:.3f} GB/s of "
            f"raw f32/u64 bytes, peak device memory {m / 2**30:.3f} GiB")


def check_recip_snapshot(mt, data, dev):
    """(a) Phase 5's snapshot in the recip mode: K6 stats, then one K8
    launch per float field over its 64 * D rows."""
    pos, vel, ids, mass, div_stats = data
    n = pos.shape[1]
    nb = n // SNAP_BLOCKS
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    torch.cuda.synchronize()
    reset_counts()
    buf = io.BytesIO()
    stats, t_enc, m_enc = timed(lambda: mt.compress_snapshot(
        buf, pos, vel, ids, snap_spec(mt), SNAP_BLOCKS, seed=SEED,
        scale_mode="recip", mass=mass))
    blob = buf.getvalue()
    out, t_dec, m_dec = timed(lambda: mt.decompress_snapshot(
        io.BytesIO(blob), batched=True, device=dev))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    report("phase 7(a)", raw, ("compress_snapshot(recip)", t_enc, m_enc),
           ("decompress_snapshot(batched)", t_dec, m_dec))
    div_bytes = div_stats["bytes"]
    log(f"phase 7(a): {len(blob)} file bytes (ratio {raw / len(blob):.3f}); "
        f"phase 5's div file {div_bytes} bytes; depths "
        f"{ {k: v for k, v in stats.items() if k != 'bytes'} }")
    log(f"phase 7(a): launches in the recip snapshot path: {launches}")
    worst = field_errors("phase 7(a)", out, dict(pos=pos, vel=vel, ids=ids,
                                                 mass=mass))
    if abs(len(blob) - div_bytes) > max(64, div_bytes // 1000):
        raise AssertionError(f"phase 7(a): recip file {len(blob)} bytes vs "
                             f"div {div_bytes}")
    floor = {"K6": 3, "K7": 3, "K8": 3, "K2": 7, "K3": 3}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 7(a) missed a kernel: {launches} "
                             f"(want at least {floor})")
    log(f"phase 7(a): max errors {worst}; IDs exact; file within "
        f"max(64, bytes // 1000) of the div file; launches at least {floor}")
    keep = {k: v[..., :STREAM_BLOCKS * nb].clone() for k, v in out.items()}
    return stats, keep, blob, launches


def check_streaming(mt, data, stats_a, keep, blob_a, dev):
    """(b) The first STREAM_BLOCKS blocks through the streaming writer at
    (a)'s depths: the same decoded values, bitwise."""
    from minnow_c_tpu_torch.segment import io as seg_io
    pos, vel, ids, mass, _ = data
    nb = pos.shape[1] // SNAP_BLOCKS
    n = STREAM_BLOCKS * nb
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    depths = {k: stats_a[f"{k}_depth"] for k in ("pos", "vel", "mass")}

    def blocks():
        for b in range(STREAM_BLOCKS):
            sl = slice(b * nb, (b + 1) * nb)
            yield {"pos": pos[:, sl], "vel": vel[:, sl], "ids": ids[sl],
                   "mass": mass[sl]}

    torch.cuda.synchronize()
    reset_counts()
    buf = io.BytesIO()
    _, t_enc, m_enc = timed(lambda: mt.compress_snapshot_streaming(
        buf, blocks(), snap_spec(mt), seed=SEED, depths=depths,
        scale_mode="recip"))
    out, t_dec, m_dec = timed(lambda: mt.decompress_snapshot(
        io.BytesIO(buf.getvalue()), batched=True, device=dev))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    report("phase 7(b)", raw, ("compress_snapshot_streaming", t_enc, m_enc),
           ("decompress_snapshot", t_dec, m_dec))
    log(f"phase 7(b): launches in the streaming path: {launches}")
    for k in ("pos", "vel", "mass"):
        if not torch.equal(bits(out[k]), bits(keep[k])):
            raise AssertionError(f"phase 7(b): streaming {k} != (a)'s decode")
    if not torch.equal(out["ids"], ids[:n]):
        raise AssertionError("phase 7(b): IDs did not come back exactly")
    if launches["K8"] < 3 * STREAM_BLOCKS:
        raise AssertionError(f"phase 7(b) missed K8: {launches}")
    segs = [sg for _, sg in seg_io.iter_segments(io.BytesIO(buf.getvalue()))]
    segs_a = [sg for _, sg in seg_io.iter_segments(io.BytesIO(blob_a))]
    same = sum(a == b for a, b in zip(segs, segs_a))
    log(f"phase 7(b): {STREAM_BLOCKS} blocks at depths {depths}: pos, vel, "
        f"mass == (a)'s decode bitwise, IDs exact; {same} of "
        f"{STREAM_BLOCKS} segments byte-identical to (a)'s")
    return launches


def cli_snapshot(dev):
    """A CLI_SIDE^3 snapshot made on the card as phase 4's, as host arrays:
    positions, velocities, IDs (u64)."""
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    n = CLI_SIDE ** 3
    ids = torch.randperm(n, generator=g, device=dev)
    pos = torch.empty(3, n, device=dev)
    for d in range(3):
        lat = (ids // CLI_SIDE ** d) % CLI_SIDE
        pos[d] = (lat.to(torch.float32) + 0.5) * (BOX / CLI_SIDE) + \
            0.5 * torch.randn(n, generator=g, device=dev)
    pos = torch.remainder(pos, BOX)
    pos = torch.where(pos >= BOX, pos - BOX, pos)
    vel = 300.0 * torch.randn(3, n, generator=g, device=dev)
    return (pos.cpu().numpy(), vel.cpu().numpy(),
            ids.cpu().numpy().astype(np.uint64))


def check_cli(dev):
    """(c) A Gadget-2 file through the CLI on the card: compress (recip),
    info, verify, decompress; read back with read_snapshot."""
    from minnow_c_tpu_torch import __main__ as cli
    from minnow_c_tpu_torch.drivers import gadget2
    pos, vel, ids = cli_snapshot(dev)
    n = ids.size
    hdr = gadget2.Gadget2Header(
        npart=(0, n, 0, 0, 0, 0), mass=(0.0, 1.0, 0.0, 0.0, 0.0, 0.0),
        time=1.0, redshift=0.0, box_size=BOX, omega0=0.3, omega_lambda=0.7,
        hubble_param=0.7)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst, back = (os.path.join(tmp, f)
                          for f in ("snap.g2", "snap.g2.min", "back.g2"))
        with open(src, "wb") as f:
            gadget2.write_snapshot(f, hdr, pos, vel, ids)
        raw = os.path.getsize(src)
        torch.cuda.synchronize()
        reset_counts()
        walls = {}
        for name, argv in (
                ("compress", ["compress", src, dst, "--scale-mode", "recip",
                              "--device", dev.type]),
                ("info", ["info", dst]), ("verify", ["verify", dst]),
                ("decompress", ["decompress", dst, back, "--device",
                                dev.type])):
            t = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"phase 7(c): {name} exited {rc}")
        launches = {k: fn.launches for k, fn in launch_counted().items()}
        size = os.path.getsize(dst)
        with open(back, "rb") as f:
            _, p2, v2, i2 = gadget2.read_snapshot(f)
    e = np.abs(p2.astype(np.float64) - pos)
    ep = float(np.minimum(e, BOX - e).max())
    ev = float(np.abs(v2.astype(np.float64) - vel).max())
    log(f"phase 7(c): {n} particles, Gadget-2 file {raw} bytes -> {size} "
        f"bytes (ratio {raw / size:.3f}); walls "
        f"{ {k: round(v, 4) for k, v in walls.items()} } s; compress "
        f"{raw / walls['compress'] / 1e9:.3f} GB/s, decompress "
        f"{raw / walls['decompress'] / 1e9:.3f} GB/s of the Gadget-2 file")
    log(f"phase 7(c): launches in the CLI path: {launches}")
    if ep > POS_DELTA or ev > VEL_DELTA or not np.array_equal(i2, ids):
        raise AssertionError(f"phase 7(c): position error {ep}, velocity "
                             f"error {ev}, or IDs not exact")
    floor = {"K5": 12, "K4": 6, "K1": 12}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 7(c) missed a kernel: {launches} "
                             f"(want at least {floor})")
    log(f"phase 7(c): max position error {ep:.6g} <= {POS_DELTA}, velocity "
        f"{ev:.6g} <= {VEL_DELTA}, IDs exact; launches at least {floor}")
    return launches, check_cli_kernels(pos, ids, p2, dev)


def check_cli_kernels(pos, ids, p2, dev, blocks: int = 2) -> dict:
    """(c) K5, K4 and K1 against their plain versions, bitwise, at the CLI
    path's ragged row length: block 0 of the snapshot (``blocks`` blocks,
    as ``gadget2.compress`` picks them), with x0, recip, anchor, depths, dither key and bin
    width derived as the writer and the reader derive them.  K1's decode
    of K5's words must also equal the CLI's decoded x positions of the
    block."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    from minnow_c_tpu_torch.ops import rng as _rng
    from minnow_c_tpu_torch.parallel import snapshot as snap
    from minnow_c_tpu_torch.quant import engine
    nb = ids.size // blocks
    xb = torch.from_numpy(pos).to(dev).reshape(3, blocks, nb).transpose(
        0, 1).contiguous()
    x0, rng_b = snap._batched_stats_pos(xb, BOX)
    depth = engine.delta_to_depth(POS_DELTA, 0.0, float(rng_b.max()))
    x0_h, rng_h = x0.cpu().numpy(), rng_b.cpu().numpy()
    row = xb[0, 0]
    args = (depth, x0_h[0, 0], kernels.exact_recip(rng_h[0]), BOX,
            row[0].item(), True)
    errs = {}
    words = encode_cuda.encode_recip_cuda(row, *args)
    errs["K5"] = max_abs_err(words, encode_cuda.encode_recip_plain(row,
                                                                   *args))
    # the reader's bin range: f32(x0 + max over dims of (x1 - x0)) - x0
    x1 = x0_h[0] + rng_h[0]
    md = np.float32(np.max(x1 - x0_h[0]))
    dx = np.float32(np.float64(x0_h[0, 0]) + md) - x0_h[0, 0]
    key = _rng.field_key(0, 0, 0)          # the CLI's seed 0, field 0, dim 0
    got = decode_cuda.decode_cuda(words, key, depth, nb, x0_h[0, 0], dx, BOX,
                                  True)
    want = decode_cuda.decode_plain(words, *key, np.float32(x0_h[0, 0]),
                                    kernels.bin_width(dx, depth),
                                    np.float32(BOX), nb, depth, 0, True)
    errs["K1"] = max_abs_err(got, want)
    cli_row = torch.from_numpy(np.ascontiguousarray(p2[0, :nb])).to(dev)
    if not torch.equal(bits(got), bits(cli_row)):
        raise AssertionError("phase 7(c): K1's decode of K5's words != the "
                             "CLI's decoded positions")
    qdims, _, _ = engine.id_decompose(
        torch.from_numpy(ids.astype(np.int64)).to(dev),
        int(np.ceil((float(ids.max()) + 1) ** (1 / 3))))   # gadget2's grid
    qd = qdims[0].reshape(blocks, nb)
    rel = qd - qd.amin(dim=1, keepdim=True)
    width = max(int(rel.max()).bit_length(), 1)
    id_row = kernels.i64_to_u32(rel[0])
    errs["K4"] = max_abs_err(encode_cuda.pack_cuda(id_row, width),
                             encode_cuda.pack_plain(id_row, width))
    if any(errs.values()):
        raise AssertionError(f"phase 7(c): a kernel != its plain version at "
                             f"n {nb}: {errs}")
    log(f"phase 7(c): at n {nb} (32 does not divide it): K5 at {depth} bits, "
        f"K1's decode of its words and K4 on the x ID row at {width} bits == "
        f"their plain versions bitwise; K1's decode == the CLI's decoded x "
        f"positions of block 0")
    return errs


def check_fast_recip(mt, dev):
    """(d) Phase 4's three position planes through
    fast_uniform_encode(scale_mode="recip"): one K5 launch each, words ==
    the plain version's, decode within the position bound; then (e) K5
    timed against its plain version on the first plane."""
    from minnow_c_tpu_torch.ops import encode_cuda, fastpath, kernels
    from minnow_c_tpu_torch.quant import engine
    pos = snapshot(mt, dev).fields[0].data
    n = pos.shape[1]
    level = engine.delta_to_depth(POS_DELTA, 0.0, BOX)
    torch.cuda.synchronize()
    reset_counts()
    enc = [fastpath.fast_uniform_encode(pos[d], level, periodic_width=BOX,
                                        scale_mode="recip")
           for d in range(3)]
    torch.cuda.synchronize()
    launches = encode_cuda.encode_recip_cuda.launches
    if launches != 3:
        raise AssertionError(f"phase 7(d): {launches} K5 launches, want 3")
    worst = 0.0
    for d, (words, x0, r) in enumerate(enc):
        x = pos[d]
        args = (level, x0.item(), kernels.exact_recip(r.item()), BOX,
                x[0].item(), True)
        if not torch.equal(words, encode_cuda.encode_recip_plain(x, *args)):
            raise AssertionError(f"phase 7(d): plane {d} K5 != plain")
        y = fastpath.fast_uniform_decode(words, (SEED, d), level, n,
                                         x0.item(), r.item(), BOX)
        e = (y.double() - x.double()).abs()
        worst = max(worst, torch.minimum(e, BOX - e).max().item())
    if worst > POS_DELTA:
        raise AssertionError(f"phase 7(d): position error {worst}")
    log(f"phase 7(d): 3 planes of {n} at {level} bits: K5 == plain bitwise, "
        f"max position error {worst:.6g} <= {POS_DELTA}; 3 K5 launches")
    x = pos[0]
    words, x0, r = enc[0]
    args = (level, x0.item(), kernels.exact_recip(r.item()), BOX,
            x[0].item(), True)
    bins = kernels.recip_scaled_bins(x, *args[1:5], level, True)
    if not torch.equal(encode_cuda.pack_cuda(bins, level), words):
        raise AssertionError("phase 7(e): K4 on the recip bins != K5")
    t = {"K5": cuda_ms(lambda: encode_cuda.encode_recip_cuda(x, *args)),
         "K5 plain": cuda_ms(lambda: encode_cuda.encode_recip_plain(x,
                                                                    *args)),
         "K5 K4": cuda_ms(lambda: encode_cuda.pack_cuda(bins, level))}
    log(f"phase 7(e): K5 at width {level}, n {n}: {t['K5']:.4f} ms, plain "
        f"torch {t['K5 plain']:.4f} ms; K4 packing the same bins "
        f"{t['K5 K4']:.4f} ms (CUDA events, median of 5)")
    # the recip map's float work: the unwrap's two subtractions and two
    # compares, (x - x0) * recip * 2^w, the clamp's compare: 8 an element
    note_work("K5", [x], [words], 8.0 * n)
    return t


def time_recip_rows(mt, data, dev):
    """(e) K8 and K12 at phase 5's position rows (64 blocks x 3 dims of
    2^21) against their plain versions; K12's one-pass encode (its launch
    counted) against the split CUDA path: K6, the host's exact recip, K8."""
    from minnow_c_tpu_torch.ops import encode_cuda, kernels
    pos = data[0]
    B, nb = SNAP_BLOCKS, pos.shape[1] // SNAP_BLOCKS
    width = 16
    x3 = pos.reshape(3, B, nb).transpose(0, 1).contiguous()   # (B, 3, nb)
    rows = x3.reshape(3 * B, nb)
    box = torch.full((3 * B,), BOX, device=dev)
    anchors = rows[:, 0].contiguous()

    def split():
        mn, mx = encode_cuda.stats_rows_cuda(rows, box, anchors, True)
        rng = kernels.ftz(mx - mn).reshape(B, 3).amax(dim=1)
        recip = torch.from_numpy(kernels.exact_recip(
            rng.cpu().numpy())).to(dev).repeat_interleave(3)
        words = encode_cuda.encode_recip_rows_cuda(rows, width, mn, recip,
                                                   box, anchors, True)
        return words.reshape(B, 3, -1), mn.reshape(B, 3), mx.reshape(B, 3)

    torch.cuda.synchronize()
    reset_counts()
    fused = encode_cuda.encode_recip_fused_blocks_cuda(
        x3, BOX, anchors.reshape(B, 3), width, True)
    torch.cuda.synchronize()
    k12_launches = encode_cuda.encode_recip_fused_blocks_cuda.launches
    ref = split()
    for a, b in zip(fused, ref):
        if not torch.equal(bits(a), bits(b)):
            raise AssertionError("phase 7(e): K12 != the split CUDA path")
    log(f"phase 7(e): K12's one-pass encode of phase 5's position blocks "
        f"({B}, 3, {nb}) == the split CUDA path (K6, host recip, K8) "
        f"bitwise; {k12_launches} K12 launch")
    x0 = ref[1].reshape(-1)
    recip = torch.from_numpy(kernels.exact_recip(kernels.ftz(
        ref[2] - ref[1]).amax(dim=1).cpu().numpy())).to(
            dev).repeat_interleave(3)
    k8_args = (width, x0, recip, box, anchors, True)
    k12_args = (BOX, anchors.reshape(B, 3), width, True)
    fns = {
        "K8": (lambda: encode_cuda.encode_recip_rows_cuda(rows, *k8_args),
               lambda: encode_cuda.encode_recip_rows_plain(rows, *k8_args),
               f"rows {3 * B}, n {nb}, width {width}"),
        "K12": (lambda: encode_cuda.encode_recip_fused_blocks_cuda(
                    x3, *k12_args),
                lambda: encode_cuda.encode_recip_fused_blocks_plain(
                    x3, *k12_args),
                f"blocks ({B}, 3, {nb}), width {width}"),
    }
    times, errs = {}, {}
    for k, (fast, plain, shape) in fns.items():
        got, want = fast(), plain()
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        errs[k] = max(max_abs_err(a, b) for a, b in zip(got, want))
        if errs[k]:
            raise AssertionError(f"{k} != plain at the snapshot's shapes")
        del got, want
        times[k] = cuda_ms(fast)
        times[k + " plain"] = cuda_ms(plain)
        log(f"phase 7(e): {k} at {shape}: {times[k]:.4f} ms, plain torch "
            f"{times[k + ' plain']:.4f} ms (CUDA events, median of 5)")
    note_work("K8", [rows, x0, recip, box, anchors],
              [fns["K8"][0]()], 8.0 * rows.numel())
    # K12 reads x once in this count (stats, then the encode, on the card
    # read it twice): the stats' 6 and the map's 8 float operations
    note_work("K12", [x3, anchors], list(fns["K12"][0]()),
              14.0 * x3.numel())
    times["K12 split"] = cuda_ms(split)
    log(f"phase 7(e): one-pass K12 {times['K12']:.4f} ms vs the split CUDA "
        f"path (K6, host recip, K8) {times['K12 split']:.4f} ms (CUDA "
        "events, median of 5)")
    times["K8 device"] = device_ms(fns["K8"][0], "pack_recip_tiles")
    log(f"phase 7(e): K8 device time alone (torch.profiler, 5 calls): "
        f"{times['K8 device']} ms against {times['K8']:.4f} ms with its "
        "wrapper (CUDA events)")
    times["K8 widths"] = time_recip_widths(rows, x0, recip, box, anchors)
    return times, errs, k12_launches


def time_recip_widths(rows, x0, recip, box, anchors) -> dict:
    """K8 at the recip write's shapes and widths (192 position rows of 2^21
    at 16 and 12 bits, 64 rows at 14), each beside K7 packing the same
    bins in the same run: K8 must equal K7 on the recip map's bins (the
    plain map), and each pair is timed in turns (K8, K7, K7, K8; CUDA
    events, median of 5 each)."""
    from minnow_c_tpu_torch.ops import encode_cuda, kernels
    out = {}
    for width, r in ((16, rows.shape[0]), (12, rows.shape[0]), (14, 64)):
        xs, s = rows[:r], (x0[:r], recip[:r], box[:r], anchors[:r])
        bins = kernels.recip_scaled_bins(xs, *(t[:, None] for t in s), width,
                                         True)

        def k8():
            return encode_cuda.encode_recip_rows_cuda(xs, width, *s, True)

        def k7():
            return encode_cuda.pack_rows_cuda(bins, width)

        if not torch.equal(k8(), k7()):
            raise AssertionError(f"K8 != K7 on the recip bins at width "
                                 f"{width}, {r} rows")
        t8a, t7a, t7b, t8b = (cuda_ms(f) for f in (k8, k7, k7, k8))
        out[f"{width} bits, {r} rows"] = {"K8": [t8a, t8b], "K7": [t7a, t7b]}
        del bins
    log(f"phase 7(e): K8 beside K7 on the same bins by width: {out} ms "
        "(CUDA events, median of 5, in turns)")
    return out


# ---------------------------------------------------------------------------
# Phase 8: per-particle accuracies and the log maps at full size
# ---------------------------------------------------------------------------

ZOOM_DELTAS = (1e-4, 1e-3, 1e-2)   # positions: first 1/8, next 3/8, rest
SYMLOG_T, VEL_LOG_DELTA = 20.0, 1e-3
MASS_LOG_DELTA = float(np.log10(1.0 + 1e-4))   # relative 1e-4
ENV_SLOPE, ENV_CONST = 8e-8, 1.2e-6            # the unmap's error envelope


def zoom_deltas(n: int) -> np.ndarray:
    """Per-particle position accuracies in contiguous runs, as a zoom
    run's particles sorted by type hold them."""
    d = np.full(n, ZOOM_DELTAS[2], np.float32)
    d[:n // 8] = ZOOM_DELTAS[0]
    d[n // 8:n // 2] = ZOOM_DELTAS[1]
    return d


def log_spec(mt, deltas):
    return mt.SnapshotSpec(
        pos=mt.PositionAccuracy(delta=0.0, width=BOX, deltas=deltas),
        vel=mt.VelocityAccuracy(delta=VEL_LOG_DELTA, sym_log10_scaled=2,
                                sym_log10_threshold=SYMLOG_T),
        ids=mt.IDAccuracy(width=SNAP_SIDE),
        mass=mt.FloatAccuracy(delta=MASS_LOG_DELTA, log10_scaled=1))


def symlog64(x: torch.Tensor) -> torch.Tensor:
    x = x.double()
    return torch.sign(x) * torch.log10(1.0 + x.abs() / SYMLOG_T)


def log_errors(label: str, out: dict, want: dict, deltas) -> dict:
    """Positions within their per-particle accuracy (periodic distance),
    velocities and masses within their mapped-space accuracy plus the
    unmap's envelope, IDs exact; returns each field's largest error over
    its bound."""
    worst = {}
    dl = torch.from_numpy(deltas).to(want["pos"].device).double()
    r = 0.0
    for d in range(3):
        e = (out["pos"][d].double() - want["pos"][d].double()).abs()
        r = max(r, (torch.minimum(e, BOX - e) / dl).max().item())
    worst["pos"] = r
    for name, fn, delta in (("vel", symlog64, VEL_LOG_DELTA),
                            ("mass", lambda x: torch.log10(x.double()),
                             MASS_LOG_DELTA)):
        ym = fn(want[name])
        err = (fn(out[name]) - ym).abs()
        worst[name] = (err / (delta + ENV_CONST + ENV_SLOPE * ym.abs())
                       ).max().item()
        del ym, err
    if not all(v <= 1.0 for v in worst.values()):
        raise AssertionError(f"{label}: error over its bound {worst}")
    if not torch.equal(out["ids"], want["ids"]):
        raise AssertionError(f"{label}: IDs did not come back exactly")
    return worst


def check_zoom_snapshot(mt, data, dev):
    """(a) Phase 5's snapshot with zoom-run position accuracies, symlog
    velocities and log10-mapped lognormal masses, in the recip scale mode
    (K6 and K8 on the mapped rows; the Deltas positions bin with the
    division map, as in the JAX package, and pack with K7):
    compress_snapshot, the full read (per segment: the batched reader
    leaves a file with a Deltas field to it, as the JAX package's does)
    and the batched read of the other fields (K2, K3)."""
    pos, vel, ids, _, _ = data
    n = pos.shape[1]
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    mass = 10.0 ** (0.5 * torch.randn(n, generator=g, device=dev))
    deltas = zoom_deltas(n)
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    torch.cuda.synchronize()
    reset_counts()
    buf = io.BytesIO()
    stats, t_enc, m_enc = timed(lambda: mt.compress_snapshot(
        buf, pos, vel, ids, log_spec(mt, deltas), SNAP_BLOCKS, seed=SEED,
        scale_mode="recip", mass=mass))
    blob = buf.getvalue()
    out, t_dec, m_dec = timed(lambda: mt.decompress_snapshot(
        io.BytesIO(blob), batched=True, device=dev))
    part, t_part, m_part = timed(lambda: mt.decompress_snapshot(
        io.BytesIO(blob), batched=True, fields={"vel", "mass", "ids"},
        device=dev))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    report("phase 8(a)", raw, ("compress_snapshot", t_enc, m_enc),
           ("decompress_snapshot (all fields, per segment)", t_dec, m_dec))
    report("phase 8(a)", n * (3 * 4 + 8 + 4),
           ("decompress_snapshot(fields=vel, mass, ids; batched)", t_part,
            m_part))
    log(f"phase 8(a): {n} particles in {SNAP_BLOCKS} blocks, {raw} raw bytes "
        f"-> {len(blob)} file bytes (ratio {raw / len(blob):.3f}); depths "
        f"{ {k: v for k, v in stats.items() if k != 'bytes'} }")
    log(f"phase 8(a): launches in the Deltas / log-map snapshot path: "
        f"{launches}")
    worst = log_errors("phase 8(a)", out, dict(pos=pos, vel=vel, ids=ids,
                                               mass=mass), deltas)
    for k in ("vel", "mass", "ids"):
        if not torch.equal(bits(part[k]), bits(out[k])):
            raise AssertionError(f"phase 8(a): batched {k} != per segment")
    floor = {"K1": 4 * SNAP_BLOCKS, "K2": 4, "K3": 3 * SNAP_BLOCKS + 3,
             "K6": 2, "K7": 3 * SNAP_BLOCKS + 3, "K8": 2}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 8(a) missed a kernel: {launches} "
                             f"(want at least {floor})")
    log(f"phase 8(a): largest error over its bound {worst} (positions "
        f"within their per-particle accuracy {ZOOM_DELTAS}, velocities "
        f"{VEL_LOG_DELTA} and masses log10(1 + 1e-4) in mapped space plus "
        f"{ENV_SLOPE} * |y| + {ENV_CONST}); IDs exact; the batched read of "
        f"vel, mass, ids == the per-segment read bitwise; launches at least "
        f"{floor}")
    nb = n // SNAP_BLOCKS
    keep = {k: v[..., :STREAM_BLOCKS * nb].clone() for k, v in out.items()}
    del out, buf
    errs = check_zoom_kernels(data, mass, deltas, stats, part, dev)
    del part
    return mass, deltas, stats, keep, blob, launches, errs


def check_zoom_kernels(data, mass, deltas, stats, part, dev) -> dict:
    """(a) The path's kernels against their plain versions, bitwise, at
    the shapes this path gives them: K7 and K3 on the Deltas chunk buckets
    of one position block per accuracy (rows of 256 at each chunk width,
    as Trim v1.1 packs and unpacks them), K6 on the mapped velocity and
    mass rows, K8 on them at the written depths, K2 on K8's words as the
    batched read decodes them (unmapped, each must equal that read's
    velocities and masses) and K1 on one velocity row as the per-segment
    read decodes it.  Returns each kernel's largest error."""
    from minnow_c_tpu_torch.algos import chunked
    from minnow_c_tpu_torch.algos.algo_trim_v1_1 import VERSION as TRIM11
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    from minnow_c_tpu_torch.ops import rng as _rng
    from minnow_c_tpu_torch.quant import engine
    from minnow_c_tpu_torch.types import (AlgoCode, Field, FieldCode,
                                          FieldHeader, PositionAccuracy)
    pos, vel = data[0], data[1]
    n = pos.shape[1]
    B, nb, C = SNAP_BLOCKS, n // SNAP_BLOCKS, chunked.CHUNK
    errs = {}

    def same(k, got, want, where):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        if not all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want)):
            raise AssertionError(f"phase 8(a): {k} != plain {where}")
        errs[k] = max([errs.get(k, 0.0)] +
                      [max_abs_err(a, b) for a, b in zip(got, want)])

    buckets = set()
    for first in (0, n // 8, n // 2):          # one block per accuracy
        sl = slice(first, first + nb)
        qf = engine.quantize(Field(
            hd=FieldHeader(FieldCode.POSN, AlgoCode.TRIM, TRIM11, nb),
            data=pos[:, sl], acc=PositionAccuracy(
                delta=0.0, width=BOX, deltas=deltas[sl])),
            seed=SEED, scale_mode="recip", device=dev)
        widths = np.asarray(qf.quant.depths).reshape(-1, C).max(axis=1)
        for d in range(3):
            zc = qf.data.reshape(3, -1)[d].reshape(-1, C)
            for wv in (int(w) for w in np.unique(widths) if w):
                rows = zc[torch.from_numpy(np.nonzero(widths == wv)[0]).to(
                    dev)]
                where = f"on Deltas chunk rows {tuple(rows.shape)} at {wv}"
                words = encode_cuda.pack_rows_cuda(rows, wv)
                same("K7", words, encode_cuda.pack_rows_plain(rows, wv),
                     where)
                got = decode_cuda.unpack_rows_cuda(words, wv, C)
                same("K3", got, decode_cuda.unpack_rows_plain(words, wv, C),
                     where)
                if not torch.equal(got, rows):
                    raise AssertionError(f"phase 8(a): K3 of K7 != the bins "
                                         f"{where}")
                buckets.add((tuple(rows.shape), wv))
        del qf
    # the mapped rows as the writer forms them; field 1 is vel, 3 mass
    for name, fi, x, mode, t in (
            ("vel", 1, vel.reshape(3, B, nb).transpose(0, 1).reshape(
                3 * B, nb), 2, SYMLOG_T),
            ("mass", 3, mass.reshape(B, nb), 1, 0.0)):
        D, depth = x.shape[0] // B, stats[f"{name}_depth"]
        where = f"on the mapped {name} rows {tuple(x.shape)}"
        rows = engine.map_float(x, mode, t)
        zeros = torch.zeros(rows.shape[0], device=dev)
        anchor = rows[:, 0].contiguous()
        mn, mx = encode_cuda.stats_rows_cuda(rows, zeros, anchor, False)
        same("K6", (mn, mx), encode_cuda.stats_rows_plain(
            rows, zeros, anchor, False), where)
        x0 = mn.cpu().numpy().reshape(B, D)
        if name == "vel":
            rng = kernels.ftz(mx - mn).reshape(B, D).amax(dim=1).cpu().numpy()
            # the reader's bin range: f32(x0 + max over dims of x1 - x0) - x0
            x1 = (x0 + rng[:, None]).astype(np.float32)
            md = np.max(x1 - x0, axis=1).astype(np.float64)
            dx = (np.float32(x0.astype(np.float64) + md[:, None]) - x0
                  ).astype(np.float32)
        else:
            rng = mx.cpu().numpy() - x0[:, 0]
            dx = rng[:, None]
        recip = torch.from_numpy(np.repeat(np.atleast_1d(
            kernels.exact_recip(rng)), D)).to(dev)
        args = (depth, mn, recip, zeros, anchor, False)
        words = encode_cuda.encode_recip_rows_cuda(rows, *args)
        same("K8", words, encode_cuda.encode_recip_rows_plain(rows, *args),
             f"{where} at {depth} bits")
        words = words.reshape(B, D, -1)
        for d in range(D):
            key = _rng.field_key(SEED, fi, d)
            wd = words[:, d].contiguous()
            keys = torch.tensor(key, dtype=torch.int64, device=dev).expand(
                B, 2)
            x0d, dxd = (torch.from_numpy(np.ascontiguousarray(v[:, d])).to(
                dev) for v in (x0, dx))
            got = decode_cuda.decode_rows_cuda(wd, keys, depth, nb, x0d, dxd)
            same("K2", got, decode_cuda.decode_rows_plain(
                wd, keys, x0d, kernels.bin_width(dxd, depth), 0.0, nb, depth),
                f"{where} (dim {d}) at {depth} bits")
            read = part[name][d] if name == "vel" else part[name]
            if not torch.equal(bits(engine.unmap_float(got, mode, t).reshape(
                    -1)), bits(read)):
                raise AssertionError(f"phase 8(a): K2's decode of K8's "
                                     f"words, unmapped, != the batched read "
                                     f"of {name} (dim {d})")
            if name == "vel" and d == 0:
                k1 = decode_cuda.decode_cuda(wd[0], key, depth, nb, x0[0, 0],
                                             dx[0, 0], 0.0, False)
                same("K1", k1, decode_cuda.decode_plain(
                    wd[0], *key, np.float32(x0[0, 0]),
                    kernels.bin_width(dx[0, 0], depth), np.float32(0.0), nb,
                    depth, 0, False), f"on a mapped velocity row of {nb}")
                if not torch.equal(bits(k1), bits(got[0])):
                    raise AssertionError("phase 8(a): K1 != K2's row 0")
        del rows, words
    log(f"phase 8(a): at the path's shapes, K7 and K3 on the Deltas chunk "
        f"buckets {sorted(buckets, key=lambda b: b[1])} (one block per "
        f"accuracy, three dims), K6 and K8 on the mapped velocity ({3 * B}, "
        f"{nb}) and mass ({B}, {nb}) rows at {stats['vel_depth']} and "
        f"{stats['mass_depth']} bits, K2 on K8's words and K1 on a velocity "
        f"row == their plain versions bitwise; K2's decode, unmapped, == the "
        f"batched read of vel and mass; errors {errs}")
    return errs


def check_zoom_streaming(mt, data, mass, deltas, stats_a, keep, blob_a,
                         dev):
    """(b) The first STREAM_BLOCKS blocks of (a) through the streaming
    writer, each with its own ``pos_deltas``, velocities and masses at
    (a)'s depths: (a)'s decoded values, bitwise."""
    from minnow_c_tpu_torch.segment import io as seg_io
    pos, vel, ids, _, _ = data
    nb = pos.shape[1] // SNAP_BLOCKS
    n = STREAM_BLOCKS * nb
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    depths = {k: stats_a[f"{k}_depth"] for k in ("vel", "mass")}

    def blocks():
        for b in range(STREAM_BLOCKS):
            sl = slice(b * nb, (b + 1) * nb)
            yield {"pos": pos[:, sl], "vel": vel[:, sl], "ids": ids[sl],
                   "mass": mass[sl], "pos_deltas": deltas[sl]}

    torch.cuda.synchronize()
    reset_counts()
    buf = io.BytesIO()
    _, t_enc, m_enc = timed(lambda: mt.compress_snapshot_streaming(
        buf, blocks(), log_spec(mt, None), seed=SEED, depths=depths,
        scale_mode="recip"))
    out, t_dec, m_dec = timed(lambda: mt.decompress_snapshot(
        io.BytesIO(buf.getvalue()), batched=True, device=dev))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    report("phase 8(b)", raw, ("compress_snapshot_streaming", t_enc, m_enc),
           ("decompress_snapshot", t_dec, m_dec))
    log(f"phase 8(b): launches in the streaming path: {launches}")
    for k in ("pos", "vel", "mass"):
        if not torch.equal(bits(out[k]), bits(keep[k])):
            raise AssertionError(f"phase 8(b): streaming {k} != (a)'s decode")
    if not torch.equal(out["ids"], ids[:n]):
        raise AssertionError("phase 8(b): IDs did not come back exactly")
    if any(launches[k] < 3 * STREAM_BLOCKS for k in ("K7", "K3")) or \
            launches["K8"] < 2 * STREAM_BLOCKS:
        raise AssertionError(f"phase 8(b) missed K7, K3 or K8: {launches}")
    segs = [sg for _, sg in seg_io.iter_segments(io.BytesIO(buf.getvalue()))]
    segs_a = [sg for _, sg in seg_io.iter_segments(io.BytesIO(blob_a))]
    same = sum(a == b for a, b in zip(segs, segs_a))
    log(f"phase 8(b): {STREAM_BLOCKS} blocks with per-block pos_deltas, vel "
        f"and mass at depths {depths}: pos, vel, mass == (a)'s decode "
        f"bitwise, IDs exact; {same} of {STREAM_BLOCKS} segments "
        "byte-identical to (a)'s")
    return launches


def check_cli_masses(dev):
    """(c) A Gadget-2 file with a MASS record (lognormal, all positive, so
    the CLI log10-maps them) through the CLI on the card: compress
    (recip), info, verify, decompress."""
    from minnow_c_tpu_torch import __main__ as cli
    from minnow_c_tpu_torch.drivers import gadget2
    pos, vel, ids = cli_snapshot(dev)
    n = ids.size
    mass = (10.0 ** (0.5 * np.random.default_rng(SEED).standard_normal(
        n))).astype(np.float32)
    hdr = gadget2.Gadget2Header(
        npart=(0, n, 0, 0, 0, 0), mass=(0.0,) * 6, time=1.0, redshift=0.0,
        box_size=BOX, omega0=0.3, omega_lambda=0.7, hubble_param=0.7)
    with tempfile.TemporaryDirectory() as tmp:
        src, dst, back = (os.path.join(tmp, f)
                          for f in ("snap.g2", "snap.g2.min", "back.g2"))
        with open(src, "wb") as f:
            gadget2.write_snapshot(f, hdr, pos, vel, ids, mass=mass)
        raw = os.path.getsize(src)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        walls = {}
        for name, argv in (
                ("compress", ["compress", src, dst, "--scale-mode", "recip",
                              "--device", dev.type]),
                ("info", ["info", dst]), ("verify", ["verify", dst]),
                ("decompress", ["decompress", dst, back, "--device",
                                dev.type])):
            t = time.perf_counter()
            rc = cli.main(argv)
            torch.cuda.synchronize()
            walls[name] = time.perf_counter() - t
            if rc != 0:
                raise AssertionError(f"phase 8(c): {name} exited {rc}")
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in launch_counted().items()}
        size = os.path.getsize(dst)
        with open(back, "rb") as f:
            _, p2, v2, i2, m2 = gadget2.read_snapshot_ext(f)
    e = np.abs(p2.astype(np.float64) - pos)
    ep = float(np.minimum(e, BOX - e).max())
    ev = float(np.abs(v2.astype(np.float64) - vel).max())
    em = float(np.abs(m2.astype(np.float64) / mass - 1.0).max())
    lm = np.log10(mass.astype(np.float64))
    em_bound = float((np.abs(np.log10(m2.astype(np.float64)) - lm) /
                      (MASS_LOG_DELTA + ENV_CONST + ENV_SLOPE * np.abs(lm))
                      ).max())
    rt = walls["compress"] + walls["decompress"]
    log(f"phase 8(c): {n} particles with per-particle masses, Gadget-2 file "
        f"{raw} bytes -> {size} bytes (ratio {raw / size:.3f}); walls "
        f"{ {k: round(v, 4) for k, v in walls.items()} } s; compress "
        f"{raw / walls['compress'] / 1e9:.3f} GB/s, decompress "
        f"{raw / walls['decompress'] / 1e9:.3f} GB/s, round trip "
        f"{raw / rt / 1e9:.3f} GB/s of the Gadget-2 file; peak device "
        f"memory {peak / 2**30:.3f} GiB")
    log(f"phase 8(c): launches in the CLI path: {launches}")
    if ep > POS_DELTA or ev > VEL_DELTA or em_bound > 1.0 or \
            not np.array_equal(i2, ids):
        raise AssertionError(f"phase 8(c): position error {ep}, velocity "
                             f"error {ev}, mass error {em_bound} of its "
                             "bound, or IDs not exact")
    floor = {"K5": 14, "K4": 6, "K1": 14}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 8(c) missed a kernel: {launches} "
                             f"(want at least {floor})")
    log(f"phase 8(c): max position error {ep:.6g} <= {POS_DELTA}, velocity "
        f"{ev:.6g} <= {VEL_DELTA}, mass relative error {em:.6g} (log10 "
        f"map, {em_bound:.4f} of log10(1 + 1e-4) plus the unmap's "
        f"envelope), IDs exact; launches at least {floor}")
    return launches, check_cli_mass_kernels(mass, m2, dev)


def check_cli_mass_kernels(mass, m2, dev, blocks: int = 2) -> dict:
    """(c) K6, K5 and K1 against their plain versions, bitwise, on the
    CLI's log10-mapped masses (``blocks`` blocks, as ``gadget2.compress``
    picks them; 32 does not divide a block): K6 on the mapped rows, K5 on
    block 0 at the written depth, K1's decode of its words.  x0, recip,
    depth, dither key and bin width are derived as the writer and the
    reader derive them; K1's decode, unmapped, must equal the CLI's
    decoded masses of block 0."""
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda, kernels
    from minnow_c_tpu_torch.ops import rng as _rng
    from minnow_c_tpu_torch.quant import engine
    nb = mass.size // blocks
    rows = engine.map_float(torch.from_numpy(mass).to(dev).reshape(
        blocks, nb), 1, 0.0)
    zeros = torch.zeros(blocks, device=dev)
    anchor = rows[:, 0].contiguous()
    errs = {}
    mn, mx = encode_cuda.stats_rows_cuda(rows, zeros, anchor, False)
    want = encode_cuda.stats_rows_plain(rows, zeros, anchor, False)
    if not all(torch.equal(bits(a), bits(b)) for a, b in zip((mn, mx),
                                                               want)):
        raise AssertionError("phase 8(c): K6 != plain on the mapped masses")
    errs["K6"] = max(max_abs_err(a, b) for a, b in zip((mn, mx), want))
    x0, x1 = mn.cpu().numpy(), mx.cpu().numpy()
    rng = x1 - x0
    depth = engine.delta_to_depth(MASS_LOG_DELTA, 0.0, float(rng.max()))
    args = (depth, x0[0], kernels.exact_recip(rng)[0], 0.0,
            rows[0, 0].item(), False)
    words = encode_cuda.encode_recip_cuda(rows[0], *args)
    want = encode_cuda.encode_recip_plain(rows[0], *args)
    errs["K5"] = max_abs_err(words, want)
    key = _rng.field_key(0, 3, 0)     # the CLI's seed 0; field 3 is mass
    got = decode_cuda.decode_cuda(words, key, depth, nb, x0[0], rng[0], 0.0,
                                  False)
    want_k1 = decode_cuda.decode_plain(words, *key, np.float32(x0[0]),
                                       kernels.bin_width(rng[0], depth),
                                       np.float32(0.0), nb, depth, 0, False)
    if not torch.equal(words, want) or not torch.equal(bits(got),
                                                       bits(want_k1)):
        raise AssertionError(f"phase 8(c): K5 or K1 != plain on the mapped "
                             f"masses at n {nb}")
    errs["K1"] = max_abs_err(got, want_k1)
    cli = torch.from_numpy(np.ascontiguousarray(m2[:nb])).to(dev)
    if not torch.equal(bits(engine.unmap_float(got, 1, 0.0)), bits(cli)):
        raise AssertionError("phase 8(c): K1's decode of K5's words, "
                             "unmapped, != the CLI's decoded masses")
    log(f"phase 8(c): at n {nb} (32 does not divide it): K6 on the mapped "
        f"masses ({blocks}, {nb}), K5 at {depth} bits and K1's decode of its "
        f"words == their plain versions bitwise; K1's decode, unmapped, == "
        f"the CLI's decoded masses of block 0")
    return errs


def card_vs_cpu_maps(vel, mass) -> None:
    """The maps' bits on the card against the CPU on 2^20 values each:
    the share of mapped values, of bins (the field's depth over the CPU's
    range) and of unmapped values that differ."""
    from minnow_c_tpu_torch.ops import kernels
    from minnow_c_tpu_torch.quant import engine
    m = 1 << 20
    for name, x, mode, t, delta in (
            ("symlog velocities", vel[0, :m], 2, SYMLOG_T, VEL_LOG_DELTA),
            ("log10 masses", mass[:m], 1, 0.0, MASS_LOG_DELTA)):
        on_card = engine.map_float(x, mode, t)
        on_cpu = engine.map_float(x.cpu(), mode, t)
        x0, x1 = (v.item() for v in kernels.minmax(on_cpu))
        depth = engine.delta_to_depth(delta, x0, x1)
        dx = np.float32(x1) - np.float32(x0)
        b_card = kernels.uniform_bin_index(on_card, depth, x0, dx).cpu()
        b_cpu = kernels.uniform_bin_index(on_cpu, depth, x0, dx)
        u_card = engine.unmap_float(on_cpu.to(x.device), mode, t).cpu()
        u_cpu = engine.unmap_float(on_cpu, mode, t)
        share = [(bits(a) != bits(b)).double().mean().item()
                 for a, b in ((on_card.cpu(), on_cpu), (b_card, b_cpu),
                              (u_card, u_cpu))]
        log(f"phase 8: {name}, {m} values, card against CPU: "
            f"{share[0]:.6%} of mapped values, {share[1]:.6%} of bins (at "
            f"{depth} bits) and {share[2]:.6%} of unmapped values differ")



# ---------------------------------------------------------------------------
# Phase 10: the block-sharded codecs and the multihost layer
# ---------------------------------------------------------------------------

CFG4_BLOCKS, CFG4_NB = 8, 12_582_912  # BASELINE config 4: 100,663,296
MH_RANKS = 2              # phase 10(c): processes on the one card
MH_TIMEOUT = 420          # seconds a phase 10(c) worker may take


def periodic_err(out: torch.Tensor, x: torch.Tensor) -> float:
    """Largest periodic distance between (R, n) rows, row by row in f64."""
    worst = 0.0
    for r in range(x.shape[0]):
        e = (out[r].double() - x[r].double()).abs()
        worst = max(worst, torch.minimum(e, BOX - e).max().item())
    return worst


def same_bits(label: str, got, want) -> None:
    for i, (a, b) in enumerate(zip(got, want)):
        if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
            raise AssertionError(f"{label}: output {i} differs")


def check_sharded_position(dev):
    """10(a): ShardedPositionCodec on BASELINE config 4's shape, 8 blocks
    of 12,582,912 uniform positions in rows (24, n_b) on one shard, at the
    spmd and adaptive depths in the div and recip modes.  Each mode's first
    encode and decode are its main path (launches counted, peak memory with
    only the input and their own outputs held); walls are the median of 3
    more."""
    from minnow_c_tpu_torch.parallel import sharding
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    x = torch.rand((CFG4_BLOCKS * 3, CFG4_NB), generator=g,
                   device=dev) * BOX
    raw = x.numel() * 4
    one = sharding.make_mesh(1)
    spmd = sharding.spmd_depth_for(POS_DELTA, BOX)
    adaptive = sharding.adaptive_depth_for(
        sharding.ShardedPositionCodec(mesh=one, width=BOX, depth=spmd), x,
        POS_DELTA)
    log(f"phase 10(a): {CFG4_BLOCKS * CFG4_NB} particles in {CFG4_BLOCKS} "
        f"blocks of {CFG4_NB} ({raw} raw bytes), depths spmd {spmd}, "
        f"adaptive {adaptive}")
    launches = {}
    for profile, depth in (("spmd", spmd), ("adaptive", adaptive)):
        for mode in ("div", "recip"):
            label = f"phase 10(a) {profile} {mode} (depth {depth})"
            codec = sharding.ShardedPositionCodec(
                mesh=one, width=BOX, depth=depth, scale_mode=mode)
            torch.cuda.synchronize()
            reset_counts()
            enc, _, m_enc = timed(lambda: codec.encode(x))
            out, _, m_dec = timed(lambda: codec.decode(*enc, seed=SEED))
            for k, fn in launch_counted().items():
                launches[k] = launches.get(k, 0) + fn.launches
            err = periodic_err(out, x)
            if not err <= POS_DELTA:
                raise AssertionError(f"{label}: error {err}")
            walls = []
            for _ in range(3):
                e2, t_enc, _ = timed(lambda: codec.encode(x))
                o2, t_dec, _ = timed(lambda: codec.decode(*e2, seed=SEED))
                same_bits(f"{label} repeat", e2 + (o2,), enc + (out,))
                walls.append((t_enc, t_dec))
                del e2, o2
            t_enc, t_dec = (sorted(w[i] for w in walls)[1] for i in (0, 1))
            wbytes = enc[0].numel() * 4
            log(f"{label}: encode {t_enc:.4f} s ({raw / t_enc / 1e9:.3f} "
                f"GB/s), decode {t_dec:.4f} s ({raw / t_dec / 1e9:.3f} "
                f"GB/s) (median of 3), peak device memory "
                f"{m_enc / 2**30:.3f} / {m_dec / 2**30:.3f} GiB; words "
                f"{wbytes} bytes (ratio {raw / wbytes:.3f}); max error "
                f"{err:.6g} <= {POS_DELTA}")
            plain = sharding.ShardedPositionCodec(
                mesh=one, width=BOX, depth=depth, scale_mode=mode,
                fused_rows=False)
            same_bits(f"{label} encode kernels == plain", enc,
                      plain.encode(x))
            same_bits(f"{label} decode kernels == plain", (out,),
                      (plain.decode(*enc, seed=SEED),))
            four = sharding.ShardedPositionCodec(
                mesh=sharding.make_mesh(4), width=BOX, depth=depth,
                scale_mode=mode)
            e4 = four.encode(x)
            same_bits(f"{label} 4 shards", e4 + (four.decode(
                *e4, seed=SEED),), enc + (out,))
            del enc, out, e4
    log("phase 10(a): kernels == plain path (fused_rows=False) bitwise in "
        "words, headers and decodes; 4 logical shards == 1 bitwise; every "
        f"run within {POS_DELTA}; launches in the four main runs: "
        f"{launches}")
    floor = {"K2": 4, "K6": 4, "K7": 2, "K8": 2}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 10(a) missed a kernel: {launches}")
    return launches


def check_sharded_snapshot(dev):
    """10(b): ShardedSnapshotCodec on phase 5's 512^3 fields in 64 blocks
    of 2^21 on one shard."""
    from minnow_c_tpu_torch.parallel import sharding
    from minnow_c_tpu_torch.quant import engine
    pos, vel, ids, mass = snapshot_fields(dev)
    del mass
    n = pos.shape[1]
    B, nb = SNAP_BLOCKS, n // SNAP_BLOCKS
    raw = n * (3 * 4 + 3 * 4 + 8)
    prow = pos.reshape(3, B, nb).transpose(0, 1).reshape(B * 3, nb)
    vrow = vel.reshape(3, B, nb).transpose(0, 1).reshape(B * 3, nb)
    irow = ids.reshape(B, nb)
    del pos, vel, ids
    one = sharding.make_mesh(1)
    spmd = sharding.spmd_depth_for(POS_DELTA, BOX)
    vd = engine.delta_to_depth(VEL_DELTA, vrow.min().item(),
                               vrow.max().item())
    codec = sharding.ShardedSnapshotCodec(mesh=one, box=BOX, pos_depth=spmd,
                                          vel_depth=vd, id_grid=SNAP_SIDE)
    torch.cuda.synchronize()
    reset_counts()
    enc, t_enc, m_enc = timed(lambda: codec.encode(prow, vrow, irow))
    out, t_dec, m_dec = timed(lambda: codec.decode(enc, seed=SEED))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    perr = periodic_err(out[0], prow)
    verr = max((out[1][r] - vrow[r]).abs().max().item()
               for r in range(vrow.shape[0]))
    if not (perr <= POS_DELTA and verr <= VEL_DELTA):
        raise AssertionError(f"phase 10(b): errors {perr}, {verr}")
    if not torch.equal(out[2], irow):
        raise AssertionError("phase 10(b): IDs did not come back exactly")
    wbytes = sum(enc[i].numel() * 4 for i in (0, 3, 6))
    log(f"phase 10(b): {n} particles in {B} blocks, depths pos {spmd}, vel "
        f"{vd}, IDs {codec.id_width}: encode {t_enc:.4f} s "
        f"({raw / t_enc / 1e9:.3f} GB/s), decode {t_dec:.4f} s "
        f"({raw / t_dec / 1e9:.3f} GB/s), peak device memory "
        f"{m_enc / 2**30:.3f} / {m_dec / 2**30:.3f} GiB; words {wbytes} "
        f"bytes (ratio {raw / wbytes:.3f}); max errors pos {perr:.6g}, vel "
        f"{verr:.6g}; IDs exact; launches {launches}")
    pcodec = sharding.ShardedPositionCodec(mesh=one, width=BOX, depth=spmd)
    penc = pcodec.encode(prow)
    same_bits("phase 10(b) positions == 10(a)'s codec",
              (enc[0], enc[1], enc[2], out[0]),
              penc + (pcodec.decode(*penc, seed=SEED),))
    del penc
    plain = sharding.ShardedSnapshotCodec(
        mesh=one, box=BOX, pos_depth=spmd, vel_depth=vd, id_grid=SNAP_SIDE,
        fused_rows=False)
    same_bits("phase 10(b) encode kernels == plain", enc,
              plain.encode(prow, vrow, irow))
    same_bits("phase 10(b) decode kernels == plain", out,
              plain.decode(enc, seed=SEED))
    log("phase 10(b): positions == 10(a)'s codec bitwise (words, headers, "
        "decode); kernels == plain path bitwise (K2, K3, K6, K7)")
    floor = {"K2": 2, "K3": 1, "K6": 2, "K7": 3}
    if any(launches[k] < v for k, v in floor.items()):
        raise AssertionError(f"phase 10(b) missed a kernel: {launches}")
    return launches


def digests(fields: dict) -> dict:
    return {k: hashlib.sha256(bits(v).contiguous().cpu().numpy().tobytes())
            .hexdigest() for k, v in sorted(fields.items())}


def multihost_worker(rank: int, addr: str, out_dir: str,
                     dev=torch.device("cuda")) -> int:
    """One process of 10(c): its half of phase 5's snapshot (made whole, as
    phase 5 makes it, then cut) through compress_snapshot_multihost, then
    its slice read back through decompress_snapshot_multihost; prints its
    walls, launches and the sha256 of each field it read."""
    import contextlib
    import minnow_c_tpu_torch as mt
    from minnow_c_tpu_torch.parallel import multihost
    multihost.initialize(addr, MH_RANKS, rank)
    fields = snapshot_fields(dev)
    k = fields[0].shape[1] // MH_RANKS
    pos, vel, ids, mass = (f[..., rank * k:(rank + 1) * k].contiguous()
                           for f in fields)
    del fields
    path = os.path.join(out_dir, "multihost.min")
    torch.cuda.synchronize()
    reset_counts()
    with open(path, "wb") if rank == 0 else contextlib.nullcontext() as fp:
        stats, t_write, m_write = timed(
            lambda: mt.parallel.compress_snapshot_multihost(
                fp, pos, vel, ids, snap_spec(mt), SNAP_BLOCKS // MH_RANKS,
                seed=SEED, mass=mass))
    with open(path, "rb") as f:
        got, t_read, m_read = timed(
            lambda: mt.parallel.decompress_snapshot_multihost(f))
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    print("MULTIHOST " + json.dumps({
        "rank": rank, "write_s": t_write, "read_s": t_read,
        "peak_write": m_write, "peak_read": m_read, "launches": launches,
        "stats": stats, "digests": digests(got["local"]),
        "blocks_local": got["blocks_local"],
        "first": got["pos"].first}), flush=True)
    multihost.barrier()
    return 0


def check_multihost(mt, dev):
    """10(c): phase 5's snapshot written by MH_RANKS processes on the card
    over gloo: the file's sha256 == the single-host file's, and each rank's
    read == its slice of decompress_snapshot bitwise."""
    import socket
    pos, vel, ids, mass = snapshot_fields(dev)
    n = pos.shape[1]
    raw = n * (3 * 4 + 3 * 4 + 8 + 4)
    buf = io.BytesIO()
    stats, t_one, _ = timed(lambda: mt.compress_snapshot(
        buf, pos, vel, ids, snap_spec(mt), SNAP_BLOCKS, seed=SEED,
        mass=mass))
    blob = buf.getvalue()
    del buf, pos, vel, ids, mass
    want_sha = hashlib.sha256(blob).hexdigest()
    full = mt.decompress_snapshot(io.BytesIO(blob))
    k = n // MH_RANKS
    want = [digests({name: t[..., r * k:(r + 1) * k]
                     for name, t in full.items()}) for r in range(MH_RANKS)]
    del full, blob
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    with tempfile.TemporaryDirectory() as tmp:
        t = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--multihost-worker",
             str(r), addr, tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=REPO)
            for r in range(MH_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MH_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        wall = time.perf_counter() - t
        for r, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise AssertionError(f"phase 10(c): worker {r} exited "
                                     f"{p.returncode}:\n{out[-4000:]}")
        with open(os.path.join(tmp, "multihost.min"), "rb") as f:
            got_sha = hashlib.file_digest(f, "sha256").hexdigest()
    reports = [json.loads(next(line for line in out.splitlines()
                               if line.startswith("MULTIHOST "))[10:])
               for out in outs]
    if got_sha != want_sha:
        raise AssertionError(f"phase 10(c): file sha256 {got_sha} != "
                             f"single-host {want_sha}")
    for r, rep in enumerate(reports):
        if rep["digests"] != want[r] or rep["first"] != r * (
                SNAP_BLOCKS // MH_RANKS):
            raise AssertionError(f"phase 10(c): rank {r}'s read != its "
                                 "slice of decompress_snapshot")
        rate = raw / MH_RANKS / rep["read_s"] / 1e9
        log(f"phase 10(c) rank {r}: compress_snapshot_multihost "
            f"{rep['write_s']:.4f} s, decompress_snapshot_multihost "
            f"{rep['read_s']:.4f} s ({rate:.3f} GB/s of its raw bytes), "
            f"peak device memory {rep['peak_write'] / 2**30:.3f} / "
            f"{rep['peak_read'] / 2**30:.3f} GiB; launches "
            f"{rep['launches']}")
    log(f"phase 10(c): {MH_RANKS} processes over gloo, "
        f"{SNAP_BLOCKS // MH_RANKS} blocks each, {wall:.2f} s with "
        f"start-up; file sha256 {got_sha} "
        f"== single-host compress_snapshot's ({t_one:.4f} s); each rank's "
        "read == its slice of decompress_snapshot bitwise")
    return {key: sum(rep["launches"][key] for rep in reports)
            for key in reports[0]["launches"]}


def trace_probe(label: str, dev) -> None:
    """Whether a torch.profiler trace still holds the card's activity:
    K9 on 2^20 elements, three traces of 5 calls."""
    from minnow_c_tpu_torch.ops import scan_cuda
    x = torch.ones(1 << 20, dtype=torch.int32, device=dev)
    t = device_ms(lambda: scan_cuda.cumsum_u32(x), "scan_kernel")
    log(f"phase 10: trace probe {label}: "
        + (f"K9 {t:.4f} ms a call" if t else "no device time in the trace"))


def check_sharded_paths(mt, dev):
    """Phase 10: (a), (b) and (c); the launches of each and their sum.
    A trace probe follows each part."""
    pa = check_sharded_position(dev)
    trace_probe("after 10(a)", dev)
    torch.cuda.empty_cache()
    pb = check_sharded_snapshot(dev)
    trace_probe("after 10(b)", dev)
    torch.cuda.empty_cache()
    pc = check_multihost(mt, dev)
    trace_probe("after 10(c)", dev)
    torch.cuda.empty_cache()
    trace_probe("after 10(c) and empty_cache", dev)
    p10 = {k: pa[k] + pb[k] + pc[k] for k in pa}
    log(f"phase 10: launches on its path ((a) + (b) + (c)): {p10}")
    return p10


# ---------------------------------------------------------------------------
# Phase 11: the measuring layer on the card
# ---------------------------------------------------------------------------

P11_TRIAL_S, P11_TOTAL_S = 0.05, 3.0   # the harness's trial and budget
P11_FLOOR = 0.9                        # harness / profiled device time
P11_RATE_CAP = 1.05 * PEAK_BYTES_S     # kernel bytes a second


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bench_workloads(dev):
    """Phase 11's workloads at the suites' sizes: (name -> (body, nominal
    bytes, the bytes its kernels must move (each input read once and each
    output written once, kernel by kernel), the kernels' names in a
    trace, their torch.profiler device time a body call (ms)), the kernel
    suite's inputs)."""
    from minnow_c_tpu_torch.bench import headline, kernel_suite
    head_fn, head_bytes = headline.workload(dev)
    inp = kernel_suite.make_inputs(dev)
    bodies = kernel_suite.workloads(inp)
    n_rows = inp["xrows"].numel()
    recip_words = n_rows * kernel_suite.ROWS_DEPTH // 8
    work = {
        "headline (K1)": (head_fn, head_bytes,
                          headline.N * headline.LEVEL // 8 + head_bytes,
                          ("decode_tiles",)),
        "rows_fused_decode (K2)": (
            *bodies["rows_fused_decode"],
            _nbytes(inp["wrows"], inp["rkeys"]) + n_rows * 4,
            ("decode_tiles",)),
        "rows_recip_encode (K6 + K8)": (
            *bodies["rows_recip_encode"],
            2 * n_rows * 4 + recip_words, ("stats_rows", "pack_recip_tiles")),
        "cumsum_u32_pallas (K9)": (
            *bodies["cumsum_u32_pallas"], 2 * _nbytes(inp["bins"]),
            ("scan_kernel",)),
    }
    t = time.perf_counter()
    salt = torch.zeros((), dtype=torch.int32, device=dev)
    for name, (fn, nominal, moved, kernel_names) in work.items():
        dev_t = [device_ms(lambda: fn(salt), k) for k in kernel_names]
        if None in dev_t:
            raise AssertionError(f"phase 11: {name}: no device time for "
                                 f"{kernel_names} in three traces")
        work[name] = (fn, nominal, moved, kernel_names, sum(dev_t))
        log(f"phase 11: {name}: its kernels' device time {sum(dev_t):.4f} "
            "ms a body call (torch.profiler, 5 calls, before phase 10)")
    log(f"phase 11: inputs made and traced in {time.perf_counter() - t:.1f} "
        "s")
    return work, inp


def bench_kernels_vs_plain(dev, work: dict, inp: dict) -> dict:
    """11(b): each body's kernels on the card at the suite's shapes and
    salt 0xDEADBEEF against their plain versions on the same inputs,
    bitwise (the body's own output too): K2 on the (192, 2^17) 16-bit
    rows with per-row keys, K6 then K8 on the (192, 2^17) rows at depth
    14, K9 on the 25,165,824 bins.  Returns each kernel's max abs error."""
    from minnow_c_tpu_torch.bench import kernel_suite as ks
    from minnow_c_tpu_torch.ops import (decode_cuda, encode_cuda, kernels,
                                        scan_cuda)
    salt = torch.tensor(-559038737, dtype=torch.int32, device=dev)
    err = {}

    def held(k, label, got, want):
        for a, b in zip(got, want):
            if a.shape != b.shape or not torch.equal(bits(a), bits(b)):
                raise AssertionError(f"phase 11(b): {label} != plain")
            err[k] = max(err.get(k, 0.0), max_abs_err(a, b))

    rows, row_n = inp["xrows"].shape
    body = {name.split(" ")[0]: w[0] for name, w in work.items()}
    # K2
    ws = inp["wrows"].clone()
    ws.view(-1)[0] ^= salt
    rx0 = torch.zeros(rows, device=dev)
    rdx = torch.full((rows,), ks.W, device=dev)
    k2 = decode_cuda.decode_rows_cuda(ws, inp["rkeys"], ks.ROWS_WIDTH, row_n,
                                      rx0, rdx, box=ks.W, periodic=True)
    held("K2", "K2 (rows_fused_decode)", (k2, body["rows_fused_decode"](
        salt)[1]), (decode_cuda.decode_rows_plain(
            ws, inp["rkeys"], rx0, kernels.bin_width(rdx, ks.ROWS_WIDTH),
            ks.W, row_n, ks.ROWS_WIDTH, True),) * 2)
    del k2
    # K6, then K8 on the plain stats' scalars
    xs = ks.salted_f32(inp["xrows"], salt)
    anchor = xs[:, 0].contiguous()
    boxes = torch.full((rows,), ks.W, device=dev)
    stats = encode_cuda.stats_rows_cuda(xs, boxes, anchor, True)
    mn, mx = encode_cuda.stats_rows_plain(xs, boxes, anchor, True)
    held("K6", "K6 (rows_recip_encode's stats)", stats, (mn, mx))
    rng_r = kernels.ftz(mx - mn).reshape(-1, 3).amax(dim=1)
    recip = kernels.ftz(torch.ones_like(rng_r) / kernels.ftz(rng_r))
    args = (ks.ROWS_DEPTH, mn, recip.repeat_interleave(3), boxes, anchor,
            True)
    want = encode_cuda.encode_recip_rows_plain(xs, *args)
    held("K8", "K8 (rows_recip_encode)",
         (encode_cuda.encode_recip_rows_cuda(xs, *args),
          body["rows_recip_encode"](salt)[1]), (want, want))
    del xs, want
    # K9
    vs = inp["bins"].clone()
    vs[0] ^= salt
    want = scan_cuda.cumsum_u32_plain(vs)
    held("K9", "K9 (cumsum_u32_pallas)", (scan_cuda.cumsum_u32(vs),
                                          body["cumsum_u32_pallas"](salt)[1]),
         (want, want))
    log(f"phase 11(b): K2 on ({rows}, {row_n}) at {ks.ROWS_WIDTH} bits, K6 "
        f"+ K8 on ({rows}, {row_n}) at depth {ks.ROWS_DEPTH}, K9 on "
        f"{vs.numel()} elements, each at salt 0xDEADBEEF: kernel == body "
        "== plain bitwise")
    return err


def dryrun_vs_plain(dev, got: dict) -> dict:
    """11(c): ``entry.dryrun_multichip(4)``'s card run against its sharded
    codecs' plain path on the card (``fused_rows=False``: words, headers,
    decodes, the global range), and its file and multihost read against
    the whole run on the CPU, where every wrapper takes its plain version;
    bitwise.  Returns each kernel's max abs error (K2, K3, K6, K7, K8)."""
    from minnow_c_tpu_torch import entry
    plain = entry.dryrun_multichip(4, device=dev, fused_rows=False)
    cpu = entry.dryrun_multichip(4, device="cpu")
    worst = 0.0

    def held(label, a, b):
        nonlocal worst
        a, b = (t.local if hasattr(t, "local") else t for t in (a, b))
        if a.shape != b.shape or not torch.equal(bits(a.cpu()),
                                                 bits(b.cpu())):
            raise AssertionError(f"phase 11(c): dryrun_multichip(4) "
                                 f"{label} != plain")
        worst = max(worst, max_abs_err(a.cpu(), b.cpu()))

    for k in ("pos", "vel", "ids", "words", "x0", "rng_b", "out"):
        held(k, got[k], plain[k])
    for i, (a, b) in enumerate(zip(got["enc"], plain["enc"])):
        held(f"enc[{i}]", a, b)
    if got["g"] != plain["g"] or got["file"] != cpu["file"]:
        raise AssertionError("phase 11(c): dryrun_multichip(4)'s global "
                             "range or file != plain")
    for k in ("pos", "vel", "ids"):
        held(f"read {k}", got["read"][k], cpu["read"][k])
    log("phase 11(c): dryrun_multichip(4) on the card == its codecs with "
        "fused_rows=False on the card, and its file and multihost read == "
        "the run on the CPU (plain versions), bitwise")
    return {k: worst for k in ("K2", "K3", "K6", "K7", "K8")}


def check_bench_layer(dev, work: dict, inp: dict):
    """11: ``bench.harness.run`` (trials of P11_TRIAL_S, a P11_TOTAL_S
    budget) on ``bench_workloads``' bodies: the headline (K1, its key on
    the card) and the kernel suite's rows_fused_decode (K2),
    rows_recip_encode (K6 + K8) and cumsum_u32_pallas (K9) at the suites'
    sizes; each harness time per iteration >= P11_FLOOR x the kernels'
    torch.profiler device time a body call (traced before phase 10 and
    again after the harness: the larger), each kernel-bytes rate <=
    1.05 x 3.35 TB/s, the last trial's salts all distinct (read after the
    run); then ``entry.dryrun_multichip(4)`` within its bounds.  After
    the counts are read, every kernel of the path against its plain
    version at the path's shapes (``bench_kernels_vs_plain``,
    ``dryrun_vs_plain``, and the headline's K1 against the host-key
    launch and the plain version).  Returns the path's launches and each
    kernel's max abs error."""
    from minnow_c_tpu_torch import entry
    from minnow_c_tpu_torch.bench import harness, headline
    from minnow_c_tpu_torch.ops import decode_cuda, kernels
    from minnow_c_tpu_torch.ops import rng as trng
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    runs = {}
    for name, (fn, nominal, _, _, _) in work.items():
        salts = []
        res = harness.run(fn, nominal, P11_TRIAL_S, P11_TOTAL_S, dev,
                          salts=salts)
        runs[name] = (res, salts)
    got = entry.dryrun_multichip(4, device=dev)
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in launch_counted().items()}
    log(f"phase 11: dryrun_multichip(4) on the card: positions within 1e-3, "
        f"velocities within 1.0, IDs exact, the multihost read of its "
        f"{got['read']['num_blocks']}-block file within 1e-3")
    for name, (fn, nominal, moved, kernel_names, dev_ms) in work.items():
        res, salts = runs[name]
        # traced again after phase 10 and the harness (earlier runs of
        # this script saw such traces come back empty): the floor holds
        # against the larger of the two that hold device time
        after = [device_ms(lambda: fn(torch.zeros(
            (), dtype=torch.int32, device=dev)), k) for k in kernel_names]
        after = None if None in after else sum(after)
        log(f"phase 11: {name}: its kernels' device time after phase 10 "
            f"and the harness: " + (f"{after:.4f} ms a body call" if after
                                    else "no device time in the traces"))
        dev_ms = max(dev_ms, after or 0.0)
        per_iter = res.trial_seconds / res.iterations * 1e3
        vals = torch.stack(salts).cpu()
        if vals.unique().numel() != vals.numel():
            raise AssertionError(f"phase 11: {name}: the last trial's "
                                 "salts repeat")
        rate = moved / (per_iter / 1e3)
        log(f"phase 11: {name}: {res.gb_per_second:.3f} GB/s of its "
            f"nominal {nominal} bytes, {per_iter:.4f} ms an iteration over "
            f"{res.iterations} (median trial {res.trial_seconds:.4f} s) "
            f"against its kernels' device time {dev_ms:.4f} ms a call; "
            f"kernel bytes {moved} at {rate / 1e9:.1f} GB/s; "
            f"{vals.numel()} distinct salts")
        if per_iter < P11_FLOOR * dev_ms:
            raise AssertionError(
                f"phase 11: {name}: {per_iter:.4f} ms an iteration is below "
                f"{P11_FLOOR} x the device time {dev_ms:.4f} ms")
        if rate > P11_RATE_CAP:
            raise AssertionError(f"phase 11: {name}: {rate / 1e12:.3f} TB/s "
                                 "of kernel bytes is over 1.05 x 3.35 TB/s")
    # the headline's K1 (key on the card) against the host-key launch and
    # the plain version, at its shape and salt 0xDEADBEEF
    packed = headline.packed_words(dev)
    key = trng.field_key(*headline.KEY)
    salt = -559038737
    salted = tuple((k ^ salt) & kernels.M32 for k in key)
    dev_key = decode_cuda.decode_cuda(
        packed, torch.tensor(key, dtype=torch.int64, device=dev) ^ salt,
        headline.LEVEL, headline.N, torch.zeros(1, device=dev),
        torch.full((1,), headline.WIDTH_BOX, device=dev),
        headline.WIDTH_BOX, periodic=True)
    host_key = decode_cuda.decode_cuda(packed, salted, headline.LEVEL,
                                       headline.N, 0.0, headline.WIDTH_BOX,
                                       headline.WIDTH_BOX, periodic=True)
    plain = decode_cuda.decode_plain(
        packed, *salted, np.float32(0.0),
        kernels.bin_width(headline.WIDTH_BOX, headline.LEVEL),
        np.float32(headline.WIDTH_BOX), headline.N, headline.LEVEL, 0, True)
    err = bench_kernels_vs_plain(dev, work, inp)
    for k, e in dryrun_vs_plain(dev, got).items():
        err[k] = max(err.get(k, 0.0), e)
    err["K1"] = max(max_abs_err(dev_key, plain), max_abs_err(host_key, plain))
    if not (torch.equal(bits(dev_key), bits(plain)) and
            torch.equal(bits(host_key), bits(plain))):
        raise AssertionError("phase 11: K1 with its key on the card != "
                             "plain")
    log(f"phase 11: K1 with its key on the card == the host-key launch == "
        f"plain bitwise at {headline.N} elements; launches on its path: "
        f"{launches}; {time.perf_counter() - t_phase:.1f} s")
    return launches, err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    if sys.argv[1:2] == ["--multihost-worker"]:
        return multihost_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    import minnow_c_tpu_torch as mt
    from minnow_c_tpu_torch.ops import cuda_lib, encode_cuda, scan_cuda

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"phase 1: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    cuda_lib.lib()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t:.2f} s")
    kernel_report(cuda_lib.build_log)

    g = torch.Generator(device=dev).manual_seed(SEED)
    err1 = check_decode_kernel(dev, g)
    err4 = check_pack_kernel(dev, g)
    rows_err = check_rows_kernels(dev, g)
    delta_err = check_delta_kernels(dev, g)
    recip_err = check_recip_kernels(dev, g)
    err13 = check_tiles_pack(dev, g)
    check_frozen_wire(mt, dev)
    check_u64_segments(mt, dev)
    # The CUDA-event floor: two events with nothing between.  A torch.profiler
    # trace leaves the card's tracing hooks in place, and they add to every
    # later event time; so the paths whose kernels are short (4, 6, 7(c),
    # 7(d)) run and are timed before the first trace.
    floor_ms = cuda_ms(lambda: None)
    reset_counts()
    seg, launches = check_main_path(mt, dev)
    times, e1, e4 = time_kernels(mt, seg, dev)
    del seg
    data, delta_launches = check_delta_path(mt, dev)
    delta_times, delta_e, deltas, body, plane = time_delta_kernels(mt, data,
                                                                   dev)
    # phase 9 on phase 6's fields, before the first torch.profiler trace
    p9, perm = check_sort_path(mt, data, dev)
    check_sort_cut(mt, data, perm)
    e9 = check_sort_kernels(mt, data, dev)
    del data, perm
    cli_launches, cli_e = check_cli(dev)
    k5_times = check_fast_recip(mt, dev)
    bins13 = u32_rows(1, 2 * 16384, 17, g, dev)[0]
    t13 = {"K13": cuda_ms(lambda: encode_cuda.pack_cuda(bins13, 17)),
           "K13 plain": cuda_ms(lambda: encode_cuda.pack_plain(bins13, 17))}
    note_work("K13", [bins13], [encode_cuda.pack_cuda(bins13, 17)])
    log(f"phase 7(e): K13 as K4's kernel at width 17, n {2 * 16384}: "
        f"{t13['K13']:.4f} ms, plain torch {t13['K13 plain']:.4f} ms (CUDA "
        "events, median of 5)")
    # phase 6's deltas and chunked plane wait on the host, out of phases 5
    # and 7's peak memory
    deltas, body = deltas.cpu(), body.cpu()
    snap_data, snap_launches = check_snapshot_path(mt, dev)
    rows_times, rows_e = time_rows_kernels(mt, snap_data, dev)
    # phase 7's parts on phase 5's snapshot run while it is on the card
    stats_a, keep, blob_a, recip_launches = check_recip_snapshot(
        mt, snap_data, dev)
    check_streaming(mt, snap_data, stats_a, keep, blob_a, dev)
    del keep, blob_a
    recip_times, recip_e, k12_launches = time_recip_rows(mt, snap_data, dev)
    # phase 8 on phase 5's snapshot while it is on the card
    mass8, deltas8, stats8, keep8, blob8, p8a, e8 = check_zoom_snapshot(
        mt, snap_data, dev)
    p8b = check_zoom_streaming(mt, snap_data, mass8, deltas8, stats8, keep8,
                               blob8, dev)
    card_vs_cpu_maps(snap_data[1], mass8)
    del keep8, blob8, mass8, deltas8, snap_data
    p8c, e8c = check_cli_masses(dev)
    e8 = {k: max(e8.get(k, 0.0), e8c.get(k, 0.0)) for k in {*e8, *e8c}}
    p8 = {k: p8a[k] + p8b[k] + p8c[k] for k in p8a}
    log(f"phase 8: launches on its path ((a) + (b) + (c)): {p8}")
    # the device times need traces: after phase 5's
    deltas = deltas.to(dev)
    delta_times["K9 device"] = device_ms(
        lambda: scan_cuda.cumsum_u32(deltas), "scan_kernel")
    delta_times["K9 library device"] = device_ms(
        lambda: torch.cumsum(deltas, 0, dtype=torch.int32), "Scan",
        per_call=True)
    log(f"phase 6: K9 device time alone (torch.profiler, 5 calls): "
        f"{delta_times['K9 device']} ms against {delta_times['K9']:.4f} ms "
        f"with its wrapper (CUDA events); torch.cumsum's kernels "
        f"{delta_times['K9 library device']} ms a call")
    # K10 and K11: all the card's activity in a call (the table's copy, the
    # memset, the kernel)
    body = body.to(dev)
    for k, (fast, _) in zip(("K10", "K11"), chunked_calls(body, *plane)):
        delta_times[k + " device"] = device_all_ms(fast)[""]
        log(f"phase 6: {k} device time a call (torch.profiler, 5 calls; "
            f"copy, memset and kernel): {delta_times[k + ' device']} ms "
            f"against {delta_times[k]:.4f} ms with its wrapper (CUDA "
            "events)")
    del deltas, body
    # phase 11's inputs and first device times, before phase 10 (it
    # traces again after the harness)
    bench_work, bench_inp = bench_workloads(dev)
    log(f"CUDA-event floor (two events, nothing between, median of 5): "
        f"{floor_ms:.4f} ms before the first torch.profiler trace, "
        f"{cuda_ms(lambda: None):.4f} ms after the last")
    # phase 10 last: its walls are host clocks, and its processes need the
    # card's memory free of the earlier phases' data
    p10 = check_sharded_paths(mt, dev)
    torch.cuda.empty_cache()
    p11, e11 = check_bench_layer(dev, bench_work, bench_inp)
    del bench_work, bench_inp

    # (name, source, replaced Pallas function, launches on its path,
    #  max_abs_err, times with "<K>" / "<K> plain" / "<K> library" keys)
    rows_ = {
        "K1": ("decode_uniform", "decode.cu", "decode_pallas.py:183",
               launches["K1"], max(err1, e1, cli_e["K1"]), times),
        "K2": ("decode_rows", "decode.cu", "decode_pallas.py:361",
               snap_launches["K2"], max(rows_err["K2"], rows_e["K2"]),
               rows_times),
        "K3": ("unpack_rows", "decode.cu", "decode_pallas.py:291",
               snap_launches["K3"], max(rows_err["K3"], rows_e["K3"]),
               rows_times),
        "K4": ("pack_uniform", "pack.cu", "encode_pallas.py:103",
               launches["K4"], max(err4, e4, cli_e["K4"]), times),
        "K5": ("encode_recip", "pack.cu", "encode_pallas.py:368",
               cli_launches["K5"], max(recip_err["K5"], cli_e["K5"]),
               k5_times),
        "K6": ("stats_rows", "stats.cu", "encode_pallas.py:501",
               snap_launches["K6"], max(rows_err["K6"], rows_e["K6"]),
               rows_times),
        "K7": ("pack_rows", "pack.cu", "encode_pallas.py:147",
               snap_launches["K7"], max(rows_err["K7"], rows_e["K7"]),
               rows_times),
        "K8": ("encode_recip_rows", "pack.cu", "encode_pallas.py:395",
               recip_launches["K8"],
               max(recip_err["K8"], recip_e["K8"]), recip_times),
        "K9": ("cumsum_u32", "scan.cu", "scan_pallas.py:106",
               delta_launches["K9"], max(delta_err["K9"], delta_e["K9"]),
               delta_times),
        "K10": ("chunked_decode", "chunked.cu", "chunked_pallas.py:208",
                delta_launches["K10"], max(delta_err["K10"],
                                           delta_e["K10"]), delta_times),
        "K11": ("chunked_decode_floats", "chunked.cu",
                "chunked_pallas.py:346", delta_launches["K11"],
                max(delta_err["K11"], delta_e["K11"]), delta_times),
        "K12": ("encode_recip_fused_blocks", "encode_recip.cu",
                "encode_pallas.py:637", k12_launches,
                max(recip_err["K12"], recip_e["K12"]), recip_times),
        "K13": ("pack_pallas_tiles (K13) as pack_uniform (K4)", "pack.cu",
                "pack_pallas.py:76", launches["K4"], err13, t13),
    }
    library_calls = {
        "K6": "torch.aminmax(rows, dim=1): nearest call, no unwrap, "
              "differs on +-0",
        "K9": "torch.cumsum(x, 0, dtype=torch.int32)"}
    kernels = []
    for k, (name, src, rep_, n_launch, err, t) in rows_.items():
        b_ms, b_by = bound(k)
        row = {"name": name if "(K" in name else f"{name} ({k})",
               "route": "cuda", "source": f"minnow_c_tpu_torch/csrc/{src}",
               "replaces": f"minnow_c_tpu/ops/{rep_}", "launches": n_launch,
               "max_abs_err": max(err, e8.get(k, 0.0), e9.get(k, 0.0),
                                  e11.get(k, 0.0)),
               "ms": t[k], "plain_ms": t[k + " plain"],
               "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / t[k],
               "library_ms": t.get(k + " library")}
        if k in library_calls:
            row["library_call"] = library_calls[k]
        if k in ("K2", "K3", "K6", "K7", "K8", "K9", "K10", "K11"):
            row["device_ms"] = t[k + " device"]
        if k == "K9":
            row["library_device_ms"] = t["K9 library device"]
        if k in ("K2", "K3", "K7", "K8"):
            row["widths_ms"] = t[k + " widths"]
        if k == "K6":
            row["velocity_rows_ms"] = t["K6 vel"]
        if k == "K5":
            row["k4_same_bins_ms"] = t["K5 K4"]
        # K13 is K4's kernel: its phase 8 launches are K4's
        row["phase8_launches"] = p8["K4" if k == "K13" else k]
        row["phase9_launches"] = p9["K4" if k == "K13" else k]
        row["phase10_launches"] = p10["K4" if k == "K13" else k]
        row["phase11_launches"] = p11["K4" if k == "K13" else k]
        kernels.append(row)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
