#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (minnow_c_tpu_torch) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc (the CUDA toolkit) and the repository checkout;
imports nothing of JAX.  Phases, one progress line each; any failure raises
and the script exits non-zero:

1. device: card name, power limit, kernel build time;
2. each CUDA kernel (K1 fused decode, K4 pack) against its plain torch
   version on the card, bitwise, over widths, ragged sizes and edge values;
3. the frozen wire: Trim v1.0 / v1.1 segments encoded from CUDA tensors and
   decoded on CUDA (generic and fused) match tests/fixtures/wire_digests.json;
4. the main path at full size: one segment of 2^24 particles (a 256^3
   N-body snapshot: lattice positions with Gaussian displacements,
   Gaussian velocities, shuffled lattice IDs) through compress_segment and
   decompress_segment on CUDA, with error bounds, exact IDs, fused ==
   generic, launch counts, wall times, rates and peak memory; then each
   kernel timed against its plain version at the main path's shapes.

The last line is {"ok": true, "device": {...}}; the line before it lists
the kernels with their launch counts, errors and times.
"""

from __future__ import annotations

import hashlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(REPO, "tests", "fixtures", "wire_digests.json")
SIDE = 256                 # particles per box side: 2^24 in all
BOX = 64.0                 # periodic box width
POS_DELTA, VEL_DELTA = 1e-3, 1.0
SEED = 42


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
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
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


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_decode_kernel(dev, g) -> float:
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda
    worst = 0.0
    cases = 0
    for width in (1, 7, 11, 16, 23, 24):
        for n in (32, (1 << 20) + 37):
            top = (1 << width) - 1
            bins = torch.randint(0, top + 1, (n,), generator=g, device=dev,
                                 dtype=torch.int64)
            bins[:4] = 0
            bins[4:8] = top
            bins[-3:] = top
            words = encode_cuda.pack_plain(bins.to(torch.int32), width)
            for periodic in (False, True):
                # periodic: values span [-2, 66) so both rewraps happen
                x0, dx = (-2.0, 68.0) if periodic else (1.5, 32.0)
                for elem0 in (0, 1 << 14):
                    key = (0x12345678 + width, 0x9ABCDEF0 + n)
                    got = decode_cuda.decode_cuda(words, key, width, n, x0,
                                                  dx, BOX, periodic, elem0)
                    want = decode_cuda.decode_plain(
                        words, *key, x0, np.float32(dx) / np.float32(
                            2.0 ** width), BOX, n, width, elem0, periodic)
                    torch.cuda.synchronize()
                    worst = max(worst, max_abs_err(got, want))
                    if not torch.equal(bits(got), bits(want)):
                        raise AssertionError(
                            f"K1 != plain: width={width} n={n} "
                            f"periodic={periodic} elem0={elem0}")
                    cases += 1
    log(f"phase 2: K1 decode == plain bitwise in {cases} cases "
        f"(max_abs_err {worst})")
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
    for n in (37, (1 << 20) + 37):
        vals = torch.randint(-(1 << 31), 1 << 31, (n,), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
        for width in range(1, 33):
            got = encode_cuda.pack_cuda(vals, width)
            want = encode_cuda.pack_plain(vals, width)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K4 != plain: u32 width={width} n={n}")
            cases += 1
        for width in range(1, 25):
            s = edge_plane(width, n if n > 300 else 300, g, dev)
            got = encode_cuda.pack_cuda(s, width, from_f32=True)
            want = encode_cuda.pack_plain(s, width, from_f32=True)
            torch.cuda.synchronize()
            worst = max(worst, max_abs_err(got, want))
            if not torch.equal(got, want):
                raise AssertionError(f"K4 != plain: from_f32 width={width}")
            cases += 1
    log(f"phase 2: K4 pack == plain bitwise in {cases} cases "
        f"(max_abs_err {worst})")
    return worst


# ---------------------------------------------------------------------------
# Phase 3: the frozen wire on CUDA
# ---------------------------------------------------------------------------

def reference_segment(mt, version: int, dev):
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
        hd = mt.FieldHeader(code, mt.AlgoCode.TRIM, version, n)
        return mt.Field(hd=hd, data=torch.from_numpy(data).to(dev), acc=acc)

    F = mt.FieldCode
    return mt.Seg(fields=[
        field(F.POSN, pos, mt.PositionAccuracy(delta=1e-3, width=W)),
        field(F.VELC, vel, mt.VelocityAccuracy(delta=0.25)),
        field(F.PTID, ids, mt.IDAccuracy(width=512)),
        field(F.UNSF, uf, mt.FloatAccuracy(delta=1e-3)),
        field(F.UNSI, ui, mt.IntAccuracy()),
    ])


def decode_digest(seg) -> str:
    h = hashlib.sha256()
    for f in seg.fields:
        h.update(np.ascontiguousarray(f.data.cpu().numpy()).tobytes())
    return h.hexdigest()


def check_frozen_wire(mt, dev) -> None:
    with open(FIXTURE) as f:
        want = json.load(f)
    for name, version in (("trim", mt.semver.pack(1, 0, 0)),
                          ("trim_v1_1", mt.semver.pack(1, 1, 0))):
        blob = mt.compress_segment(reference_segment(mt, version, dev),
                                   seed=777)
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
        log(f"phase 3: {name} encode {enc[:16]}.. ({len(blob)} B) and "
            "decode (generic, fused) match the frozen digests on CUDA")


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


def check_main_path(mt, dev):
    from minnow_c_tpu_torch.ops import decode_cuda, encode_cuda
    seg = snapshot(mt, dev)
    n = SIDE ** 3
    raw = n * (3 * 4 + 3 * 4 + 8)
    torch.cuda.synchronize()

    decode_cuda.decode_cuda.launches = 0
    encode_cuda.pack_cuda.launches = 0
    blob, t_enc, m_enc = timed(lambda: mt.compress_segment(seg, seed=SEED))
    fused, t_fus, m_fus = timed(
        lambda: mt.decompress_segment(blob, fused=True, device=dev))
    generic, t_gen, m_gen = timed(
        lambda: mt.decompress_segment(blob, fused=False, device=dev))
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
    t = {name: cuda_ms(fn) for name, fn in
         (("K1", k1), ("K1 plain", k1_plain), ("K4", k4),
          ("K4 plain", k4_plain))}
    for k in ("K1", "K4"):
        log(f"phase 4: {k} at width {width}, n {n}: {t[k]:.4f} ms, plain "
            f"torch {t[k + ' plain']:.4f} ms (CUDA events, median of 5)")
    return t, err1, err4


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    import minnow_c_tpu_torch as mt
    from minnow_c_tpu_torch.ops import cuda_lib

    dev = torch.device("cuda")
    card = nvidia_smi()
    log(f"phase 1: {torch.cuda.get_device_name(0)} ({card}); torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    t = time.perf_counter()
    cuda_lib.lib()
    log(f"phase 1: kernels built and loaded in "
        f"{time.perf_counter() - t:.2f} s")
    for line in cuda_lib.build_log.splitlines():
        if "registers" in line:
            log(f"phase 1: ptxas: {line.split(':', 1)[-1].strip()}")

    g = torch.Generator(device=dev).manual_seed(SEED)
    err1 = check_decode_kernel(dev, g)
    err4 = check_pack_kernel(dev, g)
    check_frozen_wire(mt, dev)
    seg, launches = check_main_path(mt, dev)
    times, e1, e4 = time_kernels(mt, seg, dev)

    kernels = [
        {"name": "decode_uniform (K1)", "route": "cuda",
         "source": "minnow_c_tpu_torch/csrc/decode.cu",
         "replaces": "minnow_c_tpu/ops/decode_pallas.py:183",
         "launches": launches["K1"], "max_abs_err": max(err1, e1),
         "ms": times["K1"], "plain_ms": times["K1 plain"]},
        {"name": "pack_uniform (K4)", "route": "cuda",
         "source": "minnow_c_tpu_torch/csrc/pack.cu",
         "replaces": "minnow_c_tpu/ops/encode_pallas.py:103",
         "launches": launches["K4"], "max_abs_err": max(err4, e4),
         "ms": times["K4"], "plain_ms": times["K4 plain"]},
    ]
    print(nvidia_smi(), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
