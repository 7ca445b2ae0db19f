"""The benchmark matrix over the BASELINE.json configs, the counterpart of
the JAX repository's ``bench_all.py``, with its shapes and seeds:

1. ``config1``: a 1M-value single-segment round trip (Trim, newest);
2. ``config2``: the single-stream encode at 25.2M values, depth 14: the
   div map (torch division, K4), the recip map (``fast_uniform_encode``'s
   stats and host reads, K5) and the pack alone (K4);
3. ``config3``: a 10M-particle pos + vel + ids snapshot in 8 blocks
   through ``compress_snapshot`` / ``decompress_snapshot`` (8 | 10M but
   32 does not divide its 1,250,000-particle blocks: K1 row by row, the
   IDs through the per-row unpack);
4. ``config4``: ``ShardedPositionCodec`` round trips over 8 blocks of
   6,249,984 (K6, K7, K2), then the words' gather to the host and LZ4;
   ``config4_100m``: 8 blocks of 12,582,912 (100.66M particles, 1.21 GB),
   encode (div, recip) and decode timed apart, the error over the whole
   output;
5. ``config5``: ``entry.dryrun_multichip(8)`` and a two-process gloo write
   of an 8-block snapshot (this module's ``--multihost-worker``), whose
   file must equal the single-host file byte for byte;
6. ``config6_streaming``: 6 waves of 4M particles streamed at depth 17,
   host RSS and device peak memory per wave, which must stay flat.

Device phases go through ``harness.run`` with a salt XORed into element 0
(and 1) of the input on the card; after a config's timing, each of its
bodies is traced and its time an iteration held at no less than
``harness.FLOOR`` x its device time a call (``harness.check_floors``).
A config that fails is recorded with
its error and the matrix goes on; ``main`` then returns non-zero.  Writes
the "matrix" section of a records file, one entry per config.
"""

from __future__ import annotations

import hashlib
import io
import os
import resource
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import counts, harness
from . import records as _records
from .kernel_suite import salted_f32

W = 64.0
DELTA = 1e-3
MH_RANKS = 2
MH_TIMEOUT = 600   # seconds a config5 worker may take
_MANTISSA = 0x3FFFFF


def _sync(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_reset(dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def _peak(dev):
    """Peak device memory since the last reset, bytes (None off the
    card)."""
    if torch.device(dev).type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(dev)


def _wall(fn, dev):
    """(result, seconds) of ``fn()`` up to the card's completion."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, time.perf_counter() - t0


def _periodic_err(a: torch.Tensor, b: torch.Tensor) -> float:
    e = (a - b).abs()
    return float(torch.minimum(e, W - e).max())


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _salt_at(buf: torch.Tensor, base: torch.Tensor, s) -> torch.Tensor:
    """``base`` with elements 0 and 1 of its first row XOR the salt's bits
    (element 0 the low 22, element 1 bits 10-31: every salt bit lands in
    a mantissa), written into the working copy ``buf`` (bench_all.py's
    ``salt_perturb``)."""
    flat, src = buf.view(-1).view(torch.int32), base.view(-1).view(
        torch.int32)
    flat[0] = src[0] ^ (s & _MANTISSA)
    flat[1] = src[1] ^ ((s >> 10) & _MANTISSA)
    return buf


def config1(device, n: int = 1_000_000) -> dict:
    from .. import (AlgoCode, Field, FieldCode, FieldHeader,
                    PositionAccuracy, Seg)
    from ..algos import registry
    from ..segment import api

    rng = np.random.default_rng(0)
    pos = rng.uniform(0, W, (3, n)).astype(np.float32)
    ver = registry.newest(AlgoCode.TRIM)
    data = torch.from_numpy(pos).to(device)

    def seg():
        return Seg(fields=[Field(
            hd=FieldHeader(FieldCode.POSN, AlgoCode.TRIM, ver, n),
            data=data, acc=PositionAccuracy(delta=DELTA, width=W))])
    warm = api.compress_segment(seg(), seed=0, device=device)
    api.decompress_segment(warm, fused=True, device=device)
    counts.reset()
    blob, t_enc = _wall(lambda: api.compress_segment(seg(), seed=1,
                                                     device=device), device)
    out, t_dec = _wall(lambda: api.decompress_segment(
        blob, fused=True, device=device), device)
    err = _periodic_err(out.fields[0].data, data)
    _require(err <= DELTA, f"config1: error {err} over {DELTA}")
    return {"within_delta": err <= DELTA, "max_err": err,
            "encode_s": t_enc, "decode_s": t_dec,
            "ratio": len(blob) / pos.nbytes, "launches": counts.read(),
            "note": "warm; fused decode; walls up to the card's "
                    "completion"}


def config2(device, n: int = (1 << 14) * 1536, depth: int = 14) -> dict:
    from ..ops import bitpack, fastpath, kernels
    from ..ops.encode_cuda import encode_recip_cuda

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, W, n).astype(np.float32)).to(device)
    out, bodies = {}, {}

    def timed(name, fn):
        counts.reset()
        r = harness.run(fn, n * 4, device=device)
        out[name] = r.gb_per_second
        out[name + "_ms_per_iter"] = r.trial_seconds / r.iterations * 1e3
        out[name + "_launches"] = counts.read()
        bodies[name] = (fn, out[name + "_ms_per_iter"])

    timed("GBps", lambda s: fastpath.fast_uniform_encode(
        salted_f32(x, s), depth, periodic_width=W))
    timed("recip_mode_GBps", lambda s: fastpath.fast_uniform_encode(
        salted_f32(x, s), depth, periodic_width=W, scale_mode="recip"))
    # the recip map's K5 alone, its host scalars read once: how far the
    # stats and the three host reads of each call set the pace
    x0, x1 = kernels.minmax(kernels.undo_periodic(x, W))
    args = (x0.item(), kernels.exact_recip(kernels.ftz(x1 - x0).item()), W,
            x[0].item())
    timed("recip_kernel_only_GBps", lambda s: encode_recip_cuda(
        salted_f32(x, s), depth, *args, True))
    mn, mx = kernels.minmax(x)
    bins = kernels.uniform_bin_index(x, depth, mn, kernels.ftz(mx - mn))
    timed("pack_only_GBps", lambda s: bitpack.uniform_pack(bins ^ s, depth))
    for name, ms in harness.check_floors(bodies, device).items():
        out[name + "_device_ms"] = ms
    out.update({
        "depth": depth, "input_MB": n * 4 / 1e6,
        "note": "GBps = the div map (torch IEEE division, then K4); "
                "recip_mode_GBps = fast_uniform_encode(scale_mode='recip'): "
                "torch stats, three host reads a call (x0, range, x[0]), "
                "K5; recip_kernel_only_GBps = K5 on host scalars read once; "
                "pack_only includes a full salt XOR pass; every encode "
                "includes the salt's full XOR pass (salted_f32)"})
    return out


def config3(device, n: int = 10_000_000, blocks: int = 8) -> dict:
    from .. import (IDAccuracy, PositionAccuracy, VelocityAccuracy,
                    compress_snapshot, decompress_snapshot)
    from ..parallel.snapshot import SnapshotSpec

    rng = np.random.default_rng(2)
    steps = rng.normal(0, 0.01, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + W / 2).astype(np.float32) % W
    vel = rng.normal(0, 200, (3, n)).astype(np.float32)
    ids = rng.permutation(1 << 24)[:n].astype(np.uint64)
    raw = pos.nbytes + vel.nbytes + ids.nbytes
    spec = SnapshotSpec(pos=PositionAccuracy(delta=DELTA, width=W),
                        vel=VelocityAccuracy(delta=1.0),
                        ids=IDAccuracy(width=1024))
    tpos, tvel = (torch.from_numpy(a).to(device) for a in (pos, vel))
    tids = torch.from_numpy(ids.view(np.int64)).to(device)
    buf = io.BytesIO()
    compress_snapshot(buf, tpos, tvel, tids, spec, num_blocks=blocks,
                      device=device)
    buf.seek(0)
    decompress_snapshot(buf, device=device)
    counts.reset()
    buf = io.BytesIO()
    stats, t_enc = _wall(lambda: compress_snapshot(
        buf, tpos, tvel, tids, spec, num_blocks=blocks, seed=1,
        device=device), device)
    buf.seek(0)
    out, t_dec = _wall(lambda: decompress_snapshot(buf, device=device),
                       device)
    err = _periodic_err(out["pos"], tpos)
    ok = err <= DELTA and bool(torch.equal(out["ids"], tids))
    _require(ok, f"config3: position error {err} over {DELTA} or IDs "
                 "not exact")
    return {"ok": ok, "max_pos_err": err, "encode_s": t_enc,
            "decode_s": t_dec, "ratio": stats["bytes"] / raw,
            "launches": counts.read(),
            "note": f"{n // blocks} particles a block: 32 does not divide "
                    "it, so K1 row by row and the IDs' per-row unpack "
                    "(parallel/snapshot.py); walls up to the card's "
                    "completion"}


def config4(device, blocks: int = 8, nb: int = 6_249_984) -> dict:
    from ..ops import entropy
    from ..parallel.sharding import (ShardedPositionCodec, make_mesh,
                                     spmd_depth_for)

    n = blocks * nb
    rng = np.random.default_rng(3)
    xd = torch.from_numpy(rng.uniform(0, W, (blocks * 3, nb)).astype(
        np.float32)).to(device)
    codec = ShardedPositionCodec(mesh=make_mesh(1, device=device), width=W,
                                 depth=spmd_depth_for(DELTA, W))
    xbuf = xd.clone()

    def roundtrip(s):
        words, x0b, rng_b = codec.encode(_salt_at(xbuf, xd, s))
        return codec.decode(words, x0b, rng_b, seed=4)
    counts.reset()
    res = harness.run(roundtrip, n * 12, device=device)
    launches = counts.read()
    per_iter = res.trial_seconds / res.iterations * 1e3
    dev_ms = harness.check_floors({"roundtrip": (roundtrip, per_iter)},
                                  device).get("roundtrip")
    words, x0b, rng_b = codec.encode(xd)
    err = _periodic_err(codec.decode(words, x0b, rng_b, seed=4), xd)
    _require(err <= DELTA, f"config4: error {err} over {DELTA}")
    _sync(device)
    t0 = time.perf_counter()
    words_h = words.cpu().numpy().view(np.uint32)
    t1 = time.perf_counter()
    blobs = entropy.encode_blocks([np.ascontiguousarray(r) for r in words_h])
    t2 = time.perf_counter()
    return {"particles": n, "blocks": blocks,
            "device_roundtrip_GBps": res.gb_per_second,
            "roundtrip_ms_per_iter": per_iter,
            "roundtrip_device_ms": dev_ms,
            "gather_D2H_s": t1 - t0, "host_lz4_s": t2 - t1,
            "max_err_full_array": err, "within_delta": err <= DELTA,
            "packed_ratio": sum(len(b) for b in blobs) / (n * 12),
            "launches": launches,
            "note": "harness round trips (encode + decode, rate of the raw "
                    "positions); the salt is an element update of the "
                    "input; the words' copy to the host and LZ4 timed once"}


def config4_100m(device, blocks: int = 8, nb: int = 12_582_912) -> dict:
    from ..parallel.sharding import (ShardedPositionCodec, make_mesh,
                                     spmd_depth_for)

    n = blocks * nb
    raw = n * 12
    rng = np.random.default_rng(7)
    mesh = make_mesh(1, device=device)
    depth = spmd_depth_for(DELTA, W)
    codec = ShardedPositionCodec(mesh=mesh, width=W, depth=depth)
    codec_r = ShardedPositionCodec(mesh=mesh, width=W, depth=depth,
                                   scale_mode="recip")
    xd = torch.from_numpy(rng.uniform(0, W, (blocks * 3, nb)).astype(
        np.float32)).to(device)
    words, x0b, rng_b = codec.encode(xd)
    err = _periodic_err(codec.decode(words, x0b, rng_b, seed=4), xd)
    _require(err <= DELTA, f"config4_100m: error {err} over {DELTA}")
    out = {"particles": n, "blocks": blocks, "depth": depth,
           "max_err_full_array": err, "delta_requested": DELTA,
           "within_delta": err <= DELTA}
    xbuf = xd.clone()
    wbuf = words.clone()
    bodies = {}

    def timed(name, fn):
        counts.reset()
        _peak_reset(device)
        r = harness.run(fn, raw, device=device)
        out[name] = r.gb_per_second
        per_iter = r.trial_seconds / r.iterations * 1e3
        out[name.replace("GBps", "ms_per_iter")] = per_iter
        bodies[name] = (fn, per_iter)
        out[name.replace("GBps", "launches")] = counts.read()
        out[name.replace("GBps", "peak_bytes")] = _peak(device)

    timed("encode_GBps", lambda s: codec.encode(_salt_at(xbuf, xd, s))[0])
    timed("encode_recip_GBps",
          lambda s: codec_r.encode(_salt_at(xbuf, xd, s))[0])
    timed("decode_GBps", lambda s: codec.decode(
        _salt_at(wbuf, words, s), x0b, rng_b, seed=4))
    for name, ms in harness.check_floors(bodies, device).items():
        out[name.replace("GBps", "device_ms")] = ms
    out["note"] = ("harness device phases, rate of the raw positions; the "
                   "recip encode reads each row's range to the host once a "
                   "call (sharding._rows_encode); error over the whole "
                   "output; peaks include the harness's four held outputs")
    return out


def _mh_data():
    """config5's global snapshot (numpy seed 0): 8 blocks of 256."""
    rng = np.random.default_rng(0)
    gx = rng.uniform(0, W, (8, 3, 256)).astype(np.float32)
    gv = rng.normal(0, 200, (8, 3, 256)).astype(np.float32)
    gi = rng.permutation(1024 * 1024 * 2)[: 8 * 256].astype(
        np.uint64).reshape(8, 256)
    return gx, gv, gi


def _mh_spec():
    from .. import IDAccuracy, PositionAccuracy, VelocityAccuracy
    from ..parallel.snapshot import SnapshotSpec
    return SnapshotSpec(pos=PositionAccuracy(delta=DELTA, width=W),
                        vel=VelocityAccuracy(delta=1.0),
                        ids=IDAccuracy(width=1024))


def _slab(blocks: np.ndarray) -> np.ndarray:
    """(B, d, nb) -> (d, B * nb); (B, nb) -> (B * nb,)."""
    if blocks.ndim == 3:
        return np.concatenate(list(blocks), axis=1)
    return blocks.reshape(-1)


def multihost_worker(rank: int, addr: str, path: str, device) -> int:
    """One rank of config5's write: its half of the blocks through
    ``compress_snapshot_multihost`` (rank 0 writes ``path``)."""
    from ..parallel import multihost
    from ..parallel.snapshot import compress_snapshot_multihost
    multihost.initialize(addr, MH_RANKS, rank)
    gx, gv, gi = _mh_data()
    k = gx.shape[0] // MH_RANKS
    lo, hi = rank * k, (rank + 1) * k
    fp = open(path, "wb") if rank == 0 else None
    try:
        st = compress_snapshot_multihost(
            fp, _slab(gx[lo:hi]), _slab(gv[lo:hi]), _slab(gi[lo:hi]),
            _mh_spec(), num_blocks_local=k, seed=5, device=device)
    finally:
        if fp is not None:
            fp.close()
    multihost.barrier()
    return 0 if st["num_blocks"] == gx.shape[0] else 1


def config5(device) -> dict:
    from .. import entry
    from ..parallel.snapshot import compress_snapshot

    _, t_dry = _wall(lambda: entry.dryrun_multichip(8, device=device),
                     device)
    gx, gv, gi = _mh_data()
    buf = io.BytesIO()
    compress_snapshot(buf, _slab(gx), _slab(gv), _slab(gi), _mh_spec(),
                      num_blocks=gx.shape[0], seed=5, device=device)
    want = hashlib.sha256(buf.getvalue()).hexdigest()
    with socket.socket() as s:
        s.bind(("localhost", 0))
        addr = f"localhost:{s.getsockname()[1]}"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "multihost.min")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "minnow_c_tpu_torch.bench.matrix",
             "--multihost-worker", str(r), addr, path, str(device)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo) for r in range(MH_RANKS)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=MH_TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        t_mh = time.perf_counter() - t0
        rcs = [p.returncode for p in procs]
        got = hashlib.sha256(open(path, "rb").read()).hexdigest() \
            if os.path.exists(path) else None
    if any(rcs):
        raise RuntimeError(f"config5 worker exit codes {rcs}: "
                           + " | ".join(o[-800:] for o in outs))
    _require(got == want, "config5: the two-process file differs from the "
                          "single-host file")
    return {"dryrun_8way_mesh": True, "dryrun_s": t_dry,
            "two_process_write": got == want, "two_process_s": t_mh,
            "sha256": got,
            "note": "dryrun_multichip(8): 8 logical shards of the card; "
                    f"{MH_RANKS} processes over gloo write an 8-block "
                    "snapshot whose sha256 must equal the single-host "
                    "file's"}


def config6_streaming(device, nb: int = 4_000_000, waves: int = 6,
                      depth: int = 17) -> dict:
    from .. import PositionAccuracy, compress_snapshot_streaming
    from ..parallel.snapshot import SnapshotSpec

    rng = np.random.default_rng(11)
    spec = SnapshotSpec(pos=PositionAccuracy(delta=DELTA, width=W))
    rss, dev_peak, wave_s = [], [], []

    def blocks():
        for _ in range(waves):
            pos = rng.uniform(0, W, (3, nb)).astype(np.float32)
            _peak_reset(device)
            t0 = time.perf_counter()
            yield {"pos": pos}
            _sync(device)
            wave_s.append(time.perf_counter() - t0)
            dev_peak.append(_peak(device))
            rss.append(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with open(os.path.join(tmp, "stream.min"), "wb") as f:
            stats = compress_snapshot_streaming(
                f, blocks(), spec, seed=3, depths={"pos": depth},
                device=device)
        wall = time.perf_counter() - t0
    wave_bytes = nb * 12
    growth = (rss[-1] - rss[0]) * 1024   # ru_maxrss is KiB on Linux
    out = {"particles": nb * waves, "wave_particles": nb, "waves": waves,
           "bytes": stats["bytes"], "wall_s": wall, "wave_s": wave_s,
           "wave_s_after_warm": float(np.median(wave_s[1:])),
           "rss_growth_after_wave1_bytes": growth,
           "device_peak_bytes_per_wave": dev_peak,
           "note": "one wave = one block encoded and written; the device "
                   "peak is reset before each wave"}
    if dev_peak[0] is not None:
        later = dev_peak[1:]
        out["device_peak_flat"] = max(later) - min(later) <= wave_bytes // 8
        if not out["device_peak_flat"]:
            raise AssertionError(f"config6: device peak per wave grows: "
                                 f"{dev_peak}")
    return out


CONFIGS = {f.__name__: f for f in (config1, config2, config3, config4,
                                   config4_100m, config5, config6_streaming)}


def main(device="cuda", names=None, records: str = None) -> int:
    """Run the named configs (all by default) in order; a failed config is
    recorded with its error and the rest still run.  Returns 0 when every
    config ran, 1 otherwise."""
    names = list(CONFIGS if not names else names)
    unknown = sorted(set(names) - set(CONFIGS))
    if unknown:
        raise ValueError(f"unknown configs {unknown}")
    results = _records.load(records).get("matrix", {}) if records else {}
    failed = []
    for name in names:
        t0 = time.perf_counter()
        try:
            res = CONFIGS[name](device)
        except Exception as exc:  # noqa: BLE001 - record it, run the rest
            res = {"error": f"{type(exc).__name__}: {exc}"[:2000]}
            failed.append(name)
        res["config_s"] = time.perf_counter() - t0
        res["device"] = harness.describe_device(device)
        results[name] = res
        print(f"{name}: " + ", ".join(
            f"{k}={v}" for k, v in res.items() if k != "device"),
            flush=True)
        if records:
            _records.update_sections(records, {"matrix": results})
    if failed:
        print(f"matrix: failed configs {failed}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    if sys.argv[1:2] != ["--multihost-worker"] or len(sys.argv) != 6:
        sys.exit("usage: python -m minnow_c_tpu_torch.bench.matrix "
                 "--multihost-worker RANK HOST:PORT PATH DEVICE (config5's "
                 "ranks; run the matrix as python -m "
                 "minnow_c_tpu_torch.bench matrix)")
    sys.exit(multihost_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                              sys.argv[5]))
