"""Headline benchmark: decode throughput of the fast-uniform path on one
card, the counterpart of the JAX package's ``bench.py``.

Workload (the reference's "(mock) undo fast compress" bench,
test/compress_util_bench.c:264-298): unpack packed bins -> dithered
undo-bin-index -> periodic rewrap, at level 11, box 64, on bench.py's
24,641,536-element plane: one K1 launch a call (``decode_cuda`` with its
key on the card).  Bins from numpy seed 0, packed on the host; the key
``field_key(1234, 0, 0)`` XOR the harness's salt (one launch of its own).
Throughput is GB/s of decoded f32 output per card; the baseline target is
5 GB/s (BASELINE.md).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "GB/s", "vs_baseline": N}
and on failure the same line with "error", value 0 and a non-zero exit.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from ..ops import native
from ..ops import rng as _rng
from ..ops.decode_cuda import decode_cuda
from . import harness

METRIC = "decode_fast_uniform_GBps_per_chip"
BASELINE_GBPS = 5.0
LEVEL = 11  # compress_util_bench.c:247
# 100 MB of f32 output (compress_util_bench.c:318) cut to a multiple of
# the JAX decode kernel's 2^19-element tile, as bench.py cuts it: 47 * 2^19
N = 24_641_536
WIDTH_BOX = 64.0
KEY = (1234, 0, 0)  # field_key(seed, field, dim)


def packed_words(device="cuda", n: int = N) -> torch.Tensor:
    """The plane's words on ``device``: numpy seed 0 bins at LEVEL bits,
    packed on the host (int32 tensor of u32 bits)."""
    bins = np.random.default_rng(0).integers(0, 1 << LEVEL, n,
                                             dtype=np.uint64)
    return torch.from_numpy(native.uniform_pack_host(
        bins.astype(np.uint32), LEVEL).view(np.int32)).to(device)


def workload(device="cuda", n: int = N):
    """(fn(salt) -> decoded plane, bytes of f32 output a call)."""
    dev = torch.device(device)
    packed = packed_words(dev, n)
    key = torch.tensor(_rng.field_key(*KEY), dtype=torch.int64, device=dev)
    x0 = torch.zeros(1, dtype=torch.float32, device=dev)
    dx = torch.full((1,), WIDTH_BOX, dtype=torch.float32, device=dev)

    def fn(salt):
        return decode_cuda(packed, key ^ salt, LEVEL, n, x0, dx, WIDTH_BOX,
                           periodic=True)
    return fn, n * 4


def line(value: float, error: str = None) -> dict:
    out = {"metric": METRIC, "value": round(value, 3), "unit": "GB/s",
           "vs_baseline": round(value / BASELINE_GBPS, 3)}
    if error is not None:
        out["error"] = error
    return out


def main(device="cuda", records: str = None) -> int:
    """Print the one JSON line (and write the records' "headline"
    section); 0 on success, 2 on failure."""
    try:
        fn, nbytes = workload(device)
        res = harness.run(fn, nbytes, device=device)
        per_iter = res.trial_seconds / res.iterations * 1e3
        dev_ms = harness.check_floors({"headline": (fn, per_iter)},
                                      device).get("headline")
    except Exception as exc:  # noqa: BLE001 - one line, then a failed exit
        print(json.dumps(line(0.0, f"{type(exc).__name__}: {exc}")),
              flush=True)
        return 2
    out = line(res.gb_per_second)
    print(json.dumps(out), flush=True)
    if records is not None:
        from . import records as _records
        _records.update_sections(records, {"headline": {
            **out, "device": harness.describe_device(device),
            "n_elems": N, "level": LEVEL, "iterations": res.iterations,
            "trial_s": res.trial_seconds,
            "ms_per_iter": per_iter, "device_ms": dev_ms}})
    return 0
