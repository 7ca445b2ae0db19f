"""One run of one cell: set-up, a closed-loop window of whole operations,
the metrics, the check of what the window produced, the result line.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<mix>.json``: the operation and the parameters handed to the
entry point, nothing else), the configuration's client
(``clients/<client>.py``) and each metric's reader (``metrics/<metric>.py``,
or, for a metric split by the end-to-end metric it moves, such as
``device_idle_pct.read``, the reader of the name before its last dot).  A
later cell, mix, configuration or metric is new files and new entries,
never an edit here."""

from __future__ import annotations

import collections
import contextlib
import gc
import importlib.util
import json
import os
import random
import statistics
import subprocess
import time
from dataclasses import dataclass, field
from typing import Optional

import torch

from . import reference, roofline
from . import trace as tr

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("write", "read")
TRAFFIC_KEYS = {"op", "params", "why"}


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: str, name: str):
    """Import a file of the benchmark by path (its name may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_" + name.replace(".", "_").replace("/", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A cell with its configuration, traffic and metric entries."""
    name: str
    cfg: dict
    traffic: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def load(cls, bench: dict, root: str, name: str) -> "Cell":
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = cells[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        cfg = load_json(os.path.join(root, conf["file"]))
        traffic = load_json(os.path.join(HERE, "traffic",
                                         w["traffic"] + ".json"))
        extra = set(traffic) - TRAFFIC_KEYS
        if extra or traffic.get("op") not in OPS:
            raise ValueError(f"traffic {w['traffic']!r}: the harness runs "
                             f"one closed-loop client of op {OPS} with "
                             f"params; it cannot honour {sorted(extra)} "
                             f"or op {traffic.get('op')!r}")

        def mine(metrics):
            return [m for m in metrics
                    if name in m.get("workloads", [name])]
        return cls(name, cfg, traffic, mine(bench["end_to_end"]),
                   mine(bench["per_layer"]))


@dataclass
class Window:
    """What the readers of the metrics read."""
    op: str
    raw_bytes: int                      # raw field bytes an operation
    setup_s: float
    times: list = field(default_factory=list)     # (start, end) host s
    stored: list = field(default_factory=list)    # bytes written an op
    baseline_bytes: int = 0
    peak_bytes: int = 0
    roofline_bytes: Optional[int] = None          # least bytes an op moves
    peak_Bps: Optional[float] = None
    trace: Optional[tr.Summary] = None
    on_card: bool = False                          # device readers read

    @property
    def seconds(self) -> float:
        return self.times[-1][1] - self.times[0][0] if self.times else 0.0

    @property
    def GBps(self) -> Optional[float]:
        """Raw bytes of every whole operation over the window's wall."""
        if not self.times:
            return None
        return self.raw_bytes * len(self.times) / self.seconds / 1e9


def device_identity(device) -> dict:
    """The card's name and power limit, from torch and nvidia-smi."""
    name = torch.cuda.get_device_name(device)
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi failed: {e}"
    return {"kind": name, "smi": smi}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def reader_path(name: str) -> str:
    """The reader of a metric: ``metrics/<name>.py``, else that of the name
    before its last dot."""
    path = os.path.join(HERE, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(HERE, "metrics", name.rsplit(".", 1)[0] + ".py")
    return path


def _read_metrics(entries: list, win: Window) -> dict:
    out = {}
    for m in entries:
        reader = load_module(reader_path(m["name"]), m["name"])
        value = reader.read(win)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def run(root: str, bench: dict, workload: str, seed: int, seconds: float,
        traced: bool, device, t_start: float, log=print,
        control: bool = False) -> dict:
    """One run of ``workload``; returns the result object (with
    ``checks`` last).  ``device`` is where the program runs; ``control``
    runs the check's control in the program's place (``client.py``)."""
    cell = Cell.load(bench, root, workload)
    op = cell.traffic["op"]
    client_mod = load_module(os.path.join(
        HERE, "clients", cell.cfg["client"] + ".py"), cell.cfg["client"])
    client = client_mod.Client(cell.cfg, cell.traffic.get("params", {}),
                               seed, device, control=control)
    is_cuda = torch.device(device).type == "cuda"
    client.setup(op)
    client.run(op)                      # the warm operation
    _sync(device)
    client.forget()
    gc.collect()
    win = Window(op=op, raw_bytes=client.raw_bytes,
                 setup_s=time.perf_counter() - t_start, on_card=is_cuda)
    if is_cuda:
        win.baseline_bytes = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
        win.peak_Bps = roofline.peak_bytes_per_s(
            torch.cuda.get_device_name(device))

    prof = None
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if is_cuda else [])
        prof = profile(activities=acts)
    failed = 0
    errors = []
    with prof if prof is not None else contextlib.nullcontext():
        with torch.profiler.record_function(tr.WINDOW_SPAN):
            t0 = time.perf_counter()
            while True:
                ts = time.perf_counter()
                try:
                    with torch.profiler.record_function(tr.OP_SPAN):
                        stored = client.run(op)
                        _sync(device)
                except (RuntimeError, ValueError, OSError) as e:
                    failed += 1
                    errors.append(repr(e))
                    stored = None
                te = time.perf_counter()
                win.times.append((ts, te))
                win.stored.append(stored)
                if te - t0 >= seconds or failed >= 3:
                    break
    if is_cuda:
        win.peak_bytes = torch.cuda.max_memory_allocated(device)
    attempted = len(win.times)
    if prof is not None:
        events = tr.from_profiler(prof)
        del prof
        win.trace = tr.Summary(events)
        log(json.dumps({"trace_events": dict(collections.Counter(
            e.kind for e in events))}))
        del events

    walls = [e - s for s, e in win.times]
    log(json.dumps({"workload": workload, "seed": seed, "op": op,
                    "control": control,
                    "operations": attempted, "window_s": win.seconds,
                    "op_s_median": statistics.median(walls),
                    "op_s_max": max(walls), "op_s_min": min(walls),
                    "errors": errors[:3], "writer": client.info},
                   default=str))

    # the check: once the window has closed and the peak is read
    tc = time.perf_counter()
    checks = client.check(op, random.Random(seed))
    win.roofline_bytes = client.roofline_bytes
    client.close()
    log(json.dumps({"check_s": time.perf_counter() - tc}))
    correct = failed == 0 and all(
        checks[k] <= reference.LIMITS[k] for k in checks)
    metrics = _read_metrics(cell.per_layer if traced else cell.end_to_end,
                            win)
    dev = {"platform": "gpu" if is_cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if is_cuda
           else "cpu", "count": 1,
           "memory_peak_bytes": win.peak_bytes}
    result = {"correct": correct, "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if traced and win.trace is not None:
        dev["busy_s"] = win.trace.busy_s
        dev["window_s"] = win.trace.window_s
        result["breakdown"] = {"device_ops": win.trace.device_ops(),
                               "idle_gaps": win.trace.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": reference.LIMITS[k]}
                        for k, v in checks.items()}
    return result
