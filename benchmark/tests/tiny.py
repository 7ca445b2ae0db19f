"""Tiny versions of the benchmark's configurations, and a way to run the
harness on them on the CPU (the run's look for a card is skipped)."""

from __future__ import annotations

import copy
import json
import os
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load(name: str) -> dict:
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


def tiny(name: str) -> dict:
    """The configuration at a size a test holds: the same fields, box,
    accuracies and generator, a lattice of 16 (HACC: 4,000 particles
    padded to 4 blocks of 1,024) or a 12^3 sub-cube of a 24^3 lattice
    (Millennium: one block, as the driver chooses for it)."""
    cfg = copy.deepcopy(load(name))
    g = cfg["generator"]
    if name == "hacc_sdrbench":
        g.update(lattice=16, side=16)
        cfg.update(particles=4000, padding=96, blocks=4)
    else:
        g.update(lattice=24, side=12, origin_sites=[12, 12, 12])
        cfg.update(particles=12 ** 3, blocks=1)
        cfg["gadget2_header"]["total_particles"] = 24 ** 3
    return cfg


# Cells that BENCHMARK.json leaves out while the program misses their
# configuration's accuracy (PERF.md, Open questions), kept under test so
# that they can come back as entries alone; each takes the metrics of the
# benchmark's cell with the same traffic.
LATER = {"hacc_sdrbench.read": "millennium_g2file.read",
         "hacc_sdrbench.write": "millennium_g2file.write"}


def bench_with(tmp_path, cfgs: dict) -> dict:
    """BENCHMARK.json with its configurations' files replaced by ``cfgs``
    written under ``tmp_path``, and the cells of ``LATER`` added."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "hacc_sdrbench", "file": ""})
    for cell, like in LATER.items():
        bench["workloads"].append({"name": cell, "config": "hacc_sdrbench",
                                   "traffic": cell.split(".")[1],
                                   "chips": 1})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    for c in bench["configs"]:
        if c["name"] in cfgs:
            path = os.path.join(str(tmp_path), c["name"] + ".json")
            with open(path, "w") as f:
                json.dump(cfgs[c["name"]], f)
            c["file"] = path
    return bench


def run(tmp_path, workload: str, seed: int = 12345, seconds: float = 0.2,
        traced: bool = False, cfgs=None, control: bool = False) -> dict:
    from benchlib import harness
    if cfgs is None:
        cfgs = {n: tiny(n) for n in ("hacc_sdrbench", "millennium_g2file")}
    bench = bench_with(tmp_path, cfgs)
    return harness.run(ROOT, bench, workload, seed, seconds, traced, "cpu",
                       time.perf_counter(), log=lambda s: None,
                       control=control)
