"""Whole runs of the cells at a tiny size on the CPU (the run's look for a
card skipped), the sizes the configurations state, the control, and runs
with the timed path broken underneath, whose ``correct`` must be false."""

import json
import math

import pytest
import torch

import minnow_c_tpu_torch as mt
from minnow_c_tpu_torch.parallel import snapshot
from minnow_c_tpu_torch.segment import io as seg_io
import tiny
from benchlib import datagen, reference

CELLS = ["millennium_g2file.write", "millennium_g2file.read",
         "hacc_sdrbench.write", "hacc_sdrbench.read"]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(tmp_path, cell, traced):
    res = tiny.run(tmp_path, cell, traced=traced)
    keys = list(res)
    assert keys[:5] == KEYS
    assert ("breakdown" in keys) == traced
    assert keys[-1] == "checks" and len(keys) == 6 + traced
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 1
    for c in res["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(res)
    if not traced:
        names = set(res["metrics"])
        assert {"setup_s", cell.split(".")[1] + "_GBps"} <= names
        assert ("stored_ratio" in names) == cell.endswith(".write")


def test_configuration_sizes():
    h = tiny.load("hacc_sdrbench")
    n = h["particles"] + h["padding"]
    assert h["particles"] == 280_953_867 and h["padding"] == 64_501
    assert n == h["blocks"] * 2 ** 22 and h["blocks"] == 67
    assert n <= h["generator"]["lattice"] ** 3
    m = tiny.load("millennium_g2file")
    side = m["generator"]["side"]
    assert m["particles"] == side ** 3 == 19_683_000
    assert m["generator"]["lattice"] == 8 * side == 2160
    # the driver's block count: the divisor of n nearest n // 4,000,000
    n = m["particles"]
    target = max(1, n // 4_000_000)
    blocks = min((b for b in range(1, n + 1) if n % b == 0),
                 key=lambda b: (abs(b - target), b))
    assert blocks == m["blocks"] == 4 and n // blocks == 4_920_750
    # and its ID grid width from the file's largest ID
    top = max(m["generator"]["origin_sites"]) + side - 1
    largest = top * (1 + 2160 + 2160 ** 2)
    assert math.ceil((float(largest) + 1) ** (1 / 3)) == 2160


def test_tiny_driver_writes_the_stated_blocks(tmp_path):
    cfg = tiny.tiny("millennium_g2file")
    res = tiny.run(tmp_path, "millennium_g2file.write", cfgs={
        "millennium_g2file": cfg, "hacc_sdrbench":
        tiny.tiny("hacc_sdrbench")})
    assert res["correct"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tmp_path, cell):
    """The control (floats at bfloat16 where the timed path takes them in
    or hands them out) runs through the harness and its own check, and
    comes out not correct, three times its limit or more."""
    res = tiny.run(tmp_path, cell, control=True)
    assert res["correct"] is False and res["failed"] == 0
    checks = res["checks"]
    assert checks["pos_err"]["value"] > 3 * checks["pos_err"]["limit"]
    assert checks["ids_wrong"]["value"] == 0


def test_same_seed_same_particles():
    cfg = tiny.tiny("hacc_sdrbench")
    a = datagen.make_particles(cfg, 2 ** 31 + 5, "cpu")
    b = datagen.make_particles(cfg, 2 ** 31 + 5, "cpu")
    c = datagen.make_particles(cfg, 2 ** 31 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["pos"], c["pos"])
    assert torch.equal(a["ids"], c["ids"])
    assert float(a["pos"].min()) >= 0 and float(a["pos"].max()) < 256


def _altered_bins(orig):
    def f(*args, **kw):
        words = orig(*args, **kw)
        words[0, 0, 0] ^= 1 << 7
        return words
    return f


def _half_segments(orig):
    def f(fp, segments, geometry=None):
        k = len(segments) // 2
        return orig(fp, segments[:k], None if geometry is None
                    else geometry[:k])
    return f


def _read_fault(orig, how):
    def f(*args, **kw):
        out = orig(*args, **kw)
        if how == "altered":
            out["pos"][0, 0] += 0.5
        elif how == "half":
            n = out["ids"].shape[0] // 2
            out = {k: v[..., :n] for k, v in out.items()}
        else:                            # the output left as it was made
            out = {k: torch.zeros_like(v) for k, v in out.items()}
        return out
    return f


@pytest.mark.parametrize("cell", ["millennium_g2file.write",
                                  "hacc_sdrbench.write"])
@pytest.mark.parametrize("fault", ["altered", "half"])
def test_write_faults(tmp_path, monkeypatch, cell, fault):
    if fault == "altered":
        monkeypatch.setattr(snapshot, "_batched_bin_pack_pos", _altered_bins(
            snapshot._batched_bin_pack_pos))
    else:
        monkeypatch.setattr(seg_io, "write_segments",
                            _half_segments(seg_io.write_segments))
    res = tiny.run(tmp_path, cell)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["millennium_g2file.read",
                                  "hacc_sdrbench.read"])
@pytest.mark.parametrize("fault", ["altered", "half", "unchanged"])
def test_read_faults(tmp_path, monkeypatch, cell, fault):
    wrapped = _read_fault(snapshot.decompress_snapshot, fault)
    monkeypatch.setattr(snapshot, "decompress_snapshot", wrapped)
    monkeypatch.setattr(mt, "decompress_snapshot", wrapped)
    res = tiny.run(tmp_path, cell)
    assert res["correct"] is False


def test_imports_neither_jax_nor_the_measuring_layer(tmp_path):
    import sys
    tiny.run(tmp_path, "millennium_g2file.read")
    for name in ("jax", "minnow_c_tpu", "minnow_c_tpu_torch.bench"):
        assert name not in sys.modules


@pytest.mark.parametrize("op", ["write", "read"])
@pytest.mark.parametrize("name", ["hacc_sdrbench", "millennium_g2file"])
def test_roofline_bytes_from_the_shapes(name, op):
    """Raw fields plus packed bins, each once: 32 B a particle and, for
    the bins, no more than the widths the writer chose (its depths over a
    block's shared range, its ID widths), whatever they are."""
    import random
    from benchlib import harness, roofline
    cfg = tiny.tiny(name)
    client = harness.load_module(
        f"{harness.HERE}/clients/{cfg['client']}.py", cfg["client"]).Client(
        cfg, {}, 7, "cpu")
    client.setup(op)
    client.run(op)
    info = client.info
    client.check(op, random.Random(7))
    n = cfg["particles"] + cfg.get("padding", 0)
    nb = n // cfg["blocks"]
    orig = datagen.make_particles(cfg, 7, "cpu")
    bits = [roofline.block_bits(orig, cfg, b) for b in range(cfg["blocks"])]
    assert client.roofline_bytes == n * 32 + sum(bits) * nb / 8
    writer = 3 * info["pos_depth"] + 3 * info["vel_depth"] + \
        sum(info["id_widths"])
    assert 0.8 * writer <= max(bits) <= writer
