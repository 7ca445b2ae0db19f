"""The reader of ``packed_ratio.write``: the bits of the packed bins that
the program's write records count (``packed_bits``), over the raw field
bits, on synthetic records and on tiny traced writes of both
configurations."""

import json
import time

import pytest

import tiny
from benchlib import harness
from benchlib import trace as tr
from minnow_c_tpu_torch.utils import profiling


def read(win):
    name = "packed_ratio.write"
    return harness.load_module(harness.reader_path(name), name).read(win)


def window(on_card=True):
    w = harness.Window(op="write", raw_bytes=1000, setup_s=1.0,
                       on_card=on_card)
    w.times = [(0.0, 2.0), (2.0, 5.0)]
    return w


def record(start, packed_bits=None):
    counters = {"h2d": 1, "d2h": 1}
    if packed_bits is not None:
        counters["packed_bits"] = packed_bits
    return profiling.Record("snapshot.compress", start, start + 0.1,
                            counters)


@pytest.mark.parametrize("on_card", [True, False])
def test_packed_bytes_of_the_window_s_writes(monkeypatch, on_card):
    """The warm write and one after the window are left out; the count is
    the program's on any device."""
    recs = [record(-1.0, 8 * 10 ** 6), record(0.5, 3600),
            record(2.5, 4400), record(5.5, 8 * 10 ** 6)]
    monkeypatch.setattr(profiling, "operations", lambda: recs)
    assert read(window(on_card)) == pytest.approx(0.5)


def test_a_program_without_the_counter_reads_nothing(monkeypatch):
    """The parent of the counter keeps records without ``packed_bits``, and
    an older program keeps none: the metric is left out, nothing fails.  A
    program that keeps records but none of the window's writes fails."""
    monkeypatch.setattr(profiling, "operations",
                        lambda: [record(0.5), record(2.5)])
    assert read(window()) is None
    monkeypatch.setattr(profiling, "operations", lambda: [record(6.0, 80)])
    with pytest.raises(tr.Missing):
        read(window())
    monkeypatch.delattr(profiling, "operations")
    assert read(window()) is None


@pytest.mark.parametrize("cell", ["millennium_g2file.write",
                                  "hacc_sdrbench.write"])
def test_tiny_traced_write_reads_the_writer_s_depths(tmp_path, cell):
    """A tiny traced write reads each field's depth or ID width over the
    32 raw bytes (256 bits) a particle, as the writer reports them."""
    lines = []
    cfgs = {n: tiny.tiny(n) for n in ("hacc_sdrbench", "millennium_g2file")}
    res = harness.run(tiny.ROOT, tiny.bench_with(tmp_path, cfgs), cell,
                      12345, 0.2, True, "cpu", time.perf_counter(),
                      log=lines.append)
    assert res["correct"] is True
    info = next(json.loads(s)["writer"] for s in lines if '"writer"' in s)
    bits = 3 * (info["pos_depth"] + info["vel_depth"]) + \
        sum(max(w, 1) for w in info["id_widths"])
    assert res["metrics"]["packed_ratio.write"]["value"] == \
        pytest.approx(bits / 256)
