"""The readers of the program's own spans and records: the driver's share,
the host wire's share, the copies' share and the copied bytes per raw
byte, on synthetic events and records; then tiny traced runs of every cell,
the ``hacc_sdrbench`` ones through the client that never calls the driver."""

import pytest

import tiny
from benchlib import harness
from benchlib import trace as tr
from minnow_c_tpu_torch.utils import profiling

NEW = ("host_driver_pct", "host_wire_pct", "host_copy_pct",
       "copy_bytes_per_raw")
E = tr.Event


def reader(name):
    return harness.load_module(harness.reader_path(name), name).read


def window(op, events=None, times=((0.0, 2.0), (2.0, 5.0)), on_card=True):
    w = harness.Window(op=op, raw_bytes=1000, setup_s=1.0, on_card=on_card)
    w.times = list(times)
    if events is not None:
        w.trace = tr.Summary(events)
    return w


def write_events():
    """Two writes of 100 ns each: the snapshot entry point inside the
    driver's, and nested spans inside it."""
    return [
        E(tr.SPAN, tr.WINDOW_SPAN, 0, 200),
        E(tr.SPAN, tr.OP_SPAN, 0, 100), E(tr.SPAN, tr.OP_SPAN, 100, 200),
        E(tr.SPAN, "g2.compress", 0, 100), E(tr.SPAN, "g2.parse", 2, 20),
        E(tr.SPAN, "snapshot.compress", 20, 90),
        E(tr.SPAN, "pos.upload", 20, 30), E(tr.SPAN, "pos.gather", 40, 45),
        E(tr.SPAN, "pos.entropy", 45, 55), E(tr.SPAN, "pos.wrap", 55, 60),
        E(tr.SPAN, "ids.pack", 60, 70), E(tr.SPAN, "ids.gather", 62, 66),
        E(tr.SPAN, "serialize", 70, 80),
        E(tr.SPAN, "segments.write", 80, 90),
        E(tr.SPAN, "snapshot.compress", 100, 150),   # no driver around it
        E(tr.SPAN, "vel.entropy", 110, 130),
        E(tr.SPAN, "vel.entropy", 120, 140),          # overlaps: once
    ]


def read_events():
    return [
        E(tr.SPAN, tr.WINDOW_SPAN, 0, 100), E(tr.SPAN, tr.OP_SPAN, 0, 100),
        E(tr.SPAN, "g2.decompress", 0, 100),
        E(tr.SPAN, "snapshot.decompress", 5, 65),
        E(tr.SPAN, "decode.read", 5, 10), E(tr.SPAN, "decode.parse", 10, 20),
        E(tr.SPAN, "decode.pos.entropy", 20, 35),
        E(tr.SPAN, "decode.pos", 35, 50),
        E(tr.SPAN, "decode.pos.upload", 36, 40),
        E(tr.SPAN, "g2.download", 65, 80), E(tr.SPAN, "g2.records", 80, 99),
    ]


def test_span_shares_of_a_write():
    w = window("write", write_events())
    # outside the entry points: 200 - 70 - 50 of the operations' 200
    assert reader("host_driver_pct.write")(w) == pytest.approx(40.0)
    # entropy 10 + 30 (the overlap once), wrap 5, serialize 10, segments 10
    assert reader("host_wire_pct.write")(w) == pytest.approx(32.5)
    # uploads 10, gathers 5 + 4 (the ID words' download inside ids.pack)
    assert reader("host_copy_pct.write")(w) == pytest.approx(9.5)


def test_span_shares_of_a_read():
    w = window("read", read_events())
    assert reader("host_driver_pct.read")(w) == pytest.approx(40.0)
    # segment reads 5, parse 10, LZ4 decode 15
    assert reader("host_wire_pct.read")(w) == pytest.approx(30.0)
    # the upload nested in decode.pos 4, the driver's download 15
    assert reader("host_copy_pct.read")(w) == pytest.approx(19.0)


@pytest.mark.parametrize("name", [f"{m}.{op}" for m in NEW[:3]
                                  for op in ("write", "read")])
def test_span_readers_fail_on_what_the_trace_lacks(name):
    op = name.rsplit(".", 1)[1]
    w = window(op, [E(tr.SPAN, tr.WINDOW_SPAN, 0, 100),
                    E(tr.SPAN, tr.OP_SPAN, 0, 100),
                    E(tr.SPAN, "pos.bin_pack_renamed", 10, 20)])
    with pytest.raises(tr.Missing):
        reader(name)(w)


def record(start, h2d, d2h, name="g2.compress"):
    return profiling.Record(name, start, start + 0.5,
                            {"h2d": h2d, "d2h": d2h})


@pytest.mark.parametrize("op", ["write", "read"])
def test_copied_bytes_from_the_window_s_records(monkeypatch, op):
    recs = [record(-1.0, 10 ** 6, 10 ** 6),       # the warm operation
            record(0.5, 1000, 460), record(2.0, 1200, 460),
            record(5.5, 10 ** 6, 0)]              # after the window
    monkeypatch.setattr(profiling, "operations", lambda: recs)
    w = window(op, times=[(0.0, 2.0), (2.0, 5.0)])
    assert reader(f"copy_bytes_per_raw.{op}")(w) == pytest.approx(1.56)


def test_copied_bytes_none_off_the_card_missing_on_it(monkeypatch):
    read = reader("copy_bytes_per_raw.write")
    monkeypatch.setattr(profiling, "operations", lambda: [])
    assert read(window("write", on_card=False)) is None
    with pytest.raises(tr.Missing):
        read(window("write"))
    # a record that counted nothing of one side is no record of the copies
    monkeypatch.setattr(profiling, "operations", lambda: [
        profiling.Record("g2.compress", 0.5, 0.7, {"h2d": 5})])
    with pytest.raises(tr.Missing):
        read(window("write"))


@pytest.mark.parametrize("op", ["write", "read"])
def test_a_program_without_records_reads_nothing(monkeypatch, op):
    """A program that predates the records has none of these spans or
    counters: every new reader leaves its metric out, and fails nothing."""
    monkeypatch.delattr(profiling, "operations")
    w = window(op, [E(tr.SPAN, tr.WINDOW_SPAN, 0, 100),
                    E(tr.SPAN, tr.OP_SPAN, 0, 100)])
    for m in NEW:
        assert reader(f"{m}.{op}")(w) is None


@pytest.mark.parametrize("cell", ["millennium_g2file.write",
                                  "millennium_g2file.read",
                                  "hacc_sdrbench.write",
                                  "hacc_sdrbench.read"])
def test_traced_runs_read_the_span_shares(tmp_path, cell):
    """Each cell's traced run reads the three span shares (the HACC cells
    take the Millennium cells' metrics and call no driver); the copied
    bytes are a card's count, left out on the CPU."""
    res = tiny.run(tmp_path, cell, traced=True)
    assert res["correct"] is True
    op = cell.split(".")[1]
    got = res["metrics"]
    for m in NEW[:3]:
        assert 0.0 <= got[f"{m}.{op}"]["value"] <= 100.0, m
    assert f"copy_bytes_per_raw.{op}" not in got
    if cell.startswith("millennium"):
        # the driver's own work lies outside the snapshot entry point
        assert got[f"host_driver_pct.{op}"]["value"] > 0.0
