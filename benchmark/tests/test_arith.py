"""The benchmark's own arithmetic: rates, busy unions, span shares,
roofline bytes, the peak's baseline."""

import importlib.util
import os

import pytest
import torch

from benchlib import harness, reference, roofline
from benchlib import trace as tr

METRICS = os.path.join(harness.HERE, "metrics")


def reader(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"), harness.reader_path(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def window(op="write", times=((0.0, 2.0), (2.0, 5.0)), **kw):
    w = harness.Window(op=op, raw_bytes=10 ** 9, setup_s=3.0, on_card=True,
                       **kw)
    w.times = list(times)
    return w


def test_rate_is_all_bytes_over_the_window():
    w = window(times=[(10.0, 11.0), (11.5, 14.0), (14.0, 15.0)])
    assert reader("write_GBps")(w) == pytest.approx(3 / 5.0)
    r = window(op="read", times=[(0.0, 4.0)])
    assert reader("read_GBps")(r) == pytest.approx(0.25)
    assert reader("read_GBps")(window(times=[])) is None


def test_split_metrics_share_one_reader():
    for name in ("device_idle_pct", "kernel_roofline"):
        assert harness.reader_path(name + ".write") == \
            harness.reader_path(name + ".read") == \
            os.path.join(METRICS, name + ".py")
    assert harness.reader_path("write_GBps").endswith("write_GBps.py")


@pytest.mark.parametrize("extra", [{"clients": 4}, {"loop": "open"},
                                   {"op": "query"}])
def test_traffic_the_harness_cannot_honour_is_refused(tmp_path, extra):
    import json
    bench = {"configs": [{"name": "c", "file": "c.json"}],
             "workloads": [{"name": "c.t", "config": "c", "traffic": "t"}],
             "end_to_end": [], "per_layer": []}
    (tmp_path / "c.json").write_text("{}")
    os.makedirs(tmp_path / "traffic")
    (tmp_path / "traffic" / "t.json").write_text(
        json.dumps({"op": "write", "params": {}, **extra}))
    old = harness.HERE
    harness.HERE = str(tmp_path)
    try:
        with pytest.raises(ValueError):
            harness.Cell.load(bench, str(tmp_path), "c.t")
    finally:
        harness.HERE = old


def test_stored_ratio_sums_the_writes():
    w = window(stored=[4 * 10 ** 8, 5 * 10 ** 8])
    assert reader("stored_ratio")(w) == pytest.approx(0.45)


def test_peak_subtracts_the_baseline():
    w = window(baseline_bytes=9 * 10 ** 9, peak_bytes=12 * 10 ** 9)
    assert reader("codec_peak_GB")(w) == pytest.approx(3.0)
    assert reader("codec_peak_GB")(window()) is None
    assert reader("setup_s")(w) == 3.0


@pytest.mark.parametrize("intervals,merged", [
    ([(0, 10), (5, 15)], [(0, 15)]),                  # overlapping
    ([(0, 20), (5, 8), (10, 12)], [(0, 20)]),         # nested
    ([(30, 40), (0, 10), (10, 20)], [(0, 20), (30, 40)]),  # touching
    ([(5, 5), (1, 2)], [(1, 2)]),                     # empty interval
])
def test_union(intervals, merged):
    assert tr.union(intervals) == merged


def test_busy_gaps_and_clipping():
    merged = tr.union([(0, 10), (5, 15), (30, 40), (32, 35)])
    assert tr.clipped_length(merged, 5, 35) == 10 + 5
    assert tr.gaps(merged, 5, 45) == [(15, 30), (40, 45)]


def trace_events():
    E = tr.Event
    return [
        E(tr.SPAN, tr.WINDOW_SPAN, 0, 100),
        E(tr.SPAN, tr.OP_SPAN, 0, 50), E(tr.SPAN, tr.OP_SPAN, 50, 100),
        E(tr.SPAN, "pos.binpack", 10, 20), E(tr.SPAN, "pos.entropy", 20, 40),
        E(tr.SPAN, "pos.binpack", 60, 70),
        E(tr.LAUNCH, "cudaLaunchKernel", 12, 13, 1),
        E(tr.LAUNCH, "cudaLaunchKernel", 30, 31, 2),
        E(tr.LAUNCH, "cudaLaunchKernel", 61, 62, 3),
        E(tr.KERNEL, "k_bin", 15, 25, 1),
        E(tr.KERNEL, "k_other", 32, 36, 2),
        E(tr.KERNEL, "k_bin", 64, 66, 3),
        E(tr.COPY, "Memcpy HtoD", 20, 30, 4),      # overlaps k_bin
        E(tr.SET, "Memset", 80, 120, 5),           # runs past the window
    ]


def test_summary_busy_kernels_and_spans():
    s = tr.Summary(trace_events())
    # union: [15, 30], [32, 36], [64, 66], [80, 100]
    assert s.busy_s == pytest.approx((15 + 4 + 2 + 20) / 1e9)
    assert s.window_s == pytest.approx(100 / 1e9)
    assert s.kernel_s() == pytest.approx(16 / 1e9)
    assert s.kernel_s(["pos.binpack"]) == pytest.approx(12 / 1e9)
    assert s.span_s(["pos.entropy"]) == pytest.approx(20 / 1e9)
    assert s.ops_s == pytest.approx(100 / 1e9)
    assert s.device_ops()[0] == ["Memset", pytest.approx(20 / 1e9)]


def test_idle_named_by_innermost_span():
    s = tr.Summary(trace_events())
    gaps = dict(s.idle_gaps())
    # idle: [0,15] -> op 0-10, binpack 10-15; [30,32], [36,40] entropy;
    # [40,64] -> op 40-50, op 50-60, binpack 60-64; [66,80] -> binpack
    # 66-70, op 70-80
    assert gaps["pos.binpack"] == pytest.approx((5 + 4 + 4) / 1e9)
    assert gaps["pos.entropy"] == pytest.approx(6 / 1e9)
    assert gaps[tr.OP_SPAN] == pytest.approx((10 + 10 + 10 + 10) / 1e9)
    assert sum(gaps.values()) == pytest.approx(
        s.window_s - s.busy_s)


def test_roofline_reader_and_no_card():
    s = tr.Summary(trace_events())
    w = window(trace=s, roofline_bytes=3350, peak_Bps=3.35e12)
    # least time 1 ns an operation, two operations, 16 ns of kernels
    assert reader("kernel_roofline.write")(w) == pytest.approx(12.5)
    assert reader("kernel_roofline.read")(w) == pytest.approx(12.5)
    w.peak_Bps = None
    assert reader("kernel_roofline.write")(w) is None
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


def test_span_readers_see_the_trace():
    s = tr.Summary(trace_events())
    w = window(trace=s)
    # binpack kernels 10 + 2 ns over two operations
    assert reader("binpack_device_ms.write")(w) == pytest.approx(6e-6)
    # entropy 20 of the operations' 100 ns
    assert reader("host_entropy_pct.write")(w) == pytest.approx(20.0)
    assert reader("device_idle_pct.read")(w) == pytest.approx(59.0)


@pytest.mark.parametrize("name", ["binpack_device_ms.write",
                                  "host_entropy_pct.write",
                                  "host_parse_pct.read",
                                  "kernel_roofline.write",
                                  "device_idle_pct.write"])
def test_readers_fail_on_what_the_trace_lacks(name):
    """A renamed span, or a window with nothing on the device, fails the
    run instead of leaving the metric out unseen."""
    E = tr.Event
    s = tr.Summary([E(tr.SPAN, tr.WINDOW_SPAN, 0, 100),
                    E(tr.SPAN, tr.OP_SPAN, 0, 100),
                    E(tr.SPAN, "pos.bin_pack_renamed", 10, 20)])
    w = window(trace=s, roofline_bytes=3350, peak_Bps=3.35e12)
    with pytest.raises(tr.Missing):
        reader(name)(w)


def test_least_bytes_from_the_shapes():
    """Raw fields once and the fewest bits for each block's extent:
    positions on the periodic box, IDs on the lattice ring."""
    cfg = {"blocks": 2, "box": 100.0, "generator": {"lattice": 16},
           "accuracy": {"pos": 0.5, "vel": 1.0}}
    n = 8
    pos = torch.zeros((3, n), dtype=torch.float64)
    pos[0] = torch.tensor([98.0, 99.0, 1.0, 2.0,       # wraps: extent 4
                           10.0, 20.0, 30.0, 40.0])    # extent 30
    vel = torch.zeros((3, n))
    vel[1] = torch.tensor([0.0, 3.0, 0, 0, -8.0, 0, 0, 8.0])
    # x coordinates 15, 0 (ring: 2 values) then 3..6; y, z all 0
    ids = torch.tensor([15, 0, 15, 0, 3, 4, 5, 6], dtype=torch.int64)
    orig = {"pos": pos, "vel": vel, "ids": ids}
    # block 0: pos x 4/0.5 = 8 bins, 3 bits; vel y 3 bins, 2 bits; ids
    # x 2 values, 1 bit.  block 1: pos x 60 bins, 6 bits; vel y 16 bins,
    # 4 bits; ids x 4 values, 2 bits
    assert roofline.block_bits(orig, cfg, 0) == 3 + 2 + 1
    assert roofline.block_bits(orig, cfg, 1) == 6 + 4 + 2
    assert roofline.least_bytes(orig, cfg) == n * 32 + (6 + 12) * 4 / 8
    assert roofline.extent(torch.tensor([5.0])) == 0.0
    assert roofline.bits_for(1) == 0 and roofline.bits_for(2) == 1


def test_lz4_reference_decoder():
    from benchlib import lz4
    from minnow_c_tpu_torch.ops import entropy
    for raw in (bytes(range(256)) * 300, b"ab" * 5000 + bytes(4000),
                torch.randint(0, 256, (5000,), generator=torch.Generator()
                              .manual_seed(3), dtype=torch.uint8)
                .numpy().tobytes()):
        assert lz4.decode(entropy.encode(raw), len(raw)) == raw
    with pytest.raises(ValueError):
        lz4.decode(b"\x10", 5)


def test_unpack_matches_pack():
    from minnow_c_tpu_torch.ops import bitpack
    x = torch.randint(0, 1 << 13, (1000,), dtype=torch.int32)
    words = bitpack.uniform_pack(x, 13).numpy().tobytes()
    assert torch.equal(reference.unpack(words, 13, 1000, "cpu"),
                       x.to(torch.int64))
