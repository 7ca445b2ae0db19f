"""The room rule of the port's snapshot writers on the SDRBench HACC
deployment, on the CPU.

The witness is the benchmark's HACC generator (``benchmark/benchlib/
datagen.py``) at a 48^3 lattice in the configuration's 256 Mpc/h box,
positions at 1e-3 Mpc/h and velocities at 1 km/s, four blocks.  Its blocks
span the box, so the reference's depth rule takes 18 bits, a bin of 0.977
delta, and the f32 roundings of the bin map and of the decoder's rebuilt
range put an original up to 3 ulps of 256 (4.7% of a bin) beyond its bin:
the JAX package's file decodes beyond delta.  The port's writers leave room
for those roundings (``quant.engine.delta_to_depth`` with a magnitude) and
write the witness one bit deeper.  Files are decoded by the benchmark's
plain reference (``benchlib/reference.py``: the layout read in Python, LZ4
too, bin edges in f64) and by the port's ``decompress_snapshot``; the rows
path (32 | 27,648 particles a block) and the per-row path (27,647) in the
div and recip maps.  Where the rule leaves a depth as the reference's, the
bytes stay the JAX package's."""

import io
import json
import os
import sys

import numpy as np
import pytest
import torch

import minnow_c_tpu as mnw
import minnow_c_tpu_torch as mt
from minnow_c_tpu.parallel import snapshot as jsnap
from minnow_c_tpu.quant import engine as jengine
from minnow_c_tpu_torch.quant import engine
from minnow_c_tpu_torch.utils import profiling

BENCH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark")
sys.path.append(BENCH)
from benchlib import datagen, reference  # noqa: E402

LATTICE, BLOCKS, SEED = 48, 4, 4
BOX, POS_DELTA = 256.0, 1e-3
U = engine.ulp_below(BOX)                        # 2^-16
# particles: the rows path (32 | nb) and the per-row path (32 does not
# divide nb)
PATHS = {"rows": LATTICE ** 3, "per_row": LATTICE ** 3 - BLOCKS}
# the stored bins' worst case in u (``engine``'s derivation)
OUT_OF_BIN = {"div": 5, "recip": 6}


def config(n: int) -> dict:
    with open(os.path.join(BENCH, "configs", "hacc_sdrbench.json")) as f:
        cfg = json.load(f)
    cfg["generator"].update(lattice=LATTICE, side=LATTICE)
    cfg.update(particles=n, padding=0, blocks=BLOCKS)
    return cfg


@pytest.fixture(scope="module")
def witness():
    """{path: (configuration, particles)} of the witness."""
    out = {}
    for path, n in PATHS.items():
        cfg = config(n)
        out[path] = (cfg, datagen.make_particles(cfg, SEED, "cpu"))
    return out


def port_write(f: dict, scale_mode: str = "div"):
    """The port's file of the witness, its stats and its write's record."""
    spec = mt.SnapshotSpec(pos=mt.PositionAccuracy(delta=POS_DELTA,
                                                   width=BOX),
                           vel=mt.VelocityAccuracy(delta=1.0),
                           ids=mt.IDAccuracy(width=LATTICE))
    fp = io.BytesIO()
    st = mt.compress_snapshot(fp, f["pos"], f["vel"], f["ids"], spec,
                              num_blocks=BLOCKS, seed=SEED,
                              scale_mode=scale_mode, device="cpu")
    rec = profiling.operations()[-1]
    assert rec.name == "snapshot.compress"
    return fp.getvalue(), st, rec


def jax_write(f: dict, scale_mode: str = "div"):
    spec = jsnap.SnapshotSpec(pos=mnw.PositionAccuracy(delta=POS_DELTA,
                                                       width=BOX),
                              vel=mnw.VelocityAccuracy(delta=1.0),
                              ids=mnw.IDAccuracy(width=LATTICE))
    fp = io.BytesIO()
    st = jsnap.compress_snapshot(
        fp, f["pos"].numpy(), f["vel"].numpy(),
        f["ids"].numpy().view(np.uint64), spec, num_blocks=BLOCKS,
        seed=SEED, scale_mode=scale_mode)
    return fp.getvalue(), st


def errors(data: bytes, f: dict, cfg: dict) -> tuple:
    """(the plain reference's numbers for the file's stored bins, the
    numbers of the port's decode), each in units of the accuracies."""
    count, decoded = reference.decode_file(data, 0, cfg, "cpu")
    stored = reference.compare_file(decoded, count, f, cfg)
    out = mt.decompress_snapshot(io.BytesIO(data), device="cpu")
    return stored, reference.compare_fields(out, f, cfg), decoded


def beyond_bin(decoded: list, f: dict) -> float:
    """How far, in box units, the farthest original lies outside its
    stored bin (0 inside), by periodic distance."""
    nb = f["ids"].shape[0] // BLOCKS
    worst = 0.0
    for blk in decoded:
        o = reference.block_of(f["pos"], blk["index"], nb).double()
        for d, (lo, bw) in enumerate(blk["pos"]):
            far = torch.maximum(reference._dist(o[d], lo, BOX),
                                reference._dist(o[d], lo + bw, BOX))
            worst = max(worst, float(far.max()) - bw)
    return worst


@pytest.mark.parametrize("scale_mode", ["div", "recip"])
@pytest.mark.parametrize("path", list(PATHS))
def test_witness_holds_the_stated_accuracy(witness, path, scale_mode):
    """Every stored bin's farther edge and every decoded position lie
    within delta of the original (periodic distance); an original lies
    outside its bin by no more than the roundings the rule leaves room
    for; velocities within 1 km/s, IDs exact.  The rule made positions
    one bit deeper, and the write's record says so."""
    cfg, f = witness[path]
    data, st, rec = port_write(f, scale_mode)
    stored, decoded_err, decoded = errors(data, f, cfg)
    for res in (stored, decoded_err):
        assert res["pos_err"] <= 1.0 and res["vel_err"] <= 1.0, res
        assert res["ids_wrong"] == 0 and res["count_off"] == 0, res
    assert beyond_bin(decoded, f) <= OUT_OF_BIN[scale_mode] * U
    assert (st["pos_depth"], rec.counters["depth_room"]) == (19, 1)


@pytest.mark.parametrize("path", list(PATHS))
def test_reference_bytes_of_the_witness_miss_delta(witness, path):
    """The JAX package's file of the witness, at the reference's depth 18,
    decodes beyond delta: its stored bins and its decode, read by either
    package's port of the format.  The port's file is one bit deeper in
    positions and equal in velocities and IDs."""
    cfg, f = witness[path]
    jdata, jst = jax_write(f)
    stored, decoded_err, _ = errors(jdata, f, cfg)
    assert stored["pos_err"] > 1.0 and decoded_err["pos_err"] > 1.0
    _, st, _ = port_write(f)
    assert st["pos_depth"] == jst["pos_depth"] + 1 == 19
    assert (st["vel_depth"], st["id_widths"]) == (jst["vel_depth"],
                                                  jst["id_widths"])


@pytest.mark.parametrize("delta, magnitude, lo, hi", [
    # a 64-wide box its blocks span (the tests' and digests' box): 16
    (1e-3, 64.0, 32.77, 64.0),
    # Millennium's 500 box, its blocks' ranges 74.9-82.0 (17)
    (1e-3, 500.0, 65.6, 107.0),
    # velocities at 1 km/s: Millennium's and HACC's widest blocks span
    # 4,349-4,716 km/s, within 2,510-2,782 km/s of 0 (13)
    (1.0, 4096.0, 4096.5, 8150.0),
])
def test_room_rule_keeps_the_reference_depth(delta, magnitude, lo, hi):
    """Over these ranges at these magnitudes the rule leaves the reference's
    depth: the bin and 6 ulps fit under delta wherever the bin alone
    does.  The ranges are those of the benchmark's configurations on the
    card, at full size (seeds 3141600001-004)."""
    for r in np.linspace(lo, hi, 2001, dtype=np.float32):
        assert engine.delta_to_depth(delta, 0.0, r, magnitude=magnitude) == \
            jengine.delta_to_depth(delta, 0.0, r), r


def test_room_rule_deepens_a_spanning_256_box():
    """A block spanning the 256 box at 1e-3: the reference's 18 bits leave
    2.3% of a bin (1.5 ulps) for the roundings; the rule takes 19."""
    for r in (250.0, 255.99):
        assert jengine.delta_to_depth(POS_DELTA, 0.0, r) == 18
        assert engine.delta_to_depth(POS_DELTA, 0.0, r, magnitude=BOX) == 19


def test_width_64_files_stay_the_reference_s():
    """Positions spanning a 64-wide box at 1e-3 (the blocks' range near
    64): the port's file equals the JAX package's, byte for byte."""
    rng = np.random.default_rng(16)
    n = 1 << 14
    pos = rng.uniform(0, 64.0, (3, n)).astype(np.float32)
    vel = rng.normal(0, 300, (3, n)).astype(np.float32)
    ids = rng.permutation(n).astype(np.uint64)
    jfp, tfp = io.BytesIO(), io.BytesIO()
    jsnap.compress_snapshot(
        jfp, pos, vel, ids, jsnap.SnapshotSpec(
            pos=mnw.PositionAccuracy(delta=1e-3, width=64.0),
            vel=mnw.VelocityAccuracy(delta=1.0),
            ids=mnw.IDAccuracy(width=32)), num_blocks=2, seed=3)
    st = mt.compress_snapshot(
        tfp, pos, vel, ids, mt.SnapshotSpec(
            pos=mt.PositionAccuracy(delta=1e-3, width=64.0),
            vel=mt.VelocityAccuracy(delta=1.0),
            ids=mt.IDAccuracy(width=32)), num_blocks=2, seed=3,
        device="cpu")
    assert st["pos_depth"] == 16
    assert tfp.getvalue() == jfp.getvalue()
