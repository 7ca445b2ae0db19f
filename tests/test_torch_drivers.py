"""The torch port's Gadget-2 driver and command-line interface against the
JAX package's, on the CPU.

Gadget-2 files are made with numpy from fixed seeds; both packages
compress and decompress them.  The CLI runs in process through each
package's ``main([...])``, in two directories holding the same input, so
the printed lines can be compared verbatim.  Tolerance: bitwise equality of
every output file and of the printed lines.
"""

import io

import numpy as np
import pytest
import torch

from minnow_c_tpu import __main__ as jcli
from minnow_c_tpu.drivers import gadget2 as jg2
from minnow_c_tpu_torch import __main__ as tcli
from minnow_c_tpu_torch.drivers import gadget2 as tg2

import gadget2_cases

BOX = 64.0


def gadget2_file(n: int, masses: str, seed: int = 0,
                 id_base: int = 0) -> bytes:
    """A format-1 Gadget-2 file of ``n`` particles: a random walk in the
    box, N(0, 150) velocities, unique IDs from ``id_base`` up.  ``masses``:
    "table" (one type with a mass-table entry), "mixed" (a table type, and
    a per-particle type whose masses take both signs) or "positive"
    (per-particle, all positive)."""
    rng = np.random.default_rng(seed)
    steps = rng.normal(0, 0.05, (3, n)).astype(np.float32)
    pos = (np.cumsum(steps, axis=1) + BOX / 2).astype(np.float32) % BOX
    vel = rng.normal(0, 150, (3, n)).astype(np.float32)
    ids = rng.permutation(64 ** 3)[:n].astype(np.uint64) + np.uint64(id_base)
    mass = None
    if masses == "table":
        npart, table = (0, n, 0, 0, 0, 0), (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    elif masses == "mixed":
        n1 = n // 3
        npart = (0, n1, n - n1, 0, 0, 0)
        table = (0.0, 2.5, 0.0, 0.0, 0.0, 0.0)
        m_var = rng.uniform(-1.0, 4.0, n - n1).astype(np.float32)
        mass = np.concatenate([np.full(n1, 2.5, np.float32), m_var])
    else:
        npart, table = (0, n, 0, 0, 0, 0), (0.0,) * 6
        mass = rng.uniform(0.5, 4.0, n).astype(np.float32)
    hdr = jg2.Gadget2Header(npart=npart, mass=table, time=0.5,
                            redshift=1.5, box_size=BOX, omega0=0.3,
                            omega_lambda=0.7, hubble_param=0.7)
    buf = io.BytesIO()
    jg2.write_snapshot(buf, hdr, pos, vel, ids, mass=mass)
    return buf.getvalue()


def _compress(g2, raw: bytes, **kw) -> bytes:
    out = io.BytesIO()
    g2.compress(io.BytesIO(raw), out, **kw)
    return out.getvalue()


def _decompress(g2, blob: bytes, **kw) -> bytes:
    out = io.BytesIO()
    g2.decompress(io.BytesIO(blob), out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("mode", ["div", "recip"])
@pytest.mark.parametrize("n, masses, blocks", [
    (3000, "table", None),      # one block of 3000: 32 does not divide nb
    (3000, "mixed", None),
    (8192, "table", 4),         # 4 blocks of 2048: 32 | nb
    (8192, "mixed", 4)])
def test_gadget2_files_match_jax(mode, n, masses, blocks):
    raw = gadget2_file(n, masses, seed=n)
    kw = dict(pos_delta=1e-3, vel_delta=1.0, num_blocks=blocks, seed=4,
              scale_mode=mode)
    want = _compress(jg2, raw, **kw)
    got = _compress(tg2, raw, device="cpu", **kw)
    assert got == want
    # each package's decompress of either file gives the same Gadget-2 file
    back = _decompress(jg2, want)
    assert _decompress(tg2, want, device="cpu") == back
    assert _decompress(jg2, got) == back
    hdr, pos, vel, ids, mass = tg2.read_snapshot_ext(io.BytesIO(back))
    _, pos0, vel0, ids0, mass0 = jg2.read_snapshot_ext(io.BytesIO(raw))
    e = np.abs(pos - pos0)
    assert np.minimum(e, BOX - e).max() <= 1e-3
    assert np.abs(vel - vel0).max() <= 1.0
    assert np.array_equal(ids, ids0)
    assert (mass is None) == (masses == "table")


def test_gadget2_positive_masses_raise():
    """All-positive per-particle masses take the log10 map (relative
    accuracy ``mass_rel_delta``), as in the JAX driver; the log map's bits
    follow torch's ``log`` / ``exp`` (tests/test_torch_logmaps.py), so the
    files are compared by what they decode to: each package's file, read
    by either package, gives every mass within the relative accuracy, and
    positions, velocities and IDs as the uniform fields give them."""
    raw = gadget2_file(1024, "positive")
    _, pos0, vel0, ids0, mass0 = jg2.read_snapshot_ext(io.BytesIO(raw))
    files = [_compress(jg2, raw, num_blocks=2),
             _compress(tg2, raw, num_blocks=2, device="cpu")]
    for blob in files:
        for g2, kw in ((jg2, {}), (tg2, {"device": "cpu"})):
            hdr, pos, vel, ids, mass = tg2.read_snapshot_ext(
                io.BytesIO(_decompress(g2, blob, **kw)))
            assert (np.abs(mass / mass0 - 1) <= 1.0001e-4).all()
            e = np.abs(pos - pos0)
            assert np.minimum(e, BOX - e).max() <= 1e-3
            assert np.abs(vel - vel0).max() <= 1.0
            assert np.array_equal(ids, ids0)


@pytest.mark.parametrize("case", ["table_3001", "mixed_u32_2001",
                                  "positive_1000"])
def test_file_image_matches_write_snapshot(case):
    """The one routine that lays out a Gadget-2 file: from tensors, as the
    driver's decompress hands it the decoded fields, its bytes equal the
    JAX package's ``write_snapshot`` of the same arrays, and the port's."""
    npart, table, pos, vel, ids, mass = gadget2_cases.fields(case)
    if gadget2_cases.CASES[case][2] == "<u4":
        ids = ids.astype(np.uint32)
    hdr = tg2.Gadget2Header(npart=npart, mass=table, time=0.5,
                            redshift=1.5, box_size=BOX, omega0=0.3,
                            omega_lambda=0.7, hubble_param=0.7)
    want = io.BytesIO()
    jg2.write_snapshot(want, hdr, pos, vel, ids, mass=mass)
    got = io.BytesIO()
    tg2.write_snapshot(got, hdr, pos, vel, ids, mass=mass)
    assert got.getvalue() == want.getvalue()
    image = tg2._file_image(
        hdr, torch.from_numpy(pos), torch.from_numpy(vel),
        torch.from_numpy(ids.astype(np.uint64).view(np.int64)),
        None if mass is None else torch.from_numpy(mass))
    assert image.dtype == torch.uint8 and not image.is_pinned()
    assert image.numpy().tobytes() == want.getvalue()


def test_declared_masses_without_a_mass_field_raise():
    """A header that declares per-particle masses needs them: writing it
    without a mass array raises ValueError, from numpy arrays and from
    tensors, and so does decompressing a file compressed from a legacy
    snapshot that lost its MASS record, in both packages."""
    n = 64
    hdr = tg2.Gadget2Header(npart=(0, n, 0, 0, 0, 0), mass=(0.0,) * 6,
                            time=1.0, redshift=0.0, box_size=BOX,
                            omega0=0.3, omega_lambda=0.7, hubble_param=0.7)
    pos = np.linspace(0, BOX, 3 * n, endpoint=False,
                      dtype=np.float32).reshape(3, n)
    vel = np.zeros((3, n), np.float32)
    ids = np.arange(n, dtype=np.uint64)
    with pytest.raises(ValueError, match="per-particle masses"):
        tg2.write_snapshot(io.BytesIO(), hdr, pos, vel, ids)
    with pytest.raises(ValueError, match="per-particle masses"):
        tg2._file_image(hdr, torch.from_numpy(pos), torch.from_numpy(vel),
                        torch.from_numpy(ids.view(np.int64)))
    legacy = io.BytesIO()
    for payload in (hdr.pack(), pos.T.tobytes(), vel.T.tobytes(),
                    ids.tobytes()):
        tg2._write_record(legacy, payload)
    with pytest.warns(UserWarning, match="no MASS"):
        blob = _compress(tg2, legacy.getvalue(), device="cpu")
    for g2, kw in ((jg2, {}), (tg2, {"device": "cpu"})):
        with pytest.raises(ValueError, match="per-particle masses"):
            _decompress(g2, blob, **kw)


@pytest.mark.parametrize("case", sorted(gadget2_cases.CASES))
def test_gadget2_decompress_digests_hold_the_jax_package(case):
    """``fixtures/gadget2_decompress.json`` pins the JAX package's
    decompress of each case's ``.g2.min`` (the port's, on the CPU), so a
    card, which has no JAX, checks its file against it
    (``test_torch_cuda.py``); the port's CPU decompress gives it too."""
    _, _, _, blocks = gadget2_cases.CASES[case]
    blob = _compress(tg2, gadget2_cases.raw_file(case), num_blocks=blocks,
                     device="cpu")
    want = gadget2_cases.DIGESTS[case]
    assert gadget2_cases.digest(_decompress(jg2, blob), case) == want
    assert gadget2_cases.digest(_decompress(tg2, blob, device="cpu"),
                                case) == want


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def test_cli_matches_jax(tmp_path, capsys, monkeypatch):
    """compress (recip), info, verify (and verify after a flipped byte),
    query, repack --algo Coil and decompress: the same files and lines."""
    raw = gadget2_file(4096, "mixed", seed=3)
    dirs = {}
    for name in ("jax", "torch"):
        d = tmp_path / name
        d.mkdir()
        (d / "snap.g2").write_bytes(raw)
        dirs[name] = d
    steps = [
        ["compress", "snap.g2", "snap.g2.min", "--scale-mode", "recip",
         "--blocks", "2"],
        ["info", "snap.g2.min"],
        ["verify", "snap.g2.min"],
        ["query", "snap.g2.min", "--origin", "1", "1", "1", "--size", "2",
         "2", "2", "--periodic", "64"],
        ["repack", "snap.g2.min", "snap.coil.min", "--algo", "Coil"],
        ["verify", "snap.coil.min"],
        ["decompress", "snap.g2.min", "back.g2"],
        ["decompress", "snap.coil.min", "back_coil.g2"],
    ]
    outs = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        monkeypatch.chdir(dirs[name])
        lines = []
        for argv in steps:
            if name == "torch" and argv[0] in ("compress", "decompress",
                                               "repack"):
                argv = argv + ["--device", "cpu"]
            lines.append(_run(main, argv, capsys))
        blob = bytearray((dirs[name] / "snap.g2.min").read_bytes())
        blob[-100] ^= 0xFF
        (dirs[name] / "bad.min").write_bytes(bytes(blob))
        lines.append(_run(main, ["verify", "bad.min"], capsys))
        outs[name] = lines
    assert outs["torch"] == outs["jax"]
    assert [rc for rc, _ in outs["torch"]] == [0] * len(steps) + [1]
    assert "CORRUPT" in outs["torch"][-1][1]
    for f in ("snap.g2.min", "snap.coil.min", "back.g2", "back_coil.g2"):
        assert (dirs["torch"] / f).read_bytes() == \
            (dirs["jax"] / f).read_bytes(), f
    assert (dirs["torch"] / "back.g2").read_bytes() == \
        (dirs["torch"] / "back_coil.g2").read_bytes()


@pytest.mark.parametrize("mode", ["div", "recip"])
def test_cli_u64_ids_match_jax(tmp_path, capsys, monkeypatch, mode):
    """A Gadget-2 file whose 8-byte IDs carry the top bit (>= 2^63, an ID
    grid of width 2^21 and more): compress, info and decompress through
    both CLIs give the same files and lines, and the IDs come back."""
    raw = gadget2_file(4096, "table", seed=6, id_base=1 << 63)
    outs, files = {}, {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        (d / "snap.g2").write_bytes(raw)
        monkeypatch.chdir(d)
        dev = ["--device", "cpu"] if name == "torch" else []
        outs[name] = [_run(main, argv, capsys) for argv in (
            ["compress", "snap.g2", "snap.g2.min", "--scale-mode", mode,
             "--blocks", "4"] + dev,
            ["info", "snap.g2.min"],
            ["decompress", "snap.g2.min", "back.g2"] + dev)]
        files[name] = [(d / f).read_bytes() for f in ("snap.g2.min",
                                                       "back.g2")]
    assert outs["torch"] == outs["jax"]
    assert [rc for rc, _ in outs["torch"]] == [0, 0, 0]
    assert files["torch"] == files["jax"]
    _, _, _, ids = tg2.read_snapshot(io.BytesIO(files["torch"][1]))
    _, _, _, ids0 = jg2.read_snapshot(io.BytesIO(raw))
    assert ids0.min() >= 1 << 63 and np.array_equal(ids, ids0)


def test_cli_hdf5_and_il_min_match_jax(tmp_path, capsys, monkeypatch):
    """The CLI takes HDF5 inputs and ``.il.min`` files as the JAX CLI does:
    compress of one HDF5 file and of two chunk files, info, verify and
    decompress of each archive give the same files and lines, and HDF5
    files holding the same data.  An unknown codec still exits, and the
    default device is the card, with no fallback to the CPU."""
    pytest.importorskip("h5py")
    from test_torch_illustris import h5_contents, make_h5

    steps = [["compress", "snap.hdf5", "snap.il.min", "--pos-delta", "1.0"],
             ["compress", "c.0.hdf5", "c.1.hdf5", "multi.il.min",
              "--pos-delta", "1.0", "--scale-mode", "recip"],
             ["info", "snap.il.min"], ["verify", "multi.il.min"],
             ["decompress", "snap.il.min", "back.hdf5"],
             ["decompress", "multi.il.min", "back_multi.hdf5"]]
    outs, dirs = {}, {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = dirs[name] = tmp_path / name
        d.mkdir()
        make_h5(d / "snap.hdf5", 2000, seed=1)
        make_h5(d / "c.0.hdf5", 1000, seed=2)
        make_h5(d / "c.1.hdf5", 500, seed=3, types=("PartType1",))
        monkeypatch.chdir(d)
        outs[name] = []
        for argv in steps:
            if name == "torch" and argv[0] in ("compress", "decompress"):
                argv = argv + ["--device", "cpu"]
            outs[name].append(_run(main, argv, capsys))
    assert outs["torch"] == outs["jax"]
    assert [rc for rc, _ in outs["torch"]] == [0] * len(steps)
    for f in ("snap.il.min", "multi.il.min"):
        assert (dirs["torch"] / f).read_bytes() == \
            (dirs["jax"] / f).read_bytes(), f
    for f in ("back.hdf5", "back_multi.hdf5"):
        assert h5_contents(dirs["torch"] / f) == \
            h5_contents(dirs["jax"] / f), f
    with pytest.raises(SystemExit, match="unknown codec"):
        tcli.main(["repack", "snap.il.min", "x.min", "--algo", "Zip"])
    if not torch.cuda.is_available():
        # the default device is the card, with no fallback to the CPU
        with pytest.raises((AssertionError, RuntimeError)):
            tcli.main(["compress", "snap.hdf5", "out.il.min", "--pos-delta",
                       "1.0"])
