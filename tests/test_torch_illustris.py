"""The torch port's Illustris HDF5 driver, and the CLI's repack to Sort and
Cart, against the JAX package's, on the CPU.

HDF5 snapshots are made with numpy from fixed seeds.  Both packages
compress them; the ``.il.min`` files must be equal byte for byte, and each
package's decompress of them must write HDF5 files holding the same data
and attributes (the HDF5 files themselves carry timestamps, so their bytes
are not compared).  The CLI runs in process through each package's
``main([...])`` in two directories holding the same input.  Tolerance:
bitwise equality of the ``.il.min`` / ``.min`` files, the printed lines and
every decoded dataset.
"""

import io

import numpy as np
import pytest

h5py = pytest.importorskip("h5py")

from minnow_c_tpu import __main__ as jcli  # noqa: E402
from minnow_c_tpu.drivers import illustris as jil  # noqa: E402
from minnow_c_tpu_torch import __main__ as tcli  # noqa: E402
from minnow_c_tpu_torch.drivers import illustris as til  # noqa: E402

BOX = 75000.0


def make_h5(path, n, seed, box=BOX, types=("PartType1", "PartType0"),
            coords_only=()):
    """An Illustris-layout file: ``n`` particles a type, uniform in the box
    (or, with ``box`` 0, in [-500, 200) per dim: non-periodic with negative
    coordinates), N(0, 300) velocities and permuted IDs of a 128^3 grid;
    the types in ``coords_only`` hold coordinates alone."""
    rng = np.random.default_rng(seed)
    with h5py.File(path, "w") as f:
        hdr = f.create_group("Header")
        hdr.attrs["BoxSize"] = box
        hdr.attrs["Redshift"] = 0.5
        hdr.attrs["Time"] = 0.667
        hdr.attrs["NumPart_ThisFile"] = np.array([n] * 6, np.int32)
        for t in types:
            g = f.create_group(t)
            lo, hi = (0.0, box) if box else (-500.0, 200.0)
            g.create_dataset("Coordinates", data=rng.uniform(
                lo, hi, (n, 3)).astype(np.float32))
            if t in coords_only:
                continue
            g.create_dataset("Velocities", data=rng.normal(
                0, 300, (n, 3)).astype(np.float32))
            g.create_dataset("ParticleIDs", data=rng.permutation(
                128 ** 3)[:n].astype(np.uint64))


def h5_contents(path) -> dict:
    """Every attribute and dataset of an HDF5 file, as (dtype, shape,
    bytes) or the attribute's value."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            for k, v in obj.attrs.items():
                out[f"{name}@{k}"] = np.asarray(v).tobytes()
            if isinstance(obj, h5py.Dataset):
                a = np.asarray(obj)
                out[name] = (a.dtype.str, a.shape, a.tobytes())
        f.visititems(visit)
        for k, v in f["Header"].attrs.items():
            out[f"Header@{k}"] = np.asarray(v).tobytes()
    return out


def _both(tmp_path, write, read):
    """``write(pkg, out_fp, kw)`` with each package's driver, then each
    package's decompress of the JAX file; returns the two files and the
    two HDF5 contents."""
    blobs, back = {}, {}
    for name, mod, kw in (("jax", jil, {}), ("torch", til,
                                             {"device": "cpu"})):
        buf = io.BytesIO()
        write(mod, buf, kw)
        blobs[name] = buf.getvalue()
    for name, mod, kw in (("jax", jil, {}), ("torch", til,
                                             {"device": "cpu"})):
        dst = tmp_path / f"back_{name}.hdf5"
        read(mod, io.BytesIO(blobs["jax"]), str(dst), kw)
        back[name] = h5_contents(dst)
    return blobs, back


@pytest.mark.parametrize("mode", ["div", "recip"])
@pytest.mark.parametrize("case", ["periodic", "non-periodic"])
def test_files_match_jax(tmp_path, mode, case):
    """One file with two particle types: periodic (4096 a type, 32 divides
    the block), or non-periodic (BoxSize 0, negative coordinates, 1500 a
    type, one type without velocities and IDs)."""
    src = tmp_path / "snap.hdf5"
    if case == "periodic":
        make_h5(src, 4096, seed=1)
    else:
        make_h5(src, 1500, seed=2, box=0.0, coords_only=("PartType0",))
    blobs, back = _both(
        tmp_path,
        lambda mod, out, kw: mod.compress(str(src), out, pos_delta=1.0,
                                          vel_delta=1.0, seed=3,
                                          scale_mode=mode, **kw),
        lambda mod, fin, dst, kw: mod.decompress(fin, dst, **kw))
    assert blobs["torch"] == blobs["jax"]
    assert back["torch"] == back["jax"]
    with h5py.File(src, "r") as f, \
            h5py.File(tmp_path / "back_torch.hdf5", "r") as g:
        for t in (k for k in f if k != "Header"):
            e = np.abs(np.asarray(g[t]["Coordinates"], np.float64) -
                       np.asarray(f[t]["Coordinates"]))
            if case == "periodic":
                e = np.minimum(e, BOX - e)
            assert e.max() <= 1.0
            if "ParticleIDs" not in f[t]:
                assert set(g[t]) == {"Coordinates"}
                continue
            np.testing.assert_array_equal(g[t]["ParticleIDs"],
                                          f[t]["ParticleIDs"])
            assert g[t]["ParticleIDs"].dtype == np.uint64
            assert np.abs(np.asarray(g[t]["Velocities"]) -
                          np.asarray(f[t]["Velocities"])).max() <= 1.0


@pytest.mark.parametrize("mode", ["div", "recip"])
def test_compress_multi_matches_jax(tmp_path, mode):
    """Two chunk files: 3000 particles of two types, then 1000 of one
    type; the merged archive and its decode."""
    paths = [str(tmp_path / f"snap.{i}.hdf5") for i in range(2)]
    make_h5(paths[0], 3000, seed=10)
    make_h5(paths[1], 1000, seed=11, types=("PartType1",))
    blobs, back = _both(
        tmp_path,
        lambda mod, out, kw: mod.compress_multi(paths, out, pos_delta=1.0,
                                                vel_delta=1.0, seed=3,
                                                scale_mode=mode, **kw),
        lambda mod, fin, dst, kw: mod.decompress(fin, dst, **kw))
    assert blobs["torch"] == blobs["jax"]
    assert back["torch"] == back["jax"]
    assert back["torch"]["PartType1/Coordinates"][1] == (4000, 3)
    assert back["torch"]["PartType0/Coordinates"][1] == (3000, 3)


def _cli(tmp_path, monkeypatch, capsys, steps, setup):
    """Each CLI runs ``steps`` in its own directory prepared by
    ``setup(dir)``; returns {package: (lines, dir)}.  The torch CLI's
    compress, decompress and repack get ``--device cpu``."""
    out = {}
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        d.mkdir()
        setup(d)
        monkeypatch.chdir(d)
        lines = []
        for argv in steps:
            if name == "torch" and argv[0] in ("compress", "decompress",
                                               "repack"):
                argv = argv + ["--device", "cpu"]
            rc = main(argv)
            lines.append((rc, capsys.readouterr().out))
        out[name] = (lines, d)
    return out


@pytest.mark.parametrize("algo,version", [("Sort", None), ("Sort", "1.0.0"),
                                          ("Sort", "1.1.0"), ("Cart", None)])
def test_cli_repack_to_sort_and_cart_matches_jax(tmp_path, monkeypatch,
                                                 capsys, algo, version):
    """repack of a two-type .il.min to Sort (v1.2 by default, v1.0, v1.1)
    and Cart: the same files and lines, and the repacked archive decodes
    to the original's data (the transcode is lossless)."""
    extra = [] if version is None else ["--codec-version", version]
    steps = [["compress", "snap.hdf5", "snap.il.min", "--pos-delta", "1.0"],
             ["repack", "snap.il.min", "re.il.min", "--algo", algo] + extra,
             ["info", "re.il.min"], ["verify", "re.il.min"],
             ["decompress", "snap.il.min", "back.hdf5"],
             ["decompress", "re.il.min", "back_re.hdf5"]]
    out = _cli(tmp_path, monkeypatch, capsys, steps,
               lambda d: make_h5(d / "snap.hdf5", 1000, seed=20))
    assert out["torch"][0] == out["jax"][0]
    assert all(rc == 0 for rc, _ in out["torch"][0])
    dj, dt = out["jax"][1], out["torch"][1]
    for f in ("snap.il.min", "re.il.min"):
        assert (dt / f).read_bytes() == (dj / f).read_bytes(), f
    assert h5_contents(dt / "back_re.hdf5") == h5_contents(dt / "back.hdf5")
    assert h5_contents(dt / "back_re.hdf5") == h5_contents(
        dj / "back_re.hdf5")


def test_cli_repack_order_free_matches_jax(tmp_path, monkeypatch, capsys):
    """--codec-version 1.2.1 (Sort's order-free profile) on an archive of
    scalar fields: the same file and lines.  On an .il.min, whose
    positions are 3-dim, both CLIs raise the same ValueError."""
    import minnow_c_tpu as mnw
    from minnow_c_tpu.segment import api as japi
    from minnow_c_tpu.segment import io as jio

    def setup(d):
        rng = np.random.default_rng(30)
        segs = []
        for b in range(3):
            n = 2000
            hd = lambda code: mnw.FieldHeader(  # noqa: E731
                code, mnw.AlgoCode.TRIM, mnw.semver.pack(1, 0, 0), n)
            segs.append(japi.compress_segment(mnw.Seg(fields=[
                mnw.Field(hd=hd(mnw.FieldCode.UNSI),
                          data=rng.permutation(1 << 20)[:n].astype(
                              np.uint64), acc=mnw.IntAccuracy()),
                mnw.Field(hd=hd(mnw.FieldCode.UNSF),
                          data=rng.uniform(1, 2, n).astype(np.float32),
                          acc=mnw.FloatAccuracy(delta=1e-4))]), seed=b))
        with open(d / "scalars.min", "wb") as f:
            jio.write_segments(f, segs)
        make_h5(d / "snap.hdf5", 500, seed=31)

    steps = [["repack", "scalars.min", "of.min", "--algo", "Sort",
              "--codec-version", "1.2.1"], ["verify", "of.min"],
             ["compress", "snap.hdf5", "snap.il.min", "--pos-delta", "1.0"]]
    out = _cli(tmp_path, monkeypatch, capsys, steps, setup)
    assert out["torch"][0] == out["jax"][0]
    assert (out["torch"][1] / "of.min").read_bytes() == \
        (out["jax"][1] / "of.min").read_bytes()
    errs = []
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        monkeypatch.chdir(out[name][1])
        argv = ["repack", "snap.il.min", "x.min", "--algo", "Sort",
                "--codec-version", "1.2.1"]
        with pytest.raises(ValueError, match="single-plane") as e:
            main(argv + (["--device", "cpu"] if name == "torch" else []))
        errs.append(str(e.value))
    assert errs[0] == errs[1]
