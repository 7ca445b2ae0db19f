"""Illustris / IllustrisTNG snapshot driver (the L5 client layer) of the
torch port; the port of ``minnow_c_tpu/drivers/illustris.py``, whose
``.il.min`` files it writes byte for byte and reads.

The spec's second standardized driver (header_format.tex:37-42): converts
HDF5 snapshots in the Illustris layout -- a ``Header`` group with
``BoxSize``/``NumPart_ThisFile`` attributes and ``PartType<i>`` groups
holding ``Coordinates`` (N, 3), ``Velocities`` (N, 3), and ``ParticleIDs``
(N,) datasets -- into ``*.il.min`` files and back.

The ``.il.min`` layout mirrors the Gadget-2 driver: one Fortran-framed
JSON header record carrying the snapshot attributes and the particle-type
table, followed by chained compressed segments per particle type.  Every
JSON-representable Header attribute round-trips; particle types are
loaded and compressed one at a time (peak memory is one type, not the
whole snapshot).

Non-periodic data (``BoxSize == 0``): coordinates may be negative, and
the codec's position path wraps decodes into [0, width).  The driver
therefore shifts each type by its per-dim minimum (recorded in the JSON
meta as ``pos_offset``), encodes with a width more than twice the data
range -- so the periodic unwrap/rewrap never touches real values -- and
restores the offset on decompress.

The host arithmetic (offsets, widths, the ID grid) is numpy, as in the JAX
package; the snapshots are encoded and decoded on ``device``, ``cuda``
unless the caller asks for ``cpu``.  h5py is imported by the functions
that need it, so the package imports without it.
"""

from __future__ import annotations

import json
from typing import BinaryIO, Optional

import numpy as np

from ..parallel import snapshot
from ..types import IDAccuracy, PositionAccuracy, VelocityAccuracy
from .gadget2 import _read_record, _write_record


def _pick_blocks(n: int, target: int = 4_000_000) -> int:
    nb = max(1, n // target)
    while n % nb:
        nb -= 1
    return nb


def _json_safe(v):
    a = np.asarray(v)
    if a.dtype.kind in "iufb":
        return a.tolist()
    return str(v)


def _header_meta(hdr: dict) -> dict:
    box = float(np.atleast_1d(hdr.get("BoxSize", 0.0))[0])
    return {
        "box_size": box,
        "redshift": float(np.atleast_1d(hdr.get("Redshift", 0.0))[0]),
        "time": float(np.atleast_1d(hdr.get("Time", 0.0))[0]),
        "attrs": {k: _json_safe(v) for k, v in hdr.items()},
    }


def compress(h5_path: str, out_fp: BinaryIO,
             pos_delta: float = 1e-3,
             vel_delta: float = 1.0,
             part_types: Optional[list] = None,
             seed: int = 0,
             scale_mode: str = "div",
             device="cuda") -> dict:
    """Illustris HDF5 snapshot -> .il.min, encoded on ``device``."""
    import h5py

    stats = {"types": {}}
    with h5py.File(h5_path, "r") as f:
        meta = _header_meta(dict(f["Header"].attrs))
        meta["part_types"] = []
        box = meta["box_size"]
        types = sorted(part_types if part_types is not None else
                       [k for k in f.keys() if k.startswith("PartType")])
        # Meta first, from shapes only (no data loaded yet).
        for t in types:
            entry = _chunk_entry(f[t], box)
            if entry is not None:
                meta["part_types"].append({"name": t, **entry})

        # The JSON record length depends only on shapes/offsets above.
        _write_record(out_fp, json.dumps(meta).encode())

        # One type at a time: peak memory is a single type's arrays.
        for entry in meta["part_types"]:
            st = _compress_group(out_fp, f[entry["name"]], entry, box,
                                 pos_delta, vel_delta, seed, scale_mode,
                                 device)
            stats["types"][entry["name"]] = st
    stats["meta"] = meta
    return stats


def _compress_group(out_fp, g, entry, box, pos_delta, vel_delta, seed,
                    scale_mode: str = "div", device="cuda"):
    """Compress one HDF5 particle-type group as one segment chain,
    following ``entry`` (an element of meta['part_types'] or of a
    chunked entry's 'chunks' list)."""
    pos = np.ascontiguousarray(
        np.asarray(g["Coordinates"], dtype=np.float32).T)
    off = np.asarray(entry["pos_offset"], dtype=np.float32)
    if off.any():
        pos = pos - off[:, None]
    vel = np.ascontiguousarray(
        np.asarray(g["Velocities"], dtype=np.float32).T) \
        if entry["has_vel"] else None
    ids = np.asarray(g["ParticleIDs"], dtype=np.uint64) \
        if entry["has_ids"] else None
    if box:
        width = box
    else:
        # Non-periodic: the codec's position path is periodic, so
        # pick width > 2x the data range -- undo_periodic then
        # never unwraps (everything is within width/2 of any
        # anchor) and dithered decodes can't cross a boundary.
        width = max(float(pos.max()) * 2.01, 1e-6)
    grid = int(np.ceil((float(ids.max()) + 1) ** (1 / 3))) \
        if ids is not None else 0
    spec = snapshot.SnapshotSpec(
        pos=PositionAccuracy(delta=pos_delta, width=width),
        vel=VelocityAccuracy(delta=vel_delta) if vel is not None
        else None,
        ids=IDAccuracy(width=grid) if ids is not None else None)
    return snapshot.compress_snapshot(out_fp, pos, vel, ids, spec,
                                      entry["blocks"], seed,
                                      scale_mode=scale_mode, device=device)


def _chunk_entry(g, box) -> Optional[dict]:
    """Shape-only metadata for one particle-type group (plus the
    per-dim minimum when the data is non-periodic)."""
    if "Coordinates" not in g:
        return None
    n = int(g["Coordinates"].shape[0])
    entry = {"n": n, "blocks": _pick_blocks(n),
             "has_vel": "Velocities" in g,
             "has_ids": "ParticleIDs" in g,
             "pos_offset": [0.0, 0.0, 0.0]}
    if box == 0.0 and n:
        lo = np.asarray(g["Coordinates"]).min(axis=0)
        entry["pos_offset"] = [float(v) for v in lo]
    return entry


def compress_multi(h5_paths, out_fp: BinaryIO,
                   pos_delta: float = 1e-3,
                   vel_delta: float = 1.0,
                   part_types: Optional[list] = None,
                   seed: int = 0,
                   scale_mode: str = "div",
                   device="cuda") -> dict:
    """Chunked Illustris snapshot (``snap_X.0.hdf5 ... snap_X.(N-1).hdf5``)
    -> one ``.il.min`` holding the merged logical snapshot, encoded on
    ``device``.

    Real Illustris/TNG snapshots span many HDF5 chunk files; the Header
    attrs come from chunk 0 and each (type, chunk) pair streams through
    the codec independently (peak memory is one chunk's one type).  The
    JSON meta records a ``chunks`` list per type; :func:`decompress`
    concatenates the chunks back into one merged group per type."""
    import h5py

    h5_paths = list(h5_paths)
    if not h5_paths:
        raise ValueError("compress_multi needs at least one chunk file")
    stats = {"types": {}}
    with h5py.File(h5_paths[0], "r") as f0:
        meta = _header_meta(dict(f0["Header"].attrs))
    box = meta["box_size"]
    meta["files"] = [str(p) for p in h5_paths]
    meta["part_types"] = []
    # Shape pass: one open per file, metadata only.
    by_type: dict = {}
    for fi, path in enumerate(h5_paths):
        with h5py.File(path, "r") as f:
            types = sorted(part_types if part_types is not None else
                           [k for k in f.keys() if k.startswith("PartType")])
            for t in types:
                ch = _chunk_entry(f[t], box)
                if ch is None or ch["n"] == 0:
                    continue
                ch["file"] = fi
                by_type.setdefault(t, []).append(ch)
    for t in sorted(by_type):
        chunks = by_type[t]
        meta["part_types"].append({
            "name": t, "n": sum(c["n"] for c in chunks),
            "chunks": chunks})
    _write_record(out_fp, json.dumps(meta).encode())
    # Data pass, type-major so each type's chains are adjacent on disk.
    for entry in meta["part_types"]:
        sts = []
        for ch in entry["chunks"]:
            with h5py.File(h5_paths[ch["file"]], "r") as f:
                sts.append(_compress_group(out_fp, f[entry["name"]], ch,
                                           box, pos_delta, vel_delta,
                                           seed, scale_mode, device))
        stats["types"][entry["name"]] = sts
    stats["meta"] = meta
    return stats


def decompress(in_fp: BinaryIO, h5_path: str, device="cuda") -> dict:
    """.il.min -> Illustris HDF5 snapshot, decoded on ``device`` (one
    batched read a chain where its segments allow it, as
    ``decompress_snapshot`` reads them; the same bits as a read segment
    by segment) and written from host copies of the decoded tensors."""
    import h5py

    from ..segment import io as seg_io

    meta = json.loads(_read_record(in_fp).decode())
    with h5py.File(h5_path, "w") as f:
        hdr = f.create_group("Header")
        for k, v in meta.get("attrs", {}).items():
            hdr.attrs[k] = v
        hdr.attrs["BoxSize"] = meta["box_size"]
        hdr.attrs["Redshift"] = meta["redshift"]
        hdr.attrs["Time"] = meta["time"]
        for ti in meta["part_types"]:
            # Single-file entries are one chain; compress_multi entries
            # carry a 'chunks' list, one chain per (type, chunk file).
            chunks = ti.get("chunks") or [ti]
            pos_parts, vel_parts, id_parts = [], [], []
            for ch in chunks:
                # Each chain ends with NextIOHeader = 0; iter_segments
                # consumes exactly one chain (with the corrupt-chain
                # advance guard) and leaves the file positioned at the
                # next chain.
                chain = [s for _, s in seg_io.iter_segments(in_fp)]
                if len(chain) != ch["blocks"]:
                    raise ValueError(
                        f"{ti['name']}: expected {ch['blocks']} chained "
                        f"segments, found {len(chain)}")
                off = np.asarray(ch.get("pos_offset", [0.0] * 3),
                                 dtype=np.float32)
                out = {k: v.cpu().numpy() for k, v in
                       snapshot.decode_segments(chain, device=device).items()}
                if "pos" in out:
                    pos_parts.append(out["pos"] + off[:, None]
                                     if off.any() else out["pos"])
                if "vel" in out:
                    vel_parts.append(out["vel"])
                if "ids" in out:
                    id_parts.append(out["ids"].view(np.uint64))
            g = f.create_group(ti["name"])
            pos = np.concatenate(pos_parts, axis=1)
            g.create_dataset("Coordinates",
                             data=pos.T.astype(np.float32))
            if vel_parts:
                g.create_dataset(
                    "Velocities",
                    data=np.concatenate(vel_parts,
                                        axis=1).T.astype(np.float32))
            if id_parts:
                g.create_dataset("ParticleIDs",
                                 data=np.concatenate(id_parts))
    return meta
