"""Plain Gadget-2 format-1 files: the benchmark builds its inputs with this
and reads the driver's outputs back with it, sharing no code with the
program's driver.

A file is Fortran-style records, each ``[u32 n][n bytes][u32 n]``: the
256-byte header, then positions and velocities as (n, 3) little-endian
f32, then IDs (u64 here)."""

from __future__ import annotations

import struct

import numpy as np

HEADER_BYTES = 256


def header(cfg: dict) -> bytes:
    """The 256-byte header of the configuration's file: every particle is
    of type 1."""
    h = cfg["gadget2_header"]
    n = int(cfg["particles"])
    total = int(h["total_particles"])
    raw = bytearray(HEADER_BYTES)
    struct.pack_into("<6I", raw, 0, 0, n, 0, 0, 0, 0)
    struct.pack_into("<6d", raw, 24, *[float(m) for m in h["mass_table"]])
    struct.pack_into("<2d", raw, 72, float(h["time"]), float(h["redshift"]))
    struct.pack_into("<6I", raw, 96, 0, total & 0xFFFFFFFF, 0, 0, 0, 0)
    struct.pack_into("<i", raw, 124, int(h["num_files"]))
    struct.pack_into("<4d", raw, 128, float(cfg["box"]), float(h["omega0"]),
                     float(h["omega_lambda"]), float(h["hubble_param"]))
    struct.pack_into("<6I", raw, 168, 0, total >> 32, 0, 0, 0, 0)
    return bytes(raw)


def _record(payload: bytes) -> bytes:
    n = struct.pack("<I", len(payload))
    return n + payload + n


def build(head: bytes, pos: np.ndarray, vel: np.ndarray,
          ids: np.ndarray) -> bytes:
    """A file from host arrays: pos, vel (3, n) f32, ids (n,) u64 bits."""
    return b"".join([
        _record(head),
        _record(np.ascontiguousarray(pos.T, dtype="<f4").tobytes()),
        _record(np.ascontiguousarray(vel.T, dtype="<f4").tobytes()),
        _record(np.ascontiguousarray(ids).view("<u8").tobytes())])


def records(data) -> list:
    """The payloads of every record of a file, as memoryviews; raises
    ValueError on broken framing."""
    view = memoryview(data)
    out, off = [], 0
    while off < len(view):
        if off + 4 > len(view):
            raise ValueError("truncated Gadget-2 record marker")
        (n,) = struct.unpack_from("<I", view, off)
        end = off + 4 + n
        if end + 4 > len(view) or \
                struct.unpack_from("<I", view, end)[0] != n:
            raise ValueError("corrupt Gadget-2 record framing")
        out.append(view[off + 4:end])
        off = end + 4
    return out


def parse(data) -> tuple:
    """(header bytes, pos (3, n) f32, vel (3, n) f32, ids (n,) u64) of a
    file written with u64 IDs; the arrays are views into ``data``."""
    recs = records(data)
    if len(recs) != 4:
        raise ValueError(f"expected 4 records, found {len(recs)}")
    head = bytes(recs[0])
    n = sum(struct.unpack_from("<6I", head, 0))
    pos = np.frombuffer(recs[1], dtype="<f4").reshape(n, 3).T
    vel = np.frombuffer(recs[2], dtype="<f4").reshape(n, 3).T
    ids = np.frombuffer(recs[3], dtype="<u8")
    if ids.shape[0] != n:
        raise ValueError(f"ID record holds {ids.shape[0]} of {n} IDs")
    return head, pos, vel, ids
