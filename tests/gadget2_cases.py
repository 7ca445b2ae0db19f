"""Small Gadget-2 format-1 files for the driver's decompress tests, on the
CPU against the JAX package (``test_torch_drivers.py``) and on a card
(``test_torch_cuda.py``), which has no JAX: there the JAX package's output
is known by its SHA-256 in ``fixtures/gadget2_decompress.json``, which the
CPU test holds against the JAX package's ``decompress``.

The values come from a hash of the particle index, not from numpy's random
generators, so every machine makes the same files.  Each file is built
with ``struct`` and ``tobytes`` alone, not with the code under test.
This module imports neither JAX nor the drivers."""

import hashlib
import json
import os
import struct

import numpy as np

BOX = 64.0
HEADER_BYTES = 256

# name -> (particles, masses, ID record dtype, blocks of the .g2.min)
# masses: "table" (one type with a mass-table entry), "mixed" (a table type
# and a per-particle type whose masses take both signs), "positive" (one
# per-particle type, all positive: the log10 map)
CASES = {"table_3001": (3001, "table", "<u8", 1),
         "mixed_4096": (4096, "mixed", "<u8", 2),
         "positive_1000": (1000, "positive", "<u8", 2),
         "table_u32_4096": (4096, "table", "<u4", 4),
         "mixed_u32_2001": (2001, "mixed", "<u4", 3)}

with open(os.path.join(os.path.dirname(__file__), "fixtures",
                       "gadget2_decompress.json")) as _f:
    DIGESTS = json.load(_f)


def _unit(n: int, salt: int) -> np.ndarray:
    """n floats in [0, 1): splitmix64 of (index + salt * golden gamma)."""
    x = np.arange(n, dtype=np.uint64) + np.uint64(
        (salt * 0x9E3779B97F4A7C15) % (1 << 64))
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return (x >> np.uint64(11)).astype(np.float64) / float(1 << 53)


def _record(payload: bytes) -> bytes:
    return struct.pack("<I", len(payload)) + payload + \
        struct.pack("<I", len(payload))


def fields(name: str):
    """(npart, mass table, pos (3, n), vel (3, n), ids (n,) u64, full (n,)
    masses or None) of case ``name``."""
    n, masses, _, _ = CASES[name]
    salt = sum(name.encode())
    pos = (_unit(3 * n, salt) * BOX).astype(np.float32).reshape(3, n)
    vel = ((_unit(3 * n, salt + 1) - 0.5) * 600.0).astype(
        np.float32).reshape(3, n)
    ids = np.argsort(_unit(4 * n, salt + 2), kind="stable")[:n].astype(
        np.uint64) + np.uint64(7)
    u = _unit(n, salt + 3)
    mass = None
    if masses == "table":
        npart, table = (0, n, 0, 0, 0, 0), (0.0, 1.0, 0.0, 0.0, 0.0, 0.0)
    elif masses == "mixed":
        n1 = n // 3
        npart, table = (0, n1, n - n1, 0, 0, 0), (0.0, 2.5, 0.0, 0.0, 0.0,
                                                  0.0)
        mass = np.concatenate([np.full(n1, 2.5, np.float32),
                               (u[n1:] * 5.0 - 1.0).astype(np.float32)])
    else:
        npart, table = (0, n, 0, 0, 0, 0), (0.0,) * 6
        mass = (0.5 + u * 3.5).astype(np.float32)
    return npart, table, pos, vel, ids, mass


def raw_file(name: str) -> bytes:
    """Case ``name`` as a format-1 file: header, POS, VEL, IDs in the
    case's ID dtype, and a MASS record for the per-particle types."""
    _, _, id_dtype, _ = CASES[name]
    npart, table, pos, vel, ids, mass = fields(name)
    head = bytearray(HEADER_BYTES)
    head[0:24] = struct.pack("<6I", *npart)
    head[24:72] = struct.pack("<6d", *table)
    head[72:88] = struct.pack("<2d", 0.5, 1.5)
    head[128:160] = struct.pack("<4d", BOX, 0.3, 0.7, 0.7)
    out = (_record(bytes(head)) + _record(pos.T.astype("<f4").tobytes()) +
           _record(vel.T.astype("<f4").tobytes()) +
           _record(ids.astype(id_dtype).tobytes()))
    if mass is not None:
        var = np.concatenate([mass[sum(npart[:i]):sum(npart[:i + 1])]
                              for i in range(6)
                              if npart[i] and table[i] == 0.0])
        out += _record(var.astype("<f4").tobytes())
    return out


def digest(g2_file: bytes, name: str) -> str:
    """SHA-256 of a decompressed file of case ``name``.  With all-positive
    masses the MASS record is left out: its values come back through the
    log10 map, whose bits follow the library's ``log`` / ``exp``."""
    n, masses, _, _ = CASES[name]
    if masses == "positive":
        g2_file = g2_file[:(8 + HEADER_BYTES) + 2 * (8 + 12 * n) +
                          (8 + 8 * n)]
    return hashlib.sha256(g2_file).hexdigest()
