"""Gadget-2 snapshot driver (the L5 client layer) of the torch port; the
port of ``minnow_c_tpu/drivers/gadget2.py``, whose ``.g2.min`` files it
writes byte for byte and reads.

The spec ships standardized drivers that compress Gadget-2 and Illustris
snapshots into ``*.g2.min`` files (header_format.tex:37-42); the reference
repo itself contains none -- this module provides the Gadget-2 one.

Reads the classic Gadget-2 "format 1" binary snapshot layout (public
format: 256-byte header record with particle counts/masses/cosmology,
followed by POS (3xN f32), VEL (3xN f32), ID (N u32/u64) records, each
wrapped in Fortran-style 4-byte length markers), then compresses the
fields through the snapshot pipeline into a chained-segment ``.min`` file,
encoded on ``device``; ``decompress`` reads a ``.min`` back on ``device``
and writes the Gadget-2 file with one call from a host image of it, into
which each decoded field is copied once (from the card: transposed there,
into pinned memory).

The driver honors the client-duty split (spec table 1): it owns
segmenting (the ``num_blocks`` choice), accuracy targets, and file
open/close; the library owns compression and format.
"""

from __future__ import annotations

import math
import struct
from dataclasses import dataclass
from typing import BinaryIO, Optional, Tuple

import numpy as np
import torch

from ..parallel import snapshot
from ..types import (FloatAccuracy, IDAccuracy, PositionAccuracy,
                     VelocityAccuracy)
from ..utils.profiling import count, operation, phase

HEADER_BYTES = 256

# the tensor dtype whose bytes a record holds, for each file dtype
_ON_CARD = {"<f4": torch.float32, "<u8": torch.int64}


@dataclass
class Gadget2Header:
    npart: Tuple[int, ...]  # 6 particle types
    mass: Tuple[float, ...]
    time: float
    redshift: float
    box_size: float
    omega0: float
    omega_lambda: float
    hubble_param: float
    # Original 256-byte record: pack() starts from it, so fields this
    # driver does not model (flag_sfr/feedback, npartTotal, flag_cooling,
    # num_files, trailing entries) round-trip losslessly.
    raw: bytes = b""

    @classmethod
    def unpack(cls, raw: bytes) -> "Gadget2Header":
        npart = struct.unpack("<6I", raw[0:24])
        mass = struct.unpack("<6d", raw[24:72])
        time, redshift = struct.unpack("<2d", raw[72:88])
        # bytes 88-128: flag_sfr, flag_feedback, npartTotal[6],
        # flag_cooling, num_files (preserved via ``raw``); BoxSize and
        # the cosmology doubles start at byte 128 of struct io_header.
        box_size, omega0, omega_lambda, hubble = struct.unpack(
            "<4d", raw[128:160])
        return cls(npart=npart, mass=mass, time=time, redshift=redshift,
                   box_size=box_size, omega0=omega0,
                   omega_lambda=omega_lambda, hubble_param=hubble,
                   raw=bytes(raw[:HEADER_BYTES]).ljust(HEADER_BYTES,
                                                       b"\x00"))

    def pack(self) -> bytes:
        raw = bytearray(self.raw) if len(self.raw) == HEADER_BYTES \
            else bytearray(HEADER_BYTES)
        raw[0:24] = struct.pack("<6I", *self.npart)
        raw[24:72] = struct.pack("<6d", *self.mass)
        raw[72:88] = struct.pack("<2d", self.time, self.redshift)
        raw[128:160] = struct.pack("<4d", self.box_size, self.omega0,
                                   self.omega_lambda, self.hubble_param)
        return bytes(raw)


def _read_record(fp: BinaryIO) -> bytes:
    """One Fortran-style record: [u32 len][payload][u32 len]."""
    head = fp.read(4)
    if len(head) < 4:
        raise EOFError("unexpected end of Gadget-2 file")
    (n,) = struct.unpack("<I", head)
    payload = fp.read(n)
    tail = fp.read(4)
    if len(payload) != n or struct.unpack("<I", tail)[0] != n:
        raise ValueError("corrupt Gadget-2 record framing")
    return payload


def _write_record(fp: BinaryIO, payload: bytes) -> None:
    fp.write(struct.pack("<I", len(payload)))
    fp.write(payload)
    fp.write(struct.pack("<I", len(payload)))


def _variable_mass_types(hdr: Gadget2Header):
    """Particle types whose masses live in a per-particle MASS record:
    mass-table entry 0 with npart > 0 (the Gadget-2 convention)."""
    return [i for i in range(6) if hdr.npart[i] and hdr.mass[i] == 0.0]


def read_snapshot(fp: BinaryIO
                  ) -> Tuple[Gadget2Header, np.ndarray, np.ndarray,
                             np.ndarray]:
    """Read header, positions (3, n), velocities (3, n), IDs (n,)."""
    hdr, pos, vel, ids, _ = read_snapshot_ext(fp)
    return hdr, pos, vel, ids


def read_snapshot_ext(fp: BinaryIO
                      ) -> Tuple[Gadget2Header, np.ndarray, np.ndarray,
                                 np.ndarray, Optional[np.ndarray]]:
    """``read_snapshot`` plus the per-particle MASS record, expanded to a
    full (n,) array (types with table masses are filled from the header's
    mass table; variable-mass types consume the MASS record in type
    order).  The 5th element is None when no type uses per-particle
    masses.

    Legacy tolerance (behavior change in round 4, noted per advisor
    finding): files whose header declares per-particle masses but whose
    MASS record is absent (e.g. snapshots written by the pre-round-4
    ``decompress``, which dropped MASS while preserving header flags)
    read with a warning and ``mass=None`` instead of failing.  A MASS
    record that is *present but wrong-sized* still raises (corruption)."""
    hdr = Gadget2Header.unpack(_read_record(fp))
    n = sum(hdr.npart)
    pos = np.frombuffer(_read_record(fp), dtype="<f4").reshape(n, 3).T
    vel = np.frombuffer(_read_record(fp), dtype="<f4").reshape(n, 3).T
    id_rec = _read_record(fp)
    id_dtype = "<u8" if len(id_rec) == 8 * n else "<u4"
    ids = np.frombuffer(id_rec, dtype=id_dtype).astype(np.uint64)
    mass = None
    var_types = _variable_mass_types(hdr)
    if var_types:
        nm = sum(hdr.npart[i] for i in var_types)
        try:
            raw_rec = _read_record(fp)
        except EOFError:
            import warnings
            warnings.warn(
                "header declares per-particle masses (mass table 0 with "
                f"npart > 0, types {var_types}) but the file has no MASS "
                "record; reading without masses (legacy-file tolerance)")
            return (hdr, np.ascontiguousarray(pos),
                    np.ascontiguousarray(vel), ids, None)
        rec = np.frombuffer(raw_rec, dtype="<f4")
        if rec.shape[0] != nm:
            raise ValueError(
                f"MASS record has {rec.shape[0]} entries; header implies "
                f"{nm} (types {var_types})")
        mass = np.empty(n, dtype=np.float32)
        off = 0       # offset into the snapshot's particle ordering
        moff = 0      # offset into the MASS record
        for i in range(6):
            cnt = hdr.npart[i]
            if not cnt:
                continue
            if i in var_types:
                mass[off:off + cnt] = rec[moff:moff + cnt]
                moff += cnt
            else:
                mass[off:off + cnt] = np.float32(hdr.mass[i])
            off += cnt
    return (hdr, np.ascontiguousarray(pos), np.ascontiguousarray(vel),
            ids, mass)


def _mass_record_parts(hdr: Gadget2Header, mass) -> list:
    """Inverse of the expansion in ``read_snapshot_ext``: the slices of the
    full (n,) ``mass`` that make the MASS record, the variable-mass types'
    in type order."""
    parts = []
    off = 0
    for i in range(6):
        cnt = hdr.npart[i]
        if cnt and hdr.mass[i] == 0.0:
            parts.append(mass[off:off + cnt])
        off += cnt
    return parts


def _file_image(hdr: Gadget2Header, pos, vel, ids, mass=None
                ) -> torch.Tensor:
    """The format-1 file's bytes as one uint8 host tensor: the header, POS
    and VEL as (n, 3) f32, the IDs as u64 and, when the header declares
    per-particle masses, the MASS record, each record in its four-byte
    length markers.  Every field is copied once, straight into its
    record's slice.

    The fields are numpy arrays or tensors.  From the card, the image is
    pinned host memory (torch's caching host allocator reuses it from one
    call to the next), pos and vel are transposed there, the copies are
    enqueued without waiting and the stream is synchronised once; their
    bytes count as ``d2h`` and, landing in pinned memory, ``d2h_pinned``.
    On the host the image is ordinary memory and numpy casts into it as
    ``astype`` would."""
    on_card = isinstance(pos, torch.Tensor) and pos.is_cuda
    if not on_card:
        pos, vel, ids, mass = (t.numpy() if isinstance(t, torch.Tensor)
                               else t for t in (pos, vel, ids, mass))
        if mass is not None:
            mass = np.asarray(mass, dtype=np.float32)
    # each record's payload: its pieces as (file dtype, source in file order)
    recs = [[("u1", np.frombuffer(hdr.pack(), np.uint8))],
            [("<f4", pos.T)], [("<f4", vel.T)], [("<u8", ids)]]
    if _variable_mass_types(hdr):
        if mass is None:
            raise ValueError(
                "header declares per-particle masses (mass table 0 with "
                "npart > 0) but no mass array was given")
        recs.append([("<f4", p) for p in _mass_record_parts(hdr, mass)])
    recs = [[(np.dtype(dt).itemsize * math.prod(src.shape), dt, src)
             for dt, src in rec] for rec in recs]
    markers = [np.frombuffer(struct.pack("<I", sum(b for b, _, _ in rec)),
                             np.uint8) for rec in recs]
    image = torch.empty(sum(b for rec in recs for b, _, _ in rec) +
                        8 * len(recs), dtype=torch.uint8, pin_memory=on_card)
    host = image.numpy()
    crossed = 0
    off = 0
    for rec, marker in zip(recs, markers):
        host[off:off + 4] = marker
        off += 4
        for nbytes, dt, src in rec:
            if isinstance(src, torch.Tensor):   # on the card: lay out there
                src = src.to(_ON_CARD[dt]).contiguous()
                image[off:off + nbytes].copy_(
                    src.view(-1).view(torch.uint8), non_blocking=True)
                crossed += nbytes
            else:
                np.copyto(host[off:off + nbytes].view(dt).reshape(src.shape),
                          src, casting="unsafe")
            off += nbytes
        host[off:off + 4] = marker
        off += 4
    if on_card:
        torch.cuda.current_stream(pos.device).synchronize()
    count("d2h", crossed)
    count("d2h_pinned", crossed if image.is_pinned() else 0)
    return image


def write_snapshot(fp: BinaryIO, hdr: Gadget2Header, pos: np.ndarray,
                   vel: np.ndarray, ids: np.ndarray,
                   mass: Optional[np.ndarray] = None) -> None:
    """Write a format-1 Gadget-2 snapshot (inverse of read_snapshot).
    ``mass``: optional full (n,) per-particle array; the MASS record is
    emitted (variable-mass types only, in type order) when the header
    declares per-particle masses."""
    fp.write(memoryview(_file_image(hdr, pos, vel, ids, mass).numpy()))


@operation("g2.compress")
def compress(in_fp: BinaryIO, out_fp: BinaryIO,
             pos_delta: float = 1e-3,
             vel_delta: float = 1.0,
             id_grid_width: Optional[int] = None,
             num_blocks: Optional[int] = None,
             seed: int = 0,
             scale_mode: str = "div",
             mass_rel_delta: float = 1e-4,
             device="cuda") -> dict:
    """Gadget-2 snapshot -> .g2.min: the raw header is written first as one
    Fortran-style record, then the chained compressed segments.

    Per-particle MASS records (mass table 0 with npart > 0,
    header_format.tex:44-68 makes full-snapshot handling the client
    driver's duty) are compressed as a UNSF field: log10-mapped when all
    masses are positive (``mass_rel_delta`` is then the relative
    accuracy), else linear with an absolute delta of
    ``mass_rel_delta * max|m|``.  The arrays are encoded on ``device``,
    ``cuda`` unless the caller asks for ``cpu``."""
    with phase("g2.parse"):
        hdr, pos, vel, ids, mass = read_snapshot_ext(in_fp)
    n = ids.shape[0]
    import warnings
    if in_fp.read(1):
        warnings.warn("trailing Gadget-2 records beyond POS/VEL/ID are "
                      "not compressed and will be dropped")
    if num_blocks is None:
        # nearest divisor of n to the <10^7-particles-per-segment target
        target = max(1, n // 4_000_000)
        down = target
        while down > 1 and n % down:
            down -= 1
        up = target
        while up < n and n % up:
            up += 1
        num_blocks = down if (target - down) <= (up - target) else up
        if n // num_blocks > 10_000_000:
            raise ValueError(
                f"n={n} has no block count near the 10^7-particle "
                "segment limit (spec, header_format.tex:120-127); pass "
                "num_blocks explicitly or pad the input")
    if id_grid_width is None:
        id_grid_width = int(np.ceil((float(ids.max()) + 1) ** (1 / 3)))
    mass_acc = None
    if mass is not None:
        if (mass > 0).all():
            # log10 map: quantize log10(m) so the accuracy is relative;
            # delta on the mapped axis = log10(1 + rel) ~= rel / ln(10).
            mass_acc = FloatAccuracy(
                delta=float(np.log10(1.0 + mass_rel_delta)),
                log10_scaled=1)
        else:
            mass_acc = FloatAccuracy(
                delta=float(mass_rel_delta * np.abs(mass).max()))
    spec = snapshot.SnapshotSpec(
        pos=PositionAccuracy(delta=pos_delta, width=hdr.box_size),
        vel=VelocityAccuracy(delta=vel_delta),
        ids=IDAccuracy(width=id_grid_width),
        mass=mass_acc)
    _write_record(out_fp, hdr.pack())
    stats = snapshot.compress_snapshot(out_fp, pos, vel, ids, spec,
                                       num_blocks, seed,
                                       scale_mode=scale_mode, mass=mass,
                                       device=device)
    stats["n"] = n
    return stats


@operation("g2.decompress")
def decompress(in_fp: BinaryIO, out_fp: BinaryIO,
               device="cuda") -> Gadget2Header:
    """.g2.min -> Gadget-2 snapshot, decoded on ``device`` (``cuda``
    unless the caller asks for ``cpu``) and laid out by ``_file_image``."""
    hdr = Gadget2Header.unpack(_read_record(in_fp))
    decoded = snapshot.decompress_snapshot(in_fp, device=device)
    with phase("g2.download"):
        image = _file_image(hdr, decoded["pos"], decoded["vel"],
                            decoded["ids"], decoded.get("mass"))
    del decoded
    with phase("g2.records"):
        out_fp.write(memoryview(image.numpy()))
    return hdr
