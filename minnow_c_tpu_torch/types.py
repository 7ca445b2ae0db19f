"""Core type system: field codes, algorithm codes, accuracy and quantization
specs, field containers, and segments.

TPU-native re-design of the reference's type layer (``src/types.h``).  Instead
of void-pointer ``Accuracy``/``Quantization`` structs dispatched on a u32 code,
we use typed frozen dataclasses registered as JAX pytrees where they carry
array data, and plain dataclasses where they are static metadata.  Static
metadata (widths, scale flags) hashes into the jit cache key so XLA sees
static shapes and constants.

Reference parity: field codes (types.h:8-12), algo codes (types.h:14-20 -- we
fix the reference's ``algo_Test == algo_Trim`` collision by giving Test its
own code, and its ``alog_Cart`` typo), Accuracy structs (types.h:30-59),
Quantization structs (types.h:66-99), FieldHeader/Field/QField/CField
(types.h:103-129), Seg/QSeg/CSeg (types.h:150-163).
"""

from __future__ import annotations

import dataclasses
import enum
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np


def _fourcc(name: str) -> int:
    """Spec naming convention (header_format.tex:360-366): a four-character
    name maps to the big-endian u32 of its ASCII bytes."""
    assert len(name) == 4
    b = name.encode("ascii")
    return (b[0] << 24) | (b[1] << 16) | (b[2] << 8) | b[3]


class FieldCode(enum.IntEnum):
    """Particle field type codes (types.h:8-12, header_format.tex tab. 2)."""

    POSN = _fourcc("Posn")  # 0x506f736e
    VELC = _fourcc("Velc")  # 0x56656c63
    PTID = _fourcc("Ptid")  # 0x50746964
    UNSF = _fourcc("Unsf")  # 0x556e7366
    UNSI = _fourcc("Unsi")  # 0x556e7369


class AlgoCode(enum.IntEnum):
    """Compression algorithm codes (types.h:14-20, header_format.tex tab. 3).

    The reference defines ``algo_Test`` with the same value as ``algo_Trim``
    (a collision) -- here Test gets its own code so the registry is injective.
    """

    TEST = _fourcc("Test")  # 0x54657374 (reference collides this with Trim)
    TRIM = _fourcc("Trim")  # 0x5472696d
    DIFF = _fourcc("Diff")  # 0x44696666
    COIL = _fourcc("Coil")  # 0x436f696c
    OCTO = _fourcc("Octo")  # 0x4f63746f
    SORT = _fourcc("Sort")  # 0x536f7274
    CART = _fourcc("Cart")  # 0x43617274 (reference spells the macro alog_Cart)


# ---------------------------------------------------------------------------
# Accuracy: how accurately the user wants a field stored (types.h:24-59).
# These are *inputs* to quantization; plain frozen dataclasses (hashable when
# Deltas is None, i.e. the uniform case, which is the static-jit fast path).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FloatAccuracy:
    """Accuracy request for an unspecified float field (types.h:30-38)."""

    delta: float = 0.0
    deltas: Optional[np.ndarray] = None  # per-particle accuracies, or None
    log10_scaled: int = 0  # 0 = linear, 1 = log10, 2 = symlog10
    sym_log10_threshold: float = 0.0

    def __hash__(self):
        return hash((self.delta, self.deltas is None, self.log10_scaled,
                     self.sym_log10_threshold))


@dataclass(frozen=True)
class IntAccuracy:
    """Accuracy request for an unspecified integer field: lossless, carries
    no parameters (types.h:40)."""

    def __hash__(self):
        return hash("IntAccuracy")


@dataclass(frozen=True)
class PositionAccuracy:
    """Accuracy request for positions in a periodic box (types.h:42-46)."""

    delta: float
    width: float  # periodic box width
    deltas: Optional[np.ndarray] = None

    def __hash__(self):
        return hash((self.delta, self.width, self.deltas is None))


@dataclass(frozen=True)
class VelocityAccuracy:
    """Accuracy request for velocities (types.h:48-55)."""

    delta: float
    deltas: Optional[np.ndarray] = None
    sym_log10_scaled: int = 0
    sym_log10_threshold: float = 0.0

    def __hash__(self):
        return hash((self.delta, self.deltas is None, self.sym_log10_scaled,
                     self.sym_log10_threshold))


@dataclass(frozen=True)
class IDAccuracy:
    """Accuracy request for Lagrangian particle IDs: lossless; ``width`` is
    the ID grid dimension (types.h:57-59)."""

    width: int

    def __hash__(self):
        return hash(self.width)


Accuracy = Any  # union of the five accuracy types


# ---------------------------------------------------------------------------
# Quantization: decode-side state -- enough information to unambiguously
# dequantize (types.h:61-99).  Written into the compressed stream.
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FloatQuantization:
    """Decode state for an Unsf field (types.h:71-76)."""

    x0: float
    x1: float
    depth: int
    depths: Optional[np.ndarray] = None  # per-particle bit depths (u8)
    log10_scaled: int = 0
    sym_log10_threshold: float = 0.0
    seed: int = 0  # dither seed carried in the stream => deterministic decode


@dataclass(frozen=True)
class IntQuantization:
    """Decode state for an Unsi field (types.h:78-80)."""

    x0: int
    x1: int


@dataclass(frozen=True)
class PositionQuantization:
    """Decode state for a Posn field (types.h:82-87)."""

    x0: Tuple[float, float, float]
    x1: Tuple[float, float, float]
    width: float
    depth: int
    depths: Optional[np.ndarray] = None
    seed: int = 0


@dataclass(frozen=True)
class VelocityQuantization:
    """Decode state for a Velc field (types.h:89-95)."""

    x0: Tuple[float, float, float]
    x1: Tuple[float, float, float]
    depth: int
    depths: Optional[np.ndarray] = None
    sym_log10_scaled: int = 0
    sym_log10_threshold: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class IDQuantization:
    """Decode state for a Ptid field (types.h:97-99)."""

    width: int
    x0: Tuple[int, int, int]
    x1: Tuple[int, int, int]


Quantization = Any  # union of the five quantization types


# ---------------------------------------------------------------------------
# Fields and segments
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class FieldHeader:
    """Per-field wire header (types.h:103-108).

    16 bytes on the wire: u32 field code, u32 algo code, u32 packed semver,
    i32 particle count.
    """

    field_code: int
    algo_code: int
    algo_version: int  # packed semver (see minnow_c_tpu.semver)
    particle_len: int


@dataclass
class Field:
    """A raw field: user data + accuracy request (types.h:110-115).

    ``data`` layout matches the reference: Posn/Velc are float32 arrays of
    shape (3, n) (dimension-major, quant.c:170-176); Ptid/Unsi are uint64
    (n,); Unsf is float32 (n,).
    """

    hd: FieldHeader
    data: Any  # np.ndarray or jax.Array
    acc: Accuracy
    valid: bool = True


@dataclass
class QField:
    """A quantized field: integer bin indices + decode state
    (types.h:117-122).  ``data`` is uint32 (bins are capped at 24 bits by the
    f32 mantissa; the reference stores u64 but never needs more than 24 bits
    for quantized floats -- u64 is kept only for Unsi ranges, handled by the
    optional ``data_hi`` plane)."""

    hd: FieldHeader
    data: Any  # uint32 bins; shape (3, n) for Posn/Velc/Ptid, (n,) otherwise
    quant: Quantization
    data_hi: Any = None  # optional high-32-bit plane for >32-bit Unsi ranges
    valid: bool = True


@dataclass
class CField:
    """A compressed field: opaque bytes + checksum (types.h:124-129)."""

    hd: FieldHeader
    data: bytes
    checksum: int = 0
    valid: bool = True


@dataclass
class Seg:
    """A particle segment: a collection of fields (types.h:150-153)."""

    fields: list


@dataclass
class QSeg:
    fields: list


@dataclass
class CSeg:
    fields: list


# Map from field code to the (accuracy, quantization) classes, used by
# dispatch layers.
FIELD_ACCURACY = {
    FieldCode.POSN: PositionAccuracy,
    FieldCode.VELC: VelocityAccuracy,
    FieldCode.PTID: IDAccuracy,
    FieldCode.UNSF: FloatAccuracy,
    FieldCode.UNSI: IntAccuracy,
}

FIELD_QUANTIZATION = {
    FieldCode.POSN: PositionQuantization,
    FieldCode.VELC: VelocityQuantization,
    FieldCode.PTID: IDQuantization,
    FieldCode.UNSF: FloatQuantization,
    FieldCode.UNSI: IntQuantization,
}
