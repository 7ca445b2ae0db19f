"""Algorithm registry: maps (AlgoCode, packed semver) -> codec.

Real implementation of the reference's stubbed L3 dispatch
(``src/register.{h,c}``, empty at register.c:22-84).  The registry enforces
the versioning contract from the spec (header_format.tex:239-283):

* every major.minor of an algorithm is a *frozen module*
  (``algo_<name>_v<major>_<minor>.py``) registered forever, so any segment
  ever written stays decodable;
* lookups are patch-insensitive -- a stream recorded with 1.0.3 decodes
  with the newest registered 1.0.x (header_format.tex:280-282);
* comparisons ignore the stage byte (semver.py).

A codec implements ``compress(qf) -> list[bytes]`` (blocks) and
``decompress(hd, blocks, valid) -> QField``; scratch-buffer reuse, the
reference's CAlloc/CFree machinery (register.h:15-22), is unnecessary in a
functional design -- XLA owns buffers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Protocol, Tuple

from .. import semver
from ..types import FieldHeader, QField


class Codec(Protocol):
    """The CFunc/DFunc pair of the reference (types.h:133-146), as one
    object.  ``compress`` must not compute checksums (types.h:136 contract);
    the segment layer owns integrity."""

    algo_code: int
    version: int  # packed semver

    def compress(self, qf: QField) -> List[bytes]:
        ...

    def decompress(self, hd: FieldHeader, blocks: List[Optional[bytes]]
                   ) -> QField:
        """``blocks[i] is None`` marks a corrupt block; codecs localize the
        damage (NaN subsets) per the spec (header_format.tex:190-196)."""
        ...


_registry: Dict[Tuple[int, int], Codec] = {}


def register(codec: Codec) -> None:
    """Register a frozen codec version (Register_Add, register.h:28-30).
    Patch upgrades replace in place; major.minor pairs are unique."""
    key = (int(codec.algo_code),
           (codec.version >> 8) & 0xFFFF)  # (algo, major.minor)
    existing = _registry.get(key)
    if existing is not None and semver.greater(existing.version,
                                               codec.version):
        return  # keep the newer patch
    _registry[key] = codec


def supports(algo: int, version: int) -> bool:
    """Register_Supports (register.h:48): can this (algo, major.minor) be
    decoded?"""
    return (int(algo), (version >> 8) & 0xFFFF) in _registry


def get(algo: int, version: int) -> Codec:
    """Resolve a codec, patch-insensitively.  Raises on unsupported
    versions like LoadDecompressors does (funcs.c:130-134)."""
    key = (int(algo), (version >> 8) & 0xFFFF)
    codec = _registry.get(key)
    if codec is None:
        raise KeyError(
            f"v{semver.major(version)}.{semver.minor(version)} of algorithm "
            f"{algo:#x} is not supported")
    return codec


def newest(algo: int) -> int:
    """Latest registered version of an algorithm (Register_Newest,
    register.h:49)."""
    best = None
    for (a, _mm), codec in _registry.items():
        if a == int(algo):
            if best is None or semver.greater(codec.version, best):
                best = codec.version
    if best is None:
        raise KeyError(f"no registered versions of algorithm {algo:#x}")
    return best


def registered() -> List[Tuple[int, int]]:
    """All (algo_code, version) pairs, for introspection/tests."""
    return [(a, c.version) for (a, _), c in _registry.items()]
