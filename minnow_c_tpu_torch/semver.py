"""Packed semantic-version encoding.

Versions are packed into a u32: ``[stage | major | minor | patch]`` with the
patch in the 8 least-significant bits, then minor, then major; the top byte
is an implementation-defined stage flag that never affects comparisons
(reference ``src/semver.{h,c}``, spec header_format.tex:289-297).

Comparisons mask away the stage byte (semver.c:9-15), so ``1.2.3-dev`` and
``1.2.3`` compare equal -- the stage is cosmetic by design.
"""

from __future__ import annotations

import re

# Stage values (semver.h:9-15).
DEV = 0
ALPHA = 1
BETA = 2
RC = 3
RELEASE = 4

_STAGE_NAMES = {DEV: "dev", ALPHA: "alpha", BETA: "beta", RC: "rc",
                RELEASE: ""}
_STAGE_VALUES = {"dev": DEV, "alpha": ALPHA, "beta": BETA, "rc": RC,
                 "": RELEASE}

_VERSION_RE = re.compile(r"^(\d+)\.(\d+)\.(\d+)(?:-(dev|alpha|beta|rc))?$")


def pack(major: int, minor: int, patch: int, stage: int = RELEASE) -> int:
    """Pack version components into a u32 (semver_FromString tail,
    semver.c:93-94)."""
    for name, v in (("major", major), ("minor", minor), ("patch", patch)):
        if not 0 <= v <= 255:
            raise ValueError(f"semver {name}={v} out of [0, 255]")
    if stage not in _STAGE_NAMES:
        raise ValueError(f"unknown semver stage {stage}")
    return (stage << 24) | (major << 16) | (minor << 8) | patch


def major(version: int) -> int:
    return (version >> 16) & 0xFF


def minor(version: int) -> int:
    return (version >> 8) & 0xFF


def patch(version: int) -> int:
    return version & 0xFF


def stage(version: int) -> int:
    s = (version >> 24) & 0xFF
    if s not in _STAGE_NAMES:
        raise ValueError(f"corrupt semver stage byte {s:#x}")
    return s


def greater(v1: int, v2: int) -> bool:
    """Compare ignoring the stage byte (semver.c:9-11)."""
    return (v1 & 0xFFFFFF) > (v2 & 0xFFFFFF)


def equals(v1: int, v2: int) -> bool:
    """Compare ignoring the stage byte (semver.c:13-15)."""
    return (v1 & 0xFFFFFF) == (v2 & 0xFFFFFF)


def to_string(version: int) -> str:
    """Render ``x.y.z[-stage]`` (semver_ToString, semver.c:17-42)."""
    s = _STAGE_NAMES[stage(version)]
    base = f"{major(version)}.{minor(version)}.{patch(version)}"
    return f"{base}-{s}" if s else base


def from_string(s: str) -> int:
    """Parse ``x.y.z[-stage]`` (semver_FromString, semver.c:46-95)."""
    m = _VERSION_RE.match(s)
    if m is None:
        raise ValueError(f"cannot parse semver string {s!r}")
    maj, mnr, pat = int(m.group(1)), int(m.group(2)), int(m.group(3))
    stg = _STAGE_VALUES[m.group(4) or ""]
    return pack(maj, mnr, pat, stg)
