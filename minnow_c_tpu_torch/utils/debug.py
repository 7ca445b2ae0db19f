"""Debug/assert tier -- the analog of the reference's ``src/debug.h``.

The reference distinguishes always-on ``Assert`` (wire/contract
boundaries; here: plain Python exceptions, always raised) from
``DebugAssert``, cheap internal-invariant checks compiled out of release
builds (debug.h:52-63, enabled by ``-DDEBUG``).  The equivalent toggle
here is the ``MINNOW_DEBUG=1`` environment variable or ``set_debug(True)``
-- off by default so hot paths pay nothing but a truthiness test.

``debug_assert`` accepts either a bool or a zero-arg callable; callables
are only evaluated when debugging is on, so expensive predicates (device
syncs, O(n) scans) cost nothing in release mode::

    debug_assert(lambda: int(jnp.max(widths)) <= 32, "width overflow")
"""

from __future__ import annotations

import os

def _parse_flag(v: str) -> bool:
    """Tolerant env-flag parse: true/yes/on or any nonzero integer (e.g.
    MINNOW_DEBUG=2, the common "more verbose" convention) enable; bad
    values must not crash package import."""
    s = v.strip().lower()
    if s in ("true", "yes", "on"):
        return True
    try:
        return int(s) != 0
    except ValueError:
        return False


_DEBUG = _parse_flag(os.environ.get("MINNOW_DEBUG", "0"))


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    """Toggle internal-invariant checking at runtime (tests use this)."""
    global _DEBUG
    _DEBUG = bool(on)


def debug_assert(cond, msg: str = "internal invariant violated") -> None:
    """No-op unless debugging is enabled (DebugAssert, debug.h:52-63)."""
    if not _DEBUG:
        return
    ok = cond() if callable(cond) else cond
    if not ok:
        raise AssertionError(f"DebugAssert failed: {msg}")
