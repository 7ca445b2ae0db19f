"""Spans and per-operation records of the port's snapshot path.

* ``phase(name)`` -- a named span (``torch.profiler.record_function``).
  Under ``torch.profiler`` it lies on the timeline on the same clock as the
  card's kernels and copies; with nothing listening it costs microseconds.
  The snapshot writer and reader and the Gadget-2 driver wrap each step of
  their pipelines in one (``PERF.md`` lists the names).
* ``operation(name)`` -- the span of a public entry point.  The outermost
  one open on a thread also keeps a ``Record``: its name, the host's
  ``time.perf_counter()`` at open and close, and its counters; the last
  ``MAX_RECORDS`` records are kept in memory and ``operations()`` returns
  them.  An ``operation`` opened inside another is a ``phase`` only, so a
  driver that calls an entry point gives one record.
* ``count(key, n)`` -- adds ``n`` to counter ``key`` of the open record,
  and does nothing when none is open.  The snapshot path counts the bytes
  of every copy between host and card as ``h2d`` or ``d2h`` (a copy that
  stays on one side adds 0); a write counts ``packed_bits``, the bits of
  every field's packed bins before LZ4, ``depth_room``, the fields that
  the room rule of ``quant.engine.delta_to_depth`` made deeper, and
  ``pooled_sum_bytes``, the stored block bytes whose checksum a pool task
  took (``parallel.snapshot._entropy``); a batched read counts
  ``pooled_decode_bytes``, the stored payload block bytes that a pool
  task decoded into their row (``parallel.snapshot._payload_words``), and
  a read ``viewed_segment_bytes``, the segment body bytes it took as views
  of the whole file's bytes that the caller's stream held
  (``segment.io.iter_segment_views``).

With ``MINNOW_PROFILE`` set, closing a record prints one line to standard
error, e.g. ``[minnow] g2.compress: 1712.3 ms  packed_bits 2302.9 Mbit
depth_room 0  pooled_sum_bytes 232.4 MB  h2d 630.0 MB  d2h 288.1 MB``.
Nothing synchronises the card: the wall is the host's, and for an entry
point that returns tensors on the card it is the time to enqueue the
work, not to finish it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

MAX_RECORDS = 4096

_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_open = threading.local()


@dataclass
class Record:
    """One outermost operation: host wall (``perf_counter`` s) and byte
    counters."""
    name: str
    start: float
    end: Optional[float] = None
    counters: Dict[str, int] = field(default_factory=dict)

    def line(self) -> str:
        wall = (self.end - self.start) * 1e3
        parts = "".join(f"  {k} {_shown(k, v)}"
                        for k, v in self.counters.items())
        return f"[minnow] {self.name}: {wall:.1f} ms{parts}"


def _shown(key: str, n: int) -> str:
    """A counter as the line shows it: ``depth_room`` a count,
    ``packed_bits`` in Mbit, every other in MB."""
    if key == "depth_room":
        return str(n)
    return f"{n / 1e6:.1f} {'Mbit' if key == 'packed_bits' else 'MB'}"


def phase(name: str):
    """A named span on the profiler's timeline."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def operation(name: str):
    """The span of a public entry point, and its record when it is the
    outermost one open (usable as a decorator)."""
    if getattr(_open, "record", None) is not None:
        with phase(name):
            yield
        return
    rec = Record(name, time.perf_counter())
    _open.record = rec
    try:
        with phase(name):
            yield
    finally:
        rec.end = time.perf_counter()
        _open.record = None
        _records.append(rec)
        if os.environ.get("MINNOW_PROFILE"):
            print(rec.line(), file=sys.stderr, flush=True)


def count(key: str, n: int) -> None:
    """Add ``n`` to counter ``key`` of the open record, if any."""
    rec = getattr(_open, "record", None)
    if rec is not None:
        rec.counters[key] = rec.counters.get(key, 0) + int(n)


def operations() -> List[Record]:
    """The last ``MAX_RECORDS`` closed records, oldest first."""
    return list(_records)
