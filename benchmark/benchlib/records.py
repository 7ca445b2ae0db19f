"""The program's own record of each operation (``utils.profiling``): the
host wall and byte counters of each outermost entry point it ran, and the
spans that came with those records.

A program older than the records keeps neither, and a reader of them then
reads nothing; in a program that keeps them, a span or record that is
missing fails the run (``trace.Missing``), as for every other reader."""

from __future__ import annotations

from minnow_c_tpu_torch.utils import profiling


def kept() -> bool:
    """Whether the program keeps per-operation records."""
    return hasattr(profiling, "operations")


def in_window(win) -> list:
    """The program's records that opened inside one of the window's
    operations (the same host clock, ``time.perf_counter``)."""
    return [r for r in profiling.operations()
            if any(s <= r.start <= e for s, e in win.times)]
