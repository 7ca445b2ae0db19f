"""Bytes the program copied between host and card an operation (its
records' ``h2d`` and ``d2h`` counters), over the operation's raw field
bytes: the records of the window's operations, averaged."""

from benchlib import records
from benchlib import trace as tr

KEYS = ("h2d", "d2h")


def read(win):
    if not win.on_card or not records.kept():
        return None
    recs = records.in_window(win)
    if not recs or any(k not in r.counters for r in recs for k in KEYS):
        raise tr.Missing("no record of the program's copies in the window")
    moved = sum(r.counters[k] for r in recs for k in KEYS)
    return moved / len(recs) / win.raw_bytes
