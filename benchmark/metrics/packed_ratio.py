"""Bytes of the packed bins an operation wrote (its records'
``packed_bits``: each field's depth or ID width times its elements,
before LZ4), over the operation's raw field bytes: the records of the
window's operations, averaged.  It splits ``stored_ratio`` into what the
quantizer keeps and what LZ4 and the framing make of it.  A program whose
records lack the counter reads nothing."""

from benchlib import records
from benchlib import trace as tr

KEY = "packed_bits"


def read(win):
    if not records.kept():
        return None
    recs = records.in_window(win)
    if not recs:
        raise tr.Missing("no record of the program's writes in the window")
    if any(KEY not in r.counters for r in recs):
        return None
    bits = sum(r.counters[KEY] for r in recs)
    return bits / 8 / len(recs) / win.raw_bytes
