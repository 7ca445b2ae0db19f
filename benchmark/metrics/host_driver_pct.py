"""Share of the operations' wall outside the program's snapshot entry
points (the ``snapshot.compress`` and ``snapshot.decompress`` spans): the
Gadget-2 driver's record parse, download and record writes, and whatever
else the client does around the call, %."""

from benchlib import records

SPANS = ("snapshot.compress", "snapshot.decompress")


def read(win):
    t = win.trace
    if t is None or not records.kept():
        return None
    return 100.0 * (1.0 - t.span_s(SPANS) / t.ops_s)
