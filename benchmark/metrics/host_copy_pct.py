"""Share of the operations' wall in the program's copies between host and
card, %: a write's uploads of fields (``*.upload``) and downloads of words
and block stats (``*.gather``); a read's uploads of words
(``decode.*.upload``) and the driver's download of the fields
(``g2.download``)."""

from benchlib import records

FIELDS = ("pos", "vel", "ids", "mass")
SPANS = {"write": tuple(f"{f}.{s}" for s in ("upload", "gather")
                        for f in FIELDS),
         "read": tuple(f"decode.{f}.upload" for f in FIELDS) +
         ("g2.download",)}


def read(win):
    t = win.trace
    if t is None or not records.kept():
        return None
    return 100.0 * t.span_s(SPANS[win.op]) / t.ops_s
