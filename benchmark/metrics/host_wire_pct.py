"""Share of the operations' wall in the program's host wire spans, %: a
write's LZ4 (``*.entropy``), block wrapping (``*.wrap``), checksums
(``serialize``) and segment writes (``segments.write``); a read's segment
reads (``decode.read``), parse and checksums (``decode.parse``) and LZ4
decode (``decode.*.entropy``)."""

from benchlib import records

FIELDS = ("pos", "vel", "ids", "mass")
SPANS = {"write": tuple(f"{f}.{s}" for s in ("entropy", "wrap")
                        for f in FIELDS) + ("serialize", "segments.write"),
         "read": ("decode.read", "decode.parse") +
         tuple(f"decode.{f}.entropy" for f in FIELDS)}


def read(win):
    t = win.trace
    if t is None or not records.kept():
        return None
    return 100.0 * t.span_s(SPANS[win.op]) / t.ops_s
