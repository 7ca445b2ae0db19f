"""Share of the operations' wall inside the program's LZ4 and serialize
spans (``pos.entropy``, ``vel.entropy``, ``ids.entropy``, ``serialize``),
%."""

SPANS = ("pos.entropy", "vel.entropy", "ids.entropy", "serialize")


def read(win):
    t = win.trace
    if t is None:
        return None
    return 100.0 * t.span_s(SPANS) / t.ops_s
