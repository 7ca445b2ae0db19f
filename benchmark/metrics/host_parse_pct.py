"""Share of the operations' wall inside the program's ``decode.parse``
span (segment parse and checksums), %."""

SPANS = ("decode.parse",)


def read(win):
    t = win.trace
    if t is None:
        return None
    return 100.0 * t.span_s(SPANS) / t.ops_s
