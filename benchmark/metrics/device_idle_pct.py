"""Share of the traced window in which no kernel, copy or memset ran on
the card (the union of their intervals), %."""

from benchlib import trace as tr


def read(win):
    t = win.trace
    if t is None or not win.on_card:
        return None
    if not t.device:
        raise tr.Missing("no kernel, copy or memset ran in the window")
    return 100.0 * (1.0 - t.busy_s / t.window_s)
