"""The least time the window's operations need at the card's peak
bandwidth (each input byte read once, each output byte written once, in
the counts of ``benchlib/roofline.py``: Window.roofline_bytes) over the
summed time of every kernel they ran, memcpy and memset left out, %."""

from benchlib import trace as tr


def read(win):
    t = win.trace
    if t is None or not win.on_card or not win.peak_Bps or not win.roofline_bytes:
        return None
    busy = t.kernel_s()
    if busy <= 0:
        raise tr.Missing("no kernel ran in the window")
    return 100.0 * win.roofline_bytes * len(t.ops) / win.peak_Bps / busy
