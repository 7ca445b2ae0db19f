"""File bytes over raw field bytes, summed over the window's writes."""


def read(win):
    stored = [s for s in win.stored if s is not None]
    if not stored:
        return None
    return sum(stored) / (win.raw_bytes * len(stored))
