"""The card memory the codec takes: the most allocated during the window
less what was allocated when it opened (a write cell's resident input),
GB."""


def read(win):
    if not win.peak_bytes:
        return None
    return (win.peak_bytes - win.baseline_bytes) / 1e9
