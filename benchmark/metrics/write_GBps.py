"""Raw field bytes of every whole write in the window over the window's
wall time (host clock), GB/s: Window.GBps."""


def read(win):
    return win.GBps
