"""Seconds from the start of the run to the window: imports, the first
build, the data made from the seed, a read cell's file written once, and
the warm operation."""


def read(win):
    return win.setup_s
