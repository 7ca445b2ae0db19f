"""Device time an operation of the kernels launched inside the program's
``pos.binpack`` and ``vel.binpack`` spans (the div bin map and the pack),
ms."""

SPANS = ("pos.binpack", "vel.binpack")


def read(win):
    t = win.trace
    if t is None or not win.on_card:
        return None
    return t.kernel_s(SPANS) * 1e3 / len(t.ops)
