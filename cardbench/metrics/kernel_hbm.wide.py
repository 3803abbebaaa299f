"""Share of the HBM bound in the device time of a wide op, counted by the
kernels themselves: the bytes each launch says it must move (the
``kernel.launch`` events of the window's spans) over the busy seconds of
the traced window, at the bandwidth ``kernel_roofline.wide`` uses."""

from cardbench import program


def read(r):
    return program.launch_roofline(r)
