"""Share of the HBM bound in the device time of a wide op: the frozen
byte count (cardbench/work.py) over the busy seconds of the traced window."""

from cardbench import readers


def read(r):
    return readers.roofline(r)
