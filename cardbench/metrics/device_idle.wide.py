"""Share of the traced window of a wide-op cell in which no kernel, copy
or memset ran on the card."""

from cardbench import readers


def read(r):
    return readers.idle_pct(r)
