"""Mean milliseconds of the program's ``set.aggregate`` span: one
``DeviceBitmapSet.aggregate_device`` call, entry to return, with no wait
on the card."""

from cardbench import program


def read(r):
    return program.span_ms(r, "set.aggregate")
