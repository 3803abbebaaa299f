"""Seconds of the run's set build in its timed phases (choose the layout,
pack, upload, device work), from the program's
``rb_ingest_phase_seconds``."""

from cardbench import program


def read(r, registry=None):
    return program.phase_seconds(registry=registry)
