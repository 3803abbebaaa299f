"""Seconds of the run's set build in its pack phase (the blocked rotation
and the chunked value stream on the host), from the program's
``rb_ingest_phase_seconds{phase="pack"}``."""

from cardbench import program


def read(r, registry=None):
    return program.phase_seconds("pack", registry=registry)
