"""Readers of what the program records about itself in a traced run: its
spans and their events (``Readings.spans``, the JSONL records of
``roaringbitmap_tpu_torch/obs/trace.py`` in the window) and its process
registry (``roaringbitmap_tpu_torch.obs.metrics.REGISTRY``).

Each returns None where the program records nothing of the name it reads,
as a program without that span, event or histogram does.
"""

from __future__ import annotations

from . import work


def span_ms(r, name: str):
    """Mean ``dur_ms`` of the window's spans named ``name``."""
    durs = [s["dur_ms"] for s in r.spans if s.get("name") == name]
    return sum(durs) / len(durs) if durs else None


def launch_roofline(r):
    """The bytes the window's kernel launches say they must move (the
    ``bytes`` of every ``kernel.launch`` event) at the chip's bandwidth,
    as a share of the device's busy seconds (``work.roofline_pct``)."""
    if r.device is None:
        return None
    nbytes = sum(e.get("bytes", 0) for s in r.spans
                 for e in s.get("events", ())
                 if e.get("name") == "kernel.launch")
    return work.roofline_pct(nbytes, r.device.busy_s) if nbytes else None


def phase_seconds(phase: str | None = None, registry=None):
    """Seconds the process's set builds spent in ``phase`` (every phase
    where None), summed from ``rb_ingest_phase_seconds``; ``registry`` is
    the program's unless one is given."""
    if registry is None:
        from roaringbitmap_tpu_torch.obs.metrics import REGISTRY as registry
    rows = [row for row in registry.snapshot()["histograms"].get(
                "rb_ingest_phase_seconds", [])
            if phase is None or row["labels"].get("phase") == phase]
    return sum(row["sum"] for row in rows) if rows else None
