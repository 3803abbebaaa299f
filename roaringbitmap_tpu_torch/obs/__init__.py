"""Query-path observability (the port's own copy of ``roaringbitmap_tpu.obs``:
metric names, span names, tag keys, event schemas and env knobs are the JAX
package's, so ``tools/check_trace.py`` validates a dump of either package).
It imports nothing of the JAX package.

- ``obs.trace`` — structured spans over the query path, dumped as JSONL
  via ``ROARING_TPU_TRACE=<path>`` (or ``enable(path)``); a shared no-op
  when disabled.  ``ROARING_TPU_TRACE_XPROF=1`` wraps each span in a
  ``torch.profiler.record_function`` range.
- ``obs.metrics`` — always-on process registry: dispatch-event counters
  (``guard.dispatch_stats()`` is a view over them), the serving loop's,
  mutation's and the lattice's counters, cache counters/gauges, per-
  (site, engine) execute-latency histograms.
- ``obs.export`` — Prometheus text renderer over the registry.
- ``obs.memory`` — the live HBM ledger (``rb_hbm_resident_bytes`` per
  resident kind/layout) plus per-dispatch predicted-vs-measured
  accounting (``torch.cuda.max_memory_allocated`` deltas against the
  footprint model; the ``batch.memory`` span event).
- ``obs.cost`` — device-time and cost accounting: the plan's word-op and
  byte counts, CUDA-event device time, roofline fractions against the
  H100 row of the peak table (the ``batch.cost`` / ``multiset.cost``
  span events), and the calibrated ``estimate_seconds`` the serving
  loop budgets with.
- ``obs.slo`` — per-query latency attribution (``rb_phase_seconds``) and
  deadline/SLO accounting, plus the profile-on-miss window.
- ``obs.flight`` — the black-box flight recorder: an always-on bounded
  ring dumped as an atomic JSON artifact on incident triggers.
- ``obs.statusz`` — the health report over the serving loop, the
  journals, the lattice and the flight recorder; ``obs.statusz()`` is the
  entry point.

``snapshot()`` is the in-process JSON API: the full registry state plus
the tracer's enablement, the HBM ledger, and the cost tracker.
"""

from . import cost, export, flight, memory, metrics, slo, statusz, trace
from .cost import TRACKER
from .export import render_prometheus
from .memory import LEDGER
from .metrics import (DEFAULT_LATENCY_BUCKETS, REGISTRY, counter, gauge,
                      histogram, snapshot_delta)
from .slo import SloPolicy
from .statusz import render_markdown
from .trace import current, disable, enable, enabled, inject, span, span_from


def refresh_from_env() -> None:
    """Re-read every obs env knob (``ROARING_TPU_TRACE[_XPROF]``,
    ``ROARING_TPU_PROFILE_ON_SLO_MISS``, flight-ring sizing) after an
    in-process environment change."""
    trace.refresh_from_env()
    slo.refresh_from_env()
    flight.refresh_from_env()


def snapshot() -> dict:
    """Process observability state as one plain-JSON dict: every counter,
    gauge, and histogram in the registry, plus tracer status, the HBM
    ledger's live residency breakdown, and the per-(site, engine) cost /
    roofline tracker."""
    doc = metrics.REGISTRY.snapshot()
    doc["trace"] = {"enabled": trace.enabled(), "path": trace.path()}
    doc["hbm"] = memory.LEDGER.snapshot()
    doc["cost"] = cost.TRACKER.snapshot()
    # the multihost bootstrap's state (coordinator, process id, the
    # pre-flight probe's latency), only when that module is loaded:
    # snapshot() does not pull the parallel package in for obs-only users
    import sys

    mh = sys.modules.get("roaringbitmap_tpu_torch.parallel.multihost")
    if mh is not None:
        info = mh.snapshot()
        if info:
            doc["multihost"] = info
    return doc


def reset() -> None:
    """Drop all registry instruments and the cost tracker's accumulation
    (tracer state untouched); symmetric with ``snapshot()``."""
    metrics.REGISTRY.reset()
    cost.TRACKER.reset()


__all__ = [
    "trace", "metrics", "export", "memory", "cost", "slo", "flight",
    "span", "span_from", "inject", "current", "enable", "disable",
    "enabled", "refresh_from_env",
    "counter", "gauge", "histogram", "snapshot_delta", "REGISTRY",
    "LEDGER", "TRACKER", "SloPolicy", "DEFAULT_LATENCY_BUCKETS",
    "render_prometheus", "snapshot", "reset", "statusz",
    "render_markdown",
]
