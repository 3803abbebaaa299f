"""Black-box flight recorder: post-incident state with tracing off (the
port's own copy of ``roaringbitmap_tpu.obs.flight``; the dump schema and
the ``ROARING_TPU_FLIGHT_*`` knobs are the JAX package's).

The tracer (obs.trace) is opt-in and often off in production — which is
exactly when a host loss, SLO miss, or injected crash needs forensics.
This module keeps an always-on bounded ring of recent observability
events per process and dumps it as one durable JSON artifact when a
trigger fires, so the last seconds before an incident exist on disk even
when ``ROARING_TPU_TRACE`` was never set.

What feeds the ring:

- **Span closes** — obs.trace calls the ``_span_close`` hook with every
  completed span record *while tracing is enabled*; the ring keeps a
  compact summary (name, ids, duration, error tags).  The disabled-span
  fast path allocates nothing and is untouched.
- **Typed errors and state transitions** — ``record(kind, **fields)``
  calls at the seams that matter: guard fatal/demote rungs, pod host
  loss, serving pool failures, maintenance job failures, overload-ladder
  moves.  These are plain dict appends under a lock: always-on cheap.
- **Metric deltas** — each dump carries ``metrics_delta``, the registry
  movement since the previous dump (or process start), via
  ``obs.metrics.snapshot_delta`` — the "what was trending" context.

Triggers (wired by the owning subsystems): SLO miss (serving loop),
``HostLost`` (the pod front door's ``host_lost``), crash faults
(mutation durability), overload-ladder escalation (serving loop).  ``trigger(reason, **ctx)``
debounces per reason (``ROARING_TPU_FLIGHT_DEBOUNCE_S``, first firing
always dumps) and writes the artifact with the same atomic-write
discipline as ``mutation.durability`` snapshots: temp file, flush+fsync,
``os.replace`` — a crash mid-dump leaves either the old artifact or the
new one, never a torn file.

Dump location precedence: ``configure(dir=...)`` >
``ROARING_TPU_FLIGHT_DIR`` > ``$ROARING_TPU_JOURNAL_DIR/flight`` (next
to the journal, as durability artifacts should be) > the system temp
dir.  Artifacts are single-line JSON docs with ``"kind": "rb_flight"``;
``tools/check_trace.py`` validates the schema.

Env knobs::

    ROARING_TPU_FLIGHT_DIR=<dir>         # where dumps land
    ROARING_TPU_FLIGHT_CAPACITY=<n>      # ring size (default 256)
    ROARING_TPU_FLIGHT_DEBOUNCE_S=<s>    # per-reason dump debounce (30)
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import tempfile
import threading
import time
from collections import deque

from . import metrics as _metrics
from . import trace as _trace

ENV_DIR = "ROARING_TPU_FLIGHT_DIR"
ENV_CAPACITY = "ROARING_TPU_FLIGHT_CAPACITY"
ENV_DEBOUNCE = "ROARING_TPU_FLIGHT_DEBOUNCE_S"

SCHEMA_KIND = "rb_flight"
SCHEMA_VERSION = 1
DEFAULT_CAPACITY = 256
DEFAULT_DEBOUNCE_S = 30.0

_log = logging.getLogger("roaringbitmap_tpu_torch.obs")

_lock = threading.Lock()
_ring: deque = deque(maxlen=DEFAULT_CAPACITY)
_dir: str | None = None           # configure() override
_seq = itertools.count(1)
_last_dump: dict = {}             # reason -> monotonic time of last dump
_metrics_base: dict | None = None  # registry state at the previous dump
_recent: deque = deque(maxlen=16)  # dumped-trigger summaries (statusz)

# Span-summary tag subset kept in the ring: enough to reconstruct what
# the request was doing without re-buffering whole span records.
_SPAN_TAGS = ("site", "engine", "status", "error_class", "outcome",
              "reason", "rung", "host", "from_host", "to", "tenant",
              "set_id", "level")


def record(kind: str, **fields) -> None:
    """Append one typed event to the ring (always on, never raises).
    ``kind`` is the vocabulary entry ("error", "degrade", "host_down",
    "trigger", ...); fields must be JSON-able."""
    fields["kind"] = kind
    fields["t"] = round(time.time(), 6)
    with _lock:
        _ring.append(fields)


def _span_close(rec: dict) -> None:
    """obs.trace close hook: keep a compact summary of every completed
    span while tracing is enabled."""
    tags = rec.get("tags") or {}
    ev = {
        "kind": "span", "t": round(time.time(), 6),
        "name": rec.get("name"), "span_id": rec.get("span_id"),
        "trace_id": rec.get("trace_id"), "dur_ms": rec.get("dur_ms"),
    }
    for k in _SPAN_TAGS:
        if k in tags:
            ev[k] = tags[k]
    with _lock:
        _ring.append(ev)


def configure(dir: str | None = None, capacity: int | None = None) -> None:
    """Programmatic overrides (tests, embedders).  ``dir=None`` clears
    the override back to the env/journal/temp precedence."""
    global _dir, _ring
    with _lock:
        _dir = dir
        if capacity is not None and capacity != _ring.maxlen:
            _ring = deque(_ring, maxlen=max(1, int(capacity)))


def dump_dir() -> str:
    """Resolve where artifacts land (see module docstring precedence)."""
    if _dir:
        return _dir
    d = os.environ.get(ENV_DIR)
    if d:
        return d
    jroot = os.environ.get("ROARING_TPU_JOURNAL_DIR")
    if jroot:
        return os.path.join(jroot, "flight")
    return os.path.join(tempfile.gettempdir(), "rb_flight")


def _debounce_s() -> float:
    try:
        return float(os.environ.get(ENV_DEBOUNCE, str(DEFAULT_DEBOUNCE_S)))
    except ValueError:
        return DEFAULT_DEBOUNCE_S


def trigger(reason: str, **context) -> str | None:
    """An incident happened: record it and dump the ring.  Returns the
    artifact path, or None when the per-reason debounce suppressed the
    dump (the trigger event still lands in the ring) or the dump itself
    failed (an unwritable disk must cost the artifact, not the caller).
    """
    record("trigger", reason=reason, **context)
    now = time.monotonic()
    with _lock:
        last = _last_dump.get(reason)
        if last is not None and (now - last) < _debounce_s():
            _metrics.counter("rb_flight_suppressed_total",
                             reason=reason).inc()
            return None
        _last_dump[reason] = now
        events = list(_ring)
    try:
        path = _dump(reason, context, events)
    except OSError as exc:
        _log.warning("flight dump for %r failed: %s", reason, exc)
        return None
    _metrics.counter("rb_flight_dumps_total", reason=reason).inc()
    with _lock:
        _recent.append({"reason": reason, "t": round(time.time(), 6),
                        "path": path})
    return path


def _dump(reason: str, context: dict, events: list) -> str:
    global _metrics_base
    after = _metrics.REGISTRY.snapshot()
    before = _metrics_base if _metrics_base is not None else {}
    _metrics_base = after
    doc = {
        "kind": SCHEMA_KIND, "version": SCHEMA_VERSION,
        "trigger": reason, "pid": os.getpid(),
        "t": round(time.time(), 6),
        "context": {k: v for k, v in context.items()},
        "events": events,
        "metrics_delta": _metrics.snapshot_delta(before, after),
    }
    d = dump_dir()
    os.makedirs(d, exist_ok=True)
    fname = f"flight-{os.getpid()}-{next(_seq)}-{reason}.json"
    path = os.path.join(d, fname)
    tmp = path + ".tmp"
    blob = json.dumps(doc, separators=(",", ":"), default=str)
    with open(tmp, "w") as f:
        f.write(blob + "\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def snapshot() -> dict:
    """Recorder state for statusz: ring occupancy + recent triggers."""
    with _lock:
        return {
            "capacity": _ring.maxlen, "occupancy": len(_ring),
            "dir": dump_dir(), "recent_triggers": list(_recent),
        }


def reset() -> None:
    """Drop the ring, debounce state, and metric baseline (tests)."""
    global _metrics_base
    with _lock:
        _ring.clear()
        _last_dump.clear()
        _recent.clear()
        _metrics_base = None


def refresh_from_env() -> None:
    """Re-read ``ROARING_TPU_FLIGHT_CAPACITY`` (ring size); the dump dir
    and debounce are read per use, so they need no refresh."""
    global _ring
    try:
        cap = int(os.environ.get(ENV_CAPACITY, str(DEFAULT_CAPACITY)))
    except ValueError:
        cap = DEFAULT_CAPACITY
    cap = max(1, cap)
    with _lock:
        if cap != _ring.maxlen:
            _ring = deque(_ring, maxlen=cap)


refresh_from_env()

# Install the span-close feed.  obs.trace holds only a function ref, so
# this import wiring creates no cycle (trace never imports flight).
_trace._on_close = _span_close
