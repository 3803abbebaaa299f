"""Per-query latency attribution + deadline/SLO accounting (the port's own
copy of ``roaringbitmap_tpu.obs.slo``).

The span tracer (``obs.trace``) already decomposes a query's wall time —
but only when a trace file is configured, and only into a JSONL dump a
human reads later.  A serving loop needs the same decomposition *live*
and *always on*: which phase ate the budget (plan? program build? the
device? readback?), and did the query make its deadline.  This module is
that accounting:

- :func:`query` opens a **query context** around one guarded execute
  (``BatchEngine.execute`` / ``MultiSetBatchEngine.execute`` open one per
  call; ``guard.run_with_fallback`` opens one per dispatch so every
  guarded site — aggregation, sharding — is covered with no per-site
  code).  Nested contexts are suppressed: the outermost owns the
  attribution, so a pooled S=1 route or an OOM-split recursion is
  counted once.
- :func:`phase` attributes a block to a named phase (``queue`` / ``plan``
  / ``program_build`` / ``dispatch`` / ``sync`` / ``readback``; the
  residual lands in ``other`` so the phases always sum to the query's
  wall time).  Disabled fast path: one module-int check, no allocation —
  the same contract as the disabled tracer.
- On context exit the phases feed ``rb_phase_seconds{site,engine,phase}``
  histograms, and — when a deadline is set —
  ``rb_slo_attained_total{site}`` / ``rb_slo_missed_total{site}``
  counters.  A missed query additionally attaches an ``slo`` event
  (deadline, wall, phase breakdown in ms) to the enclosing trace span,
  so a dump shows *why* the deadline was missed, not just that it was.

Deadlines come from ``SloPolicy(deadline_ms)`` — carried on
``GuardPolicy.slo_deadline_ms`` / ``ROARING_TPU_SLO_MS`` — measured from
context entry, or from ``enqueued_at`` (a ``time.perf_counter()`` stamp)
when the caller supplies arrival time.

**Profile-on-miss.**  ``ROARING_TPU_PROFILE_ON_SLO_MISS=<dir>[:n]`` arms
a ``torch.profiler.profile`` window (CPU and, on a card, CUDA activity)
after an SLO miss: each of the next ``n`` (default 1) queries runs inside
one, exported as a Chrome trace ``slo-miss-<pid>-<k>.json`` under
``dir``, so a trace of the *reoccurring* slow dispatch lands on disk
without an operator attaching anything.  (The missed query itself cannot
be profiled retroactively; the armed-next-query window is the honest
approximation for steady-state misses.)
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import itertools
import logging
import os
import time

from . import metrics as _metrics
from . import trace as _trace

ENV_SLO_MS = "ROARING_TPU_SLO_MS"
ENV_PROFILE = "ROARING_TPU_PROFILE_ON_SLO_MISS"

#: the attribution vocabulary (``other`` is the residual, always added)
PHASES = ("queue", "plan", "program_build", "dispatch", "sync", "readback")

_log = logging.getLogger("roaringbitmap_tpu_torch.obs")

_active = 0          # live query contexts; the phase() fast-path flag
_attribution = False  # force attribution without a deadline (bench lanes)
_current: contextvars.ContextVar = contextvars.ContextVar(
    "rb_slo_query", default=None)

#: the most recent completed attribution (plain dict), for callers that
#: want the breakdown without touching the registry
last_query: dict | None = None

# -- profile-on-miss state (refresh_from_env) ---------------------------
_profile_dir: str | None = None
_profile_budget = 0
_profile_armed = False
_profile_seq = itertools.count(1)


def _start_profile():
    """One profile-on-miss window: a started ``torch.profiler.profile``
    recording CPU activity and, where a card is present, CUDA activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof) -> None:
    prof.__exit__(None, None, None)
    os.makedirs(_profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(
        _profile_dir, f"slo-miss-{os.getpid()}-{next(_profile_seq)}.json"))


@dataclasses.dataclass(frozen=True)
class SloPolicy:
    """One latency objective: a per-query wall deadline in milliseconds."""

    deadline_ms: float

    @classmethod
    def from_env(cls) -> "SloPolicy | None":
        v = os.environ.get(ENV_SLO_MS)
        return cls(float(v)) if v else None


class _Noop:
    """Shared no-op for both query contexts and phases when accounting is
    inactive — instrumentation sites need no enabled checks."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def note_engine(self, engine: str):
        return self


_NOOP = _Noop()


class _Phase:
    __slots__ = ("name", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ctx = _current.get()
        if ctx is not None:
            dt = time.perf_counter() - self._t0
            ctx.phases[self.name] = ctx.phases.get(self.name, 0.0) + dt
        return False


def phase(name: str):
    """Attribute the enclosed block to ``name`` in the current query
    context (no-op when none is active — one int check)."""
    if not _active:
        return _NOOP
    return _Phase(name)


class _QueryCtx:
    __slots__ = ("site", "deadline_ms", "enqueued_at", "engine", "phases",
                 "_t0", "_token", "_profiling")

    # _profiling holds the live torch.profiler window (None when none)

    def __init__(self, site: str, deadline_ms: float | None,
                 enqueued_at: float | None):
        self.site = site
        self.deadline_ms = deadline_ms
        self.enqueued_at = enqueued_at
        self.engine = "unresolved"
        self.phases: dict = {}
        self._profiling = None

    def note_engine(self, engine: str) -> "_QueryCtx":
        self.engine = engine
        return self

    def __enter__(self):
        global _active, _profile_armed, _profile_budget
        _active += 1
        self._token = _current.set(self)
        self._t0 = time.perf_counter()
        if self.enqueued_at is not None:
            self.phases["queue"] = max(0.0, self._t0 - self.enqueued_at)
        if _profile_armed and _profile_dir:
            try:
                self._profiling = _start_profile()
                # the budget is spent only on a capture that actually
                # started; arming persists until it runs out, so a miss
                # buys windows over the next n queries, not just one
                _profile_budget -= 1
                _profile_armed = _profile_budget > 0
            except Exception as exc:  # pragma: no cover - profiler backend
                _profile_armed = False
                _log.warning("SLO-miss profile capture failed to start: %s",
                             exc)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _active, _profile_armed, last_query
        _active -= 1
        _current.reset(self._token)
        end = time.perf_counter()
        if self._profiling is not None:
            try:
                _stop_profile(self._profiling)
            except Exception as exc:  # pragma: no cover - export failed
                _log.warning("SLO-miss profile export failed: %s", exc)
        t_arrival = (self.enqueued_at if self.enqueued_at is not None
                     else self._t0)
        wall_s = end - t_arrival
        phases = dict(self.phases)
        phases["other"] = max(0.0, wall_s - sum(phases.values()))
        for ph, s in phases.items():
            _metrics.histogram("rb_phase_seconds", site=self.site,
                               engine=self.engine, phase=ph).observe(s)
        wall_ms = wall_s * 1e3
        phases_ms = {ph: round(s * 1e3, 4) for ph, s in phases.items()}
        doc = {"site": self.site, "engine": self.engine,
               "wall_ms": round(wall_ms, 4), "phases_ms": phases_ms,
               "deadline_ms": self.deadline_ms, "missed": False}
        if self.deadline_ms is not None:
            missed = wall_ms > self.deadline_ms
            doc["missed"] = missed
            if missed:
                _metrics.counter("rb_slo_missed_total",
                                 site=self.site).inc()
                # the enclosing span (batch.execute / multiset.execute /
                # guard.dispatch) carries the miss with its breakdown
                _trace.current().event(
                    "slo", site=self.site, engine=self.engine,
                    deadline_ms=self.deadline_ms,
                    wall_ms=doc["wall_ms"], missed=True,
                    phases_ms=phases_ms)
                if _profile_dir and _profile_budget > 0:
                    _profile_armed = True
            else:
                _metrics.counter("rb_slo_attained_total",
                                 site=self.site).inc()
        last_query = doc
        return False


def query(site: str, deadline_ms: float | None = None,
          enqueued_at: float | None = None):
    """Open a query context (context manager).  No-op when a context is
    already active (the outermost owns attribution) or when neither a
    deadline nor forced attribution (:func:`set_attribution`) is
    configured."""
    if _current.get() is not None:
        return _NOOP
    if deadline_ms is None:
        pol = SloPolicy.from_env()
        if pol is not None:
            deadline_ms = pol.deadline_ms
        elif not _attribution:
            return _NOOP
    return _QueryCtx(site, deadline_ms, enqueued_at)


def note_engine(engine: str) -> None:
    """Record the resolved engine rung on the current query context (the
    guard calls this when a dispatch lands, so phase histograms carry the
    rung that actually served the query)."""
    ctx = _current.get()
    if ctx is not None:
        ctx.engine = engine


def count_outcome(site: str, missed: bool,
                  tenant: str | None = None) -> None:
    """One SLO outcome outside a query context — the serving loop's
    per-REQUEST accounting (a pooled dispatch serves many requests with
    different deadlines, so the per-context counting above cannot
    attribute them individually).  Same counter names, optionally
    per-tenant labeled: ``rb_slo_attained_total`` /
    ``rb_slo_missed_total{site[,tenant]}``."""
    labels = {"site": site}
    if tenant is not None:
        labels["tenant"] = tenant
    name = "rb_slo_missed_total" if missed else "rb_slo_attained_total"
    _metrics.counter(name, **labels).inc()


def set_attribution(on: bool) -> None:
    """Force phase attribution on/off independent of any deadline — the
    bench lanes use this to capture a per-phase breakdown without
    configuring an SLO."""
    global _attribution
    _attribution = bool(on)


@contextlib.contextmanager
def attribution():
    """``with slo.attribution():`` — scoped :func:`set_attribution`."""
    prev = _attribution
    set_attribution(True)
    try:
        yield
    finally:
        set_attribution(prev)


def refresh_from_env() -> None:
    """Re-read ``ROARING_TPU_PROFILE_ON_SLO_MISS`` (``<dir>[:n]``, n = how
    many post-miss queries to profile, default 1).  Run at import; call
    again after mutating the environment in-process."""
    global _profile_dir, _profile_budget, _profile_armed
    spec = os.environ.get(ENV_PROFILE, "")
    _profile_armed = False
    if not spec:
        _profile_dir, _profile_budget = None, 0
        return
    path, n = spec, 1
    head, _, tail = spec.rpartition(":")
    if head and tail.isdigit():
        path, n = head, int(tail)
    _profile_dir, _profile_budget = path, max(0, n)


refresh_from_env()
