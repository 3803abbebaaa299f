"""Async maintenance worker: escalated repacks off the serving path
(``roaringbitmap_tpu.mutation.maintenance``).

``apply_delta(..., worker=w)`` on a delta that escalates records it on the
set's pending list, queues one repack job (later escalations ride it, so a
burst of M pays one repack) and returns ``mode="repack_queued"`` with the
version unchanged.  Until the worker commits, the set serves the pre-delta
image, bit-exact at the pre-delta version.  The commit recomputes the
post-delta sources at commit time (pending deltas in arrival order), so
patches that land in between survive.  It runs ``repack_in_place``, which
builds the new layout apart, waits for that build on the card's current
stream and only then swaps it in, then invalidates the result caches; the
engines pick the new layout up on their next plan.  ``drain()`` is the
barrier.

Jobs run one at a time on the worker thread.  ``lock=`` (the serving
loop's lock) serializes a commit against that loop, so a plan never sees a
layout change between its planning and its launch.  A job that raises is
counted (``jobs_failed``, ``last_error``, logged) and the queue moves on: a
failed repack leaves the pre-delta image serving.  The JAX package's trace
spans and metrics wait for the observability layer.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_log = logging.getLogger("roaringbitmap_tpu_torch.mutation")

SITE = "maintenance"


class MaintenanceWorker:
    """One daemon maintenance thread and its job queue (escalated repacks;
    any zero-argument callable is accepted)."""

    def __init__(self, lock=None, start: bool = True,
                 name: str = "rb-maintenance"):
        self._queue: queue_mod.Queue = queue_mod.Queue()
        self._lock = lock
        self._stop = threading.Event()
        self._idle = threading.Condition()
        #: jobs submitted and not yet finished: counted at submit() and
        #: dropped after the job ran, so pending() never reads 0 between a
        #: dequeue and the job body (drain() relies on it)
        self._pending = 0
        self.jobs_done = 0
        self.jobs_failed = 0
        self.last_error: Exception | None = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        if start:
            self._thread.start()

    def submit(self, job, kind: str = "repack", desc: str = "") -> None:
        """Queue one job (jobs run in submission order).  The submitter's
        trace context rides the queue item, so the job's span parents into
        the operation that queued it."""
        with self._idle:
            self._pending += 1
        self._queue.put((job, kind, desc, obs_trace.inject()))
        obs_metrics.counter("rb_maintenance_jobs_total", kind=kind).inc()
        obs_metrics.gauge("rb_maintenance_queue_depth").set(self.pending())

    def pending(self) -> int:
        return self._pending

    def drain(self, timeout: float = 60.0) -> int:
        """Block until every queued job has finished; returns the jobs done
        so far.  Without a running thread (``start=False``: deterministic
        single-threaded tests) the queue runs on the caller's thread."""
        if not self._thread.is_alive():
            while not self._queue.empty():
                item = self._queue.get()
                if item is None:
                    continue
                try:
                    self._run_one(*item)
                finally:
                    with self._idle:
                        self._pending -= 1
            return self.jobs_done
        deadline = time.monotonic() + timeout
        with self._idle:
            while self._pending and time.monotonic() < deadline:
                self._idle.wait(0.01)
        if self._pending:
            raise TimeoutError(f"{SITE}: {self._pending} job(s) still "
                               f"pending after {timeout:g}s")
        return self.jobs_done

    def stop(self, drain: bool = True, timeout: float = 60.0) -> None:
        if drain and self._thread.is_alive():
            self.drain(timeout=timeout)
        self._stop.set()
        self._queue.put(None)     # wake the thread
        if self._thread.is_alive():
            self._thread.join(timeout=10.0)

    def _run(self) -> None:
        while not self._stop.is_set():
            item = self._queue.get()
            if item is None:
                continue
            try:
                self._run_one(*item)
            finally:
                with self._idle:
                    self._pending -= 1
                    self._idle.notify_all()
                obs_metrics.gauge("rb_maintenance_queue_depth").set(
                    self.pending())

    def _run_one(self, job, kind: str, desc: str, ctx=None) -> None:
        # a span parented into the submitter's context: on the worker
        # thread the contextvar holds no span
        t0 = time.perf_counter()
        with obs_trace.span_from(ctx, "mutation.maintenance", site=SITE,
                                 kind=kind, desc=desc) as sp:
            try:
                if self._lock is not None:
                    with self._lock:
                        job()
                else:
                    job()
                self.jobs_done += 1
                sp.tag(ok=True)
                sp.event("mutation.maintenance", site=SITE, kind=kind,
                         desc=desc, ok=True, wall_ms=round(
                             (time.perf_counter() - t0) * 1e3, 2))
            except Exception as exc:   # stay alive, stay visible
                self.jobs_failed += 1
                self.last_error = exc
                obs_metrics.counter("rb_maintenance_failures_total",
                                    error_class=type(exc).__name__).inc()
                # "kind" is the ring event's type: the job kind rides as
                # job_kind
                obs_flight.record("error", site=SITE, job_kind=kind,
                                  desc=desc, error_class=type(exc).__name__)
                sp.tag(ok=False, status="error",
                       error_class=type(exc).__name__)
                sp.event("mutation.maintenance", site=SITE, kind=kind,
                         desc=desc, ok=False,
                         error_class=type(exc).__name__)
                _log.exception("%s: job %s (%s) failed", SITE, kind, desc)
