"""Structured span tracer for the query path (the port's own copy of
``roaringbitmap_tpu.obs.trace``: span names, tag keys, the JSONL record and
the env knobs are the JAX package's, so ``tools/check_trace.py`` validates
a dump of either package).

A span is one timed stage of a query ("batch.execute", "batch.plan",
"guard.dispatch", ...) with parent/child nesting, wall-clock duration, a
flat tag dict (engine, Q, rung, demotion counts, ...), and a list of
point-in-time events (guard retry/demote/split decisions carry the same
schema the structured log lines use, so log scrapers and trace consumers
read one vocabulary).  Completed spans are appended as one JSON object per
line to the file named by ``ROARING_TPU_TRACE`` (JSONL).

Design constraints:

- **Near-zero disabled overhead.**  When no trace path is configured,
  ``span()`` returns one shared no-op object without allocating a Span,
  touching a contextvar, or opening a file — the fast path is a module
  flag check.
- **Crash-usable dumps, no system call a span.**  Each span is written
  when it closes into a buffered sink that is flushed at the first close
  ``FLUSH_S`` (1 s) after the last flush, at ``disable()``, before a
  ``fork`` and at exit, so a trace survives the process dying mid-query
  but for its last second; the process id is read once, not per span.
  Where a system call costs tens of microseconds (an NVIDIA H100 host of
  PERF.md read ~50 us a ``getpid`` and ~80 us a line write inside a
  wide-op loop), a write and two ``getpid`` a span made a traced run
  host-bound.  Parents close after children, hence
  appear later in the file (consumers must collect ids before resolving
  ``parent_id``).
- **Device alignment.**  ``ROARING_TPU_TRACE_XPROF=1`` additionally wraps
  every span in ``torch.profiler.record_function`` so spans appear as
  named ranges in a ``torch.profiler`` trace beside the card's kernels;
  ``Span.sync(x)`` waits for a CUDA event or a tensor's stream and records
  the wait as ``sync_ms`` — the device-side tail of a dispatch that wall
  time alone cannot attribute.  The engines call it only while tracing is
  on: with tracing off nothing here synchronizes the card.

- **Cross-host stitching.**  A pod-scale request crosses processes
  (forwarding, reroute after host loss, migration dual-writes,
  maintenance threads), so parenthood cannot always ride the contextvar.
  ``inject()`` captures the current span as a plain JSON-able context
  ``{"trace_id", "span_id"}``; ``span_from(ctx, name, **tags)`` opens a
  span whose parent is that *remote* context — the local contextvar
  parent still wins when one is active, so a remote context only takes
  effect at the root of a local tree.  The serving loop's pump and the
  wire server run on their own threads, where the contextvar does not
  follow, so their spans parent through ``span_from``.

Env knobs::

    ROARING_TPU_TRACE=/path/to/trace.jsonl   # enable, append spans here
    ROARING_TPU_TRACE_XPROF=1                # spans as profiler ranges
    ROARING_TPU_TRACE_MAX_BYTES=<n>          # rotate the sink at ~n bytes
    ROARING_TPU_TRACE_KEEP=<k>               # keep last k rotated files

Rotation: always-on serving loops and soak runs cannot grow an unbounded
dump, so when the sink crosses ``ROARING_TPU_TRACE_MAX_BYTES`` it is
rotated shift-style (``trace.jsonl`` -> ``trace.jsonl.1`` -> ... ->
``trace.jsonl.<k>``, oldest dropped) and counted in
``rb_trace_rotations_total``.  Unset/0 means unbounded (the default).

Programmatic: ``enable(path)`` / ``disable()`` / ``refresh_from_env()``.
"""

from __future__ import annotations

import atexit
import contextvars
import itertools
import json
import logging
import os
import threading
import time

ENV_TRACE = "ROARING_TPU_TRACE"
ENV_XPROF = "ROARING_TPU_TRACE_XPROF"
ENV_TRACE_MAX_BYTES = "ROARING_TPU_TRACE_MAX_BYTES"
ENV_TRACE_KEEP = "ROARING_TPU_TRACE_KEEP"

DEFAULT_KEEP = 2
#: seconds a dump may lag its process (see the module docstring)
FLUSH_S = 1.0
#: the sink's buffer, bytes
_SINK_BUFFER = 1 << 16

_log = logging.getLogger("roaringbitmap_tpu_torch.obs")

_enabled = False              # the one flag the span() fast path reads
_path: str | None = None
_xprof = False
_file = None
_write_lock = threading.Lock()
_ids = itertools.count(1)
_max_bytes = 0                # 0 = unbounded sink
_keep = DEFAULT_KEEP
_bytes = 0                    # bytes written to the current sink file
_flushed = 0.0                # perf_counter of the sink's last flush
_pid = os.getpid()            # read once, and again in a forked child
_current: contextvars.ContextVar = contextvars.ContextVar(
    "rb_torch_span", default=None)

# Called with every completed span record (after the JSONL write) — the
# flight recorder's feed.  Installed by obs.flight at import; must never
# raise into Span.__exit__.  Only fires while tracing is enabled: the
# disabled fast path allocates no Span.
_on_close = None


class _NoopSpan:
    """Shared do-nothing span: the disabled-mode fast path and the
    ``current()`` result outside any active span.  Every method is a
    cheap self-return so instrumentation sites need no enabled checks."""

    __slots__ = ()
    span_id = None

    def tag(self, **tags):
        return self

    def event(self, name, **fields):
        return self

    def sync(self, x):
        return x

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _NoopSpan()


class Span:
    """One live span.  Created only while tracing is enabled; written as
    a JSONL record on ``__exit__`` (tags set after exit are lost)."""

    __slots__ = ("name", "span_id", "parent_id", "trace_id", "t_start",
                 "_t0", "tags", "events", "_token", "_ann", "_remote")

    def __init__(self, name: str, tags: dict):
        self.name = name
        self.span_id = f"{_pid:x}-{next(_ids):x}"
        self.tags = tags
        self.events: list = []
        self._ann = None
        self._remote = None

    def __enter__(self):
        # Parent priority: a live local parent wins (nesting stays
        # truthful inside one host); an injected remote context applies
        # only at the root of the local tree (the cross-host seam); else
        # this span roots a fresh trace.
        parent = _current.get()
        if parent is not None:
            self.parent_id = parent.span_id
            self.trace_id = parent.trace_id
        elif self._remote is not None:
            self.trace_id, self.parent_id = self._remote
        else:
            self.parent_id = None
            self.trace_id = self.span_id
        self._token = _current.set(self)
        # stamped before the profiler range opens, as the range's end is
        # after the span's: the range's own start-up cost (a first range
        # of a profiling session takes ~1 ms) falls inside both
        self.t_start = time.time()
        self._t0 = time.perf_counter()
        if _xprof:
            self._ann = _xprof_annotation(self.name)
            if self._ann is not None:
                self._ann.__enter__()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        if self._ann is not None:
            self._ann.__exit__(exc_type, exc, tb)
        _current.reset(self._token)
        if exc_type is not None:
            self.tags.setdefault("status", "error")
            self.tags.setdefault("error_class", exc_type.__name__)
        record = {
            "name": self.name, "span_id": self.span_id,
            "parent_id": self.parent_id, "trace_id": self.trace_id,
            "pid": _pid, "t_start": round(self.t_start, 6),
            "dur_ms": round(dur_ms, 4), "tags": self.tags,
            "events": self.events,
        }
        _write(record)
        hook = _on_close
        if hook is not None:
            try:
                hook(record)
            except Exception:  # pragma: no cover - ring must not cost a query
                pass
        return False

    def tag(self, **tags) -> "Span":
        self.tags.update(tags)
        return self

    def event(self, name: str, **fields) -> "Span":
        """Point-in-time record inside the span (guard retry/demote/split
        decisions); ``t_offset_ms`` is relative to the span start."""
        fields["name"] = name
        fields["t_offset_ms"] = round(
            (time.perf_counter() - self._t0) * 1e3, 4)
        self.events.append(fields)
        return self

    def sync(self, x):
        """Wait until ``x`` — a ``torch.cuda.Event``, or a tensor whose
        stream is waited for — is device-complete, recording the wait as
        ``sync_ms``: wall time up to this point is host work + queueing;
        sync_ms is the device-side remainder.  A CPU tensor returns at
        once (``sync_ms`` 0), as does None (nothing to wait for)."""
        import torch

        t0 = time.perf_counter()
        if isinstance(x, torch.cuda.Event):
            x.synchronize()
        elif isinstance(x, torch.Tensor) and x.device.type == "cuda":
            torch.cuda.current_stream(x.device).synchronize()
        self.tags["sync_ms"] = round((time.perf_counter() - t0) * 1e3, 4)
        return x


def _xprof_annotation(name: str):
    try:
        import torch.profiler

        return torch.profiler.record_function(name)
    except Exception:  # pragma: no cover - profiler unavailable
        return None


def span(name: str, **tags):
    """Start a span (use as a context manager).  Disabled mode returns the
    shared no-op without allocating."""
    if not _enabled:
        return _NOOP
    return Span(name, tags)


def span_from(ctx, name: str, **tags):
    """Start a span whose parent is the *remote* context ``ctx`` (an
    ``inject()`` dict that crossed a host/thread boundary on a ticket,
    forwarded envelope, KV payload, or job tuple).  A live local parent
    still wins — the remote context only roots the local tree — so the
    call is safe at seams that are sometimes nested, sometimes not.
    ``ctx=None`` (context never minted, e.g. tracing was off at
    admission) degrades to a plain ``span()``."""
    if not _enabled:
        return _NOOP
    sp = Span(name, tags)
    sp._remote = extract(ctx)
    return sp


def inject(sp=None):
    """The current (or given) span as a plain JSON-able trace context —
    ``{"trace_id", "span_id"}`` — or None outside any active span.  The
    pair is everything a downstream host needs to parent its spans into
    this request's trace."""
    if sp is None:
        sp = _current.get()
    if sp is None or getattr(sp, "span_id", None) is None:
        return None
    return {"trace_id": sp.trace_id, "span_id": sp.span_id}


def extract(ctx):
    """Validate a wire-shaped trace context back into a
    ``(trace_id, parent_span_id)`` pair, or None if ``ctx`` is absent or
    malformed (a garbled KV payload must never corrupt local spans)."""
    if not isinstance(ctx, dict):
        return None
    tid = ctx.get("trace_id")
    sid = ctx.get("span_id")
    if (isinstance(tid, str) and tid
            and isinstance(sid, str) and sid):
        return (tid, sid)
    return None


def current():
    """The innermost active span, or the shared no-op — lets deep layers
    (guard decisions) annotate their enclosing span without plumbing."""
    sp = _current.get()
    return sp if sp is not None else _NOOP


def _write(record: dict) -> None:
    global _bytes, _flushed
    with _write_lock:
        if not _enabled or _file is None:
            return
        try:
            line = json.dumps(record, separators=(",", ":"),
                              default=str) + "\n"
            _file.write(line)
            _bytes += len(line)
            now = time.perf_counter()
            if now - _flushed >= FLUSH_S:
                _file.flush()
                _flushed = now
            if _max_bytes > 0 and _bytes >= _max_bytes:
                _rotate_locked()
        except OSError as exc:
            # a full disk / revoked fd must cost the trace, never the
            # query that just succeeded (Span.__exit__ calls this)
            _log.warning("trace write to %s failed, disabling tracer: %s",
                         _path, exc)
            _disable_locked()


def _rotate_locked() -> None:
    """Shift-rotate the sink: close, ``p -> p.1 -> ... -> p.<keep>``
    (oldest overwritten), reopen ``p`` fresh.  Caller holds _write_lock;
    OSErrors propagate to _write's disable path — a sink we can no
    longer rotate is a sink we can no longer bound."""
    global _file, _bytes
    _file.close()
    for i in range(_keep, 1, -1):
        src = f"{_path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{_path}.{i}")
    if _keep >= 1:
        os.replace(_path, f"{_path}.1")
    else:
        os.remove(_path)
    _file = open(_path, "a", buffering=_SINK_BUFFER)
    _bytes = 0
    from . import metrics as _metrics

    _metrics.counter("rb_trace_rotations_total").inc()


def _env_max_bytes() -> int:
    try:
        return max(0, int(os.environ.get(ENV_TRACE_MAX_BYTES, "0")))
    except ValueError:
        _log.warning("%s is not an integer, rotation disabled",
                     ENV_TRACE_MAX_BYTES)
        return 0


def _env_keep() -> int:
    try:
        return max(0, int(os.environ.get(ENV_TRACE_KEEP,
                                         str(DEFAULT_KEEP))))
    except ValueError:
        return DEFAULT_KEEP


def enable(path: str, xprof: bool | None = None,
           max_bytes: int | None = None, keep: int | None = None) -> None:
    """Start appending completed spans to ``path`` (JSONL).  Opens the
    file eagerly so a bad path fails HERE, at configuration time, with a
    plain OSError — not out of the first query's span exit.
    ``max_bytes``/``keep`` override the env rotation knobs (0 max_bytes
    = unbounded); omitted, each enable re-reads the env — a previous
    enable's explicit rotation caps are NOT sticky across sinks."""
    global _enabled, _path, _file, _xprof, _max_bytes, _keep, _bytes
    disable()
    f = open(path, "a", buffering=_SINK_BUFFER)
    size = f.tell()
    with _write_lock:
        _path = path
        _file = f
        _bytes = size
        if xprof is not None:
            _xprof = bool(xprof)
        _max_bytes = (max(0, int(max_bytes)) if max_bytes is not None
                      else _env_max_bytes())
        _keep = max(0, int(keep)) if keep is not None else _env_keep()
        _enabled = True


def disable() -> None:
    with _write_lock:
        _disable_locked()


def _disable_locked() -> None:
    global _enabled, _path, _file
    _enabled = False
    _path = None
    if _file is not None:
        try:
            _file.close()
        except OSError:  # pragma: no cover - close on a dead fd
            pass
        _file = None


def enabled() -> bool:
    return _enabled


def path() -> str | None:
    return _path


def _flush_sink() -> None:
    with _write_lock:
        if _file is not None:
            try:
                _file.flush()
            except OSError as exc:
                _log.warning("trace flush to %s failed, disabling tracer: "
                             "%s", _path, exc)
                _disable_locked()


def _after_fork_in_child() -> None:
    global _pid
    _pid = os.getpid()


# the buffer is flushed before a fork, so a child inherits none of it
os.register_at_fork(before=_flush_sink, after_in_child=_after_fork_in_child)
atexit.register(disable)


def refresh_from_env() -> None:
    """Re-read ``ROARING_TPU_TRACE`` / ``ROARING_TPU_TRACE_XPROF`` /
    rotation knobs.  Run at import; call again after mutating the
    environment in-process.  The JAX package reads the same variables, so
    a process that loads both packages traces both into one file when
    ``ROARING_TPU_TRACE`` is set; give each an explicit ``enable(path)``
    to keep them apart."""
    global _xprof, _max_bytes, _keep
    _xprof = os.environ.get(ENV_XPROF, "") not in ("", "0")
    _max_bytes = _env_max_bytes()
    _keep = _env_keep()
    p = os.environ.get(ENV_TRACE)
    if p:
        try:
            enable(p)
        except OSError as exc:
            # importing the library must survive a misconfigured env var;
            # the operator gets one warning and no trace
            _log.warning("%s=%s is not writable, tracing disabled: %s",
                         ENV_TRACE, p, exc)
    else:
        disable()


refresh_from_env()
