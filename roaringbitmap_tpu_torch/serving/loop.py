"""Deadline-aware continuous batching over the pooled engine
(``roaringbitmap_tpu.serving.loop``).

A front end that assembles wide pools from a request stream is what makes
the pooled engine pay at serving time.  Every pool shape this loop admits
has a footprint the engine predicts before dispatch
(``MultiSetBatchEngine.predict_dispatch_bytes``) and an execute time it
predicts too (``predict_dispatch_seconds``, calibrated by measured launch
walls), so admission control and the deadline-aware assembler reason about
both up front.

Time.  Every timestamp here reads the FAULT clock (``runtime.faults.clock``:
real monotonic plus an injected offset), the clock ``guard.Deadline`` runs
on, so a ``slow`` fault rule or an explicit ``faults.advance_clock`` moves
queue age, deadlines and guard budgets together, deterministically.

Execution model.  ``submit`` admits (or rejects, typed) one request;
``pump`` assembles and dispatches every ready pool; ``drain`` forces the
rest out; ``replay`` runs a timed arrival stream through all three.  A
:class:`PumpDriver` thread calling ``pump`` on a timer is a deployment; the
tests drive the loop directly.  The loop runs on its engine's device: a
pump on another thread enters that device and the stream the loop was
built on, and every result reaches its ticket as host objects (the engine
copies its outputs to pinned host memory and waits for them).

Deadline propagation.  Each dispatch derives its guard policy with
``GuardPolicy.for_remaining``: the retry/backoff deadline inside the guard
is clamped to the pool's tightest admitted remaining deadline (floored at
the pool's predicted execute time x ``slack_x``).

The degradation ladder (level 0..3, symmetric recovery): 1 halves the pool
target; 2 serves bitmap-form requests cardinality-only (typed
``degraded``); 3 caps each tenant at its weighted share of a pool.

Observability is the JAX package's: the ``serving.admit``,
``serving.assemble``, ``serving.shed`` and ``serving.dispatch`` spans (each
request's ``serving.request`` span parented through its admission context
with ``span_from``, since the pump runs on another thread), the
``rb_serving_*`` counters and gauges in the obs registry, SLO outcomes by
tenant (``obs.slo.count_outcome``), and flight records and triggers on an
SLO miss and an overload escalation.  ``ServingLoop.snapshot()`` is the
serving section of ``obs.statusz()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import threading
import time
from collections import deque

import torch

from ..obs import flight as obs_flight
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..parallel import expr as expr_mod
from ..parallel.batch_engine import BatchQuery, query_desc
from ..parallel.multiset import BatchGroup
from ..runtime import errors, faults, guard
from ..runtime import lattice as rt_lattice
from ..runtime.cache import LRUCache

_log = logging.getLogger("roaringbitmap_tpu_torch.serving")

#: the guard/fault/counter site of the serving loop
SITE = "serving"

ENV_POOL = "ROARING_TPU_SERVING_POOL"
ENV_DEADLINE_MS = "ROARING_TPU_SERVING_DEADLINE_MS"
ENV_SHED = "ROARING_TPU_SERVING_SHED"
ENV_HEADROOM = "ROARING_TPU_SERVING_HEADROOM"
ENV_MAX_QUEUE = "ROARING_TPU_SERVING_MAX_QUEUE"
ENV_RESIDENT = "ROARING_TPU_SERVING_RESIDENT"

#: ladder depth (level 3 is the last rung: fair-share caps)
MAX_LEVEL = 3
#: per-pool timing records a loop keeps (``timings``)
TIMINGS_MAX = 4096

# ------------------------------------------------------------- the types

class AdmissionRejected(errors.RoaringRuntimeError):
    """Typed admission refusal: the request never entered a queue.
    ``reason`` is ``"queue_full"`` or ``"hbm"``; ``context`` carries the
    numbers the decision was made on."""

    def __init__(self, msg: str, reason: str, **context):
        super().__init__(msg)
        self.reason = reason
        self.context = dict(context)


class RequestShed(errors.RoaringRuntimeError):
    """Typed load shed: the request was admitted but dropped before (or
    instead of) dispatch: deadline unmeetable, expired, or device-memory
    pressure at assembly.  Always an error the caller sees."""

    def __init__(self, msg: str, reason: str, **context):
        super().__init__(msg)
        self.reason = reason
        self.context = dict(context)


@dataclasses.dataclass(frozen=True)
class ServingRequest:
    """One arriving query: a flat ``BatchQuery`` or an ``ExprQuery``
    against resident set ``set_id``, owned by ``tenant``, due
    ``deadline_ms`` after arrival (None = the loop's default)."""

    set_id: int
    query: object            # BatchQuery | ExprQuery
    tenant: str = "default"
    deadline_ms: float | None = None

    def __post_init__(self):
        if not isinstance(self.query, (BatchQuery, expr_mod.ExprQuery)):
            raise TypeError(
                f"ServingRequest.query must be a BatchQuery or ExprQuery, "
                f"got {type(self.query).__name__}")


@dataclasses.dataclass(frozen=True)
class TenantPolicy:
    """Per-tenant knobs: the stride ``weight``, ``on_deadline`` (``"drop"``
    sheds an unmeetable request typed, ``"degrade"`` serves it
    cardinality-only) and an optional per-tenant queue cap."""

    weight: float = 1.0
    on_deadline: str = "drop"
    max_queue: int | None = None

    def __post_init__(self):
        if self.on_deadline not in ("drop", "degrade"):
            raise ValueError(
                f"on_deadline must be 'drop' or 'degrade', "
                f"got {self.on_deadline!r}")
        if self.weight <= 0:
            raise ValueError(f"tenant weight must be > 0: {self.weight}")


@dataclasses.dataclass(frozen=True)
class ServingPolicy:
    """Knobs of one serving loop; ``from_env`` is the deployment default.
    ``guard`` is the BASE guard policy, clamped per dispatch with
    ``GuardPolicy.for_remaining``."""

    pool_target: int = 64          # queries per pool at level 0
    max_queue: int = 1024          # per-tenant pending cap (admission)
    default_deadline_ms: float = 100.0
    hbm_headroom: float = 0.9      # admitted fraction of the memory budget
    slack_x: float = 1.5           # predicted-execute safety factor
    dispatch_margin_ms: float = 5.0  # early-dispatch margin on deadlines
    shed: bool = True              # load shedding master switch
    degrade: bool = True           # overload ladder enabled
    escalate_after: int = 2        # consecutive hot pumps per step up
    recover_after: int = 4         # consecutive calm pumps per step down
    overload_pressure: float = 1.5   # backlog/pool_target that reads hot
    tenants: dict = dataclasses.field(default_factory=dict)
    guard: guard.GuardPolicy | None = None
    engine: str = "auto"
    #: serve vocabulary pools through the descriptor ring (``resident``)
    #: instead of the per-pool dispatch; needs a sealed-lattice warmup,
    #: without which every pool is a typed ``inactive`` demotion
    resident: bool = False
    resident_capacity: int = 64    # descriptor-ring slots (power of 2)

    @classmethod
    def from_env(cls, **overrides) -> "ServingPolicy":
        env: dict = {}
        if ENV_POOL in os.environ:
            env["pool_target"] = max(1, int(os.environ[ENV_POOL]))
        if ENV_DEADLINE_MS in os.environ:
            env["default_deadline_ms"] = float(os.environ[ENV_DEADLINE_MS])
        if ENV_SHED in os.environ:
            env["shed"] = os.environ[ENV_SHED] not in ("0", "false", "")
        if ENV_HEADROOM in os.environ:
            env["hbm_headroom"] = float(os.environ[ENV_HEADROOM])
        if ENV_MAX_QUEUE in os.environ:
            env["max_queue"] = max(1, int(os.environ[ENV_MAX_QUEUE]))
        if ENV_RESIDENT in os.environ:
            env["resident"] = os.environ[ENV_RESIDENT] \
                not in ("0", "false", "")
        env.update(overrides)
        return cls(**env)

    def tenant(self, name: str) -> TenantPolicy:
        return self.tenants.get(name) or _DEFAULT_TENANT


_DEFAULT_TENANT = TenantPolicy()


def replay_stream(target, arrivals) -> list:
    """Replay a timed arrival stream against anything exposing
    ``submit(request, arrival=)`` / ``pump()`` / ``drain()``.

    ``(at_s, request)`` pairs carry nondecreasing offsets from stream
    start, in fault-clock seconds.  The clock fast-forwards through idle
    gaps; a request submitted late is back-dated to its scheduled arrival.
    Returns one ticket per arrival in arrival order (a rejected arrival
    gets a ``rejected`` ticket with the typed error), after a ``drain``."""
    t0 = faults.clock()
    tickets: list = []
    for at_s, req in arrivals:
        sched = t0 + float(at_s)
        now = faults.clock()
        if sched > now:
            faults.advance_clock(sched - now)
        try:
            t = target.submit(req, arrival=sched)
        except AdmissionRejected as exc:
            t = Ticket(request=req, enqueued_at=sched,
                       status="rejected", error=exc)
        tickets.append(t)
        target.pump()
    target.drain()
    return tickets


def _expr_shape(e):
    """Value-free structural key of an expression DAG (predicate and
    aggregate literals dropped, top-k's k kept)."""
    if isinstance(e, expr_mod.ValuePred):
        return ("vp", e.col, e.op)
    if isinstance(e, expr_mod.Agg):
        return ("agg", e.kind, e.col, e.k,
                None if e.found is None else _expr_shape(e.found))
    if isinstance(e, expr_mod.Node):
        return ("n", e.op, tuple(_expr_shape(c) for c in e.children))
    return e


def _query_shape(q):
    """Admission-cache key of a request's query: a ``BatchQuery`` as it
    is, an ``ExprQuery`` by its DAG's shape."""
    if isinstance(q, expr_mod.ExprQuery):
        return ("expr", q.form, _expr_shape(q.expr))
    return q


@dataclasses.dataclass
class Ticket:
    """One admitted (or rejected) request's lifecycle record.  ``status``:
    ``queued`` -> ``done`` | ``shed`` | ``failed`` (typed ``error`` set for
    the last two); ``rejected`` tickets come only out of a replay.
    ``degraded`` marks a bitmap request served cardinality-only."""

    request: ServingRequest
    seq: int = -1
    enqueued_at: float = 0.0     # fault-clock arrival stamp
    deadline_at: float = float("inf")
    status: str = "queued"
    result: object = None        # BatchResult when done
    error: Exception | None = None
    degraded: bool = False
    wall_ms: float | None = None
    missed: bool | None = None   # SLO outcome (done tickets)
    pending_bytes: int = 0       # admission-time footprint estimate
    #: trace context minted at admission ({"trace_id", "span_id"}, None
    #: with tracing off): the post-dispatch ``serving.request`` span
    #: parents into it, so one request is one trace across threads
    trace_ctx: dict | None = None
    _degraded_query: object = None

    @property
    def ok(self) -> bool:
        return self.status == "done"

    @property
    def query(self):
        """The query as it will dispatch (its degraded form, if any)."""
        return self._degraded_query or self.request.query

    def degrade_fields(self) -> bool:
        """bitmap -> cardinality-only (idempotent); True when the form
        changed."""
        if self.query.form != "bitmap":
            return False
        self._degraded_query = dataclasses.replace(self.query,
                                                   form="cardinality")
        self.degraded = True
        return True


class ServingLoop:
    """Continuous-batching front end over a pooled engine.

    ``engine`` is a ``MultiSetBatchEngine`` (anything exposing
    ``execute(groups, engine=, policy=)``, ``predict_dispatch_bytes``,
    ``device`` and the per-set ``_engines`` list).  The loop runs on the
    engine's device.  One loop is logically single-threaded; its lock
    decides whose turn it is."""

    #: consecutive pools the compile-majority estimator may dominate
    #: before compiled walls stop calibrating it
    CHRONIC_CAP = 8

    def __init__(self, engine, policy: ServingPolicy | None = None):
        self._engine = engine
        self.policy = policy or ServingPolicy.from_env()
        self.device = torch.device(engine.device)
        #: the stream a pump on another thread dispatches on
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.RLock()
        self.n_sets = len(engine._engines)
        self._queues: dict[str, deque] = {}
        self._vtime: dict[str, float] = {}   # weighted-stride scheduler
        self._seq = 0
        self._pending_bytes = 0
        self._req_bytes = LRUCache(1024, name="serving_req_bytes")
        self._walls: deque = deque(maxlen=8)  # (s_per_query, one-time?)
        self._s_per_q: float | None = None
        self._chronic_run = 0
        self._lattice_warmed = rt_lattice.sealed_active()
        self.level = 0
        self.level_peak = 0
        self._hot = self._calm = 0
        self._sheds_since_pump = 0
        self._completed_sheds: list = []
        self._t_assemble = 0.0
        #: the pooled prediction the budget trim computed, for the
        #: dispatch span (None when nothing was trimmed against a budget)
        self._assembled_bytes: int | None = None
        #: per-pool host timings (``pool``, ``loop_ms``: assembly and
        #: dispatch preparation on the host before the engine call,
        #: ``engine_ms``: the engine call's wall, ``post_ms``: completing
        #: the tickets, ``resident``), newest last
        self.timings: deque = deque(maxlen=TIMINGS_MAX)
        self._resident = None
        if self.policy.resident:
            from . import resident as resident_mod
            self._resident = resident_mod.ResidentQueue(
                engine, capacity=self.policy.resident_capacity)
            self._resident.seal_vocab()
        self.stats = {"admitted": 0, "rejected": 0, "served": 0,
                      "shed": 0, "failed": 0, "pools": 0, "degraded": 0}
        #: callables run with every non-empty completed-ticket batch from
        #: inside the pump lock (the wire server's response seam)
        self._completion_listeners: list = []

    def _on_device(self):
        """The loop's device and stream, for a pump on any thread."""
        if self._stream is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(self.device))
        stack.enter_context(torch.cuda.stream(self._stream))
        return stack

    # ------------------------------------------------------------ admission

    def submit(self, request: ServingRequest,
               arrival: float | None = None) -> Ticket:
        """Admit one request (typed ``AdmissionRejected`` on refusal).
        ``arrival`` back-dates the fault-clock arrival stamp; deadlines run
        from arrival."""
        with self._lock:
            return self._submit_locked(request, arrival)

    def _submit_locked(self, request: ServingRequest,
                       arrival: float | None) -> Ticket:
        now = faults.clock()
        arrival = now if arrival is None else min(arrival, now)
        deadline_ms = (request.deadline_ms
                       if request.deadline_ms is not None
                       else self.policy.default_deadline_ms)
        tp = self.policy.tenant(request.tenant)
        if not 0 <= request.set_id < self.n_sets:
            raise IndexError(
                f"set_id out of range 0..{self.n_sets - 1}: "
                f"{request.set_id}")
        with obs_trace.span("serving.admit", site=SITE,
                            tenant=request.tenant,
                            set_id=request.set_id) as sp:
            return self._admit(sp, request, tp, arrival, deadline_ms)

    def _admit(self, sp, request: ServingRequest, tp, arrival: float,
               deadline_ms: float) -> Ticket:
        q = self._queues.setdefault(request.tenant, deque())
        cap = tp.max_queue or self.policy.max_queue
        if len(q) >= cap:
            self._reject(sp, request, "queue_full", queue_depth=len(q),
                         cap=cap)
        req_bytes = self._request_bytes(request)
        budget = self._budget()
        # resident counts everything on the device: sets, value columns,
        # result-cache rows and graph pools (obs.memory.LEDGER)
        resident = obs_memory.LEDGER.resident_bytes()
        headroom = (None if budget is None
                    else int(budget * self.policy.hbm_headroom))
        if (headroom is not None
                and resident + self._pending_bytes + req_bytes > headroom):
            self._reject(sp, request, "hbm", predicted_bytes=req_bytes,
                         pending_bytes=self._pending_bytes,
                         resident_bytes=resident, budget_bytes=budget,
                         headroom_bytes=headroom)
        self._seq += 1
        # the request's root context, minted inside the admit span
        t = Ticket(request=request, seq=self._seq, enqueued_at=arrival,
                   deadline_at=arrival + deadline_ms / 1e3,
                   pending_bytes=req_bytes, trace_ctx=obs_trace.inject())
        q.append(t)
        self._vtime.setdefault(
            request.tenant, max(self._vtime.values(), default=0.0))
        self._pending_bytes += req_bytes
        self.stats["admitted"] += 1
        obs_metrics.counter("rb_serving_requests_total",
                            tenant=request.tenant).inc()
        self._queue_gauge(request.tenant)
        sp.tag(outcome="admitted", queue_depth=len(q),
               predicted_bytes=req_bytes, resident_bytes=resident,
               budget_bytes=budget, deadline_ms=deadline_ms)
        return t

    def _budget(self):
        return guard.resolve_hbm_budget(self.policy.guard, self.device)

    def _reject(self, sp, request: ServingRequest, reason: str, **ctx):
        self.stats["rejected"] += 1
        obs_metrics.counter("rb_serving_admission_rejected_total",
                            reason=reason).inc()
        sp.tag(outcome="rejected", reason=reason, **ctx)
        _log.warning("%s: admission rejected (%s) for tenant %r: %s",
                     SITE, reason, request.tenant, ctx)
        raise AdmissionRejected(
            f"{SITE}: {reason} — {query_desc(request.query)} for tenant "
            f"{request.tenant!r} refused ({ctx})", reason, **ctx)

    def _request_bytes(self, request: ServingRequest) -> int:
        """The admission increment: the single-query predicted dispatch
        bytes of the request against its own set, cached by the query's
        value-free shape."""
        key = (request.set_id, _query_shape(request.query))
        b = self._req_bytes.get(key)
        if b is None:
            be = self._engine._engines[request.set_id]
            b = int(be.predict_dispatch_bytes([request.query],
                                              engine=self.policy.engine))
            self._req_bytes.put(key, b)
        return b

    # ------------------------------------------------------------- pumping

    def pump(self, force: bool = False) -> list:
        """Assemble and dispatch every ready pool; returns the completed
        (done/shed/failed) tickets.  ``force`` dispatches partial pools
        regardless of fill or deadline (the drain path)."""
        with self._lock, self._on_device():
            return self._pump_locked(force)

    def _pump_locked(self, force: bool) -> list:
        self._update_ladder(self._backlog())
        out: list = []
        while True:
            pool, progressed = self._assemble(force)
            if pool:
                out.extend(self._dispatch(pool))
            out.extend(self._completed_sheds)
            self._completed_sheds = []
            if not progressed:
                break
        self._queue_gauge()
        self._notify_completions(out)
        return out

    def add_completion_listener(self, fn) -> None:
        """Register ``fn(tickets)``, run under the loop lock with every
        non-empty completed batch."""
        with self._lock:
            self._completion_listeners.append(fn)

    def remove_completion_listener(self, fn) -> None:
        with self._lock:
            if fn in self._completion_listeners:
                self._completion_listeners.remove(fn)

    def _notify_completions(self, out: list) -> None:
        if not out or not self._completion_listeners:
            return
        for fn in list(self._completion_listeners):
            try:
                fn(out)
            except Exception:          # a broken observer must never
                obs_metrics.counter(      # wedge the loop
                    "rb_serving_listener_errors_total").inc()
                _log.exception("%s: completion listener failed", SITE)

    def drain(self) -> list:
        """Force every queued request out (dispatch or shed)."""
        with self._lock:
            out: list = []
            while self._backlog():
                got = self.pump(force=True)
                out.extend(got)
                if not got:
                    break
            return out

    def replay(self, arrivals) -> list:
        """Timed arrival replay on the fault clock (:func:`replay_stream`)."""
        return replay_stream(self, arrivals)

    def _backlog(self) -> int:
        return sum(len(q) for q in self._queues.values())

    # ----------------------------------------------- ticket hand-off

    def adopt(self, ticket: Ticket) -> Ticket:
        """Enqueue an existing QUEUED ticket into this loop (a re-route):
        it keeps its identity, arrival stamp and deadline; this loop takes
        over its pending-bytes accounting."""
        if ticket.status != "queued":
            raise ValueError(
                f"only queued tickets can be adopted, got "
                f"{ticket.status!r}")
        with self._lock:
            tenant = ticket.request.tenant
            self._queues.setdefault(tenant, deque()).append(ticket)
            self._vtime.setdefault(
                tenant, max(self._vtime.values(), default=0.0))
            self._pending_bytes += ticket.pending_bytes
            self._queue_gauge(tenant)
        return ticket

    def evict_queued(self) -> list:
        """Remove and return every queued ticket, oldest first (a host-down
        path re-routes them); they stay ``queued``."""
        with self._lock:
            out: list = []
            for q in self._queues.values():
                while q:
                    t = q.popleft()
                    self._pending_bytes -= t.pending_bytes
                    out.append(t)
            out.sort(key=lambda t: (t.enqueued_at, t.seq))
            self._queue_gauge()
            return out

    def _pool_target(self) -> int:
        t = self.policy.pool_target
        return max(1, t // 2) if self.level >= 1 else t

    # ------------------------------------------------------------ assembly

    def _assemble(self, force: bool):
        """One pool attempt: ``(tickets_or_None, progressed)``."""
        self._completed_sheds = []
        self._t_assemble = time.perf_counter()
        backlog = self._backlog()
        if backlog == 0:
            return None, False
        now = faults.clock()
        target = self._pool_target()
        take = min(backlog, target)
        if not force and backlog < target:
            # deadline pressure: a partial pool goes when the oldest
            # request's remaining budget nears the predicted execute time
            oldest = min(t.deadline_at
                         for q in self._queues.values() for t in q)
            est = ((self._s_per_q or 1e-3) * take * self.policy.slack_x)
            if oldest - now > est + self.policy.dispatch_margin_ms / 1e3:
                return None, False
        with obs_trace.span("serving.assemble", site=SITE, backlog=backlog,
                            target=target, level=self.level) as sp:
            picked = self._pick(target)
            if not picked:
                return None, False
            if self.level >= 2 and self.policy.degrade:
                for t in picked:
                    if t.degrade_fields():
                        self._count_degraded("fields")
            picked = self._shed_unmeetable(picked, now)
            picked = self._trim_to_budget(picked, sp)
            sp.tag(pool=len(picked), shed=self._sheds_since_pump)
            return (picked or None), True

    def _pick(self, target: int) -> list:
        """Weighted stride scheduling over tenant queues; level 3 adds the
        hard per-pool fair-share cap."""
        caps: dict | None = None
        if self.level >= MAX_LEVEL and self.policy.degrade:
            active = [t for t, q in self._queues.items() if q]
            wsum = sum(self.policy.tenant(t).weight for t in active) or 1.0
            caps = {t: max(1, round(target
                                    * self.policy.tenant(t).weight / wsum))
                    for t in active}
        picked: list = []
        taken: dict = {}
        while len(picked) < target:
            ready = [t for t, q in self._queues.items() if q
                     and (caps is None or taken.get(t, 0) < caps[t])]
            if not ready:
                break
            tenant = min(ready, key=lambda t: (self._vtime[t], t))
            picked.append(self._queues[tenant].popleft())
            taken[tenant] = taken.get(tenant, 0) + 1
            self._vtime[tenant] += 1.0 / self.policy.tenant(tenant).weight
        return picked

    def _shed_unmeetable(self, picked: list, now: float) -> list:
        """Drop (or degrade, per tenant policy) the members that cannot
        meet their deadline even if the pool went now."""
        if not self.policy.shed or not picked:
            return picked
        est = self._estimate_seconds(picked)
        keep: list = []
        for t in picked:
            remaining = t.deadline_at - now
            if remaining <= 0:
                self._shed(t, "expired", remaining_ms=remaining * 1e3)
                continue
            if remaining < est * self.policy.slack_x:
                tp = self.policy.tenant(t.request.tenant)
                if tp.on_deadline == "degrade" and t.degrade_fields():
                    self._count_degraded("deadline")
                    keep.append(t)
                    continue
                self._shed(t, "deadline", remaining_ms=remaining * 1e3,
                           est_ms=est * 1e3)
                continue
            keep.append(t)
        return keep

    def _trim_to_budget(self, picked: list, sp) -> list:
        """Device-memory backpressure at assembly: requeue the pool's tail
        while the POOLED prediction plus resident bytes passes the
        headroom; a single request past it alone is shed typed."""
        self._assembled_bytes = None
        budget = self._budget()
        if budget is None or not picked:
            return picked
        headroom = int(budget * self.policy.hbm_headroom)
        while picked:
            predicted = self._pool_bytes(picked)
            resident = obs_memory.LEDGER.resident_bytes()
            if predicted + resident <= headroom:
                # kept for the dispatch span's tag
                self._assembled_bytes = predicted
                break
            if len(picked) == 1:
                self._shed(picked[0], "hbm", predicted_bytes=predicted,
                           resident_bytes=resident, budget_bytes=budget)
                return []
            est = predicted
            while len(picked) > 1 and est + resident > headroom:
                tail = picked.pop()
                self._queues[tail.request.tenant].appendleft(tail)
                est -= tail.pending_bytes
                sp.event("requeue", site=SITE, tenant=tail.request.tenant,
                         predicted_bytes=predicted, resident_bytes=resident,
                         headroom_bytes=headroom)
        return picked

    def _shed(self, t: Ticket, reason: str, **ctx) -> None:
        t.status = "shed"
        t.error = RequestShed(
            f"{SITE}: shed ({reason}) — {query_desc(t.request.query)} "
            f"for tenant {t.request.tenant!r} ({ctx})", reason, **ctx)
        self._pending_bytes -= t.pending_bytes
        self.stats["shed"] += 1
        self._sheds_since_pump += 1
        obs_metrics.counter("rb_serving_shed_total", reason=reason).inc()
        with obs_trace.span("serving.shed", site=SITE,
                            tenant=t.request.tenant, reason=reason,
                            **{k: v for k, v in ctx.items()
                               if isinstance(v, (int, float))}):
            pass
        self._completed_sheds.append(t)

    def _count_degraded(self, reason: str) -> None:
        self.stats["degraded"] += 1
        obs_metrics.counter("rb_serving_degraded_total",
                            reason=reason).inc()

    # ------------------------------------------------------------- dispatch

    def _pooled(self, tickets: list) -> list:
        return [(t.request.set_id, t.query) for t in tickets]

    def _pool_bytes(self, tickets: list) -> int:
        groups, _ = self._group(tickets)
        pred = self._engine.predict_dispatch_bytes(
            groups, engine=self.policy.engine)
        if isinstance(pred, dict):
            # a ShardedBatchEngine reports per-shard and mesh-total bytes;
            # the budget is per device, so the per-shard figure gates
            return int(pred.get("per_shard_bytes", pred["peak_bytes"]))
        return int(pred)

    def _estimate_seconds(self, tickets: list) -> float:
        """Predicted pool execute seconds: the engine's time model
        (calibrated by its measured launches) floored by the loop's own
        median of measured pool walls, scaled down by the share of the
        pool the result cache would serve."""
        pooled = self._pooled(tickets)
        fn = getattr(self._engine, "predict_dispatch_seconds", None)
        est = float(fn(pooled, engine=self.policy.engine)) if fn else 0.0
        if self._s_per_q is not None:
            est = max(est, self._s_per_q * len(tickets))
        hit_fn = getattr(self._engine, "count_cache_hits", None)
        if hit_fn is not None and tickets:
            hits = int(hit_fn(pooled))
            if hits:
                est *= max(0.0, len(tickets) - hits) / len(tickets)
        return max(est, 1e-4)

    def _dispatch(self, tickets: list) -> list:
        now = faults.clock()
        est = self._estimate_seconds(tickets)
        # deadline propagation: the tightest admitted remaining deadline,
        # floored at the predicted execute time x slack
        remaining = min(t.deadline_at for t in tickets) - now
        deadline_s = max(remaining, est * self.policy.slack_x, 1e-3)
        base = self.policy.guard or guard.GuardPolicy.from_env()
        pol = base.for_remaining(deadline_s)
        groups, order = self._group(tickets)
        faults.maybe_delay(SITE)
        budget = self._budget()
        predicted = self._assembled_bytes
        self._assembled_bytes = None
        if predicted is None:
            predicted = self._pool_bytes(tickets)
        with obs_trace.span("serving.dispatch", site=SITE,
                            pool=len(tickets), tenants=len(
                                {t.request.tenant for t in tickets}),
                            level=self.level) as sp:
            sp.tag(predicted_bytes=predicted,
                   resident_bytes=obs_memory.LEDGER.resident_bytes(),
                   budget_bytes=budget, est_ms=round(est * 1e3, 4),
                   deadline_s=round(deadline_s, 6))
            miss0 = self._compile_misses()
            t0 = faults.clock()
            h0 = time.perf_counter()
            loop_ms = (h0 - self._t_assemble) * 1e3
            rows = None
            if self._resident is not None:
                rows = self._try_resident(groups, sp)
            resident = rows is not None
            try:
                if rows is None:
                    # the per-pool dispatch: ring-served steady state
                    # never takes it (rb_serving_dispatches_total stays
                    # flat)
                    obs_metrics.counter("rb_serving_dispatches_total",
                                        site=SITE).inc()
                    rows = self._engine.execute(
                        groups, engine=self.policy.engine, policy=pol)
            except Exception as exc:
                fault = errors.classify(exc)
                if fault is None:
                    raise              # programming error, never masked
                return self._fail(tickets, fault, sp)
            wall = faults.clock() - t0
            h1 = time.perf_counter()
        flat = [r for rws in rows for r in rws]
        # the per-query wall, learned compile-aware: a one-time cost (a
        # library load, a capture, a first eager run) folded in would read
        # as sustained slowness and shed the next pools
        compiled = self._compile_misses() != miss0
        self._walls.append((wall / max(1, len(tickets)), compiled))
        warm = [w for w, c in self._walls if not c]
        majority = (2 * sum(c for _, c in self._walls)
                    > len(self._walls))
        chronic = (not self._lattice_warmed and majority
                   and self._chronic_run < self.CHRONIC_CAP)
        self._chronic_run = ((self._chronic_run + 1)
                             if majority and not self._lattice_warmed
                             else 0)
        vals = sorted(w for w, _ in self._walls) if (chronic or not warm) \
            else sorted(warm)
        self._s_per_q = vals[len(vals) // 2]
        self.stats["pools"] += 1
        obs_metrics.counter("rb_serving_pools_total").inc()
        done = faults.clock()
        for t, res in zip(order, flat):
            t.result = res
            t.status = "done"
            t.wall_ms = (done - t.enqueued_at) * 1e3
            dl_ms = (t.deadline_at - t.enqueued_at) * 1e3
            t.missed = t.wall_ms > dl_ms
            obs_slo.count_outcome(SITE, t.missed, tenant=t.request.tenant)
            # one outcome span per request after the pooled span closed,
            # parented into the request's admission context
            with obs_trace.span_from(
                    t.trace_ctx, "serving.request", site=SITE,
                    tenant=t.request.tenant, set_id=t.request.set_id,
                    outcome="done", wall_ms=round(t.wall_ms, 4),
                    missed=t.missed, degraded=t.degraded,
                    dispatch_span_id=sp.span_id):
                pass
            if t.missed:
                obs_flight.trigger(
                    "slo_miss", site=SITE, tenant=t.request.tenant,
                    set_id=t.request.set_id, wall_ms=round(t.wall_ms, 3),
                    deadline_ms=round(dl_ms, 3))
            self._pending_bytes -= t.pending_bytes
            self.stats["served"] += 1
        self.timings.append({
            "pool": len(tickets), "loop_ms": loop_ms,
            "engine_ms": (h1 - h0) * 1e3,
            "post_ms": (time.perf_counter() - h1) * 1e3,
            "resident": resident})
        return order

    def _try_resident(self, groups, sp):
        """One attempt at the resident lane; None means a TYPED demotion
        happened (counted and traced) and the one-shot dispatch must serve
        the pool."""
        from . import resident as resident_mod
        try:
            rows = self._resident.serve(groups)
        except resident_mod.ResidentEscape as exc:
            obs_metrics.counter("rb_serving_resident_demotions_total",
                                site=SITE, reason=exc.reason).inc()
            sp.event("mega.resident", site=SITE, outcome="demoted",
                     reason=exc.reason)
            _log.warning("%s: resident demotion (%s); pool falls back "
                         "to one-shot dispatch", SITE, exc.reason)
            return None
        sp.tag(resident=True)
        return rows

    @staticmethod
    def _compile_misses() -> int:
        """Process-wide program-build count (``rb_compile_seconds``
        misses): the witness that a dispatch paid a one-time cost and its
        wall must not calibrate the steady-state estimate."""
        return obs_metrics.compile_miss_total()

    def _group(self, tickets: list):
        """Tickets -> BatchGroups by set_id (first-appearance order), and
        the tickets in the engine's flattened pooled order."""
        by_sid: dict = {}
        for t in tickets:
            by_sid.setdefault(t.request.set_id, []).append(t)
        groups = [BatchGroup(sid, [t.query for t in ts])
                  for sid, ts in by_sid.items()]
        order = [t for ts in by_sid.values() for t in ts]
        return groups, order

    def _fail(self, tickets: list, fault, sp) -> list:
        """A whole-pool typed failure (the guard walked its ladder): every
        member gets the classified fault."""
        sp.tag(status="failed", error_class=type(fault).__name__)
        obs_metrics.counter("rb_serving_pool_failures_total",
                            error_class=type(fault).__name__).inc()
        obs_flight.record("error", site=SITE,
                          error_class=type(fault).__name__,
                          tickets=len(tickets))
        for t in tickets:
            t.status = "failed"
            t.error = fault
            self._pending_bytes -= t.pending_bytes
            self.stats["failed"] += 1
            with obs_trace.span_from(
                    t.trace_ctx, "serving.request", site=SITE,
                    tenant=t.request.tenant, set_id=t.request.set_id,
                    outcome="failed", error_class=type(fault).__name__,
                    dispatch_span_id=sp.span_id):
                pass
        _log.error("%s: pool of %d failed: %s", SITE, len(tickets), fault)
        return tickets

    # ----------------------------------------------------- overload ladder

    def _update_ladder(self, backlog: int) -> None:
        """Escalate or recover the degradation level from backlog pressure
        against the BASE pool target and any shed since the last pump,
        debounced by ``escalate_after`` / ``recover_after``."""
        if not self.policy.degrade:
            self._sheds_since_pump = 0
            return
        pressure = backlog / max(1, self.policy.pool_target)
        hot = (pressure > self.policy.overload_pressure
               or self._sheds_since_pump > 0)
        self._sheds_since_pump = 0
        if hot:
            self._hot += 1
            self._calm = 0
            if self._hot >= self.policy.escalate_after \
                    and self.level < MAX_LEVEL:
                self._set_level(self.level + 1, pressure)
                self._hot = 0
        else:
            self._calm += 1
            self._hot = 0
            if self._calm >= self.policy.recover_after and self.level > 0:
                self._set_level(self.level - 1, pressure)
                self._calm = 0

    def _set_level(self, level: int, pressure: float) -> None:
        prev, self.level = self.level, level
        self.level_peak = max(self.level_peak, level)
        obs_metrics.gauge("rb_serving_degrade_level").set(level)
        obs_trace.current().event(
            "degrade", site=SITE, level_from=prev, level_to=level,
            pressure=round(pressure, 4))
        obs_flight.record("degrade", site=SITE, level_from=prev,
                          level_to=level, pressure=round(pressure, 4))
        if level > prev:
            # an escalation is an incident (a recovery is not): dump the
            # flight ring
            obs_flight.trigger("overload", site=SITE, level_from=prev,
                               level_to=level, pressure=round(pressure, 4))
        _log.warning("%s: degradation level %d -> %d (pressure %.2f)",
                     SITE, prev, level, pressure,
                     extra={"rb_site": SITE, "rb_event": "degrade",
                            "rb_level": level})

    # -------------------------------------------------------------- warmup

    def warmup(self, profile=None, rungs=None, **kw) -> dict:
        """Boot-time warmup through the pooled engine.  ``profile=`` runs
        the closed-lattice path (``engine.warmup(profile=...)``): the
        vocabulary is prepared (each program a captured graph on the card)
        and the lattice seals.  Either way the service-time estimator
        resets, and a resident lane seals its vocabulary."""
        if profile is not None:
            rep = self._engine.warmup(profile=profile, **kw)
        elif rungs is not None:
            rep = self._engine.warmup(rungs=rungs, **kw)
        else:
            rep = self._engine.warmup(**kw)
        self._walls.clear()
        self._s_per_q = None
        self._chronic_run = 0
        self._lattice_warmed = rt_lattice.sealed_active()
        if self._resident is not None:
            self._resident.seal_vocab()
        return rep

    def start_pump(self, interval_s: float | None = None) -> "PumpDriver":
        """Start a :class:`PumpDriver` over this loop; call its ``stop()``
        when done."""
        return PumpDriver(self, interval_s=interval_s).start()

    # -------------------------------------------------------------- health

    def _queue_gauge(self, tenant: str | None = None) -> None:
        tenants = [tenant] if tenant is not None else list(self._queues)
        for t in tenants:
            obs_metrics.gauge("rb_serving_queue_depth", tenant=t).set(
                len(self._queues.get(t) or ()))

    def snapshot(self) -> dict:
        """Loop state as plain JSON: the level, queues, pending bytes, the
        estimator, stats, the HBM ledger, the registry's serving counters,
        the result cache, the resident lane and the lattice."""
        out = {
            "level": self.level,
            "level_peak": self.level_peak,
            "pool_target": self._pool_target(),
            "backlog": self._backlog(),
            "queues": {t: len(q) for t, q in self._queues.items()},
            "pending_bytes": self._pending_bytes,
            "s_per_query_est": self._s_per_q,
            "stats": dict(self.stats),
            "resident_bytes": obs_memory.LEDGER.snapshot(),
            "counters": {name: rows for name, rows in
                         obs_metrics.REGISTRY.snapshot()["counters"].items()
                         if name.startswith("rb_serving_")},
        }
        rc = getattr(self._engine, "result_cache", None)
        if rc is not None:
            out["result_cache"] = rc.stats()
        if self._resident is not None:
            out["resident"] = {"active": self._resident.active,
                               "stats": dict(self._resident.stats),
                               "ring": self._resident.ring.state_event()}
        lat = rt_lattice.active()
        if lat is not None:
            out["lattice"] = {"sealed": lat.sealed,
                              "escapes": lat.escapes,
                              "warmed": self._lattice_warmed,
                              "points": lat.n_points(pooled=True)}
        return out


class PumpDriver:
    """Threaded pump-on-timer: a daemon thread calls ``loop.pump()`` every
    ``interval_s`` (default half the policy's ``dispatch_margin_ms``), so
    requests dispatch on fill or deadline with no caller thread.  The
    loop's pump enters the loop's device and stream on this thread.

    Fault-clock compatible: ``kick()`` wakes the thread at once.  A pump
    that raises is recorded on ``last_error`` and counted
    (``rb_serving_pump_errors_total{error_class}``, ``errors``): the thread
    keeps pumping and nothing is silent."""

    def __init__(self, loop, interval_s: float | None = None):
        if interval_s is None:
            margin_ms = getattr(getattr(loop, "policy", None),
                                "dispatch_margin_ms", 5.0)
            interval_s = max(5e-4, margin_ms / 2e3)
        self._loop = loop
        self.interval_s = float(interval_s)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="rb-serving-pump", daemon=True)
        self.ticks = 0
        self.completed = 0
        self.errors = 0
        self.last_tick_at: float | None = None
        self.last_error: Exception | None = None

    def start(self) -> "PumpDriver":
        self._thread.start()
        return self

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    def kick(self) -> None:
        """Wake the pump thread now."""
        self._wake.set()

    def stop(self, drain: bool = False) -> None:
        """Stop the thread (joined); ``drain=True`` then flushes the
        backlog on the caller's thread."""
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30.0)
        if drain:
            self._loop.drain()

    def _run(self) -> None:
        while not self._stop.is_set():
            self.last_tick_at = faults.clock()
            try:
                done = self._loop.pump()
                self.ticks += 1
                self.completed += len(done)
            except Exception as exc:  # keep pumping; stay visible
                self.last_error = exc
                self.errors += 1
                obs_metrics.counter("rb_serving_pump_errors_total",
                                    error_class=type(exc).__name__).inc()
                _log.exception("%s: pump thread tick failed", SITE)
            self._wake.wait(self.interval_s)
            self._wake.clear()
