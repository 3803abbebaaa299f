"""Deterministic million-user replay harness (``roaringbitmap_tpu.serving.replay``).

One seeded generator makes the SAME workload in any process, and in either
package, event for event: a Zipf-skewed tenant population firing mixed
flat / expression / analytics / delta traffic along a diurnal arrival
curve over a million-user value universe.  Two arms replay it:

- :func:`run_inproc` drives a ``ServingLoop`` on the **fault clock** (idle
  gaps fast-forward, late submits back-date), so it is wall-clock free;
- :func:`run_wire` drives a :class:`wire.WireClient` against a server,
  windowed-pipelined and wall-clock paced: the arm that prices the
  network boundary.

Both arms emit one :func:`report` shape: completed / shed / failed /
rejected counts, SLO attainment, achieved Q/s, p50/p99 latency and a
``typed_only`` flag (every failure carried a typed error).
:func:`sustained` walks a rate ladder and reports the highest rate whose
attainment clears the target.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.bitmap import RoaringBitmap
from ..parallel import expr as expr_mod
from ..parallel.batch_engine import BatchQuery
from ..runtime import errors, faults
from .loop import AdmissionRejected, ServingRequest

_OPS = ("or", "and", "xor", "andnot")


@dataclasses.dataclass(frozen=True)
class ReplayProfile:
    """Knobs of one generated workload (every field feeds the seeded
    rng — same profile + seed = same arrivals, bit for bit, in any
    process)."""

    #: resident sets (serving tenants map onto them round-robin)
    sets: int = 2
    #: sources per resident set
    sources: int = 8
    #: serving tenants (Zipf-skewed query rates)
    tenants: int = 8
    #: value universe — user-id domain (default: a million users)
    users: int = 1 << 20
    #: stored values per source bitmap
    density: int = 4096
    #: query/delta events to generate
    requests: int = 256
    #: stream length in fault-clock seconds (sets the base rate)
    duration_s: float = 2.0
    #: Zipf exponent over tenant query rates (higher = more skew)
    zipf_alpha: float = 1.1
    #: diurnal modulation amplitude in [0, 1) and full periods over
    #: the stream — the arrival curve is
    #: ``base * (1 + amp * sin(2π · periods · t/duration))``
    diurnal_amp: float = 0.6
    diurnal_periods: float = 2.0
    #: traffic mix (must sum to 1); analytics falls back to expression
    #: when the dataset has no value column attached
    flat_share: float = 0.55
    expr_share: float = 0.20
    analytics_share: float = 0.10
    delta_share: float = 0.15
    #: fraction of queries requesting bitmap-form results
    bitmap_share: float = 0.15
    #: per-request deadline (None = the serving policy default)
    deadline_ms: float | None = None
    #: name of the BSI column analytics queries target (attached by
    #: :func:`build_dataset`); "" disables the analytics lane
    analytics_col: str = "v"
    seed: int = 0


# ------------------------------------------------------------- dataset

def _draws(profile: ReplayProfile):
    """The dataset's seeded draws, set by set: ``(source value draws,
    column)``, in the JAX package's order (each set's sources, then its
    column's ids and values)."""
    rng = np.random.default_rng(profile.seed)
    for _ in range(profile.sets):
        vals = [rng.integers(0, profile.users, profile.density)
                for _ in range(profile.sources)]
        col = None
        if profile.analytics_col:
            ids = np.unique(rng.integers(
                0, profile.users, profile.density).astype(np.uint32))
            col = (ids, rng.integers(1, 1 << 16, ids.size).astype(np.int64))
        yield vals, col


def build_dataset(profile: ReplayProfile) -> tuple:
    """Seeded dataset every process rebuilds identically (the JAX
    package's draws): ``(bitmap_sets, columns)`` where ``bitmap_sets[s]``
    is one resident set's source list and ``columns[s]`` the (ids, values)
    pair of its analytics column."""
    bitmap_sets, columns = [], []
    for vals, col in _draws(profile):
        bitmap_sets.append([RoaringBitmap.from_values(
            np.unique(v.astype(np.uint32))) for v in vals])
        columns.append(col)
    return bitmap_sets, columns


def dataset_columns(profile: ReplayProfile) -> list:
    """``build_dataset``'s columns alone (the same draws, no bitmaps
    built): the analytics columns to attach to resident sets that hold
    other bitmaps."""
    return [col for _, col in _draws(profile)]


def attach_columns(sets, profile: ReplayProfile, columns) -> None:
    """Attach the generated analytics columns to built DeviceBitmapSets,
    each column on its set's device."""
    if not profile.analytics_col:
        return
    from ..analytics.column import BsiColumn

    for ds, col in zip(sets, columns):
        if col is not None:
            ids, vals = col
            ds.attach_column(BsiColumn(profile.analytics_col, ids, vals,
                                       device=ds.device))


# ----------------------------------------------------------- generator

def _arrival_times(profile: ReplayProfile, rng) -> np.ndarray:
    """Inhomogeneous-Poisson arrivals by thinning against the diurnal
    rate curve; exactly ``requests`` offsets, nondecreasing."""
    base = profile.requests / max(profile.duration_s, 1e-9)
    lam_max = base * (1.0 + profile.diurnal_amp)
    out = []
    t = 0.0
    while len(out) < profile.requests:
        t += float(rng.exponential(1.0 / lam_max))
        lam = base * (1.0 + profile.diurnal_amp * np.sin(
            2.0 * np.pi * profile.diurnal_periods
            * t / profile.duration_s))
        if rng.random() * lam_max <= max(lam, 0.0):
            out.append(t)
    return np.asarray(out)


def _zipf_weights(profile: ReplayProfile, rng) -> np.ndarray:
    w = (np.arange(profile.tenants) + 1.0) ** -profile.zipf_alpha
    rng.shuffle(w)                 # rank != tenant index
    return w / w.sum()


def generate(profile: ReplayProfile) -> list:
    """The workload: a list of events, each either
    ``("query", at_s, ServingRequest)`` or
    ``("delta", at_s, set_id, adds, removes)`` — at_s nondecreasing
    fault-clock offsets from stream start."""
    rng = np.random.default_rng(profile.seed + 1)
    times = _arrival_times(profile, rng)
    weights = _zipf_weights(profile, rng)
    kinds = ("flat", "expression", "analytics", "delta")
    mix = np.asarray([profile.flat_share, profile.expr_share,
                      profile.analytics_share, profile.delta_share])
    mix = mix / mix.sum()
    events: list = []
    for at_s in times:
        tenant_i = int(rng.choice(profile.tenants, p=weights))
        tenant = f"t{tenant_i}"
        sid = tenant_i % profile.sets
        kind = kinds[int(rng.choice(4, p=mix))]
        if kind == "analytics" and not profile.analytics_col:
            kind = "expression"
        if kind == "delta":
            n = int(rng.integers(8, 48))
            vals = rng.integers(0, profile.users, n).astype(np.uint32)
            adds = {int(rng.integers(0, profile.sources)): vals}
            removes = None
            if rng.random() < 0.3:
                removes = {int(rng.integers(0, profile.sources)):
                           rng.integers(0, profile.users,
                                        8).astype(np.uint32)}
            events.append(("delta", float(at_s), sid, adds, removes))
            continue
        form = "bitmap" if rng.random() < profile.bitmap_share \
            else "cardinality"
        if kind == "flat":
            k = int(rng.integers(2, min(5, profile.sources + 1)))
            ops = rng.choice(profile.sources, size=k, replace=False)
            q = BatchQuery(str(rng.choice(_OPS)),
                           tuple(int(i) for i in ops), form)
        elif kind == "expression":
            q = expr_mod.ExprQuery(_gen_expr(profile, rng), form)
        else:
            q = expr_mod.ExprQuery(_gen_analytics(profile, rng),
                                   "cardinality")
        events.append(("query", float(at_s),
                       ServingRequest(sid, q, tenant=tenant,
                                      deadline_ms=profile.deadline_ms)))
    return events


def _gen_expr(profile: ReplayProfile, rng):
    """A small random DAG: two-level or/and/xor over refs, sometimes an
    andnot head, sometimes an ad-hoc leaf (spec bytes over the wire)."""
    refs = [expr_mod.ref(int(i)) for i in rng.choice(
        profile.sources, size=int(rng.integers(2, 4)), replace=False)]
    if rng.random() < 0.2:
        vals = np.unique(rng.integers(
            0, profile.users, 64).astype(np.uint32))
        refs.append(expr_mod.bitmap(RoaringBitmap.from_values(vals)))
    op = str(rng.choice(("or", "and", "xor")))
    inner = expr_mod.Node(op, tuple(refs))
    if rng.random() < 0.3:
        return expr_mod.andnot(inner,
                               expr_mod.ref(int(rng.integers(
                                   0, profile.sources))))
    return inner


def _gen_analytics(profile: ReplayProfile, rng):
    """A value-domain query over the attached BSI column: a range/cmp
    predicate fused with set algebra, or a sum_ aggregate root."""
    col = profile.analytics_col
    lo = int(rng.integers(0, 1 << 15))
    hi = lo + int(rng.integers(1 << 12, 1 << 15))
    pred = expr_mod.range_(col, lo, hi) if rng.random() < 0.6 \
        else expr_mod.cmp(col, str(rng.choice(("le", "ge"))), hi)
    if rng.random() < 0.4:
        found = expr_mod.or_(expr_mod.ref(int(rng.integers(
            0, profile.sources))), pred)
        return expr_mod.sum_(col, found)
    return expr_mod.and_(expr_mod.ref(int(rng.integers(
        0, profile.sources))), pred)


# ------------------------------------------------------------- reports

def _percentile(xs: list, p: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), p))


def report(tickets: list, latencies_ms: list, deltas: int,
           wall_s: float) -> dict:
    """One report shape for both arms.  ``tickets`` carry ``status`` /
    ``error`` (``serving.Ticket`` or ``wire.WireTicket``); attainment counts
    a ticket served in time (done and not deadline-missed)."""
    by = {"done": 0, "shed": 0, "failed": 0, "rejected": 0}
    attained = 0
    typed_only = True
    for t in tickets:
        st = t.status if t.status in by else "failed"
        by[st] += 1
        missed = bool(getattr(t, "missed", False))
        res = getattr(t, "result", None)
        if res is not None and getattr(res, "missed", False):
            missed = True
        if st == "done" and not missed:
            attained += 1
        if st != "done":
            err = getattr(t, "error", None)
            if err is not None and not isinstance(
                    err, (errors.RoaringRuntimeError,
                          errors.CorruptInput)):
                typed_only = False
    n = len(tickets)
    return {"queries": n, "deltas": int(deltas),
            "done": by["done"], "shed": by["shed"],
            "failed": by["failed"], "rejected": by["rejected"],
            "attainment": round(attained / n, 4) if n else 0.0,
            "qps": round(by["done"] / wall_s, 1) if wall_s > 0 else 0.0,
            "p50_ms": round(_percentile(latencies_ms, 50), 3),
            "p99_ms": round(_percentile(latencies_ms, 99), 3),
            "wall_s": round(wall_s, 4),
            "typed_only": typed_only}


# ------------------------------------------------------- in-process arm

def _apply_delta_inproc(target, sid: int, adds, removes) -> None:
    if hasattr(target, "apply_delta"):           # a front door
        target.apply_delta(sid, adds, removes)
    else:                                        # a ServingLoop
        with target._lock:
            target._engine._engines[sid]._ds.apply_delta(adds, removes)


def run_inproc(target, events, rate_scale: float = 1.0) -> dict:
    """Replay on the fault clock (``replay_stream`` semantics) with delta
    events interleaved on the same timeline.  ``rate_scale`` compresses
    arrival offsets (2.0 = twice the arrival rate)."""
    t0 = faults.clock()
    tickets: list = []
    latencies: list = []
    deltas = 0
    pending: dict = {}

    def collect(done):
        now = faults.clock()
        for t in done:
            if id(t) in pending:
                del pending[id(t)]
                latencies.append((now - t.enqueued_at) * 1e3)

    for ev in events:
        at_s = ev[1] / max(rate_scale, 1e-9)
        sched = t0 + at_s
        now = faults.clock()
        if sched > now:
            faults.advance_clock(sched - now)
        if ev[0] == "delta":
            _, _, sid, adds, removes = ev
            _apply_delta_inproc(target, sid, adds, removes)
            deltas += 1
            continue
        req = ev[2]
        try:
            t = target.submit(req, arrival=sched)
        except AdmissionRejected as exc:
            from .loop import Ticket

            t = Ticket(request=req, enqueued_at=sched,
                       status="rejected", error=exc)
            tickets.append(t)
            continue
        tickets.append(t)
        pending[id(t)] = t
        collect(target.pump())
    collect(target.drain())
    wall_s = max(faults.clock() - t0, 1e-9)
    return report(tickets, latencies, deltas, wall_s)


# ------------------------------------------------------------ wire arm

def run_wire(client, events, rate_scale: float = 1.0,
             pace: bool = True, timeout: float = 60.0) -> dict:
    """Replay over a :class:`wire.WireClient`: windowed pipelining, every
    query submitted as its arrival time comes due (wall-clock paced when
    ``pace``, as fast as possible otherwise) without waiting for
    responses.  Deltas flow through the same connection in order."""
    t0 = time.perf_counter()
    tickets: list = []
    deltas = 0
    for ev in events:
        at_s = ev[1] / max(rate_scale, 1e-9)
        if pace:
            lag = (t0 + at_s) - time.perf_counter()
            if lag > 0:
                time.sleep(lag)
        if ev[0] == "delta":
            _, _, sid, adds, removes = ev
            client.apply_delta(sid, adds=adds, removes=removes,
                               timeout=timeout)
            deltas += 1
            continue
        tickets.append(client.submit(ev[2]))
    deadline = time.perf_counter() + timeout
    for t in tickets:
        t.wait(max(deadline - time.perf_counter(), 0.001))
    wall_s = max(time.perf_counter() - t0, 1e-9)
    latencies = [(t.done_at - t.sent_at) * 1e3 for t in tickets
                 if t.done_at is not None and t.sent_at is not None]
    return report(tickets, latencies, deltas, wall_s)


# ------------------------------------------------------------- ladders

def sustained(run_one, rates, slo_target: float = 0.9) -> dict:
    """Walk a rate ladder: ``run_one(rate_scale)`` -> report per rung; the
    sustained point is the HIGHEST rung whose attainment clears
    ``slo_target`` (zeros when none does)."""
    ladder = []
    best = None
    for r in rates:
        rep = run_one(float(r))
        rung = {"rate_x": float(r), "qps": rep["qps"],
                "attainment": rep["attainment"],
                "p99_ms": rep["p99_ms"],
                "typed_only": rep["typed_only"]}
        ladder.append(rung)
        if rep["attainment"] >= slo_target:
            best = rung
    return {"slo_target": slo_target, "ladder": ladder,
            "sustained_qps": best["qps"] if best else 0.0,
            "sustained_rate_x": best["rate_x"] if best else 0.0,
            "sustained_attainment": best["attainment"] if best else 0.0,
            "sustained_p99_ms": best["p99_ms"] if best else 0.0}
