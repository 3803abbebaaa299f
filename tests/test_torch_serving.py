"""The port's serving loop against roaringbitmap_tpu.serving.loop.

The JAX test fixture's three tenants of six bitmaps are built from the same
numpy seed in both packages: the JAX ``MultiSetBatchEngine`` on the CPU as
its own tests run it, the port's on ``device="cpu"``.  The same requests go
through both ``ServingLoop``\\ s and everything compared is exact: ticket
statuses, results (cardinalities, values, bitmap members), shed and degrade
reasons, ladder levels under explicit fault-clock jumps (each package has
its own fault clock, so both are advanced by the same amounts), admission
rejections and the guard's ``for_remaining`` clamps.  Decisions that
depend on measured walls (the loop's per-query estimate) are never pinned:
deadlines are far (``EASY_MS``) unless a test forces shedding with a clock
jump much larger than any wall.

Device-memory budgets are stated in each package's own units: the port
counts resident bytes in ``obs.memory.LEDGER`` (its sets keep other
resident arrays than the JAX sets), the JAX package with its HBM ledger.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.insights import analysis as jins
from roaringbitmap_tpu.obs import memory as jmem
from roaringbitmap_tpu.parallel import MultiSetBatchEngine as JMS
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu import serving as jserving
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.mutation import ResultCache
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
from roaringbitmap_tpu_torch.runtime import errors, faults, guard
from roaringbitmap_tpu_torch.runtime import programs
from roaringbitmap_tpu_torch import serving

torch.set_num_threads(2)

CPU = "cpu"
#: far-future deadline for tests that pin parity, not timing
EASY_MS = 300_000.0
JNOSLEEP = jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
TNOSLEEP = guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)


def _ctr(name: str, **labels) -> float:
    """The port's registry counter ``name`` summed over every label set
    that includes ``labels``."""
    return sum(row["value"] for row in
               tobs.snapshot()["counters"].get(name, [])
               if labels.items() <= row["labels"].items())


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    jobs.disable()
    jobs.reset()
    jguard.reset_dispatch_stats()
    tobs.reset()
    tobs.flight.reset()
    # SLO-miss and overload triggers dump the flight ring: keep the dumps
    # in the test's directory
    tobs.flight.configure(dir=str(tmp_path / "flight"))
    jfaults.reset_clock()
    faults.reset_clock()
    yield
    tobs.flight.configure(dir=None)
    jobs.disable()
    jobs.reset()
    jfaults.reset_clock()
    faults.reset_clock()


def _values() -> list:
    """tests/test_serving.py's three tenants of six bitmaps."""
    rng = np.random.default_rng(0x5E11)
    return [[np.unique(rng.integers(0, 1 << 16, 700).astype(np.uint32))
             for _ in range(6)] for _ in range(3)]


@pytest.fixture(scope="module")
def engines():
    vals = _values()
    j = JMS.from_bitmap_sets([[JRB.from_values(v) for v in t]
                              for t in vals], layout="dense")
    t = MultiSetBatchEngine([DeviceBitmapSet([TRB.from_values(v) for v in s],
                                             layout="dense", device=CPU)
                             for s in vals])
    yield j, t
    del j, t
    gc.collect()


def _loops(engines, **kw):
    j, t = engines
    kw.setdefault("default_deadline_ms", EASY_MS)
    jg = kw.pop("jguard", JNOSLEEP)
    tg = kw.pop("tguard", TNOSLEEP)
    return (jserving.ServingLoop(j, jserving.ServingPolicy(guard=jg, **kw)),
            serving.ServingLoop(t, serving.ServingPolicy(guard=tg, **kw)))


def _as_jax(q):
    """A port query as the JAX package's."""
    if isinstance(q, TQ):
        return JQ(q.op, q.operands, form=q.form)
    return jexpr.ExprQuery(_jexpr(q.expr), form=q.form)


def _jexpr(e):
    if isinstance(e, texpr.Ref):
        return jexpr.Ref(e.index)
    if isinstance(e, texpr.AdHoc):
        return jexpr.AdHoc(JRB.from_values(e.bm.to_array()))
    if isinstance(e, texpr.ValuePred):
        return jexpr.ValuePred(e.col, e.op, e.lo, e.hi)
    if isinstance(e, texpr.Agg):
        return jexpr.Agg(e.kind, e.col, e.k,
                         None if e.found is None else _jexpr(e.found))
    return jexpr.Node(e.op, tuple(_jexpr(c) for c in e.children))


def _pair(req):
    """(JAX request, port request) for one port ServingRequest."""
    return (jserving.ServingRequest(req.set_id, _as_jax(req.query),
                                    tenant=req.tenant,
                                    deadline_ms=req.deadline_ms), req)


def _requests(n: int, n_sets: int = 3, seed: int = 0xA11,
              form_every: int = 3, expr_every: int = 7) -> list:
    """tests/test_serving.py's mixed stream, as port requests."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = int(rng.integers(n_sets))
        form = "bitmap" if i % form_every == 0 else "cardinality"
        if expr_every and i % expr_every == 3:
            q = texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)),
                                form=form)
        else:
            op = ("or", "and", "xor", "andnot")[int(rng.integers(4))]
            k = int(rng.integers(2, 5))
            q = TQ(op, tuple(int(x) for x in rng.choice(6, size=k,
                                                         replace=False)),
                   form=form)
        out.append(serving.ServingRequest(sid, q, tenant=f"t{sid}"))
    return out


def _same_result(jr, tr) -> None:
    assert tr.cardinality == jr.cardinality
    assert tr.value == jr.value
    if jr.bitmap is None:
        assert tr.bitmap is None
    else:
        assert np.array_equal(tr.bitmap.to_array(), jr.bitmap.to_array())


def _same_ticket(jt, tt, missed: bool = False) -> None:
    """Same status, form, result or typed error; ``missed`` also holds the
    SLO outcome equal (only where a clock jump, not a measured wall,
    decides it)."""
    assert (tt.status, tt.degraded) == (jt.status, jt.degraded)
    if jt.status == "done":
        _same_result(jt.result, tt.result)
        if missed:
            assert tt.missed == jt.missed
    else:
        assert type(tt.error).__name__ == type(jt.error).__name__
        assert getattr(tt.error, "reason", None) == getattr(
            jt.error, "reason", None)


def _exact(engine, t) -> None:
    ref = engine._engines[t.request.set_id]._sequential_result(t.query)
    assert t.result.cardinality == ref.cardinality
    if t.query.form == "bitmap":
        assert t.result.bitmap == ref.bitmap


def _advance(seconds: float) -> None:
    jfaults.advance_clock(seconds)
    faults.advance_clock(seconds)


# ------------------------------------------------------------- parity path

def test_mixed_stream_same_tickets(engines):
    jl, tl = _loops(engines, pool_target=8)
    reqs = _requests(25)
    pairs = [_pair(r) for r in reqs]
    jt = [jl.submit(a) for a, _ in pairs]
    tt = [tl.submit(b) for _, b in pairs]
    jl.pump()
    tl.pump()
    jl.drain()
    tl.drain()
    assert all(t.status == "done" for t in tt)
    for a, b in zip(jt, tt):
        _same_ticket(a, b)
        _exact(engines[1], b)
    assert tl.stats == jl.stats
    assert tl.stats["served"] == 25 and tl.stats["pools"] >= 2
    assert _ctr("rb_slo_attained_total", site="serving") \
        + _ctr("rb_slo_missed_total", site="serving") == 25
    assert _ctr("rb_serving_requests_total") == 25
    assert _ctr("rb_serving_dispatches_total") == tl.stats["pools"]


def test_expr_and_flat_share_one_path(engines):
    jl, tl = _loops(engines, pool_target=6)
    reqs = [serving.ServingRequest(1, texpr.ExprQuery(
        texpr.xor(texpr.or_(0, 1), texpr.and_(2, 3)), form="bitmap"),
        tenant="e"),
        serving.ServingRequest(1, TQ("or", (0, 1, 2), form="bitmap"),
                               tenant="e"),
        serving.ServingRequest(0, texpr.ExprQuery(
            texpr.and_(texpr.or_(1, 2), texpr.not_(0))), tenant="e")]
    pairs = [_pair(r) for r in reqs]
    jt = [jl.submit(a) for a, _ in pairs]
    tt = [tl.submit(b) for _, b in pairs]
    jl.drain()
    tl.drain()
    direct = engines[1].execute([(r.set_id, (r.query,)) for r in reqs])
    for a, b, d in zip(jt, tt, [r for rows in direct for r in rows]):
        _same_ticket(a, b)
        _same_result(d, b.result)


def test_queue_cap_rejects_typed(engines):
    jl, tl = _loops(engines, max_queue=4)
    for loop, R, Q in ((jl, jserving.ServingRequest, JQ),
                       (tl, serving.ServingRequest, TQ)):
        for _ in range(4):
            loop.submit(R(0, Q("or", (0, 1))))
    with pytest.raises(jserving.AdmissionRejected) as je:
        jl.submit(jserving.ServingRequest(0, JQ("or", (0, 1))))
    with pytest.raises(serving.AdmissionRejected) as te:
        tl.submit(serving.ServingRequest(0, TQ("or", (0, 1))))
    assert te.value.reason == je.value.reason == "queue_full"
    assert te.value.context == je.value.context == {"queue_depth": 4,
                                                    "cap": 4}
    assert tl.stats["rejected"] == jl.stats["rejected"] == 1
    assert tl._backlog() == jl._backlog() == 4
    assert _ctr("rb_serving_admission_rejected_total",
                         reason="queue_full") == 1
    tl.drain()
    jl.drain()


def test_hbm_backpressure_same_admissions(engines):
    """A budget of the resident bytes plus 3.2 requests' footprint, in
    each package's own units: both admit the first three requests and
    reject the rest typed ``hbm``, then serve the admitted ones exactly."""
    j, t = engines
    jprobe = jserving.ServingRequest(0, JQ("or", (0, 1, 2)), tenant="h")
    tprobe = serving.ServingRequest(0, TQ("or", (0, 1, 2)), tenant="h")
    jper = jserving.ServingLoop(j, jserving.ServingPolicy(
        guard=JNOSLEEP))._request_bytes(jprobe)
    tper = serving.ServingLoop(t, serving.ServingPolicy(
        guard=TNOSLEEP))._request_bytes(tprobe)
    jbudget = int((jmem.LEDGER.resident_bytes() + 3.2 * jper) / 0.9)
    tbudget = int((tobs.LEDGER.resident_bytes() + 3.2 * tper) / 0.9)
    jl, tl = _loops(
        engines, pool_target=8,
        jguard=jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None,
                                  hbm_budget=jbudget),
        tguard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None,
                                 hbm_budget=tbudget))
    outcomes = []
    for loop, probe in ((jl, jprobe), (tl, tprobe)):
        got = []
        for _ in range(8):
            try:
                got.append(loop.submit(probe))
            except Exception as e:
                got.append(e)
        loop.drain()
        outcomes.append(got)
    jo, to = outcomes
    assert [type(x).__name__ for x in to] == [type(x).__name__ for x in jo]
    assert [getattr(x, "reason", None) for x in to] == \
        [getattr(x, "reason", None) for x in jo]
    rejected = [x for x in to if isinstance(x, serving.AdmissionRejected)]
    assert rejected and all(e.reason == "hbm" and
                            e.context["budget_bytes"] == tbudget
                            for e in rejected)
    served = [x for x in to if isinstance(x, serving.loop.Ticket)]
    assert served and all(x.ok for x in served)
    for x in served:
        _exact(t, x)
    # the assembly gate: every pool the port dispatched fits the headroom
    for x in served:
        assert tl._pool_bytes([x]) + tobs.LEDGER.resident_bytes() \
            <= int(tbudget * 0.9)


# -------------------------------------------------------------- shedding

def test_expired_requests_shed_typed(engines):
    jl, tl = _loops(engines, pool_target=4)
    jt = jl.submit(jserving.ServingRequest(0, JQ("or", (0, 1)),
                                           deadline_ms=50.0))
    tt = tl.submit(serving.ServingRequest(0, TQ("or", (0, 1)),
                                          deadline_ms=50.0))
    _advance(0.2)
    assert jt in jl.pump(force=True)
    assert tt in tl.pump(force=True)
    _same_ticket(jt, tt)
    assert tt.status == "shed" and tt.error.reason == "expired"
    assert isinstance(tt.error, serving.RequestShed)
    assert _ctr("rb_serving_shed_total", reason="expired") == 1


def test_unmeetable_drop_vs_degrade_per_tenant(engines):
    tenants = {"d": ("drop", None), "g": ("degrade", None)}
    jl, tl = (
        jserving.ServingLoop(engines[0], jserving.ServingPolicy(
            pool_target=4, guard=JNOSLEEP, default_deadline_ms=EASY_MS,
            tenants={k: jserving.TenantPolicy(on_deadline=v[0])
                     for k, v in tenants.items()})),
        serving.ServingLoop(engines[1], serving.ServingPolicy(
            pool_target=4, guard=TNOSLEEP, default_deadline_ms=EASY_MS,
            tenants={k: serving.TenantPolicy(on_deadline=v[0])
                     for k, v in tenants.items()})))
    jl._s_per_q = tl._s_per_q = 0.2      # 200 ms a query, in both
    out = []
    for loop, R, Q in ((jl, jserving.ServingRequest, JQ),
                       (tl, serving.ServingRequest, TQ)):
        td = loop.submit(R(0, Q("or", (0, 1), form="bitmap"), tenant="d",
                           deadline_ms=100.0))
        tg = loop.submit(R(0, Q("or", (0, 1), form="bitmap"), tenant="g",
                           deadline_ms=100.0))
        loop.pump(force=True)
        out.append((td, tg))
    (jd, jg), (td, tg) = out
    _same_ticket(jd, td)
    _same_ticket(jg, tg)
    assert td.status == "shed" and td.error.reason == "deadline"
    assert tg.status == "done" and tg.degraded and tg.result.bitmap is None
    _exact(engines[1], tg)
    assert _ctr("rb_serving_degraded_total", reason="deadline") == 1


def test_shedding_disabled_serves_late(engines):
    jl, tl = _loops(engines, pool_target=4, shed=False)
    jt = jl.submit(jserving.ServingRequest(0, JQ("or", (0, 1)),
                                           deadline_ms=10.0))
    tt = tl.submit(serving.ServingRequest(0, TQ("or", (0, 1)),
                                          deadline_ms=10.0))
    _advance(0.5)
    jl.pump(force=True)
    tl.pump(force=True)
    _same_ticket(jt, tt, missed=True)
    assert tt.status == "done" and tt.missed is True


def test_slow_fault_is_counted_against_slo(engines):
    jl, tl = _loops(engines, pool_target=2, shed=False)
    dl = faults.SLOW_LATENCY_S * 1e3 / 2
    assert faults.SLOW_LATENCY_S == jfaults.SLOW_LATENCY_S
    with jfaults.inject("slow@serving=1.0:3"):
        jt = jl.submit(jserving.ServingRequest(
            0, JQ("or", (0, 1)), tenant="s", deadline_ms=dl))
        jl.pump(force=True)
    with faults.inject("slow@serving=1.0:3"):
        tt = tl.submit(serving.ServingRequest(
            0, TQ("or", (0, 1)), tenant="s", deadline_ms=dl))
        tl.pump(force=True)
    _same_ticket(jt, tt, missed=True)
    assert tt.missed is True
    assert _ctr("rb_slo_missed_total", site="serving", tenant="s") == 1


# ------------------------------------------------- deadline propagation

@pytest.mark.parametrize("knobs,remaining", [
    ({"deadline": 10.0, "slo_deadline_ms": 5000.0}, 0.25),
    ({"deadline": 0.1, "slo_deadline_ms": 50.0}, 0.25),
    ({}, 1.5),
    ({"deadline": 2.0}, -1.0),
])
def test_for_remaining_clamps_both_knobs(knobs, remaining):
    jp = jguard.GuardPolicy(**knobs).for_remaining(remaining)
    tp = guard.GuardPolicy(**knobs).for_remaining(remaining)
    assert (tp.deadline, tp.slo_deadline_ms) == (jp.deadline,
                                                 jp.slo_deadline_ms)


def test_slo_env_knob(monkeypatch):
    monkeypatch.setenv("ROARING_TPU_SLO_MS", "12.5")
    assert guard.GuardPolicy.from_env().slo_deadline_ms == \
        jguard.GuardPolicy.from_env().slo_deadline_ms == 12.5


def test_guard_cannot_outspend_remaining_deadline(engines):
    """Slow + transient injection at the engine sites: without the
    remaining-deadline clamp the ladder would spend attempts x rungs x
    50 ms; with it the dispatch dies typed within the remaining budget,
    with the same error class in both packages."""
    spec = ("slow@multiset=1.0,transient@multiset=1.0,"
            "transient@batch_engine=1.0,slow@batch_engine=1.0:5")
    remaining_ms = 120.0
    jl, tl = _loops(engines, pool_target=2, shed=False)
    got = []
    for loop, F, R, Q in ((jl, jfaults, jserving.ServingRequest, JQ),
                          (tl, faults, serving.ServingRequest, TQ)):
        t0 = F.clock()
        with F.inject(spec):
            t = loop.submit(R(0, Q("or", (0, 1)), deadline_ms=remaining_ms))
            loop.pump(force=True)
        got.append((t, F.clock() - t0))
    (jt, _), (tt, spent) = got
    assert tt.status == jt.status == "failed"
    assert type(tt.error).__name__ == type(jt.error).__name__
    assert isinstance(tt.error, errors.RoaringRuntimeError)
    assert "deadline" in str(tt.error)
    assert spent <= remaining_ms / 1e3 + 2 * faults.SLOW_LATENCY_S
    assert _ctr("rb_serving_pool_failures_total") >= 1


# ------------------------------------------------------ overload ladder

def test_ladder_escalates_and_recovers_symmetrically(engines):
    jl, tl = _loops(engines, pool_target=4, escalate_after=1,
                    recover_after=2, overload_pressure=1.5)
    levels = {id(jl): [], id(tl): []}
    reqs = _requests(16, seed=0xF00, expr_every=0)
    for _ in range(3):
        for loop, conv in ((jl, lambda r: _pair(r)[0]), (tl, lambda r: r)):
            for r in reqs:
                loop.submit(conv(r))
            loop.pump(force=True)
            levels[id(loop)].append(loop.level)
    assert levels[id(tl)] == levels[id(jl)] == [1, 2, 3]
    assert tl._pool_target() == jl._pool_target() == 2
    jt = jl.submit(jserving.ServingRequest(0, JQ("or", (0, 1),
                                                 form="bitmap")))
    tt = tl.submit(serving.ServingRequest(0, TQ("or", (0, 1),
                                                form="bitmap")))
    jl.pump(force=True)
    tl.pump(force=True)
    _same_ticket(jt, tt)
    assert tt.ok and tt.degraded and tt.result.bitmap is None
    for want in (2, 1, 0):
        for loop in (jl, tl):
            loop.pump()
            loop.pump()
        assert tl.level == jl.level == want
    assert tl.level_peak == jl.level_peak == 3
    assert [e["level_to"] for e in tobs.flight._ring
            if e["kind"] == "degrade"] == [1, 2, 3, 2, 1, 0]


def test_weighted_fair_share(engines):
    tenants_j = {"a": jserving.TenantPolicy(weight=2.0),
                 "b": jserving.TenantPolicy(weight=1.0)}
    tenants_t = {"a": serving.TenantPolicy(weight=2.0),
                 "b": serving.TenantPolicy(weight=1.0)}
    jl = jserving.ServingLoop(engines[0], jserving.ServingPolicy(
        pool_target=6, guard=JNOSLEEP, tenants=tenants_j))
    tl = serving.ServingLoop(engines[1], serving.ServingPolicy(
        pool_target=6, guard=TNOSLEEP, tenants=tenants_t))
    for _ in range(12):
        jl.submit(jserving.ServingRequest(0, JQ("or", (0, 1)), tenant="a"))
        jl.submit(jserving.ServingRequest(1, JQ("or", (0, 1)), tenant="b"))
        tl.submit(serving.ServingRequest(0, TQ("or", (0, 1)), tenant="a"))
        tl.submit(serving.ServingRequest(1, TQ("or", (0, 1)), tenant="b"))
    for level in (0, 3):
        jl.level = tl.level = level
        jp = [t.request.tenant for t in jl._pick(6)]
        tp = [t.request.tenant for t in tl._pick(6)]
        assert tp == jp
        assert {k: tp.count(k) for k in "ab"} == {"a": 4, "b": 2}
    jl.drain()
    tl.drain()


def test_replay_backdates_late_arrivals(engines):
    jl, tl = _loops(engines, pool_target=4)
    reqs = _requests(8, seed=9, expr_every=0)
    jt = jl.replay((i * 0.01, _pair(r)[0]) for i, r in enumerate(reqs))
    tt = tl.replay((i * 0.01, r) for i, r in enumerate(reqs))
    assert len(tt) == len(jt) == 8
    for a, b in zip(jt, tt):
        _same_ticket(a, b)
    stamps = [t.enqueued_at for t in tt]
    assert all(b > a for a, b in zip(stamps, stamps[1:]))


def test_policy_from_env_six_knobs(monkeypatch):
    env = {"ROARING_TPU_SERVING_POOL": "12",
           "ROARING_TPU_SERVING_DEADLINE_MS": "40.5",
           "ROARING_TPU_SERVING_SHED": "0",
           "ROARING_TPU_SERVING_HEADROOM": "0.75",
           "ROARING_TPU_SERVING_MAX_QUEUE": "7",
           "ROARING_TPU_SERVING_RESIDENT": "1"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    jp = jserving.ServingPolicy.from_env()
    tp = serving.ServingPolicy.from_env()
    for f in ("pool_target", "default_deadline_ms", "shed",
              "hbm_headroom", "max_queue", "resident"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert (tp.pool_target, tp.shed, tp.resident) == (12, False, True)


# ----------------------------------------------------------- pump driver

def _wait(pred, timeout_s: float = 30.0) -> bool:
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if pred():
            return True
        time.sleep(0.005)
    return pred()


def test_pump_driver_serves_without_a_caller(engines):
    """The driver's thread dispatches a pool once it fills; nothing but the
    submits runs on the test's thread."""
    reqs = _requests(12, seed=0x77)
    jl, tl = _loops(engines, pool_target=len(reqs))
    drv = tl.start_pump(interval_s=0.002)
    try:
        assert drv.running
        tt = [tl.submit(r) for r in reqs]
        drv.kick()
        assert _wait(lambda: all(t.status != "queued" for t in tt))
    finally:
        drv.stop()
    assert not drv.running and drv.errors == 0 and drv.last_error is None
    assert drv.ticks >= 1 and drv.completed == len(reqs)
    jt = [jl.submit(_pair(r)[0]) for r in reqs]
    jl.drain()
    for a, b in zip(jt, tt):
        assert b.status == "done"
        _same_result(a.result, b.result)


def test_pump_driver_counts_errors_and_survives(engines):
    loop = serving.ServingLoop(engines[1], serving.ServingPolicy(
        pool_target=1, guard=TNOSLEEP, default_deadline_ms=EASY_MS))
    calls = []

    def broken_pump(force: bool = False):
        calls.append(force)
        if len(calls) == 1:
            raise TypeError("a programming error in a pump")
        return []

    loop.pump = broken_pump
    drv = serving.PumpDriver(loop, interval_s=0.002).start()
    try:
        assert _wait(lambda: len(calls) >= 3)
    finally:
        drv.stop()
    assert drv.errors == 1 and isinstance(drv.last_error, TypeError)
    assert _ctr("rb_serving_pump_errors_total",
                         error_class="TypeError") == 1


def test_pump_from_another_thread(engines):
    """A pump on another thread than the one that built the loop serves
    exactly (the loop enters its own device and stream there)."""
    _jl, tl = _loops(engines, pool_target=4)
    reqs = _requests(8, seed=0x31)
    tt = [tl.submit(r) for r in reqs]
    th = threading.Thread(target=tl.drain)
    th.start()
    th.join(timeout=60)
    assert not th.is_alive()
    for t in tt:
        assert t.ok
        _exact(engines[1], t)


def test_snapshot_and_timings(engines):
    _jl, tl = _loops(engines, pool_target=4)
    for r in _requests(8, seed=3):
        tl.submit(r)
    tl.drain()
    snap = tl.snapshot()
    assert snap["stats"]["served"] == 8 and snap["backlog"] == 0
    assert snap["resident_bytes"]["by_kind"]["bitmap_set"]["dense"] > 0
    assert snap["counters"]["rb_serving_pools_total"][0]["value"] == \
        snap["stats"]["pools"] == len(tl.timings)
    assert all(t["loop_ms"] >= 0 and t["engine_ms"] > 0
               and not t["resident"] for t in tl.timings)


# ---------------------------------------------- the pooled time model

def test_word_ops_equal_the_jax_model(engines):
    """The port's word-op counts of a pooled plan equal the JAX model's
    for the same plan ("cuda"/"megakernel" as "pallas", "torch" as
    "xla")."""
    j, t = engines
    reqs = _requests(12, seed=0x51)
    tpooled = tuple((r.set_id, r.query) for r in reqs)
    jpooled = tuple((r.set_id, _as_jax(r.query)) for r in reqs)
    tplan = t._plan_pool(tpooled)
    jplan = j._plan_pool(jpooled)
    for teng, jeng in (("cuda", "pallas"), ("torch", "xla"),
                       ("megakernel", "megakernel")):
        want = jins.predict_multiset_dispatch_word_ops(
            [b.signature for b in jplan.buckets], j._plan_sets(jplan), jeng,
            pool_rows=jplan.n_pool_rows)
        want += jins.predict_expr_word_ops(jplan.expr_signature, jeng)
        assert t._word_ops(tplan, teng) == want, teng


def test_predict_dispatch_seconds_calibrates_on_warm_launches(engines):
    """Uncalibrated, the estimate is the roofline at the card's peaks; a
    launch that built or first-ran a program does not calibrate, a warm
    one does."""
    t = engines[1]
    tobs.reset()
    pool = [(0, TQ("or", (0, 1, 2))), (1, TQ("xor", (1, 3))),
            (2, TQ("and", (0, 4)))]
    plan = t._plan_pool(tuple(pool))
    eng = t._pool_engine(plan, "torch", note=False)
    ops, nbytes = t._word_ops(plan, eng), t._predict(plan, eng)["peak_bytes"]
    peaks = tobs.cost.device_peaks()
    assert t.predict_dispatch_seconds(pool, engine="torch") == max(
        ops / peaks["peak_flops_per_s"], nbytes / peaks["peak_bytes_per_s"])
    one0 = programs.one_time_work()
    warm = t._programs
    t._programs = programs.ProgramCache(CPU, "multiset")   # a cold cache
    try:
        t.execute([(s, [q]) for s, q in pool], engine="torch")
        assert programs.one_time_work() > one0
        assert tobs.TRACKER.observed_rates("multiset", "torch") is None
        t.execute([(s, [q]) for s, q in pool], engine="torch")
    finally:
        t._programs = warm
    rates = tobs.TRACKER.observed_rates("multiset", "torch")
    assert rates is not None and rates["dispatches"] == 1
    est = t.predict_dispatch_seconds(pool, engine="torch")
    assert est == pytest.approx(max(ops / rates["achieved_flops_per_s"],
                                    nbytes / rates["achieved_bytes_per_s"]))
    tobs.reset()


# ------------------------------------------------------ resident bytes

def test_residency_counts_sets_columns_caches_and_releases():
    """The port's resident bytes in the HBM ledger: a set counts its
    ``hbm_bytes()`` (not the JAX set's count for the same bitmaps: the port
    keeps other resident arrays), a value column its planes (the JAX
    column's count exactly), a result cache its rows; each is released
    when its owner goes."""
    vals = _values()[0]
    gc.collect()            # earlier tests' garbage must not leave between
    before = tobs.LEDGER.resident_bytes()
    ts = DeviceBitmapSet([TRB.from_values(v) for v in vals], layout="dense",
                         device=CPU)
    js = JSet([JRB.from_values(v) for v in vals], layout="dense")
    assert tobs.LEDGER.resident_bytes() - before == ts.hbm_bytes() > 0
    assert js.hbm_bytes() > 0
    ids = np.unique(np.concatenate(vals))[:500]
    tcol = BsiColumn("p", ids, ids % 97, device=CPU)
    jcol = JBsi("p", ids, ids % 97)
    assert tcol.hbm_bytes() == jcol.hbm_bytes()
    assert tobs.LEDGER.resident_bytes("bsi_column") >= tcol.hbm_bytes()
    ts.attach_column(tcol)
    cache = ResultCache(1 << 20)
    assert tobs.LEDGER.snapshot()["by_kind"]["result_cache"]["device"] >= 0
    cache.nbytes = 4096                  # a filled cache accounts its rows
    cache._account()
    assert tobs.LEDGER.resident_bytes("result_cache") >= 4096
    del ts, tcol, cache, js, jcol
    gc.collect()
    assert tobs.LEDGER.resident_bytes() == before
