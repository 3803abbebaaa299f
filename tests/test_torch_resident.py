"""The port's resident pool lane against roaringbitmap_tpu.serving.resident.

The ring protocol runs the same scenarios on both packages' rings (the
port's on ``device="cpu"``: its descriptor and stamp tensors unpinned) and
holds every cursor, refusal and wedge equal.  Two tenants with a BSI
column (the JAX test fixture's, from the same numpy seed) warm the same
lattice profile in both packages; every point of the vocabulary gets the
same ``signature_id``; a resident serving loop ring-serves every pool
with ``rb_serving_dispatches_total`` flat and the results equal to the
one-shot dispatch, the host oracle and the JAX package's; every demotion
carries the JAX reason (``ESCAPE_REASONS``).
"""

import gc

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.obs import metrics as jmetrics
from roaringbitmap_tpu.parallel import MultiSetBatchEngine as JMS
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.parallel.multiset import BatchGroup as JG
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu.runtime import lattice as jlat
from roaringbitmap_tpu import serving as jserving
from roaringbitmap_tpu.serving import resident as jres
from roaringbitmap_tpu.serving.loop import replay_stream as jreplay
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.parallel.multiset import (BatchGroup,
                                                       MultiSetBatchEngine)
from roaringbitmap_tpu_torch.runtime import faults, guard
from roaringbitmap_tpu_torch.runtime import lattice as tlat
from roaringbitmap_tpu_torch import serving
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.serving import resident as tres
from roaringbitmap_tpu_torch.serving.loop import replay_stream

torch.set_num_threads(2)

CPU = "cpu"
JNOSLEEP = jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
TNOSLEEP = guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
PROFILE = "q=4,;rows=16,;keys=4,;ops=or,and;heads=both;pool=16,;expr=2;"


def _ctr(name: str, **labels) -> float:
    """The port's registry counter ``name`` summed over every label set
    that includes ``labels``."""
    return sum(row["value"] for row in
               tobs.snapshot()["counters"].get(name, [])
               if labels.items() <= row["labels"].items())


@pytest.fixture(autouse=True)
def _clean():
    jobs.disable()
    jobs.reset()
    tobs.reset()
    tobs.flight.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    jlat.deactivate()
    tlat.deactivate()
    yield
    jobs.disable()
    jobs.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    jlat.deactivate()
    tlat.deactivate()


# --------------------------------------------------------- ring protocol

def _jring(capacity):
    return jres.DescriptorRing(capacity)


def _tring(capacity):
    return tres.DescriptorRing(capacity, device=CPU)


def _attempt(trace: list, fn) -> None:
    try:
        trace.append(("ok", fn()))
    except (jres.RingBackpressure, tres.RingBackpressure) as e:
        trace.append(("refused", e.reason, dict(e.context)))


def _scenario_wraparound(mk) -> list:
    ring, out = mk(4), []
    for i in range(11):
        slot, seq = ring.push(i, payload=i)
        d = ring.pop()
        out.append((slot, seq, d.slot, d.seq, d.sig_id, d.payload))
        ring.complete(slot, seq)
        out.append(ring.poll(seq))
    out.append(ring.state_event())
    return out


def _scenario_full(mk) -> list:
    ring, out = mk(4), []
    for i in range(4):
        out.append(ring.push(i, payload=None))
    _attempt(out, lambda: ring.push(9, payload=None))
    out.append(ring.wedged)
    d = ring.pop()
    ring.complete(d.slot, d.seq)
    _attempt(out, lambda: ring.push(9, payload=None))
    out.append(ring.state_event())
    return out


def _scenario_wedged(mk) -> list:
    ring, out = mk(4), []
    ring.wedge()
    _attempt(out, lambda: ring.push(0, payload=None))
    ring.reset()
    _attempt(out, lambda: ring.push(0, payload=None))
    out.append(ring.state_event())
    return out


def _scenario_out_of_order(mk) -> list:
    ring, out = mk(4), []
    ring.push(0, payload=None)
    ring.push(1, payload=None)
    d1, d2 = ring.pop(), ring.pop()
    _attempt(out, lambda: ring.complete(d2.slot, d2.seq))
    out.append(ring.wedged)
    _attempt(out, lambda: ring.push(2, payload=None))
    out.append((d1.seq, ring.completed, ring.state_event()))
    return out


def _scenario_drain(mk) -> list:
    ring, out = mk(4), []
    _attempt(out, ring.drain_barrier)
    ring.push(0, payload=None)
    d = ring.pop()
    ring.complete(d.slot, d.seq)
    _attempt(out, ring.drain_barrier)
    ring.push(1, payload=None)
    _attempt(out, lambda: ring.drain_barrier(timeout_s=0.01))
    out.append(ring.wedged)
    return out


@pytest.mark.parametrize("scenario", [
    _scenario_wraparound, _scenario_full, _scenario_wedged,
    _scenario_out_of_order, _scenario_drain])
def test_ring_protocol_same_as_jax(scenario):
    assert scenario(_tring) == scenario(_jring)


def test_ring_tensors_and_capacity():
    ring = _tring(8)
    assert ring.sig_id.dtype == torch.int32 and ring.seq.dtype == torch.int64
    assert not ring.sig_id.is_pinned()          # a CPU ring: not pinned
    slot, seq = ring.push(5, payload="p")
    assert int(ring.sig_id[slot]) == 5 and int(ring.seq[slot]) == seq
    d = ring.pop()
    ring.complete(d.slot, d.seq)
    assert int(ring.stamp[slot]) == seq
    for bad in (6, 1):
        with pytest.raises(ValueError):
            tres.DescriptorRing(bad, device=CPU)
        with pytest.raises(ValueError):
            jres.DescriptorRing(bad)
    with pytest.raises(ValueError):
        tres.ResidentEscape("nonsense")
    assert tres.ESCAPE_REASONS == jres.ESCAPE_REASONS


# ------------------------------------------------------ resident serving

def _tenant_values(seed: int, uni: int, vmax: int):
    rng = np.random.default_rng(seed)
    bms = [np.unique(rng.integers(0, uni, 500)).astype(np.uint32)
           for _ in range(4)]
    ids = np.unique(rng.integers(0, uni, 1200)).astype(np.uint32)
    vals = rng.integers(0, vmax, ids.size).astype(np.int64)
    return bms, ids, vals


@pytest.fixture(scope="module")
def tenants():
    """The JAX fixture's two tenants in both packages:
    ``[(jax bitmaps, jax set, port bitmaps, port set, port column)]``."""
    out = []
    for seed, uni, vmax in ((0x161, 1 << 12, 400), (0x162, 1 << 11, 120)):
        vals, ids, v = _tenant_values(seed, uni, vmax)
        jb = [JRB.from_values(x) for x in vals]
        tb = [TRB.from_values(x) for x in vals]
        js = JSet(jb, layout="dense")
        js.attach_column(JBsi("price", ids, v))
        ts = DeviceBitmapSet(tb, layout="dense", device=CPU)
        col = BsiColumn("price", ids, v, device=CPU)
        ts.attach_column(col)
        out.append((jb, js, tb, ts, col))
    yield out
    out.clear()
    gc.collect()


@pytest.fixture(scope="module")
def warmed(tenants):
    """ONE warmed engine and sealed lattice per package for the module;
    tests that need the warm state activate the same lattices again."""
    depth = max(c.depth_pad for *_, c in tenants)
    prof = PROFILE + f"bsi={depth},"
    jeng = JMS([t[1] for t in tenants])
    jeng.warmup(profile=prof)
    jl = jlat.active()
    jlat.deactivate()
    teng = MultiSetBatchEngine([t[3] for t in tenants])
    teng.warmup(profile=prof)
    tl = tlat.active()
    tlat.deactivate()
    assert jl.sealed and tl.sealed
    yield jeng, jl, teng, tl
    jlat.deactivate()
    tlat.deactivate()


def _activate(warmed):
    jeng, jl, teng, tl = warmed
    jlat.activate(jl)
    tlat.activate(tl)
    return jeng, teng


def _query(i: int, ex):
    if i % 2:
        return ex.ExprQuery(ex.sum_(
            "price", found=ex.and_(ex.or_(0, 1),
                                   ex.cmp("price", "ge", 5 + i))))
    return ex.ExprQuery(ex.and_(ex.or_(0, 1), ex.cmp("price", "le", 60 + i)))


def _check_host(t, tenants) -> None:
    assert t.status == "done", (t.status, t.error)
    _, _, tb, _, col = tenants[t.request.set_id]
    q = t.request.query
    if texpr.is_agg(q.expr):
        card, value, _ = texpr.evaluate_host_agg(q.expr, tb, {"price": col})
        assert (t.result.cardinality, t.result.value) == (card, value)
    else:
        ref = texpr.evaluate_host(q.expr, tb, {"price": col})
        assert t.result.cardinality == ref.cardinality


def test_signature_id_same_for_every_point(warmed):
    _jeng, jl, _teng, tl = warmed
    assert tl.to_profile() == jl.to_profile()
    tp, jp = tl.enumerate_points(pooled=True), jl.enumerate_points(
        pooled=True)
    assert [p.as_dict() for p in tp] == [p.as_dict() for p in jp]
    seen = {}
    for a, b in zip(jp, tp):
        sig = tres.signature_id(tl, b)
        assert sig == jres.signature_id(jl, a)
        if b.q in tl.q and not b.delta:
            assert sig is not None and sig not in seen
            seen[sig] = b
        else:
            assert sig is None
    assert seen


def _loops(warmed, resident: bool, **kw):
    jeng, teng = _activate(warmed)
    kw.setdefault("pool_target", 2)
    kw.setdefault("engine", "megakernel")
    kw.setdefault("default_deadline_ms", 600_000.0)
    return (jserving.ServingLoop(jeng, jserving.ServingPolicy(
                resident=resident, guard=JNOSLEEP, **kw)),
            serving.ServingLoop(teng, serving.ServingPolicy(
                resident=resident, guard=TNOSLEEP, **kw)))


def test_resident_serves_every_pool_without_a_dispatch(tenants, warmed):
    """Every pool ring-served (the dispatch counter flat, nothing
    demoted), results equal to the one-shot loop's, the JAX package's
    resident loop's and the host oracle."""
    jl, tl = _loops(warmed, resident=True)
    n = 32
    arr = [(i * 1e-4, i % 2, i) for i in range(n)]
    tt = replay_stream(tl, [(at, serving.ServingRequest(
        s, _query(i, texpr), tenant=f"t{s}")) for at, s, i in arr])
    jt = jreplay(jl, [(at, jserving.ServingRequest(
        s, _query(i, jexpr), tenant=f"t{s}")) for at, s, i in arr])
    assert _ctr("rb_serving_dispatches_total") == 0
    assert tl._resident.stats == {"served": n // 2, "demoted": 0,
                                  "pushed": n // 2}
    assert jl._resident.stats["served"] == tl._resident.stats["served"]
    assert all(t["resident"] for t in tl.timings)
    ring = tl._resident.ring.state_event()
    assert ring["head"] == ring["completed"] == n // 2
    # the one-shot dispatch of the same stream
    _jo, ol = _loops(warmed, resident=False)
    ot = replay_stream(ol, [(at, serving.ServingRequest(
        s, _query(i, texpr), tenant=f"t{s}")) for at, s, i in arr])
    for a, b, o in zip(jt, tt, ot):
        _check_host(b, tenants)
        assert (b.result.cardinality, b.result.value) == \
            (a.result.cardinality, a.result.value) == \
            (o.result.cardinality, o.result.value)


def test_wedged_ring_demotes_typed_and_exact(tenants, warmed):
    jl, tl = _loops(warmed, resident=True)
    jl._resident.ring.wedge()
    tl._resident.ring.wedge()
    jd0 = jmetrics.counter("rb_serving_resident_demotions_total",
                           site="serving", reason="wedged").value
    tt = [tl.submit(serving.ServingRequest(0, _query(i, texpr),
                                           tenant="t0")) for i in range(2)]
    jt = [jl.submit(jserving.ServingRequest(0, _query(i, jexpr),
                                            tenant="t0")) for i in range(2)]
    tl.drain()
    jl.drain()
    assert _ctr("rb_serving_resident_demotions_total",
                         reason="wedged") == 1
    assert jmetrics.counter("rb_serving_resident_demotions_total",
                            site="serving", reason="wedged").value == jd0 + 1
    assert _ctr("rb_serving_dispatches_total") == 1
    assert tl._resident.stats == jl._resident.stats
    for a, b in zip(jt, tt):
        _check_host(b, tenants)
        assert b.result.cardinality == a.result.cardinality


def test_inactive_vocab_escape(tenants):
    teng = MultiSetBatchEngine([t[3] for t in tenants])
    jeng = JMS([t[1] for t in tenants])
    got = []
    for rq, G, ex in ((tres.ResidentQueue(teng), BatchGroup, texpr),
                      (jres.ResidentQueue(jeng), JG, jexpr)):
        assert not rq.seal_vocab() and not rq.active
        with pytest.raises((tres.ResidentEscape, jres.ResidentEscape)) as e:
            rq.serve([G(0, [_query(0, ex)])])
        got.append(e.value.reason)
    assert got == ["inactive", "inactive"]


def test_backend_escape_is_typed(warmed):
    _activate(warmed)

    class NotAnEngine:
        device = torch.device(CPU)

    got = []
    for rq, G, ex in ((tres.ResidentQueue(NotAnEngine()), BatchGroup, texpr),
                      (jres.ResidentQueue(NotAnEngine()), JG, jexpr)):
        assert rq.seal_vocab()
        with pytest.raises((tres.ResidentEscape, jres.ResidentEscape)) as e:
            rq.serve([G(0, [_query(0, ex)])])
        got.append(e.value.reason)
    assert got == ["backend", "backend"]


def _escape_reason(rq, groups):
    assert rq.seal_vocab()
    with pytest.raises((tres.ResidentEscape, jres.ResidentEscape)) as e:
        rq.serve(groups)
    return e.value.reason


def test_vocabulary_escapes(warmed):
    """A flat-only pool (no one-kernel program) and a fused pool past the
    warmed expression depth both leave the lane as ``vocabulary``."""
    jeng, teng = _activate(warmed)
    deep = {ex: ex.ExprQuery(ex.and_(
        ex.or_(ex.and_(0, 1), ex.and_(1, 2)), ex.cmp("price", "le", 50)))
        for ex in (texpr, jexpr)}
    t_flat = _escape_reason(tres.ResidentQueue(teng),
                            [BatchGroup(0, [TQ("or", (0, 1, 2))])])
    j_flat = _escape_reason(jres.ResidentQueue(jeng),
                            [JG(0, [JQ("or", (0, 1, 2))])])
    t_deep = _escape_reason(tres.ResidentQueue(teng),
                            [BatchGroup(0, [deep[texpr]])])
    j_deep = _escape_reason(jres.ResidentQueue(jeng),
                            [JG(0, [deep[jexpr]])])
    assert (t_flat, t_deep) == (j_flat, j_deep) == ("vocabulary",
                                                    "vocabulary")


def test_wedged_push_escape_counts_demotion(warmed):
    jeng, teng = _activate(warmed)
    stats = []
    for rq, G, ex in ((tres.ResidentQueue(teng), BatchGroup, texpr),
                      (jres.ResidentQueue(jeng), JG, jexpr)):
        rq.ring.wedge()
        reason = _escape_reason(rq, [G(0, [_query(0, ex), _query(2, ex)])])
        stats.append((reason, dict(rq.stats)))
    assert stats[0] == stats[1] == ("wedged", {"served": 0, "demoted": 1,
                                               "pushed": 0})


def test_resident_queue_env_opt_in(monkeypatch):
    for v, want in (("1", True), ("0", False)):
        monkeypatch.setenv("ROARING_TPU_SERVING_RESIDENT", v)
        assert serving.ServingPolicy.from_env().resident is want
        assert jserving.ServingPolicy.from_env().resident is want
