"""The port's replay harness against roaringbitmap_tpu.serving.replay.

The same profile and seed give the same workload in both packages, event
for event: arrival offsets, tenants, set ids, deltas (value for value) and
queries (their wire encodings, byte for byte, so ad-hoc leaves compare
too); ``build_dataset`` gives the same bitmaps and columns.  ``run_inproc``
over both packages' loops (the port's on ``device="cpu"``) under a far
deadline reports the same counts, every query done and typed; under
overload its counts reconcile and every failure is typed; ``run_wire``
over the port's ``WireServer`` serves the same stream.
"""

import gc

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.parallel import MultiSetBatchEngine as JMS
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu import serving as jserving
from roaringbitmap_tpu.serving import replay as jreplay
from roaringbitmap_tpu.wire import protocol as jwp
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
from roaringbitmap_tpu_torch.runtime import faults, guard
from roaringbitmap_tpu_torch import serving
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.serving import replay as treplay
from roaringbitmap_tpu_torch.wire import WireClient, WireServer
from roaringbitmap_tpu_torch.wire import protocol as wp

torch.set_num_threads(2)

CPU = "cpu"
KNOBS = dict(sets=2, sources=6, tenants=6, density=500, users=1 << 16,
             requests=80, duration_s=1.0, seed=21)


@pytest.fixture(autouse=True)
def _clean():
    jobs.disable()
    jobs.reset()
    tobs.reset()
    tobs.flight.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    yield
    jobs.disable()
    jobs.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    gc.collect()


def _tloop(knobs, **kw):
    prof = treplay.ReplayProfile(**knobs)
    bms, cols = treplay.build_dataset(prof)
    sets = [DeviceBitmapSet(b, layout="dense", device=CPU) for b in bms]
    treplay.attach_columns(sets, prof, cols)
    kw.setdefault("pool_target", 4)
    kw.setdefault("default_deadline_ms", 300_000.0)
    policy = serving.ServingPolicy(
        guard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None), **kw)
    return serving.ServingLoop(MultiSetBatchEngine(sets), policy)


def _jloop(knobs, **kw):
    prof = jreplay.ReplayProfile(**knobs)
    bms, cols = jreplay.build_dataset(prof)
    sets = [JSet(b, layout="dense") for b in bms]
    jreplay.attach_columns(sets, prof, cols)
    kw.setdefault("pool_target", 4)
    kw.setdefault("default_deadline_ms", 300_000.0)
    return jserving.ServingLoop(JMS(sets), jserving.ServingPolicy(
        guard=jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None),
        **kw))


@pytest.mark.parametrize("knobs", [
    KNOBS,
    dict(sets=3, sources=9, tenants=64, users=1 << 24, requests=200,
         duration_s=4.0, seed=7, bitmap_share=0.4),
    dict(KNOBS, delta_share=0.0, analytics_col=""),
])
def test_generate_same_events(knobs):
    tev = treplay.generate(treplay.ReplayProfile(**knobs))
    jev = jreplay.generate(jreplay.ReplayProfile(**knobs))
    assert len(tev) == len(jev) == knobs["requests"]
    for t, j in zip(tev, jev):
        assert (t[0], t[1]) == (j[0], j[1])
        if t[0] == "delta":
            assert t[2] == j[2]
            for a, b in ((t[3], j[3]), (t[4] or {}, j[4] or {})):
                assert a.keys() == b.keys()
                for k in a:
                    assert np.array_equal(a[k], b[k])
            continue
        tr, jr = t[2], j[2]
        assert (tr.set_id, tr.tenant, tr.deadline_ms) == \
            (jr.set_id, jr.tenant, jr.deadline_ms)
        assert wp.encode_query(tr.query) == jwp.encode_query(jr.query)
    kinds = {e[0] for e in tev}
    assert kinds == ({"query"} if knobs.get("delta_share") == 0.0
                     else {"query", "delta"})


def test_build_dataset_same_bitmaps():
    prof = dict(KNOBS, sets=3)
    tb, tc = treplay.build_dataset(treplay.ReplayProfile(**prof))
    jb, jc = jreplay.build_dataset(jreplay.ReplayProfile(**prof))
    for ts, js in zip(tb, jb):
        assert [b.serialize() for b in ts] == [b.serialize() for b in js]
    for (ti, tv), (ji, jv) in zip(tc, jc):
        assert np.array_equal(ti, ji) and np.array_equal(tv, jv)
    none = treplay.build_dataset(treplay.ReplayProfile(
        **dict(prof, analytics_col="")))[1]
    assert none == [None] * 3
    alone = treplay.dataset_columns(treplay.ReplayProfile(**prof))
    for (ai, av), (ti, tv) in zip(alone, tc):
        assert np.array_equal(ai, ti) and np.array_equal(av, tv)


def test_attach_columns_on_the_sets_device():
    prof = treplay.ReplayProfile(**KNOBS)
    bms, cols = treplay.build_dataset(prof)
    sets = [DeviceBitmapSet(b, layout="dense", device=CPU) for b in bms]
    treplay.attach_columns(sets, prof, cols)
    for ds, (ids, vals) in zip(sets, cols):
        col = ds.columns["v"]
        assert col.device.type == "cpu"
        assert col.host_sum(None) == (int(vals.sum()), ids.size)


def test_run_inproc_same_counts_under_easy_deadline():
    events_t = treplay.generate(treplay.ReplayProfile(**KNOBS))
    events_j = jreplay.generate(jreplay.ReplayProfile(**KNOBS))
    tl, jl = _tloop(KNOBS), _jloop(KNOBS)
    trep = treplay.run_inproc(tl, events_t)
    jrep = jreplay.run_inproc(jl, events_j)
    for k in ("queries", "deltas", "done", "shed", "failed", "rejected",
              "attainment", "typed_only"):
        assert trep[k] == jrep[k], k
    assert trep["queries"] + trep["deltas"] == KNOBS["requests"]
    assert trep["done"] == trep["queries"] and trep["attainment"] == 1.0
    assert trep["p99_ms"] >= trep["p50_ms"] >= 0.0
    # the deltas landed identically: every tenant's bitmaps agree
    for te, je in zip(tl._engine._engines, jl._engine._engines):
        assert [b.serialize() for b in te._ds.host_bitmaps()] == \
            [b.serialize() for b in je._ds.host_bitmaps()]


def test_run_inproc_overload_is_typed_and_accounted():
    knobs = dict(sets=2, sources=6, tenants=6, density=500, users=1 << 16,
                 requests=60, duration_s=0.5, deadline_ms=1.0, seed=21)
    tl = _tloop(knobs, max_queue=4)
    rep = treplay.run_inproc(tl, treplay.generate(
        treplay.ReplayProfile(**knobs)), rate_scale=50.0)
    assert rep["typed_only"], rep
    assert (rep["done"] + rep["shed"] + rep["failed"]
            + rep["rejected"]) == rep["queries"]
    assert rep["shed"] + rep["rejected"] > 0, rep
    assert rep["attainment"] < 1.0


def test_report_and_sustained_equal_the_jax_shapes():
    class T:
        def __init__(self, status, missed=False, error=None):
            self.status, self.missed, self.error = status, missed, error
            self.result = None

    tickets = [T("done"), T("done", missed=True),
               T("shed", error=serving.RequestShed("x", "expired")),
               T("failed", error=KeyError("raw"))]
    lat = [1.0, 2.0, 30.0]
    trep = treplay.report(tickets, lat, 3, 2.0)
    jrep = jreplay.report(tickets, lat, 3, 2.0)
    assert trep == jrep and trep["typed_only"] is False
    reports = {1.0: 0.99, 2.0: 0.93, 4.0: 0.55}

    def run_one(rate):
        return {"qps": 100.0 * rate, "attainment": reports[rate],
                "p99_ms": rate, "typed_only": True}

    got = treplay.sustained(run_one, [1.0, 2.0, 4.0], slo_target=0.9)
    assert got == jreplay.sustained(run_one, [1.0, 2.0, 4.0],
                                    slo_target=0.9)
    assert got["sustained_rate_x"] == 2.0


def test_run_wire_serves_the_same_stream():
    knobs = dict(KNOBS, requests=40)
    events = treplay.generate(treplay.ReplayProfile(**knobs))
    tl = _tloop(knobs)
    with WireServer(tl) as srv:
        cl = WireClient(srv.address, timeout=60)
        rep = treplay.run_wire(cl, events, pace=False, timeout=60)
        cl.close()
    inproc = treplay.run_inproc(_tloop(knobs), events)
    for k in ("queries", "deltas", "done", "typed_only"):
        assert rep[k] == inproc[k], k
    assert rep["done"] == rep["queries"] and rep["p99_ms"] > 0
    has = [e for e in events if e[0] == "query"
           and isinstance(e[2].query, texpr.ExprQuery)]
    assert has
