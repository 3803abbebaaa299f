"""The port's observability layer (``roaringbitmap_tpu_torch.obs``) against
the JAX package's (``roaringbitmap_tpu.obs``), on the CPU.

Two kinds of cases:

- the counterparts of ``tests/test_obs.py``'s cases that apply to the port
  (registry contracts, the tracer, the guard's events, the Prometheus
  renderer, the LRU caches' instruments), with the port's rung names:
  "cuda" / "torch" where the JAX package has "pallas" / "xla";
- parity cases: the same seeded workload through both packages, each
  traced to its own path — a Q 16 ``BatchEngine`` batch with one injected
  demotion, a 4-tenant pool, a 3-node expression pool and a short
  ``ServingLoop`` replay with one rejection and one shed.  The dumps agree
  on span names, parent/child nesting, tag keys and event names; the
  registries on their Prometheus families and label keys, and on the
  counter values of requests, rejections, sheds by reason, pools,
  dispatch events by (site, event) and ``rb_expr_launches_saved_total``.
  Timings and the values of engine-name tags are exempt: the packages
  time different hardware and name their rungs differently.
  The port's set build and resident wide op spans, its kernels' launch
  events, its build-phase histogram and its ingest counters have no JAX
  counterpart: the comparisons leave out exactly those names
  (``PORT_ONLY_SPANS``, ``PORT_ONLY_EVENTS``, ``PORT_ONLY_FAMILIES``), and
  one case checks that the port's dump holds them and the JAX package's
  does not.

Every port dump passes ``tools/check_trace.py``'s validator in plain mode.
Each tracer is enabled with an explicit path; no case sets
``ROARING_TPU_TRACE`` for both packages at once.
"""

import importlib.util
import json
import logging
import os

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu import serving as jserving
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.parallel.multiset import BatchGroup as JGroup
from roaringbitmap_tpu.parallel.multiset import MultiSetBatchEngine as JMS
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch import serving
from roaringbitmap_tpu_torch.parallel import aggregation
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           BatchQuery,
                                                           random_query_pool)
from roaringbitmap_tpu_torch.parallel.multiset import (BatchGroup,
                                                       MultiSetBatchEngine)
from roaringbitmap_tpu_torch.runtime import faults, guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
TNOSLEEP = guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
JNOSLEEP = jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    """Both packages start from a fresh registry and a disabled tracer;
    flight dumps land in the test's directory."""
    for o, g in ((obs, guard), (jobs, jguard)):
        o.disable()
        o.reset()
        o.flight.reset()
        o.flight.configure(dir=str(tmp_path / "flight"))
        g.reset_dispatch_stats()
    faults.reset_clock()
    jfaults.reset_clock()
    yield
    for o, g in ((obs, guard), (jobs, jguard)):
        o.disable()
        o.reset()
        o.flight.configure(dir=None)
        o.flight.reset()
        g.reset_dispatch_stats()
    faults.reset_clock()
    jfaults.reset_clock()


def _values(n: int, seed: int, uni: int = 1 << 18, card: int = 2600) -> list:
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, uni, card)).astype(np.uint32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def vals():
    return _values(16, seed=11)


@pytest.fixture(scope="module")
def engine(vals):
    return BatchEngine(DeviceBitmapSet([TRB.from_values(v) for v in vals],
                                       layout="dense", device=CPU),
                       result_cache=None)


@pytest.fixture(scope="module")
def jengine(vals):
    return JEngine(_jset(vals), result_cache=None)


def _jset(vals):
    from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JS
    return JS([JRB.from_values(v) for v in vals], layout="dense")


@pytest.fixture(scope="module")
def pool():
    return random_query_pool(16, 16, seed=5)


def _jq(q):
    if isinstance(q, BatchQuery):
        return JQ(q.op, q.operands, form=q.form)
    return jexpr.ExprQuery(_jexpr(q.expr), form=q.form)


def _jexpr(e):
    if isinstance(e, texpr.Ref):
        return jexpr.Ref(e.index)
    return jexpr.Node(e.op, tuple(_jexpr(c) for c in e.children))


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _load_check_trace():
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(REPO, "tools", "check_trace.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _traced(o, path, fn):
    """``fn()`` with package ``o``'s tracer writing to ``path``."""
    o.enable(str(path))
    try:
        return fn()
    finally:
        o.disable()


#: spans only the port opens: its set build, with one child a phase, and
#: its resident wide op (the JAX package times neither inside the program)
PORT_ONLY_SPANS = {"set.aggregate", "set.build", "set.build.choose_layout",
                   "set.build.pack", "set.build.upload", "set.build.device"}
#: events only the port records: the bytes of each CUDA kernel launch
PORT_ONLY_EVENTS = {"kernel.launch"}


def _shape(spans: list) -> dict:
    """The parts of a dump two packages must share: span names, (parent,
    child) name edges, tag keys and event names by span name, without
    :data:`PORT_ONLY_SPANS` and :data:`PORT_ONLY_EVENTS` (a span under a
    port-only span takes the nearest other ancestor as its parent)."""
    by_id = {s["span_id"]: s for s in spans}

    def parent(s):
        p = by_id.get(s["parent_id"])
        while p is not None and p["name"] in PORT_ONLY_SPANS:
            p = by_id.get(p["parent_id"])
        return None if p is None else p["name"]

    spans = [s for s in spans if s["name"] not in PORT_ONLY_SPANS]
    tags: dict = {}
    events: dict = {}
    for s in spans:
        tags.setdefault(s["name"], set()).update(s["tags"])
        events.setdefault(s["name"], set()).update(
            e["name"] for e in s["events"]
            if e["name"] not in PORT_ONLY_EVENTS)
    edges = {(parent(s), s["name"]) for s in spans}
    return {"names": set(tags), "edges": edges, "tags": tags,
            "events": events}


#: the families only a card has: the allocator's measured peak of a
#: dispatch (the JAX package reads its compiler's analysis on the CPU too),
#: and the CUDA-event time of a kernel outside any traced window
CARD_ONLY = {"rb_hbm_measured_peak_bytes", "rb_kernel_seconds"}
#: the families only the port has: its set build's phases and what the
#: build ingested
PORT_ONLY_FAMILIES = {"rb_ingest_phase_seconds", "rb_ingest_containers_total",
                      "rb_ingest_values_total", "rb_ingest_run_pairs_total",
                      "rb_ingest_rows_total"}


def _families(o) -> dict:
    """{family: (kind, label keys)} of a registry's Prometheus text,
    without :data:`CARD_ONLY` and :data:`PORT_ONLY_FAMILIES`."""
    out: dict = {}
    for name, labels, inst in o.metrics.REGISTRY.instruments():
        if name in CARD_ONLY or name in PORT_ONLY_FAMILIES:
            continue
        keys = out.setdefault(name, (inst.kind, set()))[1]
        keys.update(labels)
    return out


def _counters(o, name: str, *keys) -> dict:
    """{label values: value} of one counter family."""
    return {tuple(r["labels"].get(k) for k in keys): r["value"]
            for r in o.snapshot()["counters"].get(name, [])}


def _diff(t: dict, j: dict) -> dict:
    """{key: (port only, JAX only)} of two {key: set} maps, where they
    differ."""
    return {k: (t.get(k, set()) - j.get(k, set()),
                j.get(k, set()) - t.get(k, set()))
            for k in set(t) | set(j) if t.get(k) != j.get(k)}


def _same_dumps(tpath, jpath) -> None:
    t, j = _shape(_read(tpath)), _shape(_read(jpath))
    assert t["names"] == j["names"], (t["names"] ^ j["names"])
    assert t["edges"] == j["edges"], (t["edges"] - j["edges"],
                                      j["edges"] - t["edges"])
    assert t["tags"] == j["tags"], _diff(t["tags"], j["tags"])
    assert t["events"] == j["events"], _diff(t["events"], j["events"])
    ct = _load_check_trace()
    assert ct.validate(str(tpath)) == []


def _same_registries() -> None:
    assert _families(obs) == _families(jobs)
    for name, keys in (("rb_dispatch_events_total", ("site", "event")),
                       ("rb_expr_launches_saved_total", ("site",)),
                       ("rb_serving_requests_total", ("tenant",)),
                       ("rb_serving_admission_rejected_total", ("reason",)),
                       ("rb_serving_shed_total", ("reason",)),
                       ("rb_serving_pools_total", ())):
        assert _counters(obs, name, *keys) == _counters(jobs, name, *keys), \
            name


# ------------------------------------------------------------ parity

def test_parity_batch_with_one_demotion(tmp_path, engine, jengine, pool):
    """A Q 16 batch whose first rung takes one lowering fault: both dumps
    show the demotion on ``guard.dispatch`` under ``batch.execute``, with
    the same spans, nesting, tags and events, and the registries agree."""
    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    with faults.inject("lowering@cuda=1.0:7"):
        got = _traced(obs, tpath, lambda: engine.execute(pool,
                                                         engine="cuda"))
    with jfaults.inject("lowering@pallas=1.0:7"):
        want = _traced(jobs, jpath, lambda: jengine.execute(
            [_jq(q) for q in pool], engine="pallas"))
    assert [g.cardinality for g in got] == [w.cardinality for w in want]
    _same_dumps(tpath, jpath)
    _same_registries()
    spans = _read(tpath)
    by_id = {s["span_id"]: s for s in spans}
    (d,) = [s for s in spans if s["name"] == "guard.dispatch"]
    assert d["tags"]["demotion_chain"] == ["cuda->torch"]
    assert d["tags"]["rung_used"] == "torch"
    assert by_id[d["parent_id"]]["name"] == "batch.execute"
    (ev,) = [e for e in d["events"] if e["name"] == "demote"]
    assert (ev["engine_from"], ev["engine_to"], ev["error_class"]) == (
        "cuda", "torch", "EngineLoweringError")


def test_port_only_names_are_the_ports_alone(tmp_path, vals, monkeypatch):
    """The same workload, a set built and a wide OR and XOR over it, in
    each package: the port's dump holds every port-only span and event and
    its registry the port-only family; the JAX package's hold none.  Kernel
    launches need a card, so the port's go to a library that does nothing
    (their outputs are not read)."""
    from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JS
    from roaringbitmap_tpu_torch.ops import kernels

    def port():
        ds = DeviceBitmapSet([TRB.from_values(v) for v in vals],
                             device=CPU)
        ds.aggregate_device("or")

        class Lib:
            def __getattr__(self, name):
                return lambda *args: 0

        with monkeypatch.context() as m:
            m.setattr(kernels.build, "load", lambda source: Lib())
            m.setattr(kernels, "_on_cuda", lambda *ts: True)
            m.setattr(kernels, "_stream", lambda: 0)
            m.setattr(kernels, "_sm_count", lambda dev: kernels.H100_SMS)
            for k in kernels.KERNELS:
                m.setattr(k, "_fn", None)
            ds.aggregate_device("xor", engine="cuda")

    def jax():
        js = JS([JRB.from_values(v) for v in vals])
        js.aggregate_device("or")
        js.aggregate_device("xor")

    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    _traced(obs, tpath, port)
    _traced(jobs, jpath, jax)
    tspans, jspans = _read(tpath), _read(jpath)
    assert PORT_ONLY_SPANS <= {s["name"] for s in tspans}
    assert PORT_ONLY_EVENTS <= {e["name"] for s in tspans
                                for e in s["events"]}
    assert not PORT_ONLY_SPANS & {s["name"] for s in jspans}
    assert not PORT_ONLY_EVENTS & {e["name"] for s in jspans
                                   for e in s["events"]}

    def families(o):
        return {name for name, _, _ in o.metrics.REGISTRY.instruments()}

    assert PORT_ONLY_FAMILIES <= families(obs)
    assert not PORT_ONLY_FAMILIES & families(jobs)
    assert _load_check_trace().validate(str(tpath)) == []


def _tenants(n_t: int = 4, per: int = 6):
    vals = _values(n_t * per, seed=23)
    tsets = [DeviceBitmapSet([TRB.from_values(v)
                              for v in vals[t * per:(t + 1) * per]],
                             layout="dense", device=CPU)
             for t in range(n_t)]
    tms = MultiSetBatchEngine(tsets)
    jms = JMS.from_bitmap_sets([[JRB.from_values(v)
                                 for v in vals[t * per:(t + 1) * per]]
                                for t in range(n_t)], layout="dense")
    return tms, jms


def test_parity_four_tenant_pool(tmp_path):
    tms, jms = _tenants()
    rng = np.random.default_rng(3)
    groups = []
    for sid in range(4):
        qs = []
        for i in range(3):
            ops = tuple(int(x) for x in rng.choice(6, 3, replace=False))
            qs.append(BatchQuery(("or", "and", "xor")[i], ops,
                                 form="bitmap" if i == 0 else "cardinality"))
        groups.append(BatchGroup(sid, qs))
    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    got = _traced(obs, tpath, lambda: tms.execute(groups, engine="torch"))
    want = _traced(jobs, jpath, lambda: jms.execute(
        [JGroup(g.set_id, [_jq(q) for q in g.queries]) for g in groups],
        engine="xla"))
    for g, w in zip(got, want):
        assert [r.cardinality for r in g] == [r.cardinality for r in w]
    _same_dumps(tpath, jpath)
    _same_registries()
    spans = _read(tpath)
    (d,) = [s for s in spans if s["name"] == "multiset.dispatch"]
    names = {e["name"] for e in d["events"]}
    assert {"multiset.memory", "multiset.cost"} <= names
    assert d["tags"]["sets"] == 4 and d["tags"]["q"] == 12


def test_parity_three_node_expression_pool(tmp_path, engine, jengine):
    """A pool of 3-node expressions: ``expr.compile`` spans with the same
    tags, and ``rb_expr_launches_saved_total`` credited equally."""
    pool = [texpr.ExprQuery(texpr.and_(texpr.or_(i, i + 1),
                                       texpr.not_(i + 2)), form="bitmap")
            for i in range(6)]
    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    got = _traced(obs, tpath, lambda: engine.execute(pool, engine="torch"))
    want = _traced(jobs, jpath, lambda: jengine.execute(
        [_jq(q) for q in pool], engine="xla"))
    assert [g.cardinality for g in got] == [w.cardinality for w in want]
    _same_dumps(tpath, jpath)
    _same_registries()
    saved = _counters(obs, "rb_expr_launches_saved_total", "site")
    assert saved[("batch_engine",)] > 0
    compiles = [s for s in _read(tpath) if s["name"] == "expr.compile"]
    assert len(compiles) == 6
    assert all(s["tags"]["kind"] == "fused" and s["tags"]["nodes"] >= 2
               for s in compiles)


def test_parity_serving_replay_with_rejection_and_shed(tmp_path):
    """A short replay: one admission rejected (queue full), one request
    shed (expired on the fault clock), the rest served exactly; the
    ``serving.*`` spans, the SLO counters and the serving counters agree."""
    tms, jms = _tenants(n_t=3)
    kw = dict(pool_target=4, max_queue=2, default_deadline_ms=300_000.0)
    tl = serving.ServingLoop(tms, serving.ServingPolicy(guard=TNOSLEEP,
                                                        **kw))
    jl = jserving.ServingLoop(jms, jserving.ServingPolicy(guard=JNOSLEEP,
                                                         **kw))
    reqs = [(i % 3, BatchQuery(("or", "xor")[i % 2], (i % 4, i % 4 + 1)))
            for i in range(6)]

    def drive(loop, mk, adv):
        out = []
        for sid, q in reqs:
            out.append(loop.submit(mk(sid, q, f"t{sid}", None)))
        # a third queued request of tenant t0: the queue cap refuses it
        with pytest.raises(Exception) as err:
            loop.submit(mk(0, reqs[0][1], "t0", None))
        assert type(err.value).__name__ == "AdmissionRejected"
        loop.pump(force=True)
        late = loop.submit(mk(1, reqs[1][1], "t1", 50.0))
        adv(0.2)
        loop.pump(force=True)
        loop.drain()
        return out, late

    def tmk(sid, q, tenant, dl):
        return serving.ServingRequest(sid, q, tenant=tenant, deadline_ms=dl)

    def jmk(sid, q, tenant, dl):
        return jserving.ServingRequest(sid, _jq(q), tenant=tenant,
                                       deadline_ms=dl)

    tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    tt, tlate = _traced(obs, tpath, lambda: drive(tl, tmk,
                                                  faults.advance_clock))
    jt, jlate = _traced(jobs, jpath, lambda: drive(jl, jmk,
                                                   jfaults.advance_clock))
    assert [t.status for t in tt] == [t.status for t in jt] == ["done"] * 6
    assert [t.result.cardinality for t in tt] == \
        [t.result.cardinality for t in jt]
    assert tlate.status == jlate.status == "shed"
    assert tlate.error.reason == jlate.error.reason == "expired"
    _same_dumps(tpath, jpath)
    _same_registries()
    for name in ("rb_slo_attained_total", "rb_slo_missed_total"):
        assert _counters(obs, name, "site", "tenant") == \
            _counters(jobs, name, "site", "tenant"), name
    spans = _read(tpath)
    admits = [s for s in spans if s["name"] == "serving.admit"]
    assert sorted(s["tags"]["outcome"] for s in admits) == \
        ["admitted"] * 7 + ["rejected"]
    # each served request's outcome span parents into its admission
    by_id = {s["span_id"]: s for s in spans}
    reqspans = [s for s in spans if s["name"] == "serving.request"]
    assert len(reqspans) == 6
    assert all(by_id[s["parent_id"]]["name"] == "serving.admit"
               for s in reqspans)


# --------------------------------------------- counterparts of test_obs

def test_demoted_query_trace_shows_demotion_chain(tmp_path, monkeypatch,
                                                  engine, pool):
    """``ROARING_TPU_FAULTS`` lowering fault on the "cuda" rung, traced via
    ``ROARING_TPU_TRACE`` (set for the port alone): the dump records the
    cuda -> torch demotion with the classified error."""
    trace_path = tmp_path / "trace.jsonl"
    monkeypatch.setenv("ROARING_TPU_TRACE", str(trace_path))
    monkeypatch.setenv("ROARING_TPU_FAULTS", "lowering@cuda=1.0:7")
    obs.refresh_from_env()
    try:
        got = [r.cardinality for r in engine.execute(pool[:8],
                                                     engine="cuda")]
    finally:
        obs.disable()
    want = [r.cardinality for r in engine._execute_sequential(pool[:8])]
    assert got == want
    spans = _read(trace_path)
    by_id = {s["span_id"]: s for s in spans}
    d = [s for s in spans if s["name"] == "guard.dispatch"][-1]
    assert d["tags"]["rung_used"] == "torch"
    assert d["tags"]["demotion_chain"] == ["cuda->torch"]
    assert by_id[d["parent_id"]]["name"] == "batch.execute"


def test_snapshot_histograms_record_per_engine_latency(engine, pool):
    engine.execute(pool)                       # auto -> torch on the CPU
    engine.execute(pool[:8], engine="cuda")
    rows = obs.snapshot()["histograms"]["rb_execute_latency_seconds"]
    by = {tuple(sorted(r["labels"].items())): r for r in rows}
    t = by[(("engine", "torch"), ("site", "batch_engine"))]
    c = by[(("engine", "cuda"), ("site", "batch_engine"))]
    assert t["count"] >= 1 and c["count"] >= 1 and t["sum"] > 0
    assert t["buckets"]["+Inf"] == t["count"]


def test_sequential_landing_records_sequential_histogram(engine, pool):
    with faults.inject("lowering=1.0:0xBEEF"):
        engine.execute(pool[:4])
    rows = obs.snapshot()["histograms"]["rb_execute_latency_seconds"]
    assert any(r["labels"] == {"engine": "sequential",
                               "site": "batch_engine"} and r["count"] >= 1
               for r in rows), rows


def test_reset_snapshot_symmetry():
    baseline = obs.snapshot()
    assert baseline["counters"] == {} and baseline["histograms"] == {}
    assert baseline["trace"] == {"enabled": False, "path": None}
    obs.counter("rb_t_total", site="x").inc()
    obs.gauge("rb_g", site="x").set(3)
    obs.histogram("rb_h_seconds", site="x").observe(0.5)
    assert obs.snapshot() != baseline
    obs.reset()
    assert obs.snapshot() == baseline


def test_registry_kind_conflict_raises():
    obs.counter("rb_conflict_total", a="b")
    with pytest.raises(TypeError):
        obs.gauge("rb_conflict_total", a="b")


def test_histogram_bucket_conflict_raises():
    obs.histogram("rb_bconf_seconds", buckets=(0.1, 1.0), site="s")
    with pytest.raises(ValueError):
        obs.histogram("rb_bconf_seconds", buckets=(0.5,), site="s")
    obs.histogram("rb_bconf_seconds", buckets=(1.0, 0.1), site="s")


def test_mixed_type_label_values_stringify():
    obs.counter("rb_mixed_total", q=64).inc()
    obs.counter("rb_mixed_total", q="auto").inc()
    rows = obs.snapshot()["counters"]["rb_mixed_total"]
    assert sorted(r["labels"]["q"] for r in rows) == ["64", "auto"]
    assert "rb_mixed_total" in obs.render_prometheus()


def test_snapshot_delta_counters_and_histograms():
    before = obs.snapshot()
    obs.counter("rb_d_total").inc(2)
    h = obs.histogram("rb_d_seconds")
    h.observe(0.001)
    h.observe(0.2)
    delta = obs.snapshot_delta(before, obs.snapshot())
    assert delta["counters"]["rb_d_total"][0]["value"] == 2
    hrow = delta["histograms"]["rb_d_seconds"][0]
    assert hrow["count"] == 2 and abs(hrow["sum"] - 0.201) < 1e-9
    snap = obs.snapshot()
    assert obs.snapshot_delta(snap, snap) == {
        "counters": {}, "gauges": {}, "histograms": {}}


def test_dispatch_stats_is_a_registry_view(engine, pool):
    """``guard.dispatch_stats()`` keeps the JAX package's per-site shape
    and reads the registry's ``rb_dispatch_events_total`` counters."""
    with faults.inject("lowering@cuda=1.0:3"):
        engine.execute(pool[:4], engine="cuda")
    row = guard.dispatch_stats("batch_engine")
    assert set(row) == {"retries", "demotions", "sequential"}
    assert all(isinstance(v, int) for v in row.values())
    assert row["demotions"] == 1
    assert _counters(obs, "rb_dispatch_events_total", "site", "event")[
        ("batch_engine", "demotions")] == 1
    guard.reset_dispatch_stats()
    assert guard.dispatch_stats("batch_engine")["demotions"] == 0


def test_cache_stats_shape(engine, pool):
    engine.execute(pool[:8])
    cs = engine.cache_stats()
    assert set(cs) == {"plans", "programs", "splits"}
    assert {"size", "maxsize", "hits", "misses", "evictions"} <= set(
        cs["plans"])
    assert isinstance(cs["splits"], int)


def test_dispatch_and_cache_events_absorbed_in_registry():
    vals = _values(8, seed=13, uni=1 << 16, card=1300)
    eng = BatchEngine(DeviceBitmapSet([TRB.from_values(v) for v in vals],
                                      device=CPU), result_cache=None)
    qs = random_query_pool(8, 4)
    with faults.inject("lowering@cuda=1.0:3"):
        eng.execute(qs, engine="cuda")
    eng.execute(qs)                          # a plan-cache hit this time
    snap = obs.snapshot()
    ev = _counters(obs, "rb_dispatch_events_total", "site", "event")
    assert ev[("batch_engine", "demotions")] >= 1
    cache = {(r["labels"]["cache"], r["labels"]["event"]): r["value"]
             for r in snap["counters"]["rb_cache_events_total"]}
    assert cache[("batch_plans", "hit")] >= 1
    sizes = {r["labels"]["cache"]: r["value"]
             for r in snap["gauges"]["rb_cache_size"]}
    assert sizes["batch_plans"] >= 1


def test_guard_demotion_log_carries_structured_fields(caplog, engine, pool):
    with caplog.at_level(logging.WARNING, "roaringbitmap_tpu_torch.runtime"):
        with faults.inject("lowering@cuda=1.0:5"):
            engine.execute(pool[:2], engine="cuda")
    recs = [r for r in caplog.records
            if getattr(r, "rb_event", None) == "demote"]
    assert recs, [r.message for r in caplog.records]
    r = recs[0]
    assert (r.rb_site, r.rb_engine_from, r.rb_engine_to,
            r.rb_error_class) == ("batch_engine", "cuda", "torch",
                                  "EngineLoweringError")


def test_disabled_span_is_shared_noop():
    assert not obs.enabled()
    sp = obs.span("anything", q=64, engine="torch")
    assert sp is obs.trace._NOOP
    with sp as s:
        assert s.tag(a=1) is s
        assert s.event("x", y=2) is s
        assert s.sync("payload") == "payload"
        assert s.span_id is None


def test_bad_trace_path_fails_at_enable_not_in_queries(tmp_path,
                                                       monkeypatch):
    bad = str(tmp_path / "no" / "such" / "dir" / "t.jsonl")
    with pytest.raises(OSError):
        obs.enable(bad)
    assert not obs.enabled()
    monkeypatch.setenv("ROARING_TPU_TRACE", bad)
    obs.refresh_from_env()
    assert not obs.enabled()
    with obs.span("q"):
        pass


def test_span_nesting_and_error_status(tmp_path):
    obs.enable(str(tmp_path / "t.jsonl"))
    with pytest.raises(ValueError):
        with obs.span("outer", q=1):
            with obs.span("inner"):
                raise ValueError("boom")
    obs.disable()
    inner, outer = _read(tmp_path / "t.jsonl")
    assert inner["parent_id"] == outer["span_id"] == inner["trace_id"]
    assert inner["tags"]["status"] == "error"
    assert inner["tags"]["error_class"] == "ValueError"
    assert outer["dur_ms"] >= inner["dur_ms"] >= 0


def test_span_sync_records_sync_ms_on_a_cpu_tensor(tmp_path):
    import torch

    obs.enable(str(tmp_path / "s.jsonl"))
    x = torch.ones(4)
    with obs.span("s") as sp:
        assert sp.sync(x) is x
    obs.disable()
    (rec,) = _read(tmp_path / "s.jsonl")
    assert rec["tags"]["sync_ms"] >= 0


def test_sink_lags_by_at_most_a_flush_interval(tmp_path, monkeypatch):
    """Spans go to a buffered sink: a close within ``FLUSH_S`` of the last
    flush writes no system call, the first close after it flushes all,
    and ``disable()`` flushes what is left."""
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    monkeypatch.setattr(obs.trace, "FLUSH_S", 3600.0)
    monkeypatch.setattr(obs.trace, "_flushed", obs.trace.time.perf_counter())
    with obs.span("a"):
        pass
    assert path.read_text() == ""
    monkeypatch.setattr(obs.trace, "FLUSH_S", 0.0)
    with obs.span("b"):
        pass
    assert [s["name"] for s in _read(path)] == ["a", "b"]
    monkeypatch.setattr(obs.trace, "FLUSH_S", 3600.0)
    with obs.span("c"):
        pass
    obs.disable()
    assert [s["name"] for s in _read(path)] == ["a", "b", "c"]


def test_span_reads_no_process_id(tmp_path, monkeypatch):
    """The process id is read once (and again in a forked child), not per
    span: span ids and records carry the cached one."""
    monkeypatch.setattr(obs.trace, "_pid", obs.trace._pid)
    monkeypatch.setattr(obs.trace.os, "getpid", lambda: 0x3039)
    obs.trace._after_fork_in_child()
    monkeypatch.setattr(obs.trace.os, "getpid", lambda: 1 / 0)
    obs.enable(str(tmp_path / "t.jsonl"))
    with obs.span("s"):
        pass
    obs.disable()
    (rec,) = _read(tmp_path / "t.jsonl")
    assert rec["pid"] == 0x3039 and rec["span_id"].startswith("3039-")


def test_xprof_bridge_wraps_spans_in_profiler_ranges(tmp_path):
    """``ROARING_TPU_TRACE_XPROF`` puts each span in a
    ``torch.profiler.record_function`` range."""
    from torch.profiler import ProfilerActivity, profile

    obs.enable(str(tmp_path / "x.jsonl"), xprof=True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with obs.span("serving.dispatch"):
                pass
    finally:
        obs.enable(str(tmp_path / "y.jsonl"), xprof=False)
        obs.disable()
    assert any(e.key == "serving.dispatch" for e in prof.key_averages())


def test_aggregation_wide_span_and_histogram(tmp_path):
    bms = [TRB.from_values(v) for v in _values(6, seed=5, uni=1 << 16,
                                               card=1300)]
    obs.enable(str(tmp_path / "agg.jsonl"))
    try:
        aggregation.or_(bms, device=CPU)
    finally:
        obs.disable()
    wide = [s for s in _read(tmp_path / "agg.jsonl")
            if s["name"] == "aggregation.wide"]
    assert wide and wide[0]["tags"]["op"] == "or"
    assert wide[0]["tags"]["rung_used"] in ("cuda", "torch")
    rows = obs.snapshot()["histograms"]["rb_execute_latency_seconds"]
    assert any(r["labels"]["site"] == "aggregation" for r in rows)


def test_prometheus_render_equals_the_jax_renderer():
    for o in (obs, jobs):
        o.counter("rb_p_total", site="s").inc(3)
        o.histogram("rb_p_seconds", buckets=(0.1, 1.0),
                    site="s").observe(0.5)
    text = obs.render_prometheus()
    assert 'rb_p_total{site="s"} 3' in text
    assert 'rb_p_seconds_bucket{le="1.0",site="s"} 1' in text
    assert 'rb_p_seconds_bucket{le="+Inf",site="s"} 1' in text
    assert 'rb_p_seconds_sum{site="s"} 0.5' in text

    def mine(t):
        return [line for line in t.splitlines() if "rb_p_" in line]

    assert mine(text) == mine(jobs.render_prometheus())


def test_port_dump_of_a_real_batch_validates(tmp_path, engine, pool):
    path = tmp_path / "dump.jsonl"
    with faults.inject("lowering@cuda=1.0:7"):
        _traced(obs, path, lambda: engine.execute(pool[:4], engine="cuda"))
    ct = _load_check_trace()
    assert ct.validate(str(path)) == []
    assert ct.validate(str(path), strict_refs=True) == []


def test_cache_size_gauge_sums_across_instances():
    from roaringbitmap_tpu_torch.runtime.cache import LRUCache

    def scraped():
        rows = obs.snapshot()["gauges"].get("rb_cache_size", [])
        return {r["labels"]["cache"]: r["value"] for r in rows}

    a = LRUCache(4, name="gauge_probe")
    b = LRUCache(2, name="gauge_probe")
    for i in range(3):
        a.put(i, i)
        b.put(i, i)
    assert scraped()["gauge_probe"] == len(a) + len(b) == 5
    b.clear()
    assert scraped()["gauge_probe"] == len(a) == 3
    obs.reset()
    assert scraped()["gauge_probe"] == 3


def test_oom_split_counted_and_traced(tmp_path):
    vals = _values(8, seed=9, uni=1 << 16, card=1300)
    eng = BatchEngine(DeviceBitmapSet([TRB.from_values(v) for v in vals],
                                      device=CPU), result_cache=None)
    qs = random_query_pool(8, 8)
    want = [r.cardinality for r in eng.execute(qs, engine="torch")]
    path = tmp_path / "oom.jsonl"
    with faults.inject("oom@torch=1.0:21"):
        got = [r.cardinality for r in _traced(
            obs, path, lambda: eng.execute(qs, engine="torch"))]
    assert got == want and eng.split_count > 0
    splits = obs.snapshot()["counters"]["rb_batch_oom_splits_total"]
    assert splits[0]["value"] == eng.split_count
    evs = [e for s in _read(path) for e in s["events"]
           if e["name"] == "oom_split"]
    assert evs and evs[0]["site"] == "batch_engine"


def test_registry_updates_are_thread_safe():
    """Increments from several threads are never lost (the pump, the wire
    server and a maintenance worker share the registry)."""
    import sys
    import threading

    c = obs.counter("rb_threads_total")
    h = obs.histogram("rb_threads_seconds")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(2000):
                c.inc()
                h.observe(0.001)

        ts = [threading.Thread(target=work) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    assert c.value == 16000 and h.count == 16000
