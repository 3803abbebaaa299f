"""Trace propagation, rotation, the flight recorder and statusz of the port
(``obs.trace`` / ``obs.flight`` / ``obs.statusz``): the counterparts of
``tests/test_flight.py``'s cases that apply to the port, on the CPU.

The JAX cases of the pod front door (forwarding, rerouting after a host
loss, the two-host statusz) wait for the port's mesh and pod slice; here the
serving loop's pump thread and the wire socket are the seams a request's
trace crosses.  ``statusz`` must read the port's own journal and lattice
modules even when the JAX package's are loaded too (every case here loads
both).
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from roaringbitmap_tpu.mutation import durability as jdur
from roaringbitmap_tpu.runtime import lattice as jlat
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch import serving
from roaringbitmap_tpu_torch.mutation import durability
from roaringbitmap_tpu_torch.mutation.maintenance import MaintenanceWorker
from roaringbitmap_tpu_torch.obs import flight as obs_flight
from roaringbitmap_tpu_torch.obs import statusz as obs_statusz
from roaringbitmap_tpu_torch.obs import trace as obs_trace
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery
from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
from roaringbitmap_tpu_torch.runtime import errors, faults, guard
from roaringbitmap_tpu_torch.runtime import lattice as tlat

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
NOSLEEP = guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    obs.disable()
    obs.reset()
    guard.reset_dispatch_stats()
    faults.reset_clock()
    obs_flight.configure(dir=str(tmp_path / "flight"))
    obs_flight.reset()
    yield
    obs.disable()
    obs.reset()
    obs_flight.configure(dir=None)
    obs_flight.reset()
    faults.reset_clock()


def _set(seed: int, n: int = 4) -> DeviceBitmapSet:
    rng = np.random.default_rng(seed)
    return DeviceBitmapSet([TRB.from_values(np.unique(
        rng.integers(0, 1 << 15, 600).astype(np.uint32))) for _ in range(n)],
        layout="dense", device=CPU)


@pytest.fixture(scope="module")
def tenant_sets():
    return [_set(0xF117 + i) for i in range(3)]


def _loop(tenant_sets, **kw):
    kw.setdefault("guard", NOSLEEP)
    kw.setdefault("default_deadline_ms", 300_000.0)
    return serving.ServingLoop(MultiSetBatchEngine(tenant_sets),
                               serving.ServingPolicy(**kw))


def _dumps(tmp_path) -> list:
    fdir = tmp_path / "flight"
    if not fdir.is_dir():
        return []
    return [json.loads((fdir / f).read_text())
            for f in sorted(os.listdir(fdir)) if f.startswith("flight-")]


def _check_trace():
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(REPO, "tools", "check_trace.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    return ct


def _spans(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ------------------------------------------------------ trace propagation

def test_inject_extract_roundtrip(tmp_path):
    obs.enable(str(tmp_path / "t.jsonl"))
    with obs.span("outer", site="test") as sp:
        ctx = obs_trace.inject()
        assert ctx == {"trace_id": sp.trace_id, "span_id": sp.span_id}
        assert obs_trace.extract(ctx) == (sp.trace_id, sp.span_id)
    assert obs_trace.inject() is None
    assert obs_trace.extract(None) is None
    assert obs_trace.extract({"trace_id": "x"}) is None


def test_span_from_parents_into_remote_context(tmp_path):
    path = str(tmp_path / "t.jsonl")
    obs.enable(path)
    with obs.span("origin") as sp:
        ctx = obs_trace.inject()
    with obs_trace.span_from(ctx, "continued", site="test"):
        pass
    with obs.span("local_parent"):
        with obs_trace.span_from(ctx, "nested_local") as inner:
            assert inner.trace_id != sp.trace_id
    obs.disable()
    spans = {s["name"]: s for s in _spans(path)}
    assert spans["continued"]["trace_id"] == sp.trace_id
    assert spans["continued"]["parent_id"] == sp.span_id
    assert spans["nested_local"]["parent_id"] \
        == spans["local_parent"]["span_id"]


def test_span_from_none_context_roots(tmp_path):
    obs.enable(str(tmp_path / "t.jsonl"))
    with obs_trace.span_from(None, "rootish") as sp:
        assert sp.parent_id is None and sp.trace_id == sp.span_id
    obs.disable()


def test_pump_thread_request_spans_stitch_into_admission(tenant_sets,
                                                         tmp_path):
    """Requests admitted on the caller's thread and served by a
    ``PumpDriver`` thread: each ``serving.request`` span carries its
    admission's trace id (the contextvar does not cross threads; the
    ticket's context does)."""
    path = tmp_path / "pump.jsonl"
    loop = _loop(tenant_sets, pool_target=3)
    obs.enable(str(path))
    drv = loop.start_pump(interval_s=0.002)
    try:
        tickets = [loop.submit(serving.ServingRequest(
            i % 3, BatchQuery("or", (0, 1)), tenant=f"t{i % 3}"))
            for i in range(6)]
        drv.stop(drain=True)
    finally:
        obs.disable()
    assert drv.errors == 0 and all(t.ok for t in tickets)
    spans = _spans(path)
    admits = {s["span_id"]: s for s in spans if s["name"] == "serving.admit"}
    reqs = [s for s in spans if s["name"] == "serving.request"]
    assert len(reqs) == 6
    for r in reqs:
        a = admits[r["parent_id"]]
        assert r["trace_id"] == a["trace_id"]
    assert _check_trace().validate(str(path)) == []


def test_wire_submit_stitches_client_and_server(tenant_sets, tmp_path):
    """A request over the port's own socket: ``rpc.call`` -> ``rpc.submit``
    -> ``serving.admit`` -> ``serving.request`` is one trace."""
    from roaringbitmap_tpu_torch.wire import WireClient, WireServer

    path = tmp_path / "wire.jsonl"
    loop = _loop(tenant_sets, pool_target=2)
    obs.enable(str(path))
    try:
        with WireServer(loop) as srv:
            cl = WireClient(srv.address, timeout=60)
            try:
                t = cl.submit(serving.ServingRequest(
                    1, BatchQuery("xor", (0, 2)), tenant="w"))
                res = t.value(timeout=60)
            finally:
                cl.close()
    finally:
        obs.disable()
    assert res.cardinality > 0
    spans = _spans(path)
    call = [s for s in spans if s["name"] == "rpc.call"][0]
    chain = {s["name"] for s in spans if s["trace_id"] == call["trace_id"]}
    assert {"rpc.call", "rpc.submit", "serving.admit",
            "serving.request"} <= chain
    assert _check_trace().validate(str(path)) == []


def test_maintenance_job_parents_into_submitter_trace(tmp_path):
    path = str(tmp_path / "t.jsonl")
    obs.enable(path)
    w = MaintenanceWorker(start=False)
    with obs.span("mutation.apply_delta", site="test") as sp:
        w.submit(lambda: None, kind="repack", desc="t")
    w.drain()
    obs.disable()
    job = {s["name"]: s for s in _spans(path)}["mutation.maintenance"]
    assert job["trace_id"] == sp.trace_id
    assert job["parent_id"] == sp.span_id
    assert job["tags"]["ok"] is True


def test_maintenance_failure_is_counted_and_recorded():
    w = MaintenanceWorker(start=False)

    def boom():
        raise ValueError("job failed")

    w.submit(boom, kind="repack", desc="f")
    w.drain()
    assert w.jobs_failed == 1
    rows = obs.snapshot()["counters"]["rb_maintenance_failures_total"]
    assert rows[0]["labels"] == {"error_class": "ValueError"}
    assert any(e["kind"] == "error" and e.get("job_kind") == "repack"
               for e in obs_flight._ring)


# ---------------------------------------------------------- trace rotation

def test_trace_rotation_keeps_last_n(tmp_path):
    path = str(tmp_path / "rot.jsonl")
    obs_trace.enable(path, max_bytes=2000, keep=2)
    for i in range(200):
        with obs.span("rotate_me", i=i, pad="x" * 40):
            pass
    obs.disable()
    assert os.path.exists(path) and os.path.exists(path + ".1")
    rot = obs.snapshot()["counters"].get("rb_trace_rotations_total", [])
    assert sum(r["value"] for r in rot) >= 1
    for p in (path, path + ".1"):
        for rec in _spans(p):
            assert rec["name"] == "rotate_me" and "span_id" in rec


def test_trace_rotation_env_knobs(tmp_path, monkeypatch):
    path = str(tmp_path / "env.jsonl")
    monkeypatch.setenv("ROARING_TPU_TRACE", path)
    monkeypatch.setenv("ROARING_TPU_TRACE_MAX_BYTES", "1500")
    monkeypatch.setenv("ROARING_TPU_TRACE_KEEP", "3")
    obs.refresh_from_env()
    assert obs.enabled()
    for i in range(200):
        with obs.span("rotate_env", i=i, pad="y" * 40):
            pass
    obs.disable()
    assert os.path.exists(path + ".1")


# --------------------------------------------------------- flight recorder

def test_ring_is_bounded():
    obs_flight.configure(capacity=8)
    try:
        for i in range(40):
            obs_flight.record("error", i=i)
        snap = obs_flight.snapshot()
        assert snap["capacity"] == 8 and snap["occupancy"] == 8
    finally:
        obs_flight.configure(capacity=obs_flight.DEFAULT_CAPACITY)


def test_span_closes_feed_ring_only_while_tracing(tmp_path):
    with obs.span("invisible", site="test"):
        pass
    assert not any(e.get("kind") == "span" for e in list(obs_flight._ring))
    obs.enable(str(tmp_path / "t.jsonl"))
    with obs.span("visible", site="test", error_class="Boom"):
        pass
    obs.disable()
    assert any(e.get("kind") == "span" and e["name"] == "visible"
               and e.get("site") == "test" and e.get("error_class") == "Boom"
               for e in list(obs_flight._ring))


def test_trigger_dumps_schema_valid_and_atomic(tmp_path):
    obs_flight.record("error", site="test", error_class="ValueError")
    p = obs_flight.trigger("unit_test", site="test", detail=7)
    assert p is not None and os.path.exists(p)
    assert not any(f.endswith(".tmp")
                   for f in os.listdir(tmp_path / "flight"))
    doc = json.loads(open(p).read())
    assert doc["kind"] == "rb_flight" and doc["version"] >= 1
    assert doc["trigger"] == "unit_test"
    assert doc["context"] == {"site": "test", "detail": 7}
    kinds = [e["kind"] for e in doc["events"]]
    assert "error" in kinds and "trigger" in kinds
    assert isinstance(doc["metrics_delta"], dict)
    assert _check_trace().validate(p) == []


def test_trigger_debounce_per_reason(monkeypatch):
    monkeypatch.setenv("ROARING_TPU_FLIGHT_DEBOUNCE_S", "3600")
    assert obs_flight.trigger("same_reason") is not None
    assert obs_flight.trigger("same_reason") is None
    assert obs_flight.trigger("other_reason") is not None
    sup = obs.snapshot()["counters"].get("rb_flight_suppressed_total", [])
    assert any(r["labels"].get("reason") == "same_reason"
               and r["value"] >= 1 for r in sup)


def test_slo_miss_dumps_flight(tenant_sets, tmp_path):
    loop = _loop(tenant_sets, pool_target=4, shed=False)
    t = loop.submit(serving.ServingRequest(0, BatchQuery("or", (0, 1)),
                                           tenant="late", deadline_ms=10.0))
    faults.advance_clock(0.5)
    loop.pump(force=True)
    assert t.status == "done" and t.missed is True
    miss = [d for d in _dumps(tmp_path) if d["trigger"] == "slo_miss"]
    assert miss and miss[0]["context"]["tenant"] == "late"


def test_overload_escalation_dumps_flight(tenant_sets, tmp_path):
    """The degradation ladder's escalation is an incident: a flight dump
    and a ``degrade`` record in the ring; the level is a gauge."""
    loop = _loop(tenant_sets, pool_target=2, escalate_after=1)
    for i in range(8):
        loop.submit(serving.ServingRequest(i % 3, BatchQuery("or", (0, 1)),
                                           tenant=f"t{i % 3}"))
    loop._update_ladder(loop._backlog())
    assert loop.level == 1
    over = [d for d in _dumps(tmp_path) if d["trigger"] == "overload"]
    assert over and over[0]["context"]["level_to"] == 1
    assert any(e["kind"] == "degrade" for e in obs_flight._ring)
    assert obs.gauge("rb_serving_degrade_level").value == 1
    loop.drain()


def test_crash_torn_dumps_flight(tmp_path):
    rng = np.random.default_rng(0xC4A5)
    dt = durability.DurableTenant(
        DeviceBitmapSet([TRB.from_values(np.unique(
            rng.integers(0, 1 << 14, 300).astype(np.uint32)))
            for _ in range(3)], device=CPU),
        root=str(tmp_path / "dur"), tenant="fl",
        policy=durability.FlushPolicy(mode="never"), snapshot_every=None)
    dt.apply_delta(adds={0: [4242]})
    with faults.inject("crash@torn=1.0:3"):
        with pytest.raises(errors.InjectedCrash):
            dt.apply_delta(adds={1: [4243]})
    dumps = [d for d in _dumps(tmp_path) if d["trigger"] == "crash"]
    assert dumps, "crash@torn left no flight dump"
    assert dumps[0]["context"]["mode"] == "torn"
    assert dumps[0]["context"]["point"] in ("pre_append", "pre_apply",
                                            "post_apply")
    assert any(e["kind"] == "error" for e in dumps[0]["events"])


def test_disabled_tracer_stays_noop_with_ring_armed():
    obs_flight.record("error", site="test")
    assert obs.span("probe", q=1) is obs.trace._NOOP
    assert obs.trace._on_close is not None


# ----------------------------------------------------------------- statusz

def test_merge_counters_is_monotone_and_idempotent():
    a = {"rb_x_total": [{"labels": {"site": "a"}, "value": 3}],
         "rb_y_total": [{"labels": {}, "value": 10}]}
    b = {"rb_x_total": [{"labels": {"site": "a"}, "value": 5}],
         "rb_z_total": [{"labels": {}, "value": 1}]}
    merged = obs_statusz.merge_counters([a, b])
    assert merged["rb_x_total"][0]["value"] == 5
    assert merged["rb_y_total"][0]["value"] == 10
    assert merged["rb_z_total"][0]["value"] == 1
    assert obs_statusz.merge_counters([b, a, b]) == merged
    assert obs_statusz.merge_counters([merged, a, b]) == merged


def test_merge_same_host_newest_wins():
    d1 = {"kind": "rb_statusz", "version": 1, "merged": False,
          "host": "0", "pid": 1, "t": 1.0, "obs": {"counters": {}},
          "flight": {}, "sections": {"serving": {"level": 0}}}
    d2 = dict(d1, t=2.0, sections={"serving": {"level": 2}})
    m = obs_statusz.merge([d1, d2])
    assert m["hosts"]["0"]["sections"]["serving"]["level"] == 2
    m2 = obs_statusz.merge([m, d1, d2])
    assert m2["hosts"]["0"] == m["hosts"]["0"]
    assert m2["counters"] == m["counters"]


def test_statusz_carries_journal_and_flight_sections(tmp_path):
    rng = np.random.default_rng(0x57A7)
    dt = durability.DurableTenant(
        DeviceBitmapSet([TRB.from_values(np.unique(
            rng.integers(0, 1 << 14, 300).astype(np.uint32)))
            for _ in range(3)], device=CPU),
        root=str(tmp_path / "dur"), tenant="sz",
        policy=durability.FlushPolicy(mode="never"), snapshot_every=None)
    dt.apply_delta(adds={0: [77]})
    obs_flight.trigger("statusz_test")
    doc = obs_statusz.local_doc(host="h0")
    tenants = {t["tenant"]: t for t in doc["journal"]}
    assert "sz" in tenants
    assert tenants["sz"]["unflushed_bytes"] > 0
    assert tenants["sz"]["snapshot_age_s"] >= 0.0
    assert any(r["reason"] == "statusz_test"
               for r in doc["flight"]["recent_triggers"])
    assert _check_trace().validate_doc(doc, "doc") == []
    dt.close()


def test_statusz_reads_the_ports_modules_not_the_jax_packages(tmp_path):
    """With both packages loaded, the port's statusz reports the port's
    lattice and journals only, and the JAX package's its own."""
    from roaringbitmap_tpu import obs as jobs

    rng = np.random.default_rng(0x5EED)
    jset = None
    from roaringbitmap_tpu import RoaringBitmap as JRB
    from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JS

    vals = [np.unique(rng.integers(0, 1 << 14, 300).astype(np.uint32))
            for _ in range(3)]
    jset = JS([JRB.from_values(v) for v in vals])
    jdt = jdur.DurableTenant(jset, root=str(tmp_path / "j"), tenant="jax",
                             policy=jdur.FlushPolicy(mode="never"),
                             snapshot_every=None)
    tdt = durability.DurableTenant(
        DeviceBitmapSet([TRB.from_values(v) for v in vals], device=CPU),
        root=str(tmp_path / "t"), tenant="port",
        policy=durability.FlushPolicy(mode="never"), snapshot_every=None)
    jlat.activate("q=4,;rows=8,;keys=2,")
    try:
        doc = obs_statusz.local_doc(host="h")
        assert [t["tenant"] for t in doc["journal"]] == ["port"]
        assert "lattice" not in doc            # only the JAX one is active
        tlat.activate("q=4,;rows=8,;keys=2,")
        assert obs_statusz.local_doc(host="h")["lattice"]["sealed"] is False
        jdoc = jobs.statusz.local_doc(host="h")
        assert [t["tenant"] for t in jdoc["journal"]] == ["jax"]
    finally:
        jlat.deactivate()
        tlat.deactivate()
        jdt.close()
        tdt.close()


def test_statusz_markdown_of_a_serving_loop(tenant_sets):
    """``obs.statusz()`` and a loop's snapshot as the serving section
    render the JAX package's markdown page, and the documents validate."""
    loop = _loop(tenant_sets, pool_target=2)
    for i in range(3):
        loop.submit(serving.ServingRequest(i, BatchQuery("or", (0, 1))))
    loop.drain()
    top = obs.statusz()
    assert top["kind"] == "rb_statusz" and top["merged"] is True
    doc = obs_statusz.merge([obs_statusz.local_doc(
        sections={"serving": loop.snapshot()})])
    page = obs.render_markdown(doc)
    assert page.startswith("# roaring-tpu statusz")
    assert "- serving: level=0" in page and "- flight: ring" in page
    ct = _check_trace()
    assert ct.validate_doc(top, "top") == []
    assert ct.validate_doc(doc, "doc") == []
