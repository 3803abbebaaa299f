"""Cost, device time and SLO accounting of the port (``obs.cost``,
``obs.slo``): the counterparts of ``tests/test_cost_obs.py``'s cases that
apply to the port, on the CPU.

The port has no compiler cost analysis: a dispatch's cost is its plan's own
count (``insights.predict_*_word_ops`` as ``flops``, the footprint model's
bytes as ``bytes_accessed``), so the cost events are held against those
predictions.  On the CPU the peak table resolves the CPU proxy row (the JAX
package's); the H100 row is resolved from the card's name.  The JAX cases
of the bench-trajectory tools and of ``BatchEngine.explain`` have no
counterpart: the port has neither.
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest

from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.obs import cost as obs_cost
from roaringbitmap_tpu_torch.obs import slo as obs_slo
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           random_query_pool)
from roaringbitmap_tpu_torch.parallel.multiset import (MultiSetBatchEngine,
                                                       random_multiset_pool)
from roaringbitmap_tpu_torch.runtime import faults, guard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    obs.disable()
    obs.reset()
    obs.flight.configure(dir=str(tmp_path / "flight"))
    guard.reset_dispatch_stats()
    obs_cost.set_peaks(None)
    yield
    obs.disable()
    obs.reset()
    obs.flight.configure(dir=None)
    guard.reset_dispatch_stats()
    obs_cost.set_peaks(None)


def _bitmaps(n: int, seed: int, uni: int = 1 << 16, card: int = 900):
    rng = np.random.default_rng(seed)
    return [TRB.from_values(np.unique(rng.integers(0, uni, card))
                            .astype(np.uint32)) for _ in range(n)]


def _engine(n: int = 16, seed: int = 11) -> BatchEngine:
    return BatchEngine(DeviceBitmapSet(_bitmaps(n, seed), layout="dense",
                                       device=CPU), result_cache=None)


@pytest.fixture(scope="module")
def engine():
    return _engine()


@pytest.fixture(scope="module")
def pool():
    return random_query_pool(16, 64)


def _pooled(n_sets: int = 3, seed: int = 50) -> MultiSetBatchEngine:
    return MultiSetBatchEngine([DeviceBitmapSet(_bitmaps(8, seed + i),
                                                layout="dense", device=CPU)
                                for i in range(n_sets)])


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.mark.parametrize("eng_name", ["cuda", "torch", "megakernel"])
def test_cost_recorded_per_engine(engine, pool, eng_name):
    """Every rung's dispatch records achieved rates and a clamped roofline
    fraction, its cost the plan's own word ops and bytes."""
    qs = pool[:8]
    if eng_name == "megakernel":
        qs = [texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)))]
    engine.execute(qs, engine=eng_name, fallback=False)
    cost = engine.last_dispatch_cost
    plan = engine.plan(qs)
    eng = engine.last_timings["engine"]
    assert cost["device_ms"] >= 0
    assert cost["flops"] == engine._word_ops(plan, eng) > 0
    assert cost["bytes_accessed"] == engine._predict_plan(plan, eng) > 0
    assert 0.0 < cost["roofline_fraction"] <= 1.0
    assert cost["achieved_bytes_per_s"] > 0


def test_roofline_fraction_q64_and_snapshot_cost_section(engine, pool):
    engine.execute(pool)
    ms = _pooled()
    groups = random_multiset_pool([8] * 3, 24, seed=7)
    ms.execute(groups)
    # a launch that paid one-time work (its first eager run) is not
    # tracked: the tracker's rows come from warm launches
    ms.execute(groups)
    snap = obs.snapshot()["cost"]
    assert snap["peaks"]["peak_bytes_per_s"] > 0
    for site in ("batch_engine", "multiset"):
        rows = snap["sites"][site]
        assert rows, site
        for row in rows.values():
            assert row["dispatches"] >= 1
            assert row["bytes_total"] > 0 and row["flops_total"] >= 0
            assert 0.0 < row["roofline_fraction"] <= 1.0
    gauges = obs.snapshot()["gauges"]
    assert any(r["labels"]["site"] == "batch_engine"
               for r in gauges["rb_roofline_fraction"])
    assert any(r["labels"]["site"] == "multiset"
               for r in gauges["rb_achieved_bytes_per_s"])


def test_cost_reset_snapshot_symmetry_and_prometheus():
    baseline = obs.snapshot()
    assert baseline["cost"]["sites"] == {}
    _engine(8, seed=44).execute(random_query_pool(8, 8))
    assert obs.snapshot()["cost"]["sites"]
    text = obs.render_prometheus()
    for family in ("rb_roofline_fraction", "rb_achieved_bytes_per_s",
                   "rb_device_time_seconds_total", "rb_compile_seconds",
                   "rb_first_query_seconds", "rb_ingest_build_seconds"):
        assert family in text, family
    obs.reset()
    after = obs.snapshot()
    assert after["cost"] == baseline["cost"]
    assert after["counters"] == {} and after["histograms"] == {}


def test_cost_event_rides_dispatch_span(engine, pool, tmp_path):
    obs.enable(str(tmp_path / "t.jsonl"))
    try:
        engine.execute(pool[:8])
    finally:
        obs.disable()
    evs = [ev for s in _read(tmp_path / "t.jsonl")
           if s["name"] == "batch.dispatch"
           for ev in s["events"] if ev["name"] == "batch.cost"]
    assert evs and evs[0]["bytes_accessed"] > 0
    assert 0.0 < evs[0]["roofline_fraction"] <= 1.0


def test_multiset_cost_event_holds_the_plan_prediction(tmp_path):
    """A traced pooled dispatch's ``multiset.cost`` event carries the
    pool's predicted bytes and word ops (what 15b holds on the card)."""
    ms = _pooled()
    groups = random_multiset_pool([8] * 3, 12, seed=9)
    obs.enable(str(tmp_path / "m.jsonl"))
    try:
        ms.execute(groups, engine="torch")
    finally:
        obs.disable()
    (d,) = [s for s in _read(tmp_path / "m.jsonl")
            if s["name"] == "multiset.dispatch"]
    (cost,) = [e for e in d["events"] if e["name"] == "multiset.cost"]
    (mem,) = [e for e in d["events"] if e["name"] == "multiset.memory"]
    want = ms.predict_dispatch_bytes(groups, engine="torch")
    assert cost["bytes_accessed"] == mem["predicted_bytes"] == want
    plan = ms._plan_pool(ms._as_pooled(groups))
    assert cost["flops"] == ms._word_ops(plan, "torch")
    assert cost["sets"] == 3 and cost["device_ms"] > 0


def test_estimate_seconds_calibrates_to_observed(engine, pool):
    peaks = obs_cost.device_peaks()
    assert obs_cost.estimate_seconds(
        0.0, peaks["peak_bytes_per_s"]) == pytest.approx(1.0)
    engine.execute(pool[:8])
    rates = obs_cost.TRACKER.observed_rates("batch_engine", "torch")
    assert rates is not None and rates["achieved_bytes_per_s"] > 0
    assert obs_cost.estimate_seconds(
        0.0, rates["achieved_bytes_per_s"], "batch_engine",
        "torch") == pytest.approx(1.0)


def test_peak_table_resolves_the_h100_row(monkeypatch):
    """On a card named as the H100 reports itself the peaks are HBM3's
    3.35e12 B/s and the INT32 word-op rate; the CPU proxy is the JAX
    package's row."""
    import torch

    assert obs_cost.device_peaks()["peak_bytes_per_s"] == \
        jobs.cost.CPU_PROXY[2] == obs_cost.CPU_PROXY[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    obs_cost.set_peaks(None)            # drop the cached resolution
    p = obs_cost.device_peaks()
    assert p["kind"] == "NVIDIA H100 80GB HBM3"
    assert p["peak_bytes_per_s"] == 3.35e12
    assert p["peak_flops_per_s"] == 132 * 64 * 1.98e9
    obs_cost.set_peaks(None)


def test_phase_breakdown_sums_to_wall(engine, pool):
    with obs_slo.attribution():
        engine.execute(pool)
    lq = obs_slo.last_query
    assert lq["site"] == "batch_engine" and lq["engine"] != "unresolved"
    total = sum(lq["phases_ms"].values())
    assert abs(total - lq["wall_ms"]) <= 0.05 * lq["wall_ms"] + 0.5, lq
    assert {"dispatch", "sync", "readback", "other"} <= set(lq["phases_ms"])
    keys = {(r["labels"]["site"], r["labels"]["phase"])
            for r in obs.snapshot()["histograms"]["rb_phase_seconds"]}
    assert ("batch_engine", "dispatch") in keys
    assert ("batch_engine", "other") in keys


def test_slo_miss_counted_and_traced(engine, pool, tmp_path):
    policy = guard.GuardPolicy(slo_deadline_ms=1e-4)
    obs.enable(str(tmp_path / "slo.jsonl"))
    try:
        engine.execute(pool[:8], policy=policy)
    finally:
        obs.disable()
    snap = obs.snapshot()
    missed = snap["counters"]["rb_slo_missed_total"]
    assert missed[0]["labels"]["site"] == "batch_engine"
    assert missed[0]["value"] == 1
    assert "rb_slo_attained_total" not in snap["counters"]
    evs = [ev for s in _read(tmp_path / "slo.jsonl")
           if s["name"] == "batch.execute"
           for ev in s["events"] if ev["name"] == "slo"]
    assert evs and evs[0]["missed"] is True
    total = sum(evs[0]["phases_ms"].values())
    assert abs(total - evs[0]["wall_ms"]) <= 0.05 * evs[0]["wall_ms"] + 0.5


def test_slo_attained_and_reconciles_with_guard_stats(engine, pool):
    generous = guard.GuardPolicy(slo_deadline_ms=1e7)
    engine.execute(pool[:4], policy=generous)
    engine.execute(pool[:4], policy=generous)
    tight = guard.GuardPolicy(slo_deadline_ms=1e-4, backoff_base=0.0,
                              sleep=lambda s: None)
    with faults.inject("transient@torch=1.0:0xD1"):
        engine.execute(pool[:4], policy=tight)
    snap = obs.snapshot()["counters"]

    def total(name):
        return sum(r["value"] for r in snap.get(name, [])
                   if r["labels"].get("site") == "batch_engine")

    assert total("rb_slo_attained_total") == 2
    assert total("rb_slo_missed_total") == 1
    stats = guard.dispatch_stats("batch_engine")
    assert stats["retries"] > 0 or stats["demotions"] > 0
    ev = {(r["labels"]["site"], r["labels"]["event"]): r["value"]
          for r in snap["rb_dispatch_events_total"]}
    assert ev[("batch_engine", "retries")] == stats["retries"]
    assert ev.get(("batch_engine", "demotions"), 0) == stats["demotions"]


def test_multiset_slo_and_env_knob(monkeypatch):
    ms = _pooled(2, seed=60)
    monkeypatch.setenv(guard.ENV_SLO_MS, "1e-4")
    ms.execute(random_multiset_pool([8] * 2, 8, seed=3))
    monkeypatch.delenv(guard.ENV_SLO_MS)
    missed = obs.snapshot()["counters"]["rb_slo_missed_total"]
    assert any(r["labels"]["site"] == "multiset" and r["value"] >= 1
               for r in missed)


def test_queue_phase_from_enqueued_at():
    t_arrival = time.perf_counter()
    time.sleep(0.02)
    with obs_slo.query("batch_engine", deadline_ms=1e7,
                       enqueued_at=t_arrival):
        pass
    lq = obs_slo.last_query
    assert lq["phases_ms"]["queue"] >= 15.0
    assert lq["wall_ms"] >= lq["phases_ms"]["queue"]


def test_nested_query_contexts_suppressed():
    with obs_slo.attribution():
        with obs_slo.query("multiset") as outer:
            assert obs_slo.query("batch_engine") is obs_slo._NOOP
            assert outer is not obs_slo._NOOP
    assert obs_slo.last_query["site"] == "multiset"


def test_profile_on_slo_miss_env_parsing(monkeypatch):
    monkeypatch.setenv(obs_slo.ENV_PROFILE, "/tmp/x:3")
    obs_slo.refresh_from_env()
    assert (obs_slo._profile_dir, obs_slo._profile_budget) == ("/tmp/x", 3)
    monkeypatch.setenv(obs_slo.ENV_PROFILE, "/tmp/y")
    obs_slo.refresh_from_env()
    assert (obs_slo._profile_dir, obs_slo._profile_budget) == ("/tmp/y", 1)
    monkeypatch.delenv(obs_slo.ENV_PROFILE)
    obs_slo.refresh_from_env()
    assert obs_slo._profile_dir is None


def test_profile_on_slo_miss_exports_a_chrome_trace(engine, pool, tmp_path,
                                                    monkeypatch):
    """After a miss, the next query runs in a ``torch.profiler`` window
    exported as a Chrome trace under the configured directory."""
    out = tmp_path / "prof"
    monkeypatch.setenv(obs_slo.ENV_PROFILE, f"{out}:1")
    obs_slo.refresh_from_env()
    try:
        tight = guard.GuardPolicy(slo_deadline_ms=1e-4)
        engine.execute(pool[:4], policy=tight)       # the miss arms it
        engine.execute(pool[:4], policy=tight)       # profiled
        engine.execute(pool[:4], policy=tight)       # budget spent
    finally:
        monkeypatch.delenv(obs_slo.ENV_PROFILE)
        obs_slo.refresh_from_env()
    files = sorted(os.listdir(out))
    assert len(files) == 1 and files[0].startswith("slo-miss-")
    with open(out / files[0]) as f:
        assert "traceEvents" in json.load(f)


def test_compile_seconds_hit_miss_and_first_query():
    """Program lookups observe ``rb_compile_seconds``: the first dispatch
    of a plan's key is a miss, a repeat a hit; the engine's first execute
    and the set's build are exported too."""
    eng = _engine(8, seed=33)
    qs = random_query_pool(8, 8)
    eng.execute(qs)
    eng.execute(qs)
    snap = obs.snapshot()["histograms"]
    rows = {(r["labels"]["site"], r["labels"]["cache"]): r
            for r in snap["rb_compile_seconds"]}
    assert rows[("batch_engine", "miss")]["count"] >= 1
    assert rows[("batch_engine", "hit")]["count"] >= 1
    assert obs.metrics.compile_miss_total() >= 1
    assert any(r["labels"]["site"] == "batch_engine" and r["count"] == 1
               for r in snap["rb_first_query_seconds"])
    assert any(r["count"] >= 1 for r in snap["rb_ingest_build_seconds"])


def test_port_cost_and_slo_dump_validates(engine, pool, tmp_path):
    """``tools/check_trace.py`` (plain mode) accepts the port's cost and
    SLO events, including a forced miss."""
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(REPO, "tools", "check_trace.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    path = tmp_path / "cost.jsonl"
    obs.enable(str(path))
    try:
        engine.execute(pool[:8])
        engine.execute(pool[:8],
                       policy=guard.GuardPolicy(slo_deadline_ms=1e-4))
        _pooled().execute(random_multiset_pool([8] * 3, 12, seed=2))
    finally:
        obs.disable()
    assert ct.validate(str(path)) == []
    spans = [s for s in _read(path)]
    assert ct._cost_slo_semantics(spans, complete=True,
                                  require_miss=True) == []


def test_plan_cost_is_the_word_op_and_byte_model():
    cost = obs_cost.plan_cost(123, 4567)
    assert cost == {"flops": 123.0, "bytes_accessed": 4567.0,
                    "transcendentals": 0.0}
    sigs = [("or", 4, 8, 2, 3, True)]
    ops = insights.predict_batch_dispatch_word_ops(sigs, "dense", 0, "cuda")
    doc = obs_cost.record_dispatch("probe", "cuda",
                                   obs_cost.plan_cost(ops, 1 << 20), 1e-3)
    assert doc["flops"] == ops and doc["device_ms"] == 1.0
    assert doc["roofline_fraction_raw"] > 0
    untracked = obs_cost.record_dispatch(
        "probe2", "cuda", obs_cost.plan_cost(ops, 1 << 20), 1e-3,
        track=False)
    assert untracked["flops"] == ops
    assert obs_cost.TRACKER.observed_rates("probe2", "cuda") is None
