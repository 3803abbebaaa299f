"""Device-memory observability of the port (``obs.memory``: the HBM ledger,
dispatch measurement, the allocator reads) and the insights that read the
ledger or the spans: the counterparts of ``tests/test_memory_obs.py``'s
cases that apply to the port, on the CPU.

Resident bytes are stated in the port's own units: a dense set counts what
the JAX set counts (its image and index tensors), a compact or counts set
2 bytes a value more (the port keeps its value stream as int32, the JAX
package as u16).  On the CPU no peak is measured (the allocator's peak is
a card statistic), so the dispatch events carry the prediction alone.  The
JAX cases of ``explain`` / ``explain_wide`` / ``explain_sharded`` and of
``tools/bench_diff.py`` have no counterpart in the port.
"""

import gc
import json

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.insights import analysis as jins
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import multiset as jms
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.bsi import DeviceBSI, RoaringBitmapSliceIndex
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.mutation import ResultCache
from roaringbitmap_tpu_torch.obs import memory as obs_memory
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import (DeviceBitmapSet,
                                                          DevicePairSet)
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           random_query_pool)
from roaringbitmap_tpu_torch.parallel.multiset import (MultiSetBatchEngine,
                                                       random_multiset_pool)
from roaringbitmap_tpu_torch.runtime import faults, guard

CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.disable()
        o.reset()
    guard.reset_dispatch_stats()
    yield
    for o in (obs, jobs):
        o.disable()
        o.reset()
    guard.reset_dispatch_stats()


def _values(n: int = 16, seed: int = 7, uni: int = 1 << 18,
            card: int = 3000) -> list:
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, uni, card)).astype(np.uint32)
            for _ in range(n)]


@pytest.fixture(scope="module")
def vals():
    return _values()


@pytest.fixture(scope="module")
def bitmaps(vals):
    return [TRB.from_values(v) for v in vals]


@pytest.fixture(scope="module")
def engine(bitmaps):
    return BatchEngine(DeviceBitmapSet(bitmaps, layout="dense", device=CPU),
                       result_cache=None)


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


# ----------------------------------------------------------------- ledger

class TestLedger:
    def test_register_release_symmetry(self):
        led = obs_memory.HbmLedger()
        baseline = led.snapshot()
        assert baseline == {"total_bytes": 0, "entries": 0, "by_kind": {}}
        h1 = led.register("bitmap_set", "dense", 1000)
        h2 = led.register("bitmap_set", "counts", 500)
        h3 = led.register("pair_set", "dense", 250)
        snap = led.snapshot()
        assert snap["total_bytes"] == 1750 and snap["entries"] == 3
        assert snap["by_kind"]["bitmap_set"] == {"dense": 1000,
                                                 "counts": 500}
        assert led.resident_bytes("bitmap_set") == 1500
        assert led.resident_bytes("bitmap_set", "counts") == 500
        led.release(h2)
        led.release(h2)   # idempotent: GC finalizer after manual release
        assert led.snapshot()["total_bytes"] == 1250
        led.release(h1)
        led.release(h3)
        assert led.snapshot() == baseline
        led.register("bitmap_set", "dense", 1)
        led.reset()
        assert led.snapshot() == baseline

    def test_pulled_registration_follows_its_owner(self):
        """A function registration reads its owner through a weak
        reference, recounts when the stamp moves, and leaves with it."""
        class Owner:
            nbytes, version = 100, 0

        led = obs_memory.HbmLedger()
        o = Owner()
        led.register("result_cache", "device", lambda x: x.nbytes, owner=o,
                     stamp=lambda x: x.version)
        assert led.resident_bytes() == 100
        o.nbytes = 300                   # stamp unchanged: cached
        assert led.resident_bytes() == 100
        o.version = 1
        assert led.resident_bytes() == 300
        with pytest.raises(ValueError):
            led.register("x", "y", lambda x: 1)          # no owner
        del o
        gc.collect()
        assert led.snapshot() == {"total_bytes": 0, "entries": 0,
                                  "by_kind": {}}

    def test_owner_gc_releases(self, bitmaps):
        """The set's own bytes arrive and leave: deltas around this set,
        never a global zero (other tests' sets may be resident)."""
        led = obs_memory.LEDGER
        gc.collect()
        before = led.resident_bytes("bitmap_set", "counts")
        ds = DeviceBitmapSet(bitmaps[:4], layout="counts", device=CPU)
        held = ds.hbm_bytes()
        assert led.resident_bytes("bitmap_set", "counts") == before + held
        del ds
        gc.collect()
        assert led.resident_bytes("bitmap_set", "counts") == before

    def test_repack_moves_the_registration_to_the_new_layout(self, bitmaps):
        led = obs_memory.LEDGER
        ds = DeviceBitmapSet(bitmaps[:4], layout="compact", device=CPU)
        compact0 = led.resident_bytes("bitmap_set", "compact")
        dense0 = led.resident_bytes("bitmap_set", "dense")
        held = ds.hbm_bytes()
        ds.apply_delta(adds={0: [5]}, repack="always")
        gc.collect()
        assert ds.layout in ("dense", "counts")
        assert led.resident_bytes("bitmap_set", "compact") \
            == compact0 - held
        assert led.resident_bytes("bitmap_set", ds.layout) \
            - (dense0 if ds.layout == "dense" else 0) >= ds.hbm_bytes() > 0
        del ds
        gc.collect()

    def test_residents_of_every_kind_register(self, bitmaps, vals):
        led = obs_memory.LEDGER
        gc.collect()
        snap0 = led.snapshot()
        ps = DevicePairSet([(bitmaps[0], bitmaps[1])], device=CPU)
        ids = np.unique(np.concatenate(vals[:2]))[:400]
        col = BsiColumn("p", ids, ids % 97, device=CPU)
        dbsi = DeviceBSI(RoaringBitmapSliceIndex.from_pairs(ids, ids % 53),
                         device=CPU)
        cache = ResultCache(1 << 20)
        by = led.snapshot()["by_kind"]
        assert by["pair_set"]["dense"] - snap0["by_kind"].get(
            "pair_set", {}).get("dense", 0) == ps.hbm_bytes() > 0
        assert by["bsi_column"]["dense"] >= col.hbm_bytes() > 0
        assert by["bsi"]["dense"] >= dbsi.hbm_bytes() > 0
        assert "device" in by["result_cache"]
        del ps, col, dbsi, cache
        gc.collect()
        assert led.snapshot()["total_bytes"] == snap0["total_bytes"]

    def test_resident_gauges_exported(self, bitmaps):
        ds = DeviceBitmapSet(bitmaps[:4], layout="dense", device=CPU)
        rows = obs.snapshot()["gauges"]["rb_hbm_resident_bytes"]
        dense = [r for r in rows if r["labels"] == {"kind": "bitmap_set",
                                                    "layout": "dense"}]
        assert dense and dense[0]["value"] >= ds.hbm_bytes()
        assert "hbm" in obs.snapshot()
        assert "rb_hbm_resident_bytes" in obs.render_prometheus()


# ------------------------------------------------- unified footprint model

class TestFootprintModel:
    @pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
    def test_predictor_matches_measured(self, bitmaps, layout):
        predicted = insights.predict_resident_bytes(bitmaps, layout=layout,
                                                    device=CPU)
        ds = DeviceBitmapSet(bitmaps, layout=layout, device=CPU)
        measured = insights.resident_set_bytes(ds)
        assert predicted == measured
        assert sum(predicted.values()) == ds.hbm_bytes()

    @pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
    def test_predictor_against_the_jax_model(self, vals, bitmaps, layout):
        """The same components as the JAX model; a dense set's bytes equal
        it off the card, and on the card add the streams and B7's plan it
        keeps where its or/xor reads them; a compact or counts set's
        streams count 2 bytes a value more (int32 against u16) and its
        counts the nibble tensor alone; a counts set's metadata holds B7's
        per-key plan besides, which the JAX package has no kernel for."""
        tp = insights.predict_resident_bytes(bitmaps, layout=layout,
                                             device=CPU)
        jp = jins.predict_resident_bytes([JRB.from_values(v) for v in vals],
                                         layout=layout)
        assert set(tp) == set(jp)
        if layout == "dense":
            assert tp == jp
            card = insights.predict_resident_bytes(bitmaps, layout=layout)
            assert card["words"] == jp["words"]
            assert card["streams"] > 0 and card["meta"] > jp["meta"]
            return
        n_values = sum(int(b.cardinality) for b in bitmaps)
        plan = (DeviceBitmapSet(bitmaps, layout="counts",
                                device=CPU)._stream_plan.nbytes()
                if layout == "counts" else 0)
        assert tp["meta"] == jp["meta"] + plan
        assert tp["chunks"] == jp["chunks"]
        assert 0 < tp["streams"] - jp["streams"] <= 2 * n_values
        if layout == "counts":
            assert tp["counts"] <= jp["counts"]

    def test_footprint_shares_row_constant(self, vals, bitmaps):
        rb = bitmaps[0]
        assert insights.hbm_footprint_bytes(rb) == \
            rb.container_count() * insights.ROW_BYTES == \
            jins.hbm_footprint_bytes(JRB.from_values(vals[0]))
        assert insights.dense_rows_bytes(3) == 3 * insights.ROW_BYTES

    def test_delta_patch_bytes_equal_the_jax_model(self):
        for p in (0, 1, 37):
            assert insights.predict_delta_patch_bytes(p) == \
                jins.predict_delta_patch_bytes(p)

    def test_expr_node_report_equals_the_jax_report(self, vals, engine):
        """Per-node EXPLAIN rows of the same compiled sections equal the
        JAX package's, row for row."""
        je = JEngine(JSet([JRB.from_values(v) for v in vals],
                          layout="dense"), result_cache=None)
        tq = [texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)),
                              form="bitmap"),
              texpr.ExprQuery(texpr.xor(texpr.or_(3, 4),
                                        texpr.andnot(5, 0)))]
        jq = [jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1), jexpr.not_(2)),
                              form="bitmap"),
              jexpr.ExprQuery(jexpr.xor(jexpr.or_(3, 4),
                                        jexpr.andnot(5, 0)))]
        tsig = engine.plan(tq).expr_signature
        jsig = je.plan(jq).expr_signature
        assert tsig == jsig
        for t, j in zip(tsig, jsig):
            rows = insights.expr_node_report(t)
            assert rows == jins.expr_node_report(j) and rows
            assert all(r["est_bytes"] >= 0 and r["est_word_ops"] >= 0
                       for r in rows)

    @pytest.mark.parametrize("budget", [512 << 20, 1 << 20, 1 << 12])
    def test_recommend_device_layout_equals_the_jax_advice(self, vals,
                                                           budget):
        """The same layout and byte counts; only the ``why`` prose differs
        (the JAX text quotes TPU query costs)."""
        tb = [TRB.from_values(v) for v in vals]
        jb = [JRB.from_values(v) for v in vals]
        t = insights.recommend_device_layout(tb, budget)
        j = jins.recommend_device_layout(jb, budget)
        assert t.pop("why") and j.pop("why")
        assert t == j

    def test_recommend_lattice_reads_a_port_dump(self, tmp_path, vals,
                                                 engine):
        """The same traffic traced through each package gives the same
        recommended profile, and each recommender reads the other
        package's dump alike."""
        pool = random_query_pool(16, 12, seed=4)
        tenants = [_values(4, seed=90 + i, uni=1 << 16, card=900)
                   for i in range(3)]
        tms = MultiSetBatchEngine([DeviceBitmapSet(
            [TRB.from_values(v) for v in t], layout="dense", device=CPU)
            for t in tenants])
        jm = jms.MultiSetBatchEngine.from_bitmap_sets(
            [[JRB.from_values(v) for v in t] for t in tenants],
            layout="dense")
        mpool = random_multiset_pool([4] * 3, 9, seed=8)
        je = JEngine(JSet([JRB.from_values(v) for v in vals],
                          layout="dense"), result_cache=None)
        expr_q = [texpr.ExprQuery(texpr.and_(texpr.or_(0, 1),
                                             texpr.not_(2)))]
        tpath, jpath = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
        obs.enable(str(tpath))
        try:
            engine.execute(pool + expr_q, engine="torch")
            tms.execute(mpool, engine="torch")
        finally:
            obs.disable()
        jobs.enable(str(jpath))
        try:
            je.execute([JQ(q.op, q.operands, form=q.form) for q in pool]
                       + [jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1),
                                                     jexpr.not_(2)))],
                       engine="xla")
            jm.execute([jms.BatchGroup(g.set_id, [
                JQ(q.op, q.operands, form=q.form) for q in g.queries])
                for g in mpool], engine="xla")
        finally:
            jobs.disable()
        rec = insights.recommend_lattice(str(tpath))
        assert rec == jins.recommend_lattice(str(jpath))
        assert rec == jins.recommend_lattice(str(tpath))
        assert rec["observed"]["q"] and rec["observed"]["pool_rows"]
        assert rec["observed"]["expr_depths"] == [2]
        assert rec["points"] > 0


# ---------------------------------------------------- predicted vs actual

class TestDispatchMemory:
    def test_prediction_recorded_without_a_cpu_measurement(self, engine):
        pool = random_query_pool(16, 64)
        engine.execute(pool)
        mem = engine.last_dispatch_memory
        assert mem["q"] == 64 and mem["predicted_bytes"] > 0
        assert "measured_peak_bytes" not in mem
        g = obs.snapshot()["gauges"]
        assert g["rb_hbm_predicted_bytes"][0]["value"] == \
            mem["predicted_bytes"]
        assert "rb_hbm_measured_peak_bytes" not in g

    def test_batch_memory_event_in_trace(self, engine, tmp_path):
        path = str(tmp_path / "trace.jsonl")
        obs.enable(path)
        engine.execute(random_query_pool(16, 8))
        obs.disable()
        evs = [ev for s in _read(path) if s["name"] == "batch.dispatch"
               for ev in s["events"] if ev["name"] == "batch.memory"]
        assert evs and evs[0]["predicted_bytes"] > 0

    def test_measured_peak_and_residual(self):
        doc = obs_memory.record_dispatch("probe", 1000, {"peak_bytes": 400})
        assert doc == {"predicted_bytes": 1000, "measured_peak_bytes": 400,
                       "residual_x": 0.4}

    def test_peak_window_and_allocator_reads_are_card_only(self):
        with obs_memory.PeakWindow("cpu") as w:
            pass
        assert w.peak() is None
        assert obs_memory.backend_free_bytes("cpu") is None
        assert obs_memory.backend_memory_stats("cpu") is None
        assert guard.resolve_hbm_budget(guard.GuardPolicy(),
                                        "cpu") is None


# ------------------------------------------------------- proactive splits

class TestProactiveSplit:
    def test_budget_splits_before_dispatch_bit_exact(self, bitmaps,
                                                     tmp_path):
        eng = BatchEngine(DeviceBitmapSet(bitmaps, device=CPU),
                          result_cache=None)
        pool = random_query_pool(16, 64, seed=0xB4)
        clean = [r.cardinality for r in eng.execute(pool)]
        assert eng.proactive_split_count == 0
        budget = eng.predict_dispatch_bytes(pool) // 4
        path = str(tmp_path / "trace.jsonl")
        obs.enable(path)
        policy = guard.GuardPolicy(hbm_budget=budget)
        split = [r.cardinality for r in eng.execute(pool, policy=policy)]
        obs.disable()
        assert split == clean
        assert eng.proactive_split_count > 0 and eng.split_count == 0
        snap = obs.snapshot()
        pro = snap["counters"]["rb_batch_proactive_splits_total"]
        assert pro[0]["value"] == eng.proactive_split_count
        assert "rb_batch_oom_splits_total" not in snap["counters"]
        spans = _read(path)
        mems = [ev for s in spans if s["name"] == "batch.dispatch"
                for ev in s["events"] if ev["name"] == "batch.memory"]
        assert mems and all(ev["predicted_bytes"] <= budget for ev in mems)
        splits = [ev for s in spans for ev in s["events"]
                  if ev["name"] == "proactive_split"]
        assert len(splits) == eng.proactive_split_count
        assert all(ev["predicted_bytes"] > ev["budget_bytes"]
                   for ev in splits)

    def test_budget_env_knob(self, bitmaps, monkeypatch):
        eng = BatchEngine(DeviceBitmapSet(bitmaps[:8], device=CPU),
                          result_cache=None)
        pool = random_query_pool(8, 32, seed=0xE2)
        clean = [r.cardinality for r in eng.execute(pool)]
        monkeypatch.setenv(guard.ENV_HBM_BUDGET,
                           str(eng.predict_dispatch_bytes(pool) // 3))
        got = [r.cardinality for r in eng.execute(pool)]
        assert got == clean and eng.proactive_split_count > 0

    def test_budget_unlimited_values(self):
        assert guard.parse_bytes("0") == 0
        assert guard.parse_bytes("64M") == 64 << 20
        assert guard.parse_bytes("2g") == 2 << 30
        with pytest.raises(ValueError):
            guard.parse_bytes("lots")
        assert guard.resolve_hbm_budget(
            guard.GuardPolicy(hbm_budget=0)) is None

    def test_budget_composes_with_oom_faults(self, bitmaps):
        eng = BatchEngine(DeviceBitmapSet(bitmaps, device=CPU),
                          result_cache=None)
        pool = random_query_pool(16, 16, seed=0x00F)
        clean = [r.cardinality for r in eng.execute(pool)]
        policy = guard.GuardPolicy(
            hbm_budget=eng.predict_dispatch_bytes(pool) // 3)
        with faults.inject("oom@torch=1.0:5"):
            got = [r.cardinality for r in eng.execute(pool, policy=policy)]
        assert got == clean
        assert eng.proactive_split_count > 0 and eng.split_count > 0
        assert set(eng.cache_stats()) == {"plans", "programs", "splits"}
