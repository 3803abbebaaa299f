"""The port's mesh-sharded batch engine against
roaringbitmap_tpu.parallel.sharded_engine.

Three tenants (8, 6 and 8 bitmaps: sparse uniform, a shared dense chunk,
run-heavy) are built from one numpy seed in both packages.  The JAX engine
runs on the conftest's 8 virtual CPU devices, the port on a CPU mesh of the
same shape: "cpu" repeated (the shards of one device share the placed image
and split a group's rows by position) or "cpu:0".."cpu:7" (distinct
devices: each shard holds its own row shard and reduces the rows it owns).
Held exact: every result's cardinality and members against the JAX engine
and the host oracle, the plan's padded flat rows and op groups, split
counts and the footprint model's numbers, the combine-mode B5 streams, the
guard ladder and the observability vocabulary."""

import json

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.insights import analysis as jins
from roaringbitmap_tpu.parallel import BatchEngine as JEng
from roaringbitmap_tpu.parallel import BatchGroup as JGroup
from roaringbitmap_tpu.parallel import BatchQuery as JQ
from roaringbitmap_tpu.parallel import ShardedBatchEngine as JSharded
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.runtime import lattice as jlat
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.obs import memory as obs_memory
from roaringbitmap_tpu_torch.parallel import (BatchEngine, BatchGroup,
                                              BatchQuery, MultiSetBatchEngine,
                                              ShardedBatchEngine, default_mesh,
                                              expr)
from roaringbitmap_tpu_torch.parallel.sharding import Mesh
from roaringbitmap_tpu_torch.runtime import errors, faults, guard
from roaringbitmap_tpu_torch.runtime import lattice as tlat
from roaringbitmap_tpu_torch.runtime import warmup as twarm

torch.set_num_threads(2)

S_SIZES = (8, 6, 8)
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("ROARING_TPU_FAULTS", raising=False)
    obs.disable()
    obs.reset()
    guard.reset_dispatch_stats()
    tlat.deactivate()
    jlat.deactivate()
    yield
    obs.disable()
    obs.reset()
    tlat.deactivate()
    jlat.deactivate()


def _jmesh(rows, data=1):
    return JMesh(np.array(jax.devices()[:rows * data]).reshape(rows, data),
                 ("rows", "data"))


def _tmesh(rows, data=1, distinct=False):
    devs = ([f"cpu:{i}" for i in range(rows * data)] if distinct
            else [CPU] * (rows * data))
    return Mesh(np.array(devs).reshape(rows, data), ("rows", "data"))


def _values():
    rng = np.random.default_rng(0x5AAD)
    out = []
    for s, n in enumerate(S_SIZES):
        vals = []
        for i in range(n):
            v = [rng.integers(0, 1 << 17, 2000).astype(np.uint32)]
            if s == 1 and i % 2 == 0:
                v.append(np.arange(1 << 16, (1 << 16) + 9000,
                                   dtype=np.uint32))
            if s == 2:
                start = int(rng.integers(0, 1 << 16))
                v.append(np.arange(start, start + 1500, dtype=np.uint32))
            vals.append(np.unique(np.concatenate(v)))
        out.append(vals)
    return out


@pytest.fixture(scope="module")
def tenant_values():
    return _values()


@pytest.fixture(scope="module")
def engines(tenant_values):
    return [BatchEngine.from_bitmaps([TRB.from_values(v) for v in t],
                                     layout="dense", device=CPU)
            for t in tenant_values]


@pytest.fixture(scope="module")
def jengines(tenant_values):
    return [JEng.from_bitmaps([JRB.from_values(v) for v in t],
                              layout="dense") for t in tenant_values]


def _pool(expr_too: bool = True):
    groups = []
    for sid, n in enumerate(S_SIZES):
        qs = [BatchQuery("or", (0, 1, 2), form="bitmap"),
              BatchQuery("and", (1, 2, 3), form="bitmap"),
              BatchQuery("xor", (0, 2, 4), form="bitmap"),
              BatchQuery("andnot", (0, 1, 3), form="bitmap"),
              BatchQuery("or", tuple(range(n)), form="bitmap")]
        if expr_too:
            qs.append(expr.ExprQuery(expr.and_(expr.or_(0, 1),
                                               expr.not_(2)), form="bitmap"))
            qs.append(expr.ExprQuery(expr.xor(expr.andnot(3, 4),
                                              expr.or_(0, 5))))
        groups.append(BatchGroup(sid, qs))
    return groups


def _jq(q):
    if isinstance(q, expr.ExprQuery):
        return jexpr.ExprQuery(_jexpr(q.expr), form=q.form)
    return JQ(q.op, q.operands, form=q.form)


def _jexpr(e):
    if isinstance(e, expr.Ref):
        return jexpr.ref(e.index)
    return jexpr.Node(e.op, tuple(_jexpr(c) for c in e.children))


def _jpool(pool):
    return [JGroup(g.set_id, [_jq(q) for q in g.queries]) for g in pool]


@pytest.fixture(scope="module")
def oracle(engines):
    return [[engines[g.set_id]._sequential_result(q) for q in g.queries]
            for g in _pool()]


def _exact(got, want, tag):
    assert len(got) == len(want)
    for gi, (grows, wrows) in enumerate(zip(got, want)):
        assert len(grows) == len(wrows)
        for qi, (a, b) in enumerate(zip(grows, wrows)):
            assert a.cardinality == b.cardinality, (tag, gi, qi)
            if b.bitmap is not None:
                assert a.bitmap is not None, (tag, gi, qi)
                assert a.bitmap.serialize() == b.bitmap.serialize(), (
                    tag, gi, qi)


@pytest.mark.parametrize("shape,placement,distinct", [
    ((1, 1), "sharded", False),
    ((2, 1), "sharded", False),
    ((4, 1), "sharded", True),
    ((8, 1), "sharded", False),
    ((2, 2), "sharded", True),
    ((4, 1), "replicated", False),
    ((4, 2), "replicated", False),
])
def test_sharded_matches_single_device(engines, jengines, oracle, shape,
                                       placement, distinct):
    """The (op x mesh shape x placement) matrix, flat and expression
    queries: the port equals the host oracle and the JAX engine, guarded
    and raw, and its plan pads the flat rows as the JAX plan does."""
    pool = _pool()
    eng = ShardedBatchEngine(engines, mesh=_tmesh(*shape, distinct=distinct),
                             placement=placement)
    assert eng._position_split() == (not distinct or placement
                                     == "replicated")
    _exact(eng.execute(pool), oracle, (shape, placement))
    _exact(eng.execute(pool, fallback=False), oracle, (shape, "raw"))
    je = JSharded(jengines, mesh=_jmesh(*shape), placement=placement)
    jgot = je.execute(_jpool(pool))
    for grows, jrows in zip(eng.execute(pool), jgot):
        assert [r.cardinality for r in grows] == [r.cardinality
                                                  for r in jrows]
    pooled, _ = eng._single._flatten(pool)
    jpooled, _ = je._single._flatten(_jpool(pool))
    tp, jp = eng._plan(tuple(pooled)), je._plan(tuple(jpooled))
    assert tp.n_pads == jp.n_pads
    assert [g.sig for g in tp.op_groups] == [g.sig for g in jp.op_groups]
    assert eng.pool_rows == je.pool_rows
    assert eng.shard_balance == pytest.approx(je.shard_balance)


def test_and_on_a_segment_only_some_shards_hold():
    """AND over keys whose rows sit on one row shard only: the other
    shards hold no row of that segment and must contribute the AND
    identity to the butterfly, not zeros."""
    rng = np.random.default_rng(12)
    common = np.arange(0, 1 << 18, 3, dtype=np.uint32)
    sets = [[TRB.from_values(np.unique(np.concatenate(
        [common, rng.integers(0, 1 << 18, 4000).astype(np.uint32)])))
        for _ in range(3)] for _t in range(2)]
    engines = [BatchEngine.from_bitmaps(s, layout="dense", device=CPU)
               for s in sets]
    pool = [BatchGroup(t, [BatchQuery("and", (0, 1, 2), form="bitmap")])
            for t in range(2)]
    want = [[engines[t]._sequential_result(q) for q in g.queries]
            for t, g in enumerate(pool)]
    assert want[0][0].cardinality > 0
    for shape in ((2, 1), (4, 1), (8, 1), (2, 2)):
        for distinct in (False, True):
            eng = ShardedBatchEngine(engines,
                                     mesh=_tmesh(*shape, distinct=distinct),
                                     placement="sharded")
            _exact(eng.execute(pool, fallback=False), want,
                   (shape, distinct))


def test_results_do_not_depend_on_the_mesh_shape(engines, oracle):
    """1x1, 2x1, 4x1, 8x1, 2x2 and 4x2 give identical results, in both
    split modes."""
    pool = _pool()
    for shape in ((1, 1), (2, 1), (4, 1), (8, 1), (2, 2), (4, 2)):
        for distinct in (False, True):
            eng = ShardedBatchEngine(engines,
                                     mesh=_tmesh(*shape, distinct=distinct),
                                     placement="sharded")
            _exact(eng.execute(pool, fallback=False), oracle,
                   (shape, distinct))


def test_single_set_query_sugar(engines, jengines):
    eng = ShardedBatchEngine(engines[0], mesh=_tmesh(4))
    je = JSharded(jengines[0], mesh=_jmesh(4))
    qs = [BatchQuery("or", (0, 1, 2), form="bitmap"),
          BatchQuery("andnot", (0, 3, 4)), BatchQuery("and", (1, 2)),
          BatchQuery("xor", (0, 5), form="bitmap")]
    got = eng.execute(qs)
    jgot = je.execute([JQ(q.op, q.operands, form=q.form) for q in qs])
    assert [r.cardinality for r in got] == [r.cardinality for r in jgot]
    assert got[0].bitmap.serialize() == jgot[0].bitmap.serialize()
    assert got[3].bitmap.serialize() == jgot[3].bitmap.serialize()


def test_mesh_demotes_to_single_device_then_sequential(engines, oracle):
    """The mesh -> single -> sequential ladder under injected faults:
    bit-exact every way, demotions counted as the JAX package counts
    them."""
    pool = _pool()
    eng = ShardedBatchEngine(engines, mesh=_tmesh(4))
    with faults.inject("lowering@mesh=1.0:0xD1"):
        got = eng.execute(pool)
    _exact(got, oracle, "mesh->single")
    stats = guard.dispatch_stats("sharded_engine")
    assert stats["demotions"] >= 1 and stats["sequential"] == 0
    guard.reset_dispatch_stats()
    with faults.inject("lowering=1.0:0xD2"):
        got = eng.execute(pool)
    _exact(got, oracle, "sequential-floor")
    assert guard.dispatch_stats("sharded_engine")["sequential"] >= 1
    with faults.inject("oom@mesh=0.5:0xD3"):
        got = eng.execute(pool)
    _exact(got, oracle, "oom")
    guard.reset_dispatch_stats()
    with faults.inject("transient@mesh=1.0:0xD4"):
        got = eng.execute(pool, policy=guard.GuardPolicy(
            backoff_base=0.0, sleep=lambda s: None))
    _exact(got, oracle, "transient")
    st = guard.dispatch_stats("sharded_engine")
    assert st["retries"] >= 1 and st["demotions"] == 1


def test_card_chain_holds_kernel_rungs_only(engines, monkeypatch):
    """On a CUDA device the sharded chain is mesh -> single, with no host
    rung: a fault both rungs fail to absorb raises typed."""
    assert guard.chain_from(guard.MESH, (guard.MESH, guard.SINGLE_DEVICE),
                            "cuda") == ("mesh", "single")
    assert guard.chain_from(guard.MESH, (guard.MESH, guard.SINGLE_DEVICE),
                            CPU) == ("mesh", "single", "sequential")
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2))
    monkeypatch.setattr(eng, "device", torch.device("cuda"))
    with faults.inject("lowering=1.0:5"):
        with pytest.raises(errors.EngineLoweringError):
            eng.execute(_pool(expr_too=False))


def test_per_shard_budget_split_property(engines, jengines, oracle,
                                         tmp_path):
    """The proactive split fires before dispatch while the per-shard
    prediction passes the budget; every launch fits; the split count and
    the predictions equal the JAX engine's."""
    pool = _pool(expr_too=False)
    eng = ShardedBatchEngine(engines, mesh=_tmesh(4))
    je = JSharded(jengines, mesh=_jmesh(4))
    full = eng.predict_dispatch_bytes(pool)
    assert full == je.predict_dispatch_bytes(_jpool(pool))
    budget = max(1, full["per_shard_bytes"] // 2)
    path = str(tmp_path / "trace.jsonl")
    obs.enable(path)
    got = eng.execute(pool, policy=guard.GuardPolicy(hbm_budget=budget))
    obs.disable()
    _exact(got, [r[:5] for r in oracle], "budget")
    je.execute(_jpool(pool), policy=__import__(
        "roaringbitmap_tpu.runtime.guard", fromlist=["GuardPolicy"])
        .GuardPolicy(hbm_budget=budget))
    assert eng.proactive_split_count == je.proactive_split_count > 0
    spans = [json.loads(line) for line in open(path)]
    mems = [ev for s in spans if s["name"] == "sharded.dispatch"
            for ev in s["events"] if ev["name"] == "sharded.memory"]
    assert mems and all(ev["per_shard_predicted_bytes"] <= budget
                        for ev in mems)
    splits = [ev for s in spans for ev in s["events"]
              if ev["name"] == "proactive_split"
              and ev.get("site") == "sharded_engine"]
    assert len(splits) == eng.proactive_split_count
    pro = obs.snapshot()["counters"]["rb_sharded_proactive_splits_total"]
    assert pro[0]["value"] == eng.proactive_split_count


def test_sharded_splits_less_than_single_device(engines):
    """At one per-device budget the 4-row mesh splits a pool fewer times
    than the single-device pooled engine: the per-shard transient is a
    quarter of the pooled one."""
    pool = _pool(expr_too=False)
    sh = ShardedBatchEngine(engines, mesh=_tmesh(4))
    single = MultiSetBatchEngine(engines)
    budget = max(1, sh.predict_dispatch_bytes(pool)["per_shard_bytes"] // 2)
    policy = guard.GuardPolicy(hbm_budget=budget)
    _exact(sh.execute(pool, policy=policy),
           single.execute(pool, engine="cuda", policy=policy), "split")
    assert sh.proactive_split_count >= 1
    assert single.proactive_split_count >= 2 * sh.proactive_split_count


def test_resident_capacity_per_shard(engines):
    """Sharded placement: each row shard holds pool_rows / mesh_rows rows;
    shards of one device share one image, distinct devices hold their own;
    the HBM ledger carries what the devices hold."""
    before = obs_memory.LEDGER.resident_bytes("sharded_pool")
    eng = ShardedBatchEngine(engines, mesh=_tmesh(4), placement="sharded")
    for t in eng.pool_shards().values():
        assert t.shape == (eng.pool_rows // 4, 2048)
    assert eng.hbm_bytes() == eng.pool_rows * insights.ROW_BYTES
    dis = ShardedBatchEngine(engines, mesh=_tmesh(4, distinct=True),
                             placement="sharded")
    assert dis.hbm_bytes() == dis.pool_rows * insights.ROW_BYTES
    repl = ShardedBatchEngine(engines, mesh=_tmesh(2, distinct=True),
                              placement="replicated")
    for t in repl.pool_shards().values():
        assert t.shape == (repl.pool_rows, 2048)
    assert repl.hbm_bytes() == repl.pool_rows * insights.ROW_BYTES * 2
    assert repl.shard_balance == 1.0
    sq = ShardedBatchEngine(engines, mesh=_tmesh(2, 2, distinct=True),
                            placement="sharded")
    for t in sq.pool_shards().values():
        assert t.shape == (sq.pool_rows // 2, 2048)
    assert sq.hbm_bytes() == sq.pool_rows * insights.ROW_BYTES * 2
    assert (obs_memory.LEDGER.resident_bytes("sharded_pool") - before
            == eng.hbm_bytes() + dis.hbm_bytes() + repl.hbm_bytes()
            + sq.hbm_bytes())


def test_dispatch_registers_no_new_resident_buffers(engines):
    import gc

    eng = ShardedBatchEngine(engines[0], mesh=_tmesh(2))
    qs = [BatchQuery("or", (0, 1, 2)), BatchQuery("xor", (1, 3))]
    gc.collect()
    before = obs_memory.LEDGER.snapshot()
    eng.execute(qs)
    n_programs = len(eng._programs)
    eng.execute(qs)
    assert obs_memory.LEDGER.snapshot() == before
    assert len(eng._programs) == n_programs


def test_batch_shard_event_and_mesh_metrics(engines, tmp_path):
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2))
    path = str(tmp_path / "trace.jsonl")
    obs.enable(path)
    eng.execute(_pool())
    obs.disable()
    spans = [json.loads(line) for line in open(path)]
    names = {s["name"] for s in spans}
    assert {"sharded.execute", "sharded.plan", "sharded.pool",
            "sharded.dispatch", "sharded.readback"} <= names
    dispatches = [s for s in spans if s["name"] == "sharded.dispatch"]
    assert dispatches
    for s in dispatches:
        ev = [e for e in s["events"] if e["name"] == "batch.shard"][0]
        assert ev["mesh"] == [2, 2] and ev["rows_per_shard"] > 0
        assert ev["shard_balance"] >= 1.0
        assert ev["per_shard_predicted_bytes"] > 0
        mem = [e for e in s["events"] if e["name"] == "sharded.memory"][0]
        assert mem["predicted_bytes"] > 0 and mem["mesh"] == [2, 2]
        cost = [e for e in s["events"] if e["name"] == "sharded.cost"][0]
        assert cost["device_ms"] >= 0 and cost.get("devices") == 4
        assert any(e["name"] == "expr.megakernel" for e in s["events"])
    snap = obs.snapshot()
    assert any(r["labels"].get("mesh") == "2x2" and r["value"] >= 1.0
               for r in snap["gauges"]["rb_shard_balance"])
    assert any(r["labels"].get("mesh") == "2x2" and r["value"] >= 1
               for r in snap["counters"]["rb_sharded_launches_total"])


def test_shadow_check_catches_silent_corruption(engines):
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2))
    policy = guard.GuardPolicy(shadow_rate=1.0)
    eng.execute(_pool(), policy=policy)
    with faults.inject("silent@sharded_engine=1.0:3"):
        with pytest.raises(errors.ShadowMismatch):
            eng.execute(_pool(), policy=policy)


def test_validation_and_empty(engines):
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2))
    with pytest.raises(IndexError):
        eng.execute([BatchGroup(9, [BatchQuery("or", (0, 1))])])
    assert eng.execute([]) == []
    assert eng.execute([BatchGroup(0, [])]) == [[]]
    with pytest.raises(ValueError):
        ShardedBatchEngine(engines, mesh=_tmesh(2), placement="bogus")
    with pytest.raises(ValueError):
        ShardedBatchEngine(engines, mesh=_tmesh(3))
    with pytest.raises(ValueError):
        ShardedBatchEngine(engines, mesh=Mesh(np.array([CPU] * 2).reshape(
            2, 1), ("rows", "lanes")))
    with pytest.raises(ValueError):
        default_mesh([CPU] * 2, data=3)


def test_warmup_precompiles_and_execute_cache_hits(engines):
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2))
    rep = eng.warmup(rungs=(2, 4))
    assert rep["programs"] and rep["mesh"] == [2, 1]
    n_programs = len(eng._programs)
    hits0 = eng._programs.stats()["hits"]
    pool = [BatchGroup(sid, e._rung_queries(2, ("or", "and", "xor",
                                                "andnot")))
            for sid, e in enumerate(eng._engines)]
    eng.execute(pool)
    assert len(eng._programs) == n_programs
    assert eng._programs.stats()["hits"] > hits0


def test_compile_cache_env_knob(engines, tmp_path, monkeypatch):
    """ROARING_TPU_COMPILE_CACHE moves the build directory the warmup
    report names."""
    cache_dir = str(tmp_path / "cache")
    monkeypatch.setenv(twarm.ENV_COMPILE_CACHE, cache_dir)
    try:
        eng = ShardedBatchEngine(engines[0], mesh=_tmesh(2))
        rep = eng.warmup(rungs=(2,))
        assert rep["compile_cache_dir"].endswith("cache")
    finally:
        monkeypatch.delenv(twarm.ENV_COMPILE_CACHE)
        twarm.disable_compile_cache()


def test_lattice_warmup_zero_escapes(engines, oracle):
    """warmup(profile=) seals the mesh vocabulary; traffic inside it
    replays (on the CPU a program is a marker) with zero escapes and the
    same bits; one pool past a rung counts one escape."""
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2))
    rep = eng.warmup(profile="q=16,;rows=64,;keys=4,;heads=both;expr=2",
                     pools=[_pool()])
    assert rep["lattice"]["sealed"] and rep["programs"] == "eager"
    assert tlat.escape_total() == 0
    _exact(eng.execute(_pool()), oracle, "lattice")
    _exact(eng.execute(_pool()), oracle, "lattice-again")
    assert tlat.escape_total() == 0
    big = [BatchGroup(0, [BatchQuery("or", (i % 8, (i + 1) % 8))
                          for i in range(17)])]
    got = eng.execute(big)
    assert [r.cardinality for r in got[0]] == [
        engines[0]._sequential_result(q).cardinality
        for q in big[0].queries]
    assert tlat.escape_total() == 1


def test_combine_mode_streams_equal_jax(engines, jengines):
    """The combine-mode B5 program of one expression pool: the port's
    stream arrays, leaf gather and bank-0 group bases equal the JAX
    ``build_combines`` output."""
    pool = [BatchGroup(sid, [q for q in g.queries
                             if isinstance(q, expr.ExprQuery)]
                       + [BatchQuery("or", (0, 1), form="bitmap")])
            for sid, g in enumerate(_pool())]
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2))
    je = JSharded(jengines, mesh=_jmesh(2, 2))
    tp = eng._plan(tuple(eng._single._flatten(pool)[0]))
    jp = je._plan(tuple(je._single._flatten(_jpool(pool))[0]))
    assert len(tp.megas) == 1 and jp.mega is not None
    tm = tp.megas[0]
    assert tm.mode == jp.mega.mode == "combine"
    for k in ("opc", "dst", "src", "row", "bank", "orow", "crow", "imm",
              "leafidx"):
        assert np.array_equal(np.asarray(tm.host[k]),
                              np.asarray(jp.mega.host[k])), k
    assert tm.group_base == jp.mega.group_base
    assert tm.signature == jp.mega.signature
    assert tm.leaf_rows == jp.mega.leaf_rows


def test_mutation_patches_the_placed_pool(tenant_values):
    """A value delta on a member set replays into the placed image (a
    one-shard patch); later dispatches see it, bit-exact."""
    engines = [BatchEngine.from_bitmaps([TRB.from_values(v) for v in t],
                                        layout="dense", device=CPU)
               for t in tenant_values]
    for distinct in (False, True):
        eng = ShardedBatchEngine(engines, mesh=_tmesh(4, distinct=distinct),
                                 placement="sharded")
        q = [BatchGroup(1, [BatchQuery("or", (0, 1), form="bitmap")])]
        eng.execute(q)
        engines[1]._ds.apply_delta(adds={0: [70000 + (3 if distinct else 5)]})
        got = eng.execute(q)[0][0]
        want = engines[1]._sequential_result(q[0].queries[0])
        assert got.bitmap == want.bitmap and got.cardinality == \
            want.cardinality
        snap = obs.snapshot()["counters"]
        assert snap["rb_sharded_pool_patches_total"][0]["value"] >= 1


def test_predict_sharded_dispatch_bytes_model():
    """Pure arithmetic: equal numbers in both packages."""
    for sigs in ([("or", 4, 8, 2, 2, False)],
                 [("andnot", 8, 4, 3, 2, True), ("and", 2, 16, 1, 4, False)]):
        for pool_rows, d, r in ((100, 1, 1), (100, 4, 4), (513, 8, 2)):
            assert insights.predict_sharded_dispatch_bytes(
                sigs, pool_rows, d, r) == jins.predict_sharded_dispatch_bytes(
                    sigs, pool_rows, d, r)
    one = insights.predict_sharded_dispatch_bytes(
        [("or", 4, 8, 2, 2, False)], 100, 1, 1)
    four = insights.predict_sharded_dispatch_bytes(
        [("or", 4, 8, 2, 2, False)], 100, 4, 4)
    assert four["per_shard_bytes"] < one["per_shard_bytes"]
    assert four["resident_per_shard_bytes"] == insights.dense_rows_bytes(25)


def test_compact_tenants_place_from_their_resident_words(tenant_values):
    """A compact tenant's rows are rebuilt on the device (B3's plain
    version on the CPU) into the placed image; results equal the dense
    engines'."""
    sets = [BatchEngine.from_bitmaps([TRB.from_values(v) for v in t],
                                     layout=lay, device=CPU)
            for t, lay in zip(tenant_values, ("compact", "dense", "compact"))]
    eng = ShardedBatchEngine(sets, mesh=_tmesh(2, 2), placement="sharded")
    pool = _pool()
    want = [[sets[g.set_id]._sequential_result(q) for q in g.queries]
            for g in pool]
    _exact(eng.execute(pool), want, "compact")


def test_stream_past_capacity_runs_the_plain_combines(engines, oracle,
                                                      monkeypatch):
    """A section whose combine-mode stream does not fit B5 on its own is
    counted as a capacity demotion, and its launch raises
    ``EngineLoweringError``: the guard demotes it to ``single``, whose
    kernel rungs (and their plain combines) answer bit-exact, in both
    split modes.  Without the guard the error reaches the caller typed."""
    from roaringbitmap_tpu_torch.ops import megakernel

    monkeypatch.setattr(megakernel.MegaPlan, "fits", lambda self: False)
    for distinct in (False, True):
        guard.reset_dispatch_stats()
        eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2,
                                                      distinct=distinct),
                                 placement="sharded")
        pooled, _ = eng._single._flatten(_pool())
        assert eng._plan(tuple(pooled)).megas is None
        _exact(eng.execute(_pool()), oracle, ("plain-combines", distinct))
        st = guard.dispatch_stats("sharded_engine")
        assert st["demotions"] >= 1 and st["sequential"] == 0, st
        with pytest.raises(errors.EngineLoweringError):
            eng.execute(_pool(), fallback=False)
    demos = obs.snapshot()["counters"]["rb_mega_capacity_demotions_total"]
    assert any(r["labels"].get("site") == "sharding" for r in demos)


@pytest.mark.parametrize("distinct", [False, True])
def test_sections_past_capacity_split_into_combine_launches(
        engines, oracle, monkeypatch, distinct):
    """Fused sections whose one stream passes B5's step cap are halved, in
    order, into streams that each fit, one combine-mode launch each; the
    results are bit-exact and nothing demotes."""
    from roaringbitmap_tpu_torch.ops import megakernel

    eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2, distinct=distinct),
                             placement="sharded")
    pooled, _ = eng._single._flatten(_pool())
    whole = eng._plan(tuple(pooled)).megas
    assert len(whole) == 1
    cap = max(whole[0].steps_pad // 2, 1)
    monkeypatch.setattr(megakernel, "MAX_STEPS", cap)
    eng = ShardedBatchEngine(engines, mesh=_tmesh(2, 2, distinct=distinct),
                             placement="sharded")
    plan = eng._plan(tuple(pooled))
    assert plan.megas is not None and len(plan.megas) >= 2
    assert all(m.fits() and m.mode == "combine" for m in plan.megas)
    assert sum(len(m.expr_out) for m in plan.megas) == len(plan.fused)
    guard.reset_dispatch_stats()
    _exact(eng.execute(_pool()), oracle, ("split", distinct))
    _exact(eng.execute(_pool(), fallback=False), oracle, ("split raw",
                                                          distinct))
    assert guard.dispatch_stats("sharded_engine")["demotions"] == 0
