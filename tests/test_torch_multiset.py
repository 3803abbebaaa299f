"""The port's pooled multi-tenant engine against
roaringbitmap_tpu.parallel.multiset.

The JAX test fixture's three tenants (8, 6 and 8 bitmaps: sparse uniform, a
shared dense chunk, run-heavy) are built from the same numpy seed in both
packages.  The JAX ``MultiSetBatchEngine`` runs as its own tests run it on
the CPU (the "xla" rung); the port runs on ``device="cpu"``: "cuda" takes
B1's and B3's plain versions for CPU tensors, "megakernel" B5's, "torch"
the plain rung.  Held bit-exact (cardinalities, sums and ``serialize()``
bytes): the pool generator, the planner's op-group host arrays, the parity
matrix over layouts and rungs, regular (one key a query) pools, expression
and value pools, 64-bit tenants, the S=1 route, validation, and the guard:
split counts and drain retries under the same fault specs, the budget
split, the pipeline depth knob and the shadow check.
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import multiset as jms
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel import multiset as tms
from roaringbitmap_tpu_torch.parallel.batch_engine import ENGINES
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.runtime import errors, faults, guard

torch.set_num_threads(2)

CPU = "cpu"
S_SIZES = (8, 6, 8)


def _tenant_values() -> list:
    """The JAX fixture's tenants (tests/test_multiset.py), as value
    arrays."""
    rng = np.random.default_rng(0x7E4A)
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
def tenants():
    vals = _tenant_values()
    return ([[JRB.from_values(v) for v in t] for t in vals],
            [[TRB.from_values(v) for v in t] for t in vals])


def _jpool(pool) -> list:
    """A port pool as the JAX package's groups."""
    return [jms.BatchGroup(g.set_id, [JQ(q.op, q.operands, form=q.form)
                                      for q in g.queries]) for g in pool]


def _bitmap_form(pool) -> list:
    return [tms.BatchGroup(g.set_id, [TQ(q.op, q.operands, form="bitmap")
                                      for q in g.queries]) for g in pool]


@pytest.fixture(scope="module")
def bm_pool():
    return _bitmap_form(tms.random_multiset_pool(list(S_SIZES), 18,
                                                 seed=0xBEEF))


_JAX: dict = {}


def _jax_engine(tenants, layout="dense"):
    if layout not in _JAX:
        _JAX[layout] = jms.MultiSetBatchEngine.from_bitmap_sets(
            tenants[0], layout=layout)
    return _JAX[layout]


@pytest.fixture(scope="module")
def oracle(tenants, bm_pool):
    """The JAX pooled engine's answer to the bitmap pool ("xla" rung)."""
    return _jax_engine(tenants).execute(_jpool(bm_pool), engine="xla")


def _port(tenants, layout="dense"):
    return tms.MultiSetBatchEngine.from_bitmap_sets(tenants[1],
                                                    layout=layout, device=CPU)


def _same(got, want, tag="") -> None:
    assert len(got) == len(want), tag
    for gi, (grows, wrows) in enumerate(zip(got, want)):
        assert len(grows) == len(wrows), (tag, gi)
        for qi, (a, b) in enumerate(zip(grows, wrows)):
            assert a.cardinality == b.cardinality, (tag, gi, qi)
            assert a.value == b.value, (tag, gi, qi)
            if b.bitmap is not None:
                assert a.bitmap.serialize() == b.bitmap.serialize(), \
                    (tag, gi, qi)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("ROARING_TPU_BACKOFF_S", "0")
    for var in ("ROARING_TPU_FAULTS", "ROARING_TPU_SHADOW",
                "ROARING_TPU_HBM_BUDGET", "ROARING_TPU_PIPELINE_DEPTH"):
        monkeypatch.delenv(var, raising=False)
    guard.reset_dispatch_stats()
    jguard.reset_dispatch_stats()


# ------------------------------------------------------------ generator

@pytest.mark.parametrize("sizes,q,seed,max_ops", [
    (S_SIZES, 18, 0xBEEF, 8), ((256,) * 16, 64, 0xACE, 8),
    ((8,) * 4, 16, 200, 3), ((2, 3), 7, 5, 8)])
def test_pool_generator_matches_jax(sizes, q, seed, max_ops):
    got = tms.random_multiset_pool(list(sizes), q, seed=seed,
                                   max_operands=max_ops)
    want = jms.random_multiset_pool(list(sizes), q, seed=seed,
                                    max_operands=max_ops)
    assert [(g.set_id, [(x.op, x.operands, x.form) for x in g.queries])
            for g in got] == \
        [(g.set_id, [(x.op, x.operands, x.form) for x in g.queries])
         for g in want]


# -------------------------------------------------------------- planner

def _expr_pool(t):
    """Two depth-2 expressions a tenant, one with a value predicate on
    tenant 0's column; ``t`` is the package's expr module."""
    out = []
    for sid, n in enumerate(S_SIZES):
        qs = [t.ExprQuery(t.and_(t.or_(0, 1), t.not_(2)), form="bitmap"),
              t.ExprQuery(t.xor(t.and_(t.or_(1, 3), t.or_(2, 4)),
                                t.andnot(t.or_(0, 5), 2)))]
        if sid == 0:
            qs += [t.ExprQuery(t.and_(t.or_(3, 4),
                                      t.range_("price", 100, 6000)),
                               form="bitmap"),
                   t.ExprQuery(t.sum_("price", found=t.or_(0, 1))),
                   t.ExprQuery(t.top_k("price", 5, found=t.or_(2, 6)),
                               form="bitmap")]
        out.append((sid, qs))
    return out


def _columns(n_rows: int = 1 << 17):
    rng = np.random.default_rng(0xC01)
    ids = np.unique(rng.integers(0, n_rows, 20000)).astype(np.uint32)
    return ids, rng.integers(0, 9000, ids.size).astype(np.int64)


_COLS: dict = {}


def _value_engines(tenants):
    """(JAX engine, port engine) with a BsiColumn on tenant 0."""
    if not _COLS:
        ids, prices = _columns()
        jsets = [JSet(b, layout="dense") for b in tenants[0]]
        tsets = [DeviceBitmapSet(b, layout="dense", device=CPU)
                 for b in tenants[1]]
        jsets[0].attach_column(JBsi("price", ids, prices))
        tsets[0].attach_column(BsiColumn("price", ids, prices, device=CPU))
        _COLS["engines"] = (jms.MultiSetBatchEngine(jsets),
                            tms.MultiSetBatchEngine(tsets))
    return _COLS["engines"]


@pytest.mark.parametrize("kind", ["flat", "expr"])
def test_planner_matches_jax(tenants, bm_pool, kind):
    """The op groups' host arrays, array for array, and the compacted
    pooled row space (``n_pool_rows``, ``row_sel``); the merged
    ``flat_seg`` ascends, as B1 needs."""
    if kind == "flat":
        je, te = _jax_engine(tenants), _port(tenants)
        jpooled = je._flatten(_jpool(bm_pool))[0]
        tpooled = te._flatten(bm_pool)[0]
    else:
        je, te = _value_engines(tenants)
        jpooled = tuple((sid, q) for sid, qs in _expr_pool(jexpr)
                        for q in qs)
        tpooled = tuple((sid, q) for sid, qs in _expr_pool(texpr)
                        for q in qs)
    jplan, tplan = je._plan_pool(jpooled), te._plan_pool(tpooled)
    assert tplan.sids == jplan.sids
    assert tplan.n_pool_rows == jplan.n_pool_rows
    for sid in jplan.sids:
        assert np.array_equal(tplan.row_sel[sid], jplan.row_sel[sid])
    assert [b.signature for b in tplan.buckets] == \
        [b.signature for b in jplan.buckets]
    assert len(tplan.op_groups) == len(jplan.op_groups)
    for tg, jg in zip(tplan.op_groups, jplan.op_groups):
        assert (tg.op, tg.bucket_idx, tg.seg_offs, tg.nseg, tg.n_rows,
                tg.n_steps, tg.regular) == \
            (jg.op, jg.bucket_idx, jg.seg_offs, jg.nseg, jg.n_rows,
             jg.n_steps, jg.regular)
        assert set(tg.host) == set(jg.host)
        for k in jg.host:
            assert np.array_equal(tg.host[k], jg.host[k]), (tg.op, k)
        assert np.all(np.diff(tg.host["flat_seg"]) >= 0)
    if kind == "expr":
        assert tplan.mega is not None and jplan.mega is not None


# --------------------------------------------------------- parity matrix

@pytest.mark.parametrize("layout,rung", [
    ("dense", "cuda"), ("dense", "torch"), ("compact", "cuda"),
    ("compact", "torch"), ("counts", "cuda"), ("counts", "torch")])
def test_pooled_matches_jax(tenants, bm_pool, oracle, layout, rung):
    """The mixed-op bitmap pool over every tenant on each layout and rung:
    bit-exact with the JAX pooled engine, the port's per-set loop and the
    host rung; one pooled launch."""
    te = _port(tenants, layout)
    got = te.execute(bm_pool, engine=rung)
    _same(got, oracle, (layout, rung))
    assert te.launch_count == 1 and te.launches_saved == len(S_SIZES) - 1
    assert te.last_dispatch_memory["engine"] == rung
    loop = [te._engines[g.set_id].execute(list(g.queries), engine=rung)
            for g in bm_pool]
    _same(got, loop, "per-set loop")
    _same(got, te._regroup(te._sequential(te._flatten(bm_pool)[0]),
                           [len(g.queries) for g in bm_pool]), "host")


def test_raw_path_and_cardinalities(tenants, bm_pool, oracle):
    te = _port(tenants)
    _same(te.execute(bm_pool, engine="cuda", fallback=False), oracle, "raw")
    cards = te.cardinalities(bm_pool)
    assert [c.tolist() for c in cards] == \
        [[r.cardinality for r in rows] for rows in oracle]


# --------------------------------------------------------- regular pools

def test_regular_pool_live_layout(tenants):
    """Tenants of single-container bitmaps: every query has one key slot
    (k_pad == 1), so the plain rung folds by halving and keeps one live
    slot a query; equal to JAX on both rungs."""
    rng = np.random.default_rng(0x1E6)
    vals = [[np.unique(rng.integers(0, 1 << 16, 900 + 40 * i)).astype(
        np.uint32) for i in range(n)] for n in (5, 7)]
    je = jms.MultiSetBatchEngine.from_bitmap_sets(
        [[JRB.from_values(v) for v in t] for t in vals], layout="dense")
    te = tms.MultiSetBatchEngine.from_bitmap_sets(
        [[TRB.from_values(v) for v in t] for t in vals], layout="dense",
        device=CPU)
    pool = _bitmap_form(tms.random_multiset_pool([5, 7], 14, seed=0x3E6,
                                                 max_operands=4))
    want = je.execute(_jpool(pool), engine="xla")
    plan = te._plan_pool(te._flatten(pool)[0])
    assert plan.op_groups and all(g.regular for g in plan.op_groups)
    for rung in ("torch", "cuda"):
        _same(te.execute(pool, engine=rung), want, rung)


# ------------------------------------------------- expressions and columns

@pytest.mark.parametrize("rung", ["megakernel", "cuda", "torch"])
def test_expression_and_value_pool(tenants, rung):
    """Depth-2 expressions over every tenant and value queries (a range
    predicate, a sum and a top-k) over tenant 0's BsiColumn: equal to the
    JAX pooled engine; on "megakernel" one B5 program for the pool."""
    je, te = _value_engines(tenants)
    jpool = [jms.BatchGroup(s, qs) for s, qs in _expr_pool(jexpr)]
    tpool = [tms.BatchGroup(s, qs) for s, qs in _expr_pool(texpr)]
    if "expr" not in _COLS:
        _COLS["expr"] = je.execute(jpool, engine="xla")
    got = te.execute(tpool, engine=rung)
    _same(got, _COLS["expr"], rung)
    assert te.last_dispatch_memory["engine"] == rung
    assert any(r.value is not None for r in got[0])


# ------------------------------------------------------- 64-bit tenants

def test_u64_tenants(tenants):
    """Tenants of Roaring64Bitmaps whose u48 keys cross 2^32 and 2^63:
    Roaring64Bitmap results, equal to JAX's pooled engine."""
    rng = np.random.default_rng(0x64)
    buckets = (0, 1, 2**31, 2**32 - 1)
    vals = [[(np.uint64(buckets[i % 4]) << np.uint64(32))
             | np.unique(rng.integers(0, 1 << 19, 3000)).astype(np.uint64)
             for i in range(n)] for n in (6, 5)]
    je = jms.MultiSetBatchEngine.from_bitmap_sets(
        [[J64.from_values(v) for v in t] for t in vals], layout="dense")
    te = tms.MultiSetBatchEngine.from_bitmap_sets(
        [[T64.from_values(v) for v in t] for t in vals], layout="dense",
        device=CPU)
    pool = _bitmap_form(tms.random_multiset_pool([6, 5], 12, seed=0x640))
    want = je.execute(_jpool(pool), engine="xla")
    for rung in ("cuda", "torch"):
        got = te.execute(pool, engine=rung)
        _same(got, want, rung)
        assert all(type(r.bitmap) is T64 for rows in got for r in rows)


# ------------------------------------------------------------ S=1 route

def test_single_set_pool_routes_through_batch_engine(tenants):
    te = _port(tenants)
    queries = [TQ("or", (0, 1, 2)), TQ("xor", (1, 3))]
    be = te._engines[1]
    got = te.execute([tms.BatchGroup(1, queries)])
    assert len(te._plans) == 0 and te.launch_count == 0
    assert be.plan_key(queries) in be._plans
    assert [r.cardinality for r in got[0]] == \
        [r.cardinality for r in be.execute(queries)]


# ----------------------------------------------------------- validation

def test_group_validation(tenants):
    te, je = _port(tenants), _jax_engine(tenants)
    with pytest.raises(IndexError):
        te.execute([tms.BatchGroup(9, [TQ("or", (0, 1))])])
    with pytest.raises(IndexError):
        je.execute([jms.BatchGroup(9, [JQ("or", (0, 1))])])
    assert te.execute([]) == [] == je.execute([])
    assert te.execute([tms.BatchGroup(0, [])]) == [[]]
    with pytest.raises(ValueError):
        tms.MultiSetBatchEngine([])
    with pytest.raises(ValueError):
        jms.MultiSetBatchEngine([])
    with pytest.raises(ValueError):
        te.execute([tms.BatchGroup(0, [TQ("or", (0, 1))])], engine="xla")
    # every tenant on one device
    with pytest.raises(ValueError, match="different devices"):
        tms.MultiSetBatchEngine([
            DeviceBitmapSet(tenants[1][0], layout="dense", device=CPU),
            DeviceBitmapSet(tenants[1][1], layout="dense", device="meta")])


# ----------------------------------------------------------------- guard

@pytest.mark.parametrize("spec", ["oom=0.4,transient=0.1:0xAB",
                                  "lowering=1.0:0xAC"])
def test_faults_match_jax(tenants, bm_pool, oracle, spec):
    """The same spec gives both engines the same schedule: equal results
    and the same number of reactive OOM halvings."""
    je, te = _jax_engine(tenants), _port(tenants)
    j0 = je.split_count
    with jfaults.inject(spec):
        want = je.execute(_jpool(bm_pool), engine="xla")
    with faults.inject(spec):
        got = te.execute(bm_pool, engine="torch")
    _same(want, oracle, "jax")
    _same(got, oracle, spec)
    assert te.split_count == je.split_count - j0
    if spec.startswith("lowering"):
        assert guard.dispatch_stats("multiset")["sequential"] == 1


CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("spec,fault", [
    ("lowering@cuda:1", errors.EngineLoweringError),
    ("oom=1.0:5", errors.ResourceExhausted)])
def test_card_chain_raises_typed(tenants, bm_pool, spec, fault):
    """On a card the pooled chain holds only the kernel rung: a fault it
    cannot retry or split away raises typed, never lands on "torch" or the
    host (CPU tensors, a CUDA device handed to the guard)."""
    te = _port(tenants)
    chain = guard.chain_from("cuda", ENGINES, CARD)
    assert chain == ("cuda",)
    qs = te._flatten(bm_pool)[0]
    with faults.inject(spec):
        with pytest.raises(fault):
            te._launch_guarded(qs, chain, guard.GuardPolicy.from_env(),
                               guard.Deadline(None), None, sync=True)
    stats = guard.dispatch_stats("multiset")
    assert stats["demotions"] == 0 and stats["sequential"] == 0
    assert te.launch_count == 0
    if spec.startswith("oom"):
        # the first half is halved down to one query, which then raises
        assert te.split_count == int(np.ceil(np.log2(len(qs))))


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_pipeline_drain_faults_match_jax(tenants, depth):
    """Six pools through one window at depth 1, 2 and 4 under
    ``transient@multiset.drain``: equal to JAX, and as many launches re-run
    at drain time as in JAX."""
    je, te = _jax_engine(tenants), _port(tenants)
    pools = [tms.random_multiset_pool(list(S_SIZES), 9, seed=s)
             for s in range(41, 47)]
    spec = "transient@multiset.drain=0.5:0xD4"
    jpol = jguard.GuardPolicy(pipeline_depth=depth, backoff_base=0.0,
                              sleep=lambda s: None)
    jobs.reset()
    with jfaults.inject(spec):
        want = je.execute_pipelined([_jpool(p) for p in pools],
                                    engine="xla", policy=jpol)
    j_retries = sum(r["value"] for r in jobs.snapshot()["counters"].get(
        "rb_multiset_drain_retries_total", []))
    pol = guard.GuardPolicy(pipeline_depth=depth, backoff_base=0.0,
                            sleep=lambda s: None)
    with faults.inject(spec):
        got = te.execute_pipelined(pools, engine="torch", policy=pol)
    for g, w in zip(got, want):
        _same(g, w, depth)
    assert te.drain_retries == j_retries > 0
    assert te.last_pipeline["depth"] == depth
    assert te.last_pipeline["launches"] == len(pools)
    assert te.launch_count == len(pools) + j_retries
    if depth == 1:
        assert te.last_pipeline["overlap_ratio"] == 0.0
    else:
        assert te.last_pipeline["host_overlapped_ms"] > 0


def test_budget_split_proactive_and_bit_exact(tenants, bm_pool, oracle):
    te = _port(tenants)
    full = te.predict_dispatch_bytes(bm_pool)
    assert full > 0
    budget = full // 3
    got = te.execute(bm_pool, policy=guard.GuardPolicy(hbm_budget=budget))
    _same(got, oracle, "budget")
    assert te.proactive_split_count > 0 and te.split_count == 0
    launched = list(te.dispatch_memory)
    assert len(launched) == te.launch_count > 1
    assert all(m["predicted_bytes"] <= budget for m in launched)
    assert te.last_pipeline["launches"] == len(launched)
    # an explicit unlimited budget (<= 0) never splits
    te2 = _port(tenants)
    te2.execute(bm_pool, policy=guard.GuardPolicy(hbm_budget=0))
    assert te2.proactive_split_count == 0 and te2.launch_count == 1


def test_pipeline_depth_env_knob(tenants, monkeypatch):
    monkeypatch.setenv(guard.ENV_PIPELINE_DEPTH, "4")
    assert guard.GuardPolicy.from_env().pipeline_depth == 4 == \
        jguard.GuardPolicy.from_env().pipeline_depth
    te = _port(tenants)
    pools = [tms.random_multiset_pool(list(S_SIZES), 6, seed=s)
             for s in (51, 52)]
    got = te.execute_pipelined(pools)
    for p, rows in zip(pools, got):
        _same(rows, te._regroup(te._sequential(te._flatten(p)[0]),
                                [len(g.queries) for g in p]), "env depth")
    assert te.last_pipeline["depth"] == 4


def test_shadow_catches_silent_corruption(tenants, bm_pool):
    te = _port(tenants)
    policy = guard.GuardPolicy(shadow_rate=1.0)
    te.execute(bm_pool, policy=policy)          # clean: passes
    with faults.inject("silent@multiset=1.0:3"):
        with pytest.raises(errors.ShadowMismatch):
            te.execute(bm_pool, policy=policy)
