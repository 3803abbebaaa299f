"""The port's engine leftovers held against the JAX package on the CPU:
``DeviceBitmapSet.evaluate``, ``aggregation.explain_wide``,
``BatchEngine.explain`` / ``chained_cardinality`` / ``hbm_bytes``,
``MultiSetBatchEngine.hbm_bytes``, ``expr.host_op_count``,
``expr.execute_node_at_a_time`` and ``models.flagship``.

The same seeded bitmaps and queries go through both packages.  Results
(cardinalities, members, serialized bytes, sums) are compared exactly;
reports compare their keys, their plan rows and the engine chain with the
JAX rung names mapped to the port's (``RUNG_OF``).  Predicted bytes are
the port's own footprint model (``insights.analysis``), so they are held
against it rather than against the JAX package's.
"""

import gc

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.models import flagship as jflag
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import multiset as jms
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.models import flagship as tflag
from roaringbitmap_tpu_torch.ops.words import to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel import multiset as tms
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.parallel.batch_engine import random_query_pool

CPU = "cpu"
N = 12
#: the port rung each JAX rung stands for
RUNG_OF = {"pallas": "cuda", "xla": "torch", "xla-vmap": "torch-vmap",
           "megakernel": "megakernel", "sequential": "sequential"}


def _values(seed: int = 0xE7A, n: int = N) -> list:
    """n value sets over 2^17: sparse ones, and every third with a run."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = [rng.integers(0, 1 << 17, 1500)]
        if i % 3 == 0:
            vals.append(np.arange(1 << 16, (1 << 16) + 5000))
        out.append(np.unique(np.concatenate(vals)).astype(np.uint32))
    return out


_WORLD: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_objects():
    """The JAX sets register with the JAX package's process-global ledger:
    drop them when the module ends."""
    yield
    _WORLD.clear()
    gc.collect()


def _world(layout: str = "dense"):
    """(JAX set, JAX engine, port set, port engine), once per layout; both
    sets carry a ``price`` column over the same pairs."""
    if layout not in _WORLD:
        vals = _values()
        rng = np.random.default_rng(5)
        ids = np.unique(rng.integers(0, 1 << 17, 4000)).astype(np.uint32)
        prices = rng.integers(0, 5000, ids.size).astype(np.int64)
        js = jagg.DeviceBitmapSet([JRB.from_values(v) for v in vals],
                                  layout=layout)
        ts = DeviceBitmapSet([TRB.from_values(v) for v in vals],
                             layout=layout, device=CPU)
        js.attach_column(JBsi("price", ids, prices))
        ts.attach_column(BsiColumn("price", ids, prices, device=CPU))
        _WORLD[layout] = (js, JEngine(js, result_cache=None), ts,
                          BatchEngine(ts, result_cache=None))
    return _WORLD[layout]


def _hand(m):
    shared = m.or_(0, 1)
    return [
        m.and_(m.or_(0, 1), m.not_(2)),
        m.xor(m.and_(shared, 2), m.and_(shared, m.xor(3, 4))),
        m.andnot(m.andnot(0, 1), m.or_(2, 3)),
        m.or_(m.and_(0, 3), m.and_(3, 0), 9),
        m.ref(7),
        m.xor(0, 1, 0),
    ]


def _exprs(m, form="cardinality"):
    return ([m.ExprQuery(e, form=form) for e in _hand(m)]
            + m.random_expr_pool(N, 8, depth=2, seed=41, form=form))


def _flat(form="cardinality"):
    pool = random_query_pool(N, 10, seed=9, max_operands=6)
    return [TQ(q.op, q.operands, form=form) for q in pool]


def _jq(q):
    return JQ(q.op, q.operands, form=q.form)


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.cardinality, g.value) == (w.cardinality, w.value), i
        assert (g.bitmap is None) == (w.bitmap is None), i
        if g.bitmap is not None:
            assert g.bitmap.serialize() == w.bitmap.serialize(), i


# --------------------------------------------------------------- evaluate

@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("form", ["cardinality", "bitmap"])
def test_evaluate_matches_jax(layout, form):
    js, _, ts, _ = _world(layout)
    for je, te in zip(_hand(jexpr), _hand(texpr)):
        want, got = js.evaluate(je, form=form), ts.evaluate(te, form=form)
        if form == "bitmap":
            assert got.serialize() == want.serialize()
        else:
            assert got == want and isinstance(got, int)


def test_evaluate_form_override_and_plan_cache():
    js, _, ts, _ = _world()
    tq = texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)),
                         form="bitmap")
    jq = jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1), jexpr.not_(2)),
                         form="bitmap")
    assert ts.evaluate(tq).serialize() == js.evaluate(jq).serialize()
    assert ts.evaluate(tq, form="cardinality") == \
        js.evaluate(jq, form="cardinality") == ts.evaluate(tq).cardinality
    cq = texpr.ExprQuery(tq.expr)
    assert ts.evaluate(cq, form="bitmap").serialize() == \
        js.evaluate(jexpr.ExprQuery(jq.expr), form="bitmap").serialize()
    hits = ts._expr_engine._plans.stats()["hits"]
    ts.evaluate(tq)
    assert ts._expr_engine._plans.stats()["hits"] == hits + 1


# ----------------------------------------------------------- explain_wide

@pytest.mark.parametrize("op", ["or", "and", "xor"])
@pytest.mark.parametrize("engine", ["auto", "xla", "pallas"])
def test_explain_wide_matches_jax(op, engine):
    vals = _values(seed=3)
    jb = [JRB.from_values(v) for v in vals]
    tb = [TRB.from_values(v) for v in vals]
    want = jagg.explain_wide(op, jb, engine=engine)
    got = tagg.explain_wide(op, tb, engine=RUNG_OF.get(engine, engine),
                            device=CPU)
    assert set(got) == set(want)
    for k in ("site", "op", "n", "containers", "device_rows",
              "hbm_budget_bytes", "within_budget"):
        assert got[k] == want[k], k
    assert got["engine"] == RUNG_OF[want["engine"]]
    assert got["engine_chain"] == [RUNG_OF[r] for r in want["engine_chain"]]
    assert got["predicted_hbm_bytes"] == insights.dense_rows_bytes(
        got["device_rows"])
    assert tagg.explain_wide(op, tb[0], device=CPU)["n"] == 1


def test_explain_wide_rejects_like_jax():
    for fn, kw in ((jagg.explain_wide, {}),
                   (tagg.explain_wide, {"device": CPU})):
        with pytest.raises(ValueError):
            fn("andnot", [], **kw)


# --------------------------------------------------------- BatchEngine.explain

def _row_keys(rows):
    return [None if r is None else sorted(r) for r in rows]


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("kind", ["flat", "mixed"])
def test_batch_explain_matches_jax(layout, kind):
    js, je, ts, te = _world(layout)
    tq = _flat("bitmap")
    if kind == "mixed":
        tq = tq[:4] + _exprs(texpr)
        jq = [_jq(q) for q in tq[:4]] + _exprs(jexpr)
    else:
        jq = [_jq(q) for q in tq]
    want, got = je.explain(jq), te.explain(tq)
    assert set(got) == set(want)
    for k in ("site", "q", "layout", "source_kind", "hbm_budget_bytes",
              "plan_cache_hit", "queries"):
        assert got[k] == want[k], k
    assert got["engine"] == RUNG_OF[want["engine"]]
    assert got["engine_chain"] == [RUNG_OF[r] for r in want["engine_chain"]]
    shape = ("op", "queries", "q_padded", "r_pad", "k_pad", "n_steps",
             "needs_words")
    assert [[b[k] for k in shape] for b in got["buckets"]] == \
        [[b[k] for k in shape] for b in want["buckets"]]
    assert _row_keys(got["buckets"]) == _row_keys(want["buckets"])
    for g, w in zip(got["exprs"], want["exprs"]):
        assert set(g) == set(w)
        for k in ("qid", "kind", "form", "nodes", "reduce_nodes",
                  "combine_nodes", "depth", "cse_saved"):
            assert g[k] == w[k], k
    assert len(got["exprs"]) == len(want["exprs"])
    assert got["sequential_floor"]["host_pairwise_ops"] == \
        want["sequential_floor"]["host_pairwise_ops"]
    for sect in ("resident", "proactive_split", "sequential_floor", "cost"):
        assert set(got[sect]) == set(want[sect]), sect
    # bytes from the port's own footprint model
    plan = te.plan(tq)
    pred = insights.predict_batch_dispatch_bytes(
        [b.signature for b in plan], te._resident_kind(), ts._n_rows,
        got["engine"])
    if plan.exprs:
        pred["peak_bytes"] += insights.predict_expr_dispatch_bytes(
            plan.expr_signature, got["engine"])["peak_bytes"]
    assert got["predicted"]["peak_bytes"] == pred["peak_bytes"]
    assert got["resident"]["hbm_bytes"] == ts.hbm_bytes() == te.hbm_bytes()
    assert got["proactive_split"] == {"would_split": False,
                                      "dispatches": [len(tq)]}


def test_batch_explain_cache_hits_on_repeat():
    _, je, _, te = _world()
    tq = _flat()[:6] + [texpr.ExprQuery(texpr.xor(texpr.or_(0, 5), 6))]
    jq = [_jq(q) for q in tq[:6]] + [
        jexpr.ExprQuery(jexpr.xor(jexpr.or_(0, 5), 6))]
    first = (te.explain(tq), je.explain(jq))
    assert [r["plan_cache_hit"] for r in first] == [False, False]
    te.execute(tq)
    je.execute(jq)
    again = (te.explain(tq), je.explain(jq))
    assert [r["plan_cache_hit"] for r in again] == [True, True]
    assert again[0]["program_cache_hit"] is True
    assert again[0]["program_cache_hit"] == again[1]["program_cache_hit"]


@pytest.mark.parametrize("pool", ["hand", "random"])
def test_host_op_count_matches_jax(pool):
    tq = (_exprs(texpr)[:6] if pool == "hand"
          else texpr.random_expr_pool(N, 16, depth=3, seed=77))
    jq = (_exprs(jexpr)[:6] if pool == "hand"
          else jexpr.random_expr_pool(N, 16, depth=3, seed=77))
    assert [texpr.host_op_count(q.expr) for q in tq] == \
        [jexpr.host_op_count(q.expr) for q in jq]
    assert texpr.host_op_count(texpr.not_(3)) == \
        jexpr.host_op_count(jexpr.not_(3)) == 0


# -------------------------------------------------------- chained probe

@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("engine", ["cuda", "torch", "torch-vmap"])
def test_chained_cardinality_matches_jax(layout, engine):
    _, je, _, te = _world(layout)
    tq = _flat()
    jq = [_jq(q) for q in tq]
    total = sum(r.cardinality for r in te.execute(tq))
    want = int(je.chained_cardinality(jq, 3, engine="xla")())
    got = te.chained_cardinality(tq, 3, engine=engine)()
    assert isinstance(got, torch.Tensor)
    assert int(got) == want == (3 * total) % (1 << 32)


def test_chained_cardinality_rejects_expressions_alike():
    _, je, _, te = _world()
    with pytest.raises(ValueError):
        je.chained_cardinality(_exprs(jexpr)[:1], 2)
    with pytest.raises(ValueError):
        te.chained_cardinality(_exprs(texpr)[:1], 2)
    with pytest.raises(ValueError):
        te.chained_cardinality(_flat(), 2, engine="nope")


# ------------------------------------------------------------- hbm bytes

@pytest.mark.parametrize("layout", ["dense", "compact", "counts"])
def test_hbm_bytes_of_both_engines(layout):
    vals = _values(seed=11)
    sets = [DeviceBitmapSet([TRB.from_values(v) for v in vals[i::2]],
                            layout=layout, device=CPU) for i in range(2)]
    jsets = [jagg.DeviceBitmapSet([JRB.from_values(v) for v in vals[i::2]],
                                  layout=layout) for i in range(2)]
    engines = [BatchEngine(s) for s in sets]
    ms = tms.MultiSetBatchEngine(engines)
    jm = jms.MultiSetBatchEngine([JEngine(s) for s in jsets])
    assert [e.hbm_bytes() for e in engines] == [s.hbm_bytes() for s in sets]
    assert ms.hbm_bytes() == sum(s.hbm_bytes() for s in sets) > 0
    assert jm.hbm_bytes() == sum(s.hbm_bytes() for s in jsets)
    assert [sum(insights.resident_set_bytes(s).values()) for s in sets] == \
        [e.hbm_bytes() for e in engines]


# --------------------------------------------------- node at a time

@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("form", ["cardinality", "bitmap"])
def test_node_at_a_time_matches_jax(layout, form):
    _, je, _, te = _world(layout)
    tq = _flat(form)[:5] + _exprs(texpr, form)
    jq = [_jq(q) for q in tq[:5]] + _exprs(jexpr, form)
    got = texpr.execute_node_at_a_time(te, tq)
    _same(got, jexpr.execute_node_at_a_time(je, jq))
    _same(got, te.execute(tq))


def test_node_at_a_time_agg_roots_and_launches():
    _, je, _, te = _world()
    tq = [texpr.ExprQuery(texpr.sum_("price", found=texpr.or_(0, 1))),
          texpr.ExprQuery(texpr.top_k("price", 5, found=texpr.ref(2)),
                          form="bitmap"),
          texpr.ExprQuery(texpr.sum_("price"))]
    jq = [jexpr.ExprQuery(jexpr.sum_("price", found=jexpr.or_(0, 1))),
          jexpr.ExprQuery(jexpr.top_k("price", 5, found=jexpr.ref(2)),
                          form="bitmap"),
          jexpr.ExprQuery(jexpr.sum_("price"))]
    got = texpr.execute_node_at_a_time(te, tq)
    _same(got, jexpr.execute_node_at_a_time(je, jq))
    _same(got, te._execute_sequential(tq))
    # a bare leaf root is a copy, never the set's host bitmap
    leaf = texpr.execute_node_at_a_time(
        te, [texpr.ExprQuery(texpr.ref(3), form="bitmap")])[0].bitmap
    leaf.add(0xFFFFFFF0)
    assert not te._ds.host_bitmaps()[3].contains(0xFFFFFFF0)


# -------------------------------------------------------------- flagship

@pytest.mark.parametrize("n,seed", [(16, 0), (1, 3), (40, 7)])
def test_flagship_forward_matches_jax(n, seed):
    words, seg, head = tflag.example_inputs(n, seed, device=CPU)
    jw, js_, jh = jflag.example_inputs(n, seed)
    assert np.array_equal(to_u32(words), np.asarray(jw))
    assert np.array_equal(seg.numpy(), np.asarray(js_))
    assert np.array_equal(head.numpy(), np.asarray(jh))
    got_w, got_c = tflag.forward(words, seg, head)
    want_w, want_c = jflag.forward(jw, js_, jh)
    assert got_w.dtype == torch.int32 and got_c.dtype == torch.int32
    assert got_w.shape == (head.shape[0], 2048)
    assert np.array_equal(to_u32(got_w), np.asarray(want_w))
    assert np.array_equal(got_c.numpy(), np.asarray(want_c))


def test_flagship_equals_wide_or():
    rng = np.random.default_rng(0)
    bms = [TRB.from_values(rng.integers(0, 1 << 18, 2048).astype(np.uint32))
           for _ in range(16)]
    words, seg, head = tflag.example_inputs(device=CPU)
    _, cards = tflag.forward(words, seg, head)
    assert int(cards.sum()) == tagg.or_(bms, device=CPU).cardinality
