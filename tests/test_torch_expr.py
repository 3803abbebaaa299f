"""The port's expression compiler against roaringbitmap_tpu.parallel.expr.

The same expressions (the shared ``random_expr_pool`` generator, same seeds,
and hand-written DAGs) go through both packages: canonical DAGs,
``dag_stats``, ``evaluate_host`` and the compiled sections' steps and host
arrays must be equal.  Set algebra has no tolerance: everything is compared
exactly.
"""

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine

N = 12


def _values(seed: int = 0x5E7, n: int = N) -> list:
    """n value sets over 2^17 (keys 0 and 1), a few sharing dense runs."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = [rng.integers(0, 1 << 17, 1500)]
        if i % 3 == 0:
            vals.append(np.arange(1 << 16, (1 << 16) + 5000))
        out.append(np.unique(np.concatenate(vals)).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def pair():
    vals = _values()
    return ([JRB.from_values(v) for v in vals],
            [TRB.from_values(v) for v in vals])


@pytest.fixture(scope="module")
def engines(pair):
    j, t = pair
    return (JEngine.from_bitmaps(j, layout="dense"),
            BatchEngine(DeviceBitmapSet(t, layout="dense", device="cpu")))


def _tuple(e):
    """Structural form of an expression of either package."""
    name = type(e).__name__
    if name == "Ref":
        return ("ref", e.index)
    if name == "Node":
        return (e.op, tuple(_tuple(c) for c in e.children))
    raise TypeError(name)


def _hand(m):
    """Hand DAGs in one package's IR: the not_ rewrite, xor cancellation,
    shared subtrees (CSE), nested andnot, and a fully-cancelled xor."""
    shared = m.or_(0, 1)
    return [
        m.and_(m.or_(0, 1), m.not_(2)),
        m.xor(0, 1, 0),
        m.xor(m.or_(0, 1), m.or_(1, 0)),
        m.xor(m.and_(shared, 2), m.and_(shared, m.xor(3, 4))),
        m.andnot(m.andnot(0, 1), m.or_(2, 3)),
        m.and_(m.not_(m.not_(5)), m.or_(6, 7), m.not_(8)),
        m.or_(m.and_(0, 3), m.and_(3, 0), 9),
    ]


def _pools(m):
    return {f"depth{d}": m.random_expr_pool(N, 40, depth=d, seed=31 + d)
            for d in (2, 3)} | {"hand": [m.ExprQuery(e) for e in _hand(m)]}


@pytest.mark.parametrize("pool", ["depth2", "depth3", "hand"])
def test_canonical_dags_and_stats(pool):
    jp, tp = _pools(jexpr)[pool], _pools(texpr)[pool]
    for jq, tq in zip(jp, tp):
        assert _tuple(tq.expr) == _tuple(jq.expr)
        assert (_tuple(texpr.canonicalize(tq.expr))
                == _tuple(jexpr.canonicalize(jq.expr)))
        assert texpr.dag_stats(tq.expr) == jexpr.dag_stats(jq.expr)


@pytest.mark.parametrize("pool", ["depth2", "depth3", "hand"])
def test_evaluate_host(pair, pool):
    j, t = pair
    for jq, tq in zip(_pools(jexpr)[pool], _pools(texpr)[pool]):
        got = texpr.evaluate_host(tq.expr, t)
        want = jexpr.evaluate_host(jq.expr, j)
        assert np.array_equal(got.to_array(), want.to_array())


def test_rewrites():
    assert texpr.canonicalize(texpr.xor(0, 1, 0)) == texpr.Ref(1)
    assert texpr.canonicalize(
        texpr.xor(texpr.or_(0, 1), texpr.or_(1, 0))) is texpr.EMPTY
    got = texpr.canonicalize(texpr.and_(texpr.or_(0, 1), texpr.not_(2)))
    assert got == texpr.Node("andnot", (texpr.or_(0, 1), texpr.Ref(2)))
    assert texpr.dag_stats(_hand(texpr)[3])["cse_saved"] == \
        jexpr.dag_stats(_hand(jexpr)[3])["cse_saved"] > 0


@pytest.mark.parametrize("build", [
    lambda m: m.not_(0),
    lambda m: m.or_(0, m.not_(1)),
    lambda m: m.and_(m.not_(0), m.not_(1)),
    lambda m: m.andnot(m.not_(0), 1),
    lambda m: m.andnot(0, m.not_(1)),
])
def test_unbounded_not_raises_alike(build):
    with pytest.raises(ValueError) as jerr:
        jexpr.canonicalize(build(jexpr))
    with pytest.raises(ValueError) as terr:
        texpr.canonicalize(build(texpr))
    assert str(terr.value) == str(jerr.value)


def test_value_predicate_raises_alike(engines):
    jeng, teng = engines
    jq = jexpr.ExprQuery(jexpr.and_(0, jexpr.range_("price", 1, 5)))
    tq = texpr.ExprQuery(texpr.and_(0, texpr.ValuePred("price", "range", 1,
                                                       5)))

    def plan_reduce(bq, owner):
        return 0, np.zeros(1, np.uint16)

    with pytest.raises(ValueError) as jerr:
        jexpr.compile_query(jq, 0, plan_reduce, jeng._plan_leaf)
    with pytest.raises(ValueError) as terr:
        texpr.compile_query(tq, 0, plan_reduce, teng._plan_leaf)
    assert str(terr.value) == str(jerr.value)
    # with the engine's resolver, a column the set lacks is a KeyError
    with pytest.raises(KeyError) as jerr:
        jeng.plan([jexpr.ExprQuery(jexpr.sum_("price"))])
    with pytest.raises(KeyError) as terr:
        teng.plan([texpr.ExprQuery(texpr.Agg("sum", "price", 0))])
    assert str(terr.value) == str(jerr.value)


def _sections(jeng, teng, jp, tp):
    jplan, tplan = jeng.plan(jp), teng.plan(tp)
    assert len(jplan.exprs) == len(tplan.exprs)
    return list(zip(jplan.exprs, tplan.exprs))


@pytest.mark.parametrize("pool", ["depth2", "depth3", "hand"])
def test_compiled_sections_match(engines, pool):
    jeng, teng = engines
    form = "bitmap" if pool == "depth2" else "cardinality"
    jp = [jexpr.ExprQuery(q.expr, form=form) for q in _pools(jexpr)[pool]]
    tp = [texpr.ExprQuery(q.expr, form=form) for q in _pools(texpr)[pool]]
    n_fused = 0
    for js, ts in _sections(jeng, teng, jp, tp):
        assert (ts.kind, ts.form, ts.root) == (js.kind, js.form, js.root)
        assert ts.steps == js.steps
        assert (ts.n_nodes, ts.n_reduce, ts.n_combine, ts.depth,
                ts.cse_saved) == (js.n_nodes, js.n_reduce, js.n_combine,
                                  js.depth, js.cse_saved)
        if ts.kind != "fused":
            continue
        n_fused += 1
        assert ts.signature == js.signature
        assert np.array_equal(ts.root_keys, js.root_keys)
        want = {k: np.asarray(v) for k, v in js.arrays.items()}
        assert sorted(ts.host) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(np.asarray(ts.host[k]), v), k
    assert n_fused > 0


def test_short_circuits_match(pair):
    """Disjoint AND and an all-cancelled xor prune to "empty" sections in
    both packages; an ad-hoc root resolves on the host."""
    j, t = pair
    extra = [np.arange(10 << 16, (10 << 16) + 100, dtype=np.uint32)]
    jeng = JEngine.from_bitmaps(j + [JRB.from_values(extra[0])],
                                layout="dense")
    teng = BatchEngine(DeviceBitmapSet(
        t + [TRB.from_values(extra[0])], layout="dense", device="cpu"))
    ad = _values(seed=9, n=1)[0]

    def queries(m, rb):
        return [m.ExprQuery(m.and_(0, N), form="bitmap"),
                m.ExprQuery(m.and_(m.or_(0, 1), m.or_(N, N))),
                m.ExprQuery(m.xor(m.or_(0, 1), m.or_(1, 0))),
                m.ExprQuery(m.bitmap(rb.from_values(ad)), form="bitmap")]

    jp, tp = queries(jexpr, JRB), queries(texpr, TRB)
    kinds = [(js.kind, ts.kind) for js, ts in _sections(jeng, teng, jp, tp)]
    assert kinds == [("empty", "empty")] * 3 + [("adhoc", "adhoc")]
    got = teng.execute(tp, engine="torch")
    want = jeng.execute(jp, engine="xla", fallback=False)
    assert [g.cardinality for g in got] == [w.cardinality for w in want]
    assert got[0].bitmap.is_empty()
    assert np.array_equal(got[3].bitmap.to_array(), ad)
