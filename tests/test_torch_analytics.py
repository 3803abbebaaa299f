"""The port's analytics lane against roaringbitmap_tpu's.

The same seeded bitmaps and value columns (a sparse ``BsiColumn`` over 2^17
row ids, a ``RangeColumn`` of 3,000 rows of 62-bit values) go through both
packages.  Every value predicate, composed with set algebra, runs on the
port's "megakernel" (B5's plain version on the CPU), "cuda" and "torch"
rungs and must equal the JAX ``BatchEngine`` on its "xla" rung, JAX and port
``evaluate_host``, and the port's host oracle (``_execute_sequential``).
``sum_`` and ``top_k`` roots, the two-phase baseline, pruning, the typed
errors, and the megakernel's instruction stream and bank-2 rows are held to
the JAX package too.  Set algebra and integer sums have no tolerance:
everything is compared exactly.
"""

import gc

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.analytics import RangeColumn as JRange
from roaringbitmap_tpu.ops import megakernel as jmk
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.analytics import (BsiColumn, RangeColumn,
                                               two_phase_execute)
from roaringbitmap_tpu_torch.ops import megakernel as mk
from roaringbitmap_tpu_torch.ops.words import to_u32
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine

RUNGS = ["megakernel", "cuda", "torch"]
VMAX_RANGE = 1 << 62


def _data(seed: int = 0xA7A):
    rng = np.random.default_rng(seed)
    bms = [np.unique(rng.integers(0, 1 << 17, 2000)).astype(np.uint32)
           for _ in range(4)]
    ids = np.unique(rng.integers(0, 1 << 17, 5000)).astype(np.uint32)
    prices = rng.integers(0, 9000, ids.size).astype(np.int64)
    ts = rng.integers(0, VMAX_RANGE, 3000).astype(np.int64)
    return bms, ids, prices, ts


_CACHE: dict = {}


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_objects():
    """The JAX sets built here register with the JAX package's
    process-global HBM ledger: drop them and collect when the module ends,
    so a later file in the same worker does not count them."""
    yield
    _CACHE.clear()
    _JAX_RESULTS.clear()
    gc.collect()


def _world(layout: str = "dense"):
    """(JAX engine, JAX bitmaps, JAX columns, port engine, port bitmaps,
    port columns), built once per layout."""
    if layout not in _CACHE:
        bms, ids, prices, ts = _data()
        jb = [JRB.from_values(v) for v in bms]
        tb = [TRB.from_values(v) for v in bms]
        jcols = {"price": JBsi("price", ids, prices), "ts": JRange("ts", ts)}
        tcols = {"price": BsiColumn("price", ids, prices, device="cpu"),
                 "ts": RangeColumn("ts", ts, device="cpu")}
        jds = JSet(jb, layout=layout)
        tds = DeviceBitmapSet(tb, layout=layout, device="cpu")
        for c in jcols.values():
            jds.attach_column(c)
        for c in tcols.values():
            tds.attach_column(c)
        _CACHE[layout] = (JEngine(jds, result_cache=None), jb, jcols,
                          BatchEngine(tds), tb, tcols)
    return _CACHE[layout]


_BMS, _IDS, _PRICES, _TS = _data()
#: a stored price of a row in bitmap 0, so eq/neq are non-trivial
_PRICE0 = int(_PRICES[np.isin(_IDS, _BMS[0])][0])

BSI_CASES = [("range", (150, 6200)), ("eq", (_PRICE0,)), ("neq", (_PRICE0,)),
             ("lt", (4000,)), ("le", (4000,)), ("gt", (700,)),
             ("ge", (700,))]
RANGE_CASES = [("range", (1 << 59, 1 << 61)), ("le", (1 << 60,)),
               ("ge", (1 << 60,)), ("lt", (1 << 60,)), ("gt", (1 << 60,)),
               ("eq", (int(_TS[7]),)), ("neq", (int(_TS[7]),))]


def _pred(m, col, op, args):
    return m.range_(col, *args) if op == "range" else m.cmp(col, op, args[0])


_JAX_RESULTS: dict = {}


def _jax_results(key, jqs, layout="dense"):
    """The JAX engine's "xla" results for one query list, computed once."""
    if key not in _JAX_RESULTS:
        jeng = _world(layout)[0]
        _JAX_RESULTS[key] = jeng.execute(jqs, engine="xla", fallback=False)
    return _JAX_RESULTS[key]


def _check(got, want, qs):
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.cardinality, g.value) == (w.cardinality, w.value), i
        if qs[i].form == "bitmap":
            assert np.array_equal(g.bitmap.to_array(), w.bitmap.to_array()), i


def _predicate_case(col, op, args, rung):
    jeng, jb, jcols, teng, tb, tcols = _world()
    jq = jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1),
                                    _pred(jexpr, col, op, args)),
                         form="bitmap")
    tq = texpr.ExprQuery(texpr.and_(texpr.or_(0, 1),
                                    _pred(texpr, col, op, args)),
                         form="bitmap")
    want = _jax_results(("pred", col, op, args), [jq])
    got = teng.execute([tq], engine=rung)
    assert teng.last_timings["engine"] == rung
    _check(got, want, [tq])
    _check(got, teng._execute_sequential([tq]), [tq])
    host = texpr.evaluate_host(tq.expr, tb, tcols)
    jhost = jexpr.evaluate_host(jq.expr, jb, jcols)
    assert np.array_equal(host.to_array(), jhost.to_array())
    assert np.array_equal(got[0].bitmap.to_array(), host.to_array())
    assert got[0].cardinality > 0


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("op,args", BSI_CASES)
def test_predicate_parity_bsi(op, args, rung):
    _predicate_case("price", op, args, rung)


@pytest.mark.parametrize("rung", RUNGS)
@pytest.mark.parametrize("op,args", RANGE_CASES)
def test_predicate_parity_range_column(op, args, rung):
    """62-bit values ride the RangeBitmap threshold family (padded depth
    64), composed with andnot."""
    jeng, jb, jcols, teng, tb, tcols = _world()
    jq = jexpr.ExprQuery(jexpr.andnot(_pred(jexpr, "ts", op, args),
                                      jexpr.ref(2)), form="bitmap")
    tq = texpr.ExprQuery(texpr.andnot(_pred(texpr, "ts", op, args),
                                      texpr.ref(2)), form="bitmap")
    want = _jax_results(("rpred", op, args), [jq])
    got = teng.execute([tq], engine=rung)
    _check(got, want, [tq])
    _check(got, teng._execute_sequential([tq]), [tq])
    jhost = jexpr.evaluate_host(jq.expr, jb, jcols)
    assert np.array_equal(got[0].bitmap.to_array(), jhost.to_array())
    assert tcols["ts"].depth_pad == 64 and got[0].cardinality > 0


def _agg_queries(m):
    found = m.and_(m.or_(0, 1), m.range_("price", 100, 5000))
    rfound = m.range_("ts", 1 << 58, 1 << 61)
    return [m.ExprQuery(m.sum_("price", found=found)),
            m.ExprQuery(m.sum_("price")),
            m.ExprQuery(m.sum_("ts", found=m.or_(0, 2))),
            m.ExprQuery(m.sum_("ts")),
            m.ExprQuery(m.top_k("price", 1, found=m.or_(0, 1, 2)),
                        form="bitmap"),
            m.ExprQuery(m.top_k("price", 13, found=found), form="bitmap"),
            m.ExprQuery(m.top_k("price", 10 ** 7, found=m.ref(3)),
                        form="bitmap"),
            m.ExprQuery(m.top_k("ts", 9, found=rfound), form="bitmap"),
            m.ExprQuery(m.top_k("ts", 25)),
            m.ExprQuery(m.top_k("ts", 0, found=m.ref(1)), form="bitmap")]


@pytest.mark.parametrize("rung", RUNGS)
def test_aggregates_match_jax(rung):
    """sum_ totals and counts (a 62-bit column sums past 2^64), top_k's
    clamp and smallest-id tie trim, against the JAX engine and both host
    oracles."""
    jeng, jb, jcols, teng, tb, tcols = _world()
    jqs, tqs = _agg_queries(jexpr), _agg_queries(texpr)
    want = _jax_results(("agg",), jqs)
    got = teng.execute(tqs, engine=rung)
    _check(got, want, tqs)
    _check(got, teng._execute_sequential(tqs), tqs)
    for g, jq in zip(got, jqs):
        if jq.expr.kind == "sum" and jq.expr.col == "ts":
            continue    # the JAX host oracle's int64 sum wraps here
        card, value, bm = jexpr.evaluate_host_agg(jq.expr, jb, jcols)
        assert (g.cardinality, g.value) == (card, value)
        if bm is not None and g.bitmap is not None:
            assert np.array_equal(g.bitmap.to_array(), bm.to_array())
    assert got[3].value == sum(int(v) for v in _TS) > 1 << 64
    # k clamped to the found set's stored rows
    assert got[6].cardinality == (tb[3] & tcols["price"].host.ebm).cardinality
    assert got[9].cardinality == 0


def test_range_column_sum_is_exact():
    """Regression: the reference RangeColumn.host_sum sums int64 values in
    numpy and wraps past 2^63 (two rows of 2^62 give -2^63); the port's
    oracle and every rung give the exact total."""
    values = np.array([1 << 62, 1 << 62, 5], np.int64)
    col = RangeColumn("t", values, device="cpu")
    assert col.host_sum(None) == ((1 << 63) + 5, 3)
    assert col.host_sum(TRB.from_values(np.array([0, 1, 9], np.uint32))) \
        == (1 << 63, 3)
    assert JRange("t", values).host_sum(None)[0] == -(1 << 63) + 5
    ds = DeviceBitmapSet([TRB.from_values(np.arange(3, dtype=np.uint32))],
                         layout="dense", device="cpu")
    ds.attach_column(col)
    eng = BatchEngine(ds)
    q = texpr.ExprQuery(texpr.sum_("t"))
    for rung in RUNGS:
        assert eng.execute([q], engine=rung)[0].value == (1 << 63) + 5


def test_top_k_ties_trim_smallest_ids():
    """Every stored value equal: the Kaser scan keeps all rows, the trim
    drops the smallest ids, on every rung."""
    ids = np.arange(100, 200, dtype=np.uint32)
    ds = DeviceBitmapSet([TRB.from_values(ids)], layout="dense",
                         device="cpu")
    ds.attach_column(BsiColumn("v", ids, np.full(ids.size, 5), device="cpu"))
    eng = BatchEngine(ds)
    q = texpr.ExprQuery(texpr.top_k("v", 7, found=texpr.or_(0)),
                        form="bitmap")
    for rung in RUNGS:
        got = eng.execute([q], engine=rung)[0]
        assert list(got.bitmap.to_array()) == list(range(193, 200)), rung


@pytest.mark.parametrize("col,op,args,decision", [
    ("price", "ge", (0,), "all"), ("price", "gt", (10 ** 6,), "empty"),
    ("price", "range", (-5, 10 ** 6), "all"), ("ts", "le", (-1,), "empty"),
    ("ts", "ge", (0,), "all"), ("ts", "neq", (-3,), "all")])
def test_pruned_predicates_issue_no_scan_steps(col, op, args, decision):
    """Min/max pruning answers at plan time: "empty" prunes the section,
    "all" is the existence plane; neither puts a VSCAN opcode in the
    stream, and both equal JAX's plan and the host oracle."""
    jeng, jb, jcols, teng, tb, tcols = _world()
    assert tcols[col].scan_plan(op, *args)[0] == decision
    assert jcols[col].scan_plan(op, *args)[0] == decision
    tq = texpr.ExprQuery(texpr.or_(texpr.ref(0),
                                   _pred(texpr, col, op, args)),
                         form="bitmap")
    plan = teng.plan([tq])
    steps = [st for s in plan.fused for st in s.steps if st[0] == "vscan"]
    assert all(st[2] == "col:all" for st in steps)
    assert len(steps) == (decision == "all")
    opc = plan.mega.host["opc"][:plan.mega.n_steps]
    assert not np.isin(opc, [mk.VSCAN_HI, mk.VSCAN_LO]).any()
    for rung in RUNGS:
        got = teng.execute([tq], engine=rung)[0]
        want = texpr.evaluate_host(tq.expr, tb, tcols)
        assert np.array_equal(got.bitmap.to_array(), want.to_array()), rung


def test_missing_column_raises_like_jax():
    jeng, _, _, teng, _, _ = _world()
    with pytest.raises(KeyError) as jerr:
        jeng.execute([jexpr.ExprQuery(jexpr.cmp("nope", "le", 3))])
    with pytest.raises(KeyError) as terr:
        teng.execute([texpr.ExprQuery(texpr.cmp("nope", "le", 3))])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(KeyError):
        teng.execute([texpr.ExprQuery(texpr.sum_("nope"))])


def test_sum_rejects_bitmap_form_and_nested_agg():
    for m in (jexpr, texpr):
        with pytest.raises(ValueError):
            m.ExprQuery(m.sum_("price"), form="bitmap")
        with pytest.raises(ValueError):
            m.canonicalize(m.or_(m.sum_("price"), m.ref(0)))
        with pytest.raises(ValueError):
            m.cmp("price", "between", 3)
        with pytest.raises(ValueError):
            m.top_k("price", -1)


def _stream_pool(m):
    return ([m.ExprQuery(m.and_(m.or_(0, 1), m.cmp("price", "le", 2500)),
                         form="bitmap"),
             m.ExprQuery(m.andnot(m.range_("price", 100, 5000), m.ref(2))),
             m.ExprQuery(m.xor(m.cmp("ts", "gt", 1 << 60), m.ref(1))),
             m.ExprQuery(m.range_("ts", 1 << 59, 1 << 61), form="bitmap"),
             m.ExprQuery(m.cmp("price", "ge", 0))]
            + _agg_queries(m)[:2] + _agg_queries(m)[4:6]
            + _agg_queries(m)[7:8])


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_stream_matches_jax(layout):
    """``build_full`` on analytics plans: the eight stream arrays, the plan
    signature and counts, and the bank-2 rows equal the JAX plan's."""
    jeng, _, _, teng, _, _ = _world(layout)
    jplan = jeng.plan(_stream_pool(jexpr))
    tplan = teng.plan(_stream_pool(texpr))
    jm, tm = jplan.mega, tplan.mega
    assert tm.signature == jm.signature
    assert (tm.n_steps, tm.n_slots, tm.n_vscan, tm.n_vagg) == (
        jm.n_steps, jm.n_slots, jm.n_vscan, jm.n_vagg)
    assert tm.n_vscan > 0 and tm.n_vagg > 0 and tm.fits()
    for k in mk.STREAM_KEYS + ("extra",):
        assert np.array_equal(tm.host[k], np.asarray(jm.arrays[k])), k
    jbank = np.asarray(jmk._col_bank(jm, jexpr.launch_cols(jplan.fused)))
    tbank = to_u32(tm.device_arrays("cpu")["cols"])
    assert tbank.shape == (tm.col_rows, 2048) == jbank.shape
    assert np.array_equal(tbank, jbank)
    stats = tm.stats_event()
    assert (stats["vscan_steps"], stats["vagg_steps"]) == (tm.n_vscan,
                                                           tm.n_vagg)


def test_compiled_value_sections_match_jax():
    """vscan/vagg steps, predicate bits, alignment arrays and k equal the
    JAX compiler's, section by section."""
    jeng, _, _, teng, _, _ = _world()
    jplan = jeng.plan(_stream_pool(jexpr))
    tplan = teng.plan(_stream_pool(texpr))
    for js, ts in zip(jplan.exprs, tplan.exprs):
        assert (ts.kind, ts.form, ts.root, ts.agg) == (js.kind, js.form,
                                                       js.root, js.agg)
        assert ts.steps == js.steps
        assert ts.n_nodes == js.n_nodes
        if ts.kind != "fused":
            continue
        want = {k: np.asarray(v) for k, v in js.arrays.items()}
        assert sorted(ts.host) == sorted(want)
        for k, v in want.items():
            assert np.array_equal(np.asarray(ts.host[k]), v), k
        assert [c.name for c in ts.cols] == [c.name for c in js.cols]


@pytest.mark.parametrize("rung", RUNGS)
def test_two_phase_matches_fused(rung):
    _, _, _, teng, _, _ = _world()
    qs = [q for q in _agg_queries(texpr) if q.expr.k != 10 ** 7]
    fused = teng.execute(qs, engine=rung)
    tp = two_phase_execute(teng, qs, engine_rung=rung)
    for i, (f, t) in enumerate(zip(fused, tp)):
        assert (f.cardinality, f.value) == (t.cardinality, t.value), i
        if qs[i].form == "bitmap":
            assert f.bitmap == t.bitmap, i


def test_megakernel_runs_the_value_batch_in_one_stream():
    _, _, _, teng, _, _ = _world()
    qs = _stream_pool(texpr)
    plan = teng.plan(qs)
    assert plan.mega.fits()
    assert teng._bucket_engine(plan, "megakernel") == "megakernel"
    opc = plan.mega.host["opc"][:plan.mega.n_steps]
    for op in (mk.VSCAN_HI, mk.VSCAN_LO, mk.VAGG_CARD, mk.ACC_POP, mk.TAKE):
        assert (opc == op).any(), op


def test_reattached_column_never_serves_a_stale_plan():
    bms, ids, prices, _ = _data()
    ds = DeviceBitmapSet([TRB.from_values(v) for v in bms], layout="dense",
                         device="cpu")
    eng = BatchEngine(ds)
    q = texpr.ExprQuery(texpr.sum_("price"))
    ds.attach_column(BsiColumn("price", ids, prices, device="cpu"))
    first = eng.execute([q], engine="megakernel")[0]
    ds.attach_column(BsiColumn("price", ids, prices * 2, device="cpu"))
    second = eng.execute([q], engine="megakernel")[0]
    assert second.value == 2 * first.value
    ds.detach_column("price")
    with pytest.raises(KeyError):
        eng.execute([q])


def test_column_device_and_deltas():
    _, ids, prices, _ = _data()
    ds = DeviceBitmapSet([TRB.from_values(ids)], device="cpu")
    meta = BsiColumn("price", ids, prices, device="meta")
    with pytest.raises(ValueError, match="lives on"):
        ds.attach_column(meta)
    col = BsiColumn("price", ids, prices, device="cpu")
    assert col.uid != ds.uid and col.hbm_bytes() == (
        col.depth_pad + 1) * col.keys.size * 8192
    # a delta applies (no longer NotImplementedError): the row's new value
    # reads back and the version moves
    rep = col.apply_delta({int(ids[1]): 2})
    assert rep == {"set": 1, "removed": 0, "version": 1,
                   "structure_version": 0}
    assert col.host.get_value(int(ids[1])) == (2, True)


def _delta_world(layout="dense"):
    """Fresh sets with both column kinds attached, in both packages (the
    deltas below mutate them)."""
    bms, ids, prices, ts = _data()
    jcols = {"price": JBsi("price", ids, prices), "ts": JRange("ts", ts)}
    tcols = {"price": BsiColumn("price", ids, prices, device="cpu"),
             "ts": RangeColumn("ts", ts, device="cpu")}
    jds = JSet([JRB.from_values(v) for v in bms], layout=layout)
    tds = DeviceBitmapSet([TRB.from_values(v) for v in bms], layout=layout,
                          device="cpu")
    for c in jcols.values():
        jds.attach_column(c)
    for c in tcols.values():
        tds.attach_column(c)
    return jds, jcols, tds, tcols, ids


def _same_planes(jc, tc):
    assert (jc.version, jc.structure_version, jc.depth, jc.depth_pad) == (
        tc.version, tc.structure_version, tc.depth, tc.depth_pad)
    assert (jc.min_value, jc.max_value) == (tc.min_value, tc.max_value)
    assert np.array_equal(jc.keys, tc.keys)
    assert np.array_equal(jc.ebm_np, tc.ebm_np)
    assert np.array_equal(jc.slices_np, tc.slices_np)


def _value_queries(m, col, vmax):
    return [m.ExprQuery(m.and_(m.or_(0, 1), m.range_(col, vmax // 5,
                                                      vmax // 2)),
                        form="bitmap"),
            m.ExprQuery(m.sum_(col, found=m.or_(1, 2))),
            m.ExprQuery(m.top_k(col, 7, found=m.ref(3)), form="bitmap"),
            m.ExprQuery(m.sum_(col))]


@pytest.mark.parametrize("rung", RUNGS)
def test_bsi_column_delta_matches_jax(rung):
    """Upserts (one past the old depth) and removals through both packages:
    the same planes, versions and answers; plans over the old planes
    retire."""
    jds, jcols, tds, tcols, ids = _delta_world()
    jeng = JEngine(jds, result_cache=None)
    teng = BatchEngine(tds, result_cache=None)
    jq, tq = _value_queries(jexpr, "price", 9000), _value_queries(
        texpr, "price", 9000)
    _check(teng.execute(tq, engine=rung),
           jeng.execute(jq, engine="xla", fallback=False), tq)
    upserts = {int(ids[0]): 5, int(ids[7]): 123456, 99991: 40}
    removes = [int(ids[3]), int(ids[4]), 131000]
    a = jcols["price"].apply_delta(upserts, removes)
    b = tcols["price"].apply_delta(upserts, removes)
    assert a == b and b["structure_version"] == 1
    _same_planes(jcols["price"], tcols["price"])
    want = jeng.execute(jq, engine="xla", fallback=False)
    _check(teng.execute(tq, engine=rung), want, tq)
    _check(teng._execute_sequential(tq), want, tq)
    a = jcols["price"].apply_delta((ids[10:14], [1, 2, 3, 4]))
    b = tcols["price"].apply_delta((ids[10:14], [1, 2, 3, 4]))
    assert a == b and b["version"] == 2
    _check(teng.execute(tq, engine=rung),
           jeng.execute(jq, engine="xla", fallback=False), tq)


@pytest.mark.parametrize("rung", RUNGS)
def test_range_column_delta_matches_jax(rung):
    jds, jcols, tds, tcols, _ = _delta_world()
    jeng = JEngine(jds, result_cache=None)
    teng = BatchEngine(tds, result_cache=None)
    jq, tq = _value_queries(jexpr, "ts", VMAX_RANGE), _value_queries(
        texpr, "ts", VMAX_RANGE)
    for updates in ({0: 7, 5: 0, 2999: VMAX_RANGE - 1}, {1: 3, 2: 3}):
        a = jcols["ts"].apply_delta(updates)
        b = tcols["ts"].apply_delta(updates)
        assert a == b
        _same_planes(jcols["ts"], tcols["ts"])
        _check(teng.execute(tq, engine=rung),
               jeng.execute(jq, engine="xla", fallback=False), tq)
    for col in (jcols["ts"], tcols["ts"]):
        with pytest.raises(IndexError):
            col.apply_delta({3000: 1})
        with pytest.raises(ValueError):
            col.apply_delta({0: -1})


def test_column_delta_drops_only_its_cache_entries():
    from roaringbitmap_tpu.mutation import ResultCache as JCache
    from roaringbitmap_tpu_torch.mutation import ResultCache

    jds, jcols, tds, tcols, ids = _delta_world()
    jc, tc = JCache(8 << 20), ResultCache(8 << 20)
    jeng, teng = JEngine(jds, result_cache=jc), BatchEngine(tds,
                                                            result_cache=tc)
    tq = (_value_queries(texpr, "price", 9000)
          + [texpr.ExprQuery(texpr.or_(0, 1), form="bitmap"),
             texpr.ExprQuery(texpr.sum_("ts", found=texpr.ref(2)))])
    jq = (_value_queries(jexpr, "price", 9000)
          + [jexpr.ExprQuery(jexpr.or_(0, 1), form="bitmap"),
             jexpr.ExprQuery(jexpr.sum_("ts", found=jexpr.ref(2)))])
    _check(teng.execute(tq), jeng.execute(jq), tq)
    assert tc.stats() == jc.stats() and tc.stats()["entries"] == 6
    jcols["price"].apply_delta({int(ids[0]): 1})
    tcols["price"].apply_delta({int(ids[0]): 1})
    # the four entries that read "price" dropped; or_(0, 1) and the "ts"
    # sum survive and hit, and or_(0, 1) also serves the first query's
    # subtree
    assert tc.stats() == jc.stats()
    assert tc.stats()["entries"] == 2 and tc.stats()["invalidations"] == 4
    _check(teng.execute(tq), jeng.execute(jq), tq)
    assert tc.stats() == jc.stats() and tc.stats()["hits"] == 3
    assert teng.plan(tq).exprs[0].n_cached == 1


def test_value_entry_points_need_a_card(monkeypatch):
    """device=None means "cuda": without a card every new entry point
    raises instead of falling back to the CPU."""
    from roaringbitmap_tpu_torch.bsi import (DeviceBSI, DeviceRangeBitmap,
                                             RoaringBitmapSliceIndex)
    from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ids, prices, ts = _data()
    for make in (lambda: BsiColumn("p", ids, prices),
                 lambda: RangeColumn("t", ts),
                 lambda: DeviceBSI(RoaringBitmapSliceIndex.from_pairs(
                     ids, prices)),
                 lambda: DeviceRangeBitmap(RangeBitmap.from_values(ts))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
