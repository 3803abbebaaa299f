"""The port's compile vocabulary against roaringbitmap_tpu.runtime.lattice.

The same seeded bitmaps, value columns and traffic go through both
packages: the JAX engines on their "xla" rung, the port on
``device="cpu"`` (each snapped plan's program is then a marker and its
device part runs on the packed operands, as a graph replay would read
them).  Everything compared is an integer, so every comparison is exact:
lattice points, padded bucket shapes, megakernel stream shapes, padding
bytes, warmup ``lattice`` reports, escape counts and results.
"""

import gc
import json
import logging

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.analytics import BsiColumn as JBsi
from roaringbitmap_tpu.parallel import batch_engine as jbe
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import multiset as jms
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.runtime import lattice as jlat
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch import native
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.analytics import BsiColumn
from roaringbitmap_tpu_torch.ops import build
from roaringbitmap_tpu_torch.parallel import batch_engine as tbe
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel import multiset as tms
from roaringbitmap_tpu_torch.runtime import lattice as tlat
from roaringbitmap_tpu_torch.runtime import warmup as twarm

CPU = "cpu"
N = 8
#: sparse rungs: every shape of the traffic below is covered
PROFILE = "q=16,;rows=16,;keys=2,;heads=both;pool=16,"
XPROFILE = PROFILE + ";expr=2"
FORMS = ("cardinality", "bitmap")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    """Every case starts and ends with no lattice in either package and
    none of the knobs set: the lattice is process state, and a leaked one
    would snap every later test's plans in the same worker."""
    for var in ("ROARING_TPU_FAULTS", tlat.ENV_PROFILE,
                twarm.ENV_COMPILE_CACHE):
        monkeypatch.delenv(var, raising=False)
    jlat.deactivate()
    tlat.deactivate()
    tobs.reset()
    jobs.reset()
    twarm.disable_compile_cache()
    yield
    jlat.deactivate()
    tlat.deactivate()
    tobs.reset()
    jobs.reset()
    twarm.disable_compile_cache()


@pytest.fixture(scope="module", autouse=True)
def _collect():
    """The JAX sets made here register with the JAX package's process-wide
    ledger: collect them when the module ends."""
    yield
    _W.clear()
    gc.collect()


def _values(seed: int, n: int = N, universe: int = 1 << 17) -> list:
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, universe, int(rng.integers(300, 1500)))
                      ).astype(np.uint32) for _ in range(n)]


_W: dict = {}


def _single(layout: str = "dense"):
    """(JAX engine, port engine, port bitmaps) over the same bitmaps."""
    key = ("single", layout)
    if key not in _W:
        vals = _values(0x13)
        jb = [JRB.from_values(v) for v in vals]
        tb = [TRB.from_values(v) for v in vals]
        _W[key] = (jbe.BatchEngine(JSet(jb, layout=layout),
                                   result_cache=None),
                   tbe.BatchEngine(DeviceBitmapSet(tb, layout=layout,
                                                   device=CPU),
                                   result_cache=None), tb)
    return _W[key]


def _fresh_single(layout: str = "dense"):
    """A new engine pair (empty program caches)."""
    vals = _values(0x13)
    return (jbe.BatchEngine(JSet([JRB.from_values(v) for v in vals],
                                 layout=layout), result_cache=None),
            tbe.BatchEngine(DeviceBitmapSet([TRB.from_values(v)
                                             for v in vals], layout=layout,
                                            device=CPU), result_cache=None))


def _multi(layout: str = "dense"):
    """(JAX pooled engine, port pooled engine) over four tenants."""
    vals = [_values(0x20 + i, universe=1 << 16) for i in range(4)]
    return (jms.MultiSetBatchEngine([JSet([JRB.from_values(v) for v in t],
                                          layout=layout) for t in vals],
                                    result_cache=None),
            tms.MultiSetBatchEngine(
                [DeviceBitmapSet([TRB.from_values(v) for v in t],
                                 layout=layout, device=CPU) for t in vals],
                result_cache=None))


def _jq(q):
    """A port query as the JAX package's."""
    if isinstance(q, tbe.BatchQuery):
        return jbe.BatchQuery(q.op, q.operands, form=q.form)
    return jexpr.ExprQuery(_jexpr(q.expr), form=q.form)


def _jexpr(e):
    if isinstance(e, texpr.Ref):
        return jexpr.Ref(e.index)
    if isinstance(e, texpr.Node):
        return jexpr.Node(e.op, tuple(_jexpr(c) for c in e.children))
    if isinstance(e, texpr.ValuePred):
        return (jexpr.range_(e.col, e.lo, e.hi) if e.op == "range"
                else jexpr.cmp(e.col, e.op, e.lo))
    if isinstance(e, texpr.Agg):
        found = None if e.found is None else _jexpr(e.found)
        return (jexpr.sum_(e.col, found=found) if e.kind == "sum"
                else jexpr.top_k(e.col, e.k, found=found))
    raise TypeError(type(e))


def _jgroups(pool):
    return [jms.BatchGroup(g.set_id, [_jq(q) for q in g.queries])
            for g in pool]


def _same(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.cardinality, g.value) == (w.cardinality, w.value), i
        assert (g.bitmap is None) == (w.bitmap is None), i
        if g.bitmap is not None:
            assert np.array_equal(g.bitmap.to_array(), w.bitmap.to_array())


def _same_groups(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _flat_pool(form: str) -> list:
    return [tbe.BatchQuery(op, ops_, form=form)
            for op, ops_ in (("or", (0, 1, 2)), ("and", (1, 2, 3)),
                             ("xor", (0, 3)), ("andnot", (0, 1, 4)))]


def _expr_pool(form: str) -> list:
    return texpr.random_expr_pool(N, 4, depth=2, seed=3, form=form)


# ------------------------------------------------------------ vocabulary

@pytest.mark.parametrize("profile", [
    "q=8,64;rows=32;keys=4;pool=128,;heads=both;expr=2",
    "q=4;rows=8,;keys=1,2;ops=or|and,or,xor;heads=bitmap;bsi=32,64;pool=8",
    "q=2,16;rows=4,16;keys=2,;heads=cardinality;placements=single"])
def test_snap_covering_and_idempotent(profile):
    jl, tl = (jlat.Lattice.from_profile(profile),
              tlat.Lattice.from_profile(profile))
    for ops in (("or",), ("and", "or"), ("xor",), tlat.OPS):
        for q in (1, 3, 9, 64, 65):
            for rows in (1, 5, 17, 40):
                for keys in (1, 2, 3, 5):
                    for heads in (False, True):
                        for extra in ({}, {"expr": 2}, {"pool": 100},
                                      {"bsi": 31}, {"expr": 3}):
                            kw = dict(ops=ops, q=q, rows=rows, keys=keys,
                                      heads=heads, placement="single",
                                      **extra)
                            jp, tp = jl.snap(**kw), tl.snap(**kw)
                            assert (jp is None) == (tp is None), kw
                            if tp is None:
                                continue
                            assert tp.as_dict() == jp.as_dict(), kw
                            assert tl.contains(tp) and jl.contains(jp)
                            again = tl.snap(
                                ops=tp.ops, q=tp.q, rows=tp.rows,
                                keys=tp.keys, heads=tp.heads,
                                placement="single",
                                **{k: getattr(tp, k) for k in extra})
                            assert again == tp, kw


def test_profile_round_trip_and_env_knob(monkeypatch, caplog):
    spec = "q=8,64;rows=16,;keys=1,;pool=32,;heads=cardinality;expr=0"
    jl, tl = (jlat.Lattice.from_profile(spec),
              tlat.Lattice.from_profile(spec))
    assert tl.to_profile() == jl.to_profile()
    assert tlat.Lattice.from_profile(tl.to_profile()) == tl
    assert tlat.Lattice.from_profile("q=8").q == jlat.Lattice.from_profile(
        "q=8").q == (1, 2, 4, 8)
    assert tlat.Lattice.from_profile("q=8,").q == (8,)
    monkeypatch.setenv(tlat.ENV_PROFILE, spec)
    assert tlat.refresh_from_env() == tl and tlat.active() == tl
    assert jlat.refresh_from_env().to_profile() == tl.to_profile()
    tlat.deactivate()
    jlat.deactivate()
    monkeypatch.setenv(tlat.ENV_PROFILE, "q=8;bogus=3")
    with caplog.at_level(logging.WARNING):
        assert tlat.refresh_from_env() is None
        assert jlat.refresh_from_env() is None
    assert tlat.active() is None and jlat.active() is None
    warned = [r.name for r in caplog.records
              if "not a valid lattice profile" in r.getMessage()]
    assert warned == ["roaringbitmap_tpu_torch.runtime",
                      "roaringbitmap_tpu.runtime"]
    with pytest.raises(ValueError):
        tlat.activate("q=8;bogus=3")


@pytest.mark.parametrize("profile", [
    PROFILE, XPROFILE + ";delta=8;bsi=32,",
    "q=4;rows=8;keys=2;ops=or|and,xor;pool=4,64"])
@pytest.mark.parametrize("pooled", [False, True])
def test_enumerate_points(profile, pooled):
    jl, tl = (jlat.Lattice.from_profile(profile),
              tlat.Lattice.from_profile(profile))
    assert ([p.as_dict() for p in tl.enumerate_points(pooled)]
            == [p.as_dict() for p in jl.enumerate_points(pooled)])
    assert tl.n_points(pooled) == jl.n_points(pooled) == len(
        tl.enumerate_points(pooled))


# ----------------------------------------------------- padded vs exact

def _bucket_shapes(plan):
    return [(b.op, b.q, b.r_pad, b.k_pad) for b in plan]


@pytest.mark.parametrize("layout", ["dense", "compact", "counts"])
@pytest.mark.parametrize("rung", ["torch", "megakernel"])
def test_padded_vs_exact(layout, rung):
    """Snapped plans equal the exact ones and the JAX package's results,
    with the same point and padded bucket shapes."""
    je, te, _ = _single(layout)
    pool = [q for f in FORMS for q in _flat_pool(f) + _expr_pool(f)]
    exact = te.execute(pool, engine=rung, fallback=False)
    want = je.execute([_jq(q) for q in pool], engine="xla", fallback=False)
    _same(exact, want)
    tlat.activate(XPROFILE)
    jlat.activate(XPROFILE)
    snapped = te.execute(pool, engine=rung, fallback=False)
    _same(snapped, want)
    tplan, jplan = te.plan(pool), je.plan([_jq(q) for q in pool])
    assert tplan.point is not None
    assert tplan.point.as_dict() == jplan.point.as_dict()
    assert _bucket_shapes(tplan) == _bucket_shapes(jplan)
    assert [b.n_steps for b in tplan] == [b.n_steps for b in jplan]
    assert tplan.padding[0] == jplan.padding[0]


def test_megakernel_stream_snap():
    je, te, _ = _single()
    for profile in (None, XPROFILE):
        if profile:
            tlat.activate(profile)
            jlat.activate(profile)
        for q in (1, 4):
            pool = _expr_pool("bitmap")[:q]
            tm, jm = te.plan(pool).mega, je.plan([_jq(x) for x in pool]).mega
            got = (tm.n_steps, tm.steps_pad, tm.slots_pad, tm.card_pad,
                   tm.out_pad)
            assert got == (jm.n_steps, jm.steps_pad, jm.slots_pad,
                           jm.card_pad, jm.out_pad)
            if profile:
                assert tm.slots_pad >= 4 and tm.card_pad >= 8
                assert tm.steps_pad >= 16 and tm.out_pad >= 8


# ------------------------------------------------------- shape closure

MIXES = [[("or", (0, 1))],
         [("and", (0, 1, 2, 3)), ("xor", (1, 2))],
         [("andnot", (2, 0)), ("or", (3, 4, 5)), ("or", (0, 2, 4, 6))]]


def test_diverse_flat_traffic_is_one_program():
    je, te = _fresh_single()
    tlat.activate(PROFILE)
    jlat.activate(PROFILE)
    for mix in MIXES:
        pool = [tbe.BatchQuery(op, o) for op, o in mix]
        _same(te.execute(pool, engine="torch"),
              je.execute([_jq(q) for q in pool], engine="xla"))
    assert len(te._programs) == len(je._programs) == 1
    points = {te.plan([tbe.BatchQuery(op, o) for op, o in m]).point
              for m in MIXES}
    assert len(points) == 1


TENANT_MIXES = [[(0, "or", (0, 1)), (2, "and", (1, 2))],
                [(1, "xor", (0, 3)), (3, "or", (2, 4))],
                [(0, "andnot", (0, 2)), (1, "or", (1, 5)),
                 (2, "and", (0, 1, 2))]]


def test_multiset_tenant_mix_closure():
    jm, tm = _multi()
    tlat.activate(PROFILE)
    jlat.activate(PROFILE)
    for mix in TENANT_MIXES:
        pool = [tms.BatchGroup(s, [tbe.BatchQuery(op, o)]) for s, op, o in mix]
        got = tm.execute(pool, engine="torch")
        _same_groups(got, jm.execute(_jgroups(pool), engine="xla"))
        for g, rows in zip(pool, got):
            _same(rows, tm._engines[g.set_id]._execute_sequential(g.queries))
    assert len(tm._programs) == len(jm._programs) == 1


@pytest.mark.parametrize("rung", ["megakernel", "cuda", "torch"])
def test_pooled_expressions_snapped(rung):
    """A pooled expression pool snaps (every set, padded selections) and
    equals the JAX package on every rung; B5's stream runs from the pack."""
    jm, tm = _multi()
    prof = XPROFILE.replace("pool=16,", "pool=32,")
    pool = [tms.BatchGroup(s, texpr.random_expr_pool(N, 2, depth=2,
                                                     seed=10 + s,
                                                     form="bitmap"))
            for s in (0, 2)]
    want = jm.execute(_jgroups(pool), engine="xla", fallback=False)
    tlat.activate(prof)
    jlat.activate(prof)
    got = tm.execute(pool, engine=rung, fallback=False)
    _same_groups(got, want)
    tplan = tm._plan_pool(tm._flatten(pool)[0])
    jplan = jm._plan_pool(jm._flatten(_jgroups(pool))[0])
    assert tplan.point is not None
    assert tplan.point.as_dict() == jplan.point.as_dict()
    assert tplan.n_pool_rows == jplan.n_pool_rows
    assert tm._programs.replays == 1


def test_pool_rung_overflow_falls_back_exact():
    jm, tm = _multi()
    prof = "q=16,;rows=16,;keys=2,;heads=both;pool=2,"
    tlat.activate(prof)
    jlat.activate(prof)
    pool = [tms.BatchGroup(0, [tbe.BatchQuery("or", (0, 1, 2, 3))]),
            tms.BatchGroup(1, [tbe.BatchQuery("or", (0, 1))])]
    _same_groups(tm.execute(pool, engine="torch"),
                 jm.execute(_jgroups(pool), engine="xla"))
    tplan = tm._plan_pool(tm._flatten(pool)[0])
    jplan = jm._plan_pool(jm._flatten(_jgroups(pool))[0])
    assert tplan.point is None and jplan.point is None
    assert sum(len(b.qids) for b in tplan.buckets) == sum(
        len(b.qids) for b in jplan.buckets) == 2


def test_pool_rung_boundary_includes_padding_row():
    jm, tm = _multi()
    pool = [tms.BatchGroup(0, [tbe.BatchQuery("or", (1, 2, 3, 4))]),
            tms.BatchGroup(1, [tbe.BatchQuery("or", (1, 2))])]
    for rung, snaps in ((4, False), (8, True)):
        prof = f"q=16,;rows=16,;keys=2,;heads=both;pool={rung},"
        tlat.activate(prof)
        jlat.activate(prof)
        tplan = tm._plan_pool(tm._flatten(pool)[0])
        jplan = jm._plan_pool(jm._flatten(_jgroups(pool))[0])
        assert (tplan.point is not None) == (jplan.point is not None) == snaps
        if snaps:
            assert tplan.point.as_dict() == jplan.point.as_dict()
            assert all(s.size == 8 for s in tplan.row_sel.values())
            assert tplan.n_pool_rows == jplan.n_pool_rows
            assert tplan.padding[0] == jplan.padding[0]
        _same_groups(tm.execute(pool, engine="torch"),
                     jm.execute(_jgroups(pool), engine="xla"))


# ------------------------------------------------ warmup and the seal

def test_warmup_profile_reports_and_zero_escapes():
    je, te = _fresh_single()
    trep, jrep = te.warmup(profile=XPROFILE), je.warmup(profile=XPROFILE)
    assert trep["lattice"] == jrep["lattice"]
    assert tlat.sealed_active() and jlat.sealed_active()
    for seed in (1, 2, 3):
        pool = tbe.random_query_pool(N, 12, seed=seed, max_operands=5)
        got = te.execute(pool)
        _same(got, je.execute([_jq(q) for q in pool]))
        _same(got, te._execute_sequential(pool))
    assert tlat.escape_total() == jlat.escape_total() == 0
    assert _by_site(tobs, "rb_lattice_escapes_total") == {} \
        == _by_site(jobs, "rb_lattice_escapes_total")


def test_multiset_warmup_reports_and_zero_escapes():
    jm, tm = _multi()
    trep, jrep = tm.warmup(profile=PROFILE), jm.warmup(profile=PROFILE)
    assert trep["lattice"] == jrep["lattice"]
    # the same programs: the JAX package warms a donating twin of each
    # pooled program only where its backend donates (not on the CPU), and
    # the port donates nothing (ROADMAP C)
    assert len(tm._programs) == len(jm._programs)
    assert [len(e._programs) for e in tm._engines] == [
        len(e._programs) for e in jm._engines]
    pools = [tms.random_multiset_pool([N] * 4, 10, seed=s) for s in (5, 6)]
    for pool in pools:
        _same_groups(tm.execute(pool), jm.execute(_jgroups(pool)))
    got = tm.execute_pipelined(pools)
    for pool, rows in zip(pools, got):
        _same_groups(rows, jm.execute(_jgroups(pool)))
    assert tlat.escape_total() == jlat.escape_total() == 0


def test_value_traffic_replays_one_program_per_shape():
    """Value batches warmed at one predicate replay at other predicate
    values (the bits ride in the operand pack) with no escape, equal to
    the JAX package."""
    vals = _values(0x13)
    rng = np.random.default_rng(0xC01)
    ids = np.unique(rng.integers(0, 1 << 17, 4000)).astype(np.uint32)
    prices = rng.integers(0, 9000, ids.size).astype(np.int64)
    jds = JSet([JRB.from_values(v) for v in vals], layout="dense")
    tds = DeviceBitmapSet([TRB.from_values(v) for v in vals],
                          layout="dense", device=CPU)
    jds.attach_column(JBsi("price", ids, prices))
    tds.attach_column(BsiColumn("price", ids, prices, device=CPU))
    je = jbe.BatchEngine(jds, result_cache=None)
    te = tbe.BatchEngine(tds, result_cache=None)
    prof = "q=16,;rows=16,;keys=2,;heads=both;bsi=16,;expr=2"

    def batch(lo, hi, k):
        # the reduce or_(0, 1) gives the plan a bucket, so that it snaps (a
        # plan of value steps and leaves alone has no bucket to snap)
        found = texpr.and_(texpr.or_(0, 1), texpr.range_("price", lo, hi))
        return [texpr.ExprQuery(texpr.range_("price", lo, hi)),
                texpr.ExprQuery(texpr.and_(texpr.or_(0, 2),
                                           texpr.cmp("price", "le", hi))),
                texpr.ExprQuery(texpr.sum_("price", found=found)),
                texpr.ExprQuery(texpr.top_k("price", k, found=found),
                                form="bitmap")]

    assert te.warmup(profile=prof)["lattice"] == je.warmup(
        profile=prof)["lattice"]
    for rung in ("torch", "cuda", "megakernel"):
        tlat.activate(prof)
        te.execute(batch(100, 8000, 3), engine=rung)
        tlat.active().seal()
        for lo, hi, k in ((5, 4000, 2), (2000, 8500, 7), (1, 8998, 1)):
            b = batch(lo, hi, k)
            assert te.plan(b).point is not None
            replays = te._programs.replays
            got = te.execute(b, engine=rung)
            assert te._programs.replays == replays + 1
            _same(got, te._execute_sequential(b))
            _same(got, je.execute([_jq(q) for q in b], engine="xla",
                                  fallback=False))
        assert tlat.escape_total() == 0, rung


def test_warmup_refuses_a_pool_past_the_budget(monkeypatch):
    """A vocabulary whose predicted graph pool passes the device-memory
    budget raises at warmup, typed, and seals nothing."""
    from roaringbitmap_tpu_torch.runtime import errors

    _je, te = _fresh_single()
    monkeypatch.setenv("ROARING_TPU_HBM_BUDGET", "1K")
    with pytest.raises(errors.GraphPoolBudgetError):
        te.warmup(profile=PROFILE)
    assert tlat.active() is None and len(te._programs) == 0


def _by_site(o, name) -> dict:
    """{site: value} of one registry instrument of either package."""
    snap = o.snapshot()
    rows = snap["counters"].get(name, []) + snap["gauges"].get(name, [])
    return {r["labels"]["site"]: r["value"] for r in rows}


def test_escape_counted_in_both_packages(tmp_path):
    je, te = _fresh_single()
    te.warmup(profile=PROFILE)
    je.warmup(profile=PROFILE)
    big = [tbe.BatchQuery("or", (0, 1)) for _ in range(17)]
    path = tmp_path / "escape.jsonl"
    tobs.enable(str(path))
    try:
        got = te.execute(big)
    finally:
        tobs.disable()
    _same(got, je.execute([_jq(q) for q in big]))
    _same(got, te._execute_sequential(big))
    assert tlat.escape_total() == jlat.escape_total() == 1
    assert _by_site(tobs, "rb_lattice_escapes_total") == {
        "batch_engine": 1} == _by_site(jobs, "rb_lattice_escapes_total")
    (ev,) = [e for line in path.read_text().splitlines()
             for e in json.loads(line)["events"]
             if e["name"] == "lattice.escape"]
    assert set(ev) == {"name", "t_offset_ms", "site", "engine",
                       "in_vocabulary", "compile_ms"}
    assert ev["site"] == "batch_engine" and ev["in_vocabulary"] is False
    assert isinstance(ev["compile_ms"], float)
    # a second run of the same shape is no new program
    te.execute(big)
    je.execute([_jq(q) for q in big])
    assert tlat.escape_total() == jlat.escape_total() == 1


def test_padding_on_last_dispatch_memory():
    je, te = _fresh_single()
    te.warmup(profile=PROFILE)
    je.warmup(profile=PROFILE)
    pool = tbe.random_query_pool(N, 12, seed=9, max_operands=5)
    te.execute(pool)
    je.execute([_jq(q) for q in pool])
    tm, jm = te.last_dispatch_memory, je.last_dispatch_memory
    assert tm["lattice_padding_bytes"] == jm["lattice_padding_bytes"] > 0
    assert tm["lattice_padding_fraction"] == jm["lattice_padding_fraction"]
    assert _by_site(tobs, "rb_lattice_padding_bytes")["batch_engine"] \
        == tm["lattice_padding_bytes"] \
        == _by_site(jobs, "rb_lattice_padding_bytes")["batch_engine"]
    assert _by_site(tobs, "rb_lattice_padding_fraction")["batch_engine"] \
        == tm["lattice_padding_fraction"]


def test_warmup_rungs_listing():
    je, te = _fresh_single()
    rungs = (1, 2, "expr:2", "delta:8")
    trep, jrep = te.warmup(rungs=rungs), je.warmup(rungs=rungs)

    def listing(rep):
        return [(p.get("q"), p.get("buckets"), "delta_rung" in p)
                for p in rep["programs"]]

    assert listing(trep) == listing(jrep)
    assert trep["compile_cache_dir"] == str(build.BUILD_DIR)
    assert len(te._programs) == len([p for p in trep["programs"]
                                     if "q" in p])


def test_compile_cache_knob_redirects_builds(monkeypatch, tmp_path):
    src = build.SOURCES[0]
    assert build.library_path(src).parent == build.BUILD_DIR
    monkeypatch.setenv(twarm.ENV_COMPILE_CACHE, str(tmp_path / "cc"))
    assert build.library_path(src).parent == tmp_path / "cc"
    assert native.library_path().parent == tmp_path / "cc"
    assert twarm.compile_cache_dir() == str(tmp_path / "cc")
    # same name in either directory: keyed by source and flags alone
    monkeypatch.delenv(twarm.ENV_COMPILE_CACHE)
    assert build.library_path(src).parent == build.BUILD_DIR
    assert twarm.enable_compile_cache(str(tmp_path / "x")) == str(
        tmp_path / "x")
    assert native.library_path().parent == tmp_path / "x"
