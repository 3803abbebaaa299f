"""The port's mutable tenants against roaringbitmap_tpu.mutation.

The same seeded numpy inputs go through both packages: the JAX
``DeviceBitmapSet`` / ``BatchEngine`` / ``MultiSetBatchEngine`` as its own
tests run them on the CPU, the port on ``device="cpu"`` with the plain
versions of its kernels.  Held exactly equal: the mutation reports (all but
``wall_ms``), the version stamps (``version``, ``structure_version``,
``source_versions``, ``row_versions``), the delta journal, every query
result (cardinalities and ``serialize()`` bytes), ``warmup_delta``'s rungs
and the result caches' ``stats()``.

Beyond the JAX tests (``tests/test_mutation.py``): the lineage across a
repack, the engines re-reading their row maps after one, cached rows left
unchanged by an injected plan, a version-fresh host twin, the maintenance
worker's deferred commit and its failure path, the journal's append order,
and deltas on a set of u48 keys.
"""

import gc
import threading

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
from roaringbitmap_tpu.mutation import MaintenanceWorker as JWorker
from roaringbitmap_tpu.mutation import ResultCache as JCache
from roaringbitmap_tpu.mutation import delta as jdelta
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import multiset as jms
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEngine
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64
from roaringbitmap_tpu_torch.mutation import (MaintenanceWorker, ResultCache,
                                              result_cache)
from roaringbitmap_tpu_torch.mutation import delta as tdelta
from roaringbitmap_tpu_torch.ops.words import to_u32
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel import multiset as tms
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.runtime import faults

torch.set_num_threads(2)

CPU = "cpu"
RUNGS = ("megakernel", "cuda", "torch")

#: the JAX sets, engines and caches this module builds: they register with
#: the JAX package's process-global HBM ledger, so the module drops them
#: and collects before the next file runs in this worker
_JAX: list = []


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_objects():
    yield
    _JAX.clear()
    gc.collect()


def _keep(*objs):
    _JAX.extend(objs)
    return objs[0] if len(objs) == 1 else objs


def mk_values(seed, n=5, uni=1 << 17, card=2500) -> list:
    rng = np.random.default_rng(seed)
    return [np.sort(rng.choice(uni, card, replace=False)).astype(np.uint32)
            for _ in range(n)]


def both_sets(vals, layout="dense"):
    """(JAX set, port set) over the same values."""
    js = JSet([JRB.from_values(v) for v in vals], layout=layout)
    ts = DeviceBitmapSet([TRB.from_values(v) for v in vals], layout=layout,
                         device=CPU)
    return _keep(js), ts


def host_apply(hosts, adds, removes):
    out = list(hosts)
    for src in set(adds) | set(removes):
        bm = out[src].clone()
        if src in adds:
            bm = bm | TRB.from_values(np.asarray(adds[src], np.uint32))
        if src in removes:
            bm = bm - TRB.from_values(np.asarray(removes[src], np.uint32))
        out[src] = bm
    return out


def report(r: dict) -> dict:
    r = dict(r)
    r.pop("wall_ms")
    return r


def both_delta(js, ts, **kw):
    """The same delta through both packages; the reports must agree."""
    a, b = js.apply_delta(**kw), ts.apply_delta(**kw)
    assert report(a) == report(b)
    return b


def same_lineage(js, ts):
    assert (js.version, js.structure_version) == (ts.version,
                                                  ts.structure_version)
    assert np.array_equal(js.source_versions, ts.source_versions)
    assert np.array_equal(js.row_versions, ts.row_versions)


def same_sets(js, ts, ops=("or", "xor", "and")):
    for op in ops:
        assert js.aggregate(op).serialize() == ts.aggregate(op).serialize()
    assert ([b.serialize() for b in js.host_bitmaps()]
            == [b.serialize() for b in ts.host_bitmaps()])


def jq(q):
    """A port query as the JAX package's."""
    if isinstance(q, TQ):
        return JQ(q.op, q.operands, form=q.form)
    return jexpr.ExprQuery(_jexpr(q.expr), form=q.form)


def _jexpr(e):
    if isinstance(e, texpr.Ref):
        return jexpr.ref(e.index)
    if isinstance(e, texpr.Node):
        fn = {"or": jexpr.or_, "and": jexpr.and_, "xor": jexpr.xor,
              "andnot": jexpr.andnot}.get(e.op)
        if fn is not None:
            return fn(*(_jexpr(c) for c in e.children))
        if e.op == "not":
            return jexpr.not_(_jexpr(e.children[0]))
    raise TypeError(f"no JAX twin for {e!r}")


def same_results(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.cardinality, g.value) == (w.cardinality, w.value)
        assert (g.bitmap is None) == (w.bitmap is None)
        if g.bitmap is not None:
            assert g.bitmap.serialize() == w.bitmap.serialize()


# --------------------------------------------------------- delta ingest

def test_patch_and_versioning():
    js, ts = both_sets(mk_values(1))
    adds = {0: np.array([11, 12, 13], np.uint32),
            2: np.array([500, 777], np.uint32)}
    removes = {1: np.array([1, 2, 3], np.uint32)}
    rep = both_delta(js, ts, adds=adds, removes=removes)
    assert rep["mode"] == "patch" and rep["rows_patched"] >= 1
    same_sets(js, ts)
    same_lineage(js, ts)
    assert ts.version == 1 and ts.structure_version == 0
    assert set(np.flatnonzero(ts.source_versions == 1)) == {0, 1, 2}
    assert int((ts.row_versions == 1).sum()) == rep["rows_patched"]
    # the journal entry: (version, rows, add masks, remove masks)
    (jv, jr, ja, jm), = js._delta_journal
    (tv, tr, ta, tm), = ts._delta_journal
    assert jv == tv == 1
    for x, y in ((jr, tr), (ja, ta), (jm, tm)):
        assert np.array_equal(x, y)
    # removes win over adds for a value in both
    rep = both_delta(js, ts, adds={0: [99]}, removes={0: [99]})
    assert rep["mode"] == "patch"
    assert not ts.host_bitmaps()[0].contains(99)
    same_sets(js, ts)
    # a removal aimed only at containers the source lacks: no-op
    rep = both_delta(js, ts, removes={0: [(0x7F7F << 16) + 1]})
    assert rep["mode"] == "noop" and ts.version == 2
    rep = both_delta(js, ts)
    assert rep["mode"] == "noop"
    same_lineage(js, ts)


def test_patch_counts_rows_and_modes():
    """A patch and a no-op move the registry as in the JAX package:
    ``rb_delta_rows_patched_total`` and ``rb_delta_apply_seconds{mode}``
    (a no-op observes nothing)."""
    tobs.reset()
    jobs.reset()
    js, ts = both_sets(mk_values(2, n=3))
    both_delta(js, ts, adds={0: [7, 9], 1: [70000]})
    both_delta(js, ts, removes={2: [(0x7F7F << 16) + 1]})
    for o in (tobs, jobs):
        assert o.counter("rb_delta_rows_patched_total").value == 2
        assert o.histogram("rb_delta_apply_seconds", mode="patch").count == 1
        assert "noop" not in {r["labels"]["mode"] for r in o.snapshot()[
            "histograms"]["rb_delta_apply_seconds"]}


def test_structural_escalation_and_engine_resync():
    vals = mk_values(2)
    js, ts = both_sets(vals)
    je = _keep(JEngine(js, result_cache=None))
    te = BatchEngine(ts, result_cache=None)
    queries = [TQ("or", (0, 1, 2)), TQ("xor", (1, 3)),
               TQ("andnot", (1, 0, 4), form="bitmap")]
    same_results(te.execute(queries), je.execute([jq(q) for q in queries]))
    new_key = (0xBEEF << 16) + 7
    rep = both_delta(js, ts, adds={1: [new_key]})
    assert rep["mode"] == "repack" and rep["repack_reason"] == "structural"
    assert ts.structure_version == 1
    rep = both_delta(js, ts, adds={1: [new_key + 1]})
    assert rep["mode"] == "patch"
    # a repack that grows the image past its padding
    many = {0: [(0xA000 + k) << 16 for k in range(12)]}
    rep = both_delta(js, ts, adds=many)
    assert rep["mode"] == "repack" and ts.structure_version == 2
    same_lineage(js, ts)
    same_sets(js, ts)
    for rung in RUNGS:
        same_results(te.execute(queries, engine=rung),
                     je.execute([jq(q) for q in queries]))
    # the engine re-read the row maps of the re-laid image
    assert te._row_src is ts.row_src and te._row_seg is ts.row_seg


@pytest.mark.parametrize("case", ["layout", "drift", "never"])
def test_layout_drift_and_never(case):
    if case == "layout":
        js, ts = both_sets(mk_values(3), layout="counts")
        rep = both_delta(js, ts, adds={0: [5]})
        assert rep["mode"] == "repack" and rep["repack_reason"] == "layout"
        assert ts.layout == js.layout
    elif case == "drift":
        js, ts = both_sets(mk_values(4))
        rep = both_delta(js, ts, adds={0: [21]}, drift_limit=0)
        assert rep["mode"] == "repack" and rep["repack_reason"] == "drift"
        assert rep["drift"]["fired"]
    else:
        js, ts = both_sets(mk_values(5))
        words0 = ts.words.clone()
        for s in (js, ts):
            with pytest.raises(ValueError, match="repack"):
                s.apply_delta(adds={0: [(0x7777 << 16) + 1]}, repack="never")
        assert ts.version == js.version == 0
        assert ts._mutated_values == js._mutated_values == 0
        assert torch.equal(ts.words, words0)
    same_lineage(js, ts)
    same_sets(js, ts)


@pytest.mark.parametrize("layout", ["dense", "counts"])
@pytest.mark.parametrize("fault_spec",
                         [None, "transient@batch_engine=0.4:1337"])
def test_property_interleaved_delta_query_stream(layout, fault_spec):
    """Interleaved deltas and batches stay equal to the JAX package and the
    host oracle, across layouts and under fault injection; the caches'
    counts stay equal too."""
    rng = np.random.default_rng(0xD17A)
    vals = mk_values(6, n=4, uni=1 << 16, card=800)
    js, ts = both_sets(vals, layout=layout)
    jc, tc = _keep(JCache(4 << 20)), ResultCache(4 << 20)
    je = _keep(JEngine(js, result_cache=jc))
    te = BatchEngine(ts, result_cache=tc)
    hosts = [TRB.from_values(v) for v in vals]
    e = texpr.and_(texpr.or_(0, 1), texpr.not_(3))
    queries = [TQ("or", (0, 1, 2)), TQ("xor", (1, 3), form="bitmap"),
               TQ("andnot", (2, 0)), texpr.ExprQuery(e)]
    for step in range(10):
        if step % 2 == 0:
            src = int(rng.integers(4))
            universe = 1 << 16 if rng.random() < 0.8 else 1 << 18
            adds = {src: rng.integers(0, universe, 5).astype(np.uint32)}
            rem_src = int(rng.integers(4))
            pool = hosts[rem_src].to_array()
            removes = {rem_src: rng.choice(pool, 3)} if pool.size else {}
            both_delta(js, ts, adds=adds, removes=removes)
            hosts = host_apply(hosts, adds, removes)
        if fault_spec:
            with jfaults.inject(fault_spec):
                want = je.execute([jq(q) for q in queries])
            with faults.inject(fault_spec):
                got = te.execute(queries)
        else:
            want = je.execute([jq(q) for q in queries])
            got = te.execute(queries)
        same_results(got, want)
        assert got[0].cardinality == (hosts[0] | hosts[1]
                                      | hosts[2]).cardinality, step
        assert got[1].bitmap == hosts[1] ^ hosts[3], step
        assert got[2].cardinality == (hosts[2] - hosts[0]).cardinality
        assert got[3].cardinality == texpr.evaluate_host(
            e, hosts).cardinality, step
        assert tc.stats() == jc.stats(), step
    same_lineage(js, ts)


@pytest.mark.parametrize("n", [1, 2, 4, 5, 64])
def test_warmup_delta_rungs(n):
    js, ts = both_sets(mk_values(7, n=3))
    want, got = js.warmup_delta(n), ts.warmup_delta(n)
    assert got == want and got["compiled"] is True
    assert len(ts._delta_programs) == len(got["rungs"])
    js, ts = both_sets(mk_values(7, n=3), layout="compact")
    want, got = js.warmup_delta(n), ts.warmup_delta(n)
    assert got == want


def _delta_stream(seed: int, steps: int = 6) -> list:
    """Seeded deltas inside the containers of ``mk_values(7)``'s sources
    (keys 0 and 1 of five sources): patches of 1 to 10 rows."""
    rng = np.random.default_rng(1000 + seed)
    out = []
    for _ in range(steps):
        srcs = rng.choice(5, int(rng.integers(1, 6)), replace=False)
        adds = {int(s): rng.integers(0, 1 << 17, 40) for s in srcs}
        removes = {int(s): rng.integers(0, 1 << 17, 40)
                   for s in srcs[:int(rng.integers(0, srcs.size + 1))]}
        out.append((adds, removes))
    return out


@pytest.mark.parametrize("seed", range(24))
def test_warmed_rungs_replay_equal_to_eager_patch(seed):
    """A set whose "delta:N" rungs are warmed pads each patch to its rung
    and runs the rung's program; image, host twin, journal and reports
    equal the eager set's and the JAX package's."""
    vals = mk_values(7)
    js, warm = both_sets(vals)
    eager = DeviceBitmapSet([TRB.from_values(v) for v in vals], device=CPU)
    assert warm.warmup_delta(16) == js.warmup_delta(16)
    for adds, removes in _delta_stream(seed):
        want = report(js.apply_delta(adds=adds, removes=removes))
        assert report(warm.apply_delta(adds=adds, removes=removes)) == want
        assert report(eager.apply_delta(adds=adds, removes=removes)) == want
        assert want["mode"] == "patch"
        assert torch.equal(warm.words, eager.words)
    for a, b in zip(warm._delta_journal, eager._delta_journal):
        assert a[0] == b[0] and all(np.array_equal(x, y)
                                    for x, y in zip(a[1:], b[1:]))
    same_sets(js, warm)
    same_lineage(js, warm)
    assert len(warm._delta_programs) == 5 and not eager._delta_programs


def test_warmed_rung_pads_and_counts_compiles():
    """Warmup observes one compile miss a rung on
    ``rb_compile_seconds{site="mutation"}``, a warmed in-band patch a hit;
    a rung's staged operands are the JAX package's padded patch (extra
    entries on the padding row, zero masks), and only the patch's rows
    change."""
    tobs.reset()
    js, ts = both_sets(mk_values(7))
    rep = ts.warmup_delta(4)
    hist = lambda c: tobs.histogram("rb_compile_seconds", site="mutation",
                                    cache=c).count
    assert hist("miss") == len(rep["rungs"]) == 3 and hist("hit") == 0
    rows = np.flatnonzero(ts.row_src >= 0)[:3].astype(np.int32)
    rng = np.random.default_rng(3)
    add = rng.integers(0, 1 << 32, (3, 2048), dtype=np.uint64).astype(
        np.uint32)
    rem = np.zeros((3, 2048), np.uint32)
    prog = ts._delta_programs[tdelta._program_key(ts, 4)]
    before = ts.words.clone()
    prog.run(ts, rows, add, rem)
    rows_p, add_p, rem_p, p_pad = jdelta._pad_patch(js, rows, add, rem)
    assert p_pad == prog.p_pad == 4
    assert np.array_equal(prog.rows.numpy(), rows_p)
    assert np.array_equal(to_u32(prog.masks[:, 0]), add_p)
    assert np.array_equal(to_u32(prog.masks[:, 1]), rem_p)
    assert rows_p[3] == tdelta._pad_row(ts) and ts.row_src[rows_p[3]] < 0
    want = before.clone()
    want[torch.from_numpy(rows).long()] |= torch.from_numpy(add.view(np.int32))
    assert torch.equal(ts.words, want)
    ts.words.copy_(before)
    both_delta(js, ts, adds={0: [5, 6], 1: [70001], 2: [9]})
    assert hist("hit") == 1
    same_sets(js, ts)


def test_repack_drops_patch_programs():
    """A repack replaces the image the graphs write: the set's programs
    are dropped first, a later patch runs cold and exact, and a new
    warmup keys on the new image."""
    js, ts = both_sets(mk_values(7))
    ts.warmup_delta(8)
    js.warmup_delta(8)
    key0 = next(iter(ts._delta_programs))
    rep = both_delta(js, ts, adds={0: [(9 << 16) + 1]})
    assert rep["mode"] == "repack" and ts._delta_programs == {}
    both_delta(js, ts, adds={1: [3, 4]})
    same_sets(js, ts)
    assert ts.warmup_delta(8)["compiled"] is True
    assert next(iter(ts._delta_programs))[2] == ts.words.data_ptr()
    assert key0[:2] == next(iter(ts._delta_programs))[:2] or \
        key0[0] != ts._n_rows
    both_delta(js, ts, removes={1: [3]})
    same_sets(js, ts)
    assert tdelta.drop_patch_programs(ts) == 4


# --------------------------------------------------------- result cache

def cached_pair(vals, nbytes=8 << 20, layout="dense"):
    js, ts = both_sets(vals, layout=layout)
    jc, tc = _keep(JCache(nbytes)), ResultCache(nbytes)
    return (_keep(JEngine(js, result_cache=jc)), jc,
            BatchEngine(ts, result_cache=tc), tc)


def test_result_cache_serves_flat_and_expr():
    je, jc, te, tc = cached_pair(mk_values(8))
    steps = [
        [TQ("or", (0, 1, 2)), TQ("xor", (1, 3), form="bitmap")],
        [TQ("or", (0, 1, 2)), TQ("xor", (1, 3), form="bitmap")],
        # the same canonical DAG shares the flat entry
        [texpr.ExprQuery(texpr.or_(2, 0, 1))],
        # a bitmap query misses on a cardinality entry, then upgrades it
        [TQ("or", (0, 1, 2), form="bitmap")],
        [TQ("or", (0, 1, 2))],
    ]
    for qs in steps:
        same_results(te.execute(qs), je.execute([jq(q) for q in qs]))
        assert tc.stats() == jc.stats()
    assert tc.stats()["hits"] == 4 and tc.stats()["entries"] == 2


def test_subtree_injection_counts_cached_nodes():
    vals = mk_values(9, n=6)
    je, jc, te, tc = cached_pair(vals)
    sub = [texpr.ExprQuery(texpr.or_(0, 4), form="bitmap")]
    same_results(te.execute(sub), je.execute([jq(q) for q in sub]))
    e = texpr.and_(texpr.or_(0, 4), texpr.not_(5))
    q = [texpr.ExprQuery(e)]
    same_results(te.execute(q), je.execute([jq(x) for x in q]))
    assert tc.stats() == jc.stats()
    tplan, jplan = te.plan(tuple(q)), je.plan(tuple(jq(x) for x in q))
    assert tplan.exprs[0].n_cached == jplan.exprs[0].n_cached >= 1
    hosts = [TRB.from_values(v) for v in vals]
    want = texpr.evaluate_host(e, hosts).cardinality
    for rung in RUNGS:
        got = te.execute([texpr.ExprQuery(e, form="bitmap")], engine=rung)
        assert got[0].cardinality == want
        assert got[0].bitmap == texpr.evaluate_host(e, hosts)


def test_cached_rows_unchanged_after_injected_plan():
    """Plans only read an injected entry's rows: the same injected plan run
    twice on every rung leaves them as they were."""
    vals = mk_values(10, n=6)
    tc = ResultCache(8 << 20)
    _, ts = both_sets(vals)
    te = BatchEngine(ts, result_cache=tc)
    te.execute([texpr.ExprQuery(texpr.or_(0, 4), form="bitmap")])
    (entry,) = tc._data.values()
    before = entry.words.clone()
    hosts = [TRB.from_values(v) for v in vals]
    for e in (texpr.and_(texpr.or_(0, 4), texpr.not_(5)),
              texpr.xor(texpr.or_(0, 4), texpr.and_(1, 2)),
              texpr.andnot(texpr.or_(0, 4), texpr.ref(3))):
        q = [texpr.ExprQuery(e, form="bitmap")]
        assert te.plan(q).exprs[0].n_cached >= 1
        for rung in RUNGS:
            for _ in range(2):
                got = te.execute(q, engine=rung, fallback=False)
                assert got[0].bitmap == texpr.evaluate_host(e, hosts)
                assert torch.equal(entry.words, before)
    assert entry.bitmap == hosts[0] | hosts[4]


def test_exact_invalidation():
    je_a, jc, te_a, tc = cached_pair(mk_values(10))
    vb = mk_values(11)
    jsb, tsb = both_sets(vb)
    je_b = _keep(JEngine(jsb, result_cache=jc))
    te_b = BatchEngine(tsb, result_cache=tc)

    def run(qs, a=True):
        je, te = (je_a, te_a) if a else (je_b, te_b)
        same_results(te.execute(qs), je.execute([jq(q) for q in qs]))
        assert tc.stats() == jc.stats()

    run([TQ("or", (0, 1)), TQ("xor", (2, 3), form="bitmap")])
    run([TQ("or", (0, 1), form="bitmap")], a=False)
    assert tc.stats()["entries"] == 3
    # bump ONE leaf: only its dependents drop
    both_delta(je_a._ds, te_a._ds, adds={0: [123]})
    assert tc.stats() == jc.stats()
    assert tc.stats()["entries"] == 2 and tc.stats()["invalidations"] == 1
    run([TQ("or", (0, 1), form="bitmap")], a=False)
    run([TQ("xor", (2, 3), form="bitmap")])
    assert tc.stats()["hits"] == 2
    # the dropped entry fills again with the post-delta result
    run([TQ("or", (0, 1))])
    hosts = host_apply([TRB.from_values(v) for v in mk_values(10)],
                       {0: [123]}, {})
    assert te_a.execute([TQ("or", (0, 1))])[0].cardinality == (
        hosts[0] | hosts[1]).cardinality


def test_byte_budget_eviction():
    vals = mk_values(12, n=8)
    probe_c = ResultCache(1 << 30)
    _, ts = both_sets(vals)
    BatchEngine(ts, result_cache=probe_c).execute(
        [TQ("or", (0, 1), form="bitmap")])
    one = probe_c.nbytes
    je, jc, te, tc = cached_pair(vals, nbytes=int(one * 2.5))
    for i in range(6):
        qs = [TQ("or", (i % 7, (i + 1) % 7), form="bitmap")]
        same_results(te.execute(qs), je.execute([jq(q) for q in qs]))
        assert tc.stats() == jc.stats()
    assert tc.stats()["evictions"] >= 1 and tc.nbytes <= tc.max_bytes
    # an entry larger than the whole budget is refused
    small = ResultCache(64)
    small.put(("k",), frozenset(), te.execute(qs)[0], device=CPU)
    assert small.stats()["entries"] == 0


def test_cache_knob_from_env(monkeypatch):
    from roaringbitmap_tpu.mutation import result_cache as jrc

    monkeypatch.setenv("ROARING_TPU_RESULT_CACHE", "3M")
    tc, jc = result_cache.from_env(), _keep(jrc.from_env())
    assert tc.max_bytes == jc.max_bytes == 3 << 20
    assert result_cache.from_env() is tc
    _, ts = both_sets(mk_values(13, n=3))
    assert BatchEngine(ts).result_cache is tc
    monkeypatch.setenv("ROARING_TPU_RESULT_CACHE", "0")
    assert result_cache.from_env() is None and jrc.from_env() is None
    monkeypatch.delenv("ROARING_TPU_RESULT_CACHE")
    assert result_cache.from_env() is None
    assert BatchEngine(ts).result_cache is None


def _tenants():
    return [mk_values(20 + i, n=4, uni=1 << 16, card=900) for i in range(3)]


def _jpool(pool):
    return [jms.BatchGroup(g.set_id, [jq(q) for q in g.queries])
            for g in pool]


def test_multiset_cache_and_tenant_invalidation():
    tenants = _tenants()
    jc, tc = _keep(JCache(16 << 20)), ResultCache(16 << 20)
    jm = _keep(jms.MultiSetBatchEngine(
        [JSet([JRB.from_values(v) for v in t], layout="dense")
         for t in tenants], result_cache=jc))
    tm = tms.MultiSetBatchEngine(
        [DeviceBitmapSet([TRB.from_values(v) for v in t], layout="dense",
                         device=CPU) for t in tenants], result_cache=tc)
    pool = tms.random_multiset_pool([4] * 3, 12, seed=5)

    def run():
        got, want = tm.execute(pool), jm.execute(_jpool(pool))
        for g, w in zip(got, want):
            same_results(g, w)
        assert tc.stats() == jc.stats()
        return got

    first = run()
    run()
    assert tc.stats()["hits"] >= len(first)
    assert tm.count_cache_hits(pool) == jm.count_cache_hits(_jpool(pool)) > 0
    inval0 = tc.stats()["invalidations"]
    both_delta(jm._engines[1]._ds, tm._engines[1]._ds, adds={0: [3]})
    assert tc.stats() == jc.stats() and tc.stats()["invalidations"] > inval0
    # only tenant 1's entries dropped
    assert all(leaf[0] != tm._engines[1]._ds.uid or leaf[1] != 0
               for leaf in tc._by_leaf)
    run()
    # an image-growing repack of tenant 0 retires its pooled plans
    both_delta(jm._engines[0]._ds, tm._engines[0]._ds,
               adds={1: [(0xB000 + k) << 16 for k in range(12)]})
    got = run()
    for gi, g in enumerate(pool):
        e = tm._engines[g.set_id]
        assert [r.cardinality for r in got[gi]] == [
            e._sequential_result(q).cardinality for q in g.queries]


def test_multiset_pipelined_serves_from_cache():
    tenants = _tenants()
    tc = ResultCache(16 << 20)
    tm = tms.MultiSetBatchEngine(
        [DeviceBitmapSet([TRB.from_values(v) for v in t], layout="dense",
                         device=CPU) for t in tenants], result_cache=tc)
    plain = tms.MultiSetBatchEngine(
        [DeviceBitmapSet([TRB.from_values(v) for v in t], layout="dense",
                         device=CPU) for t in tenants], result_cache=None)
    pools = [tms.random_multiset_pool([4] * 3, 12, seed=s) for s in (5, 6)]
    want = [plain.execute(p) for p in pools]
    for rep in range(2):
        n0 = tm.launch_count
        got = tm.execute_pipelined(pools)
        for gp, wp in zip(got, want):
            for g, w in zip(gp, wp):
                same_results(g, w)
        if rep:
            assert tm.launch_count == n0     # every query served
    assert tc.stats()["hits"] == sum(len(g.queries) for p in pools
                                     for g in p)


# ------------------------------------------------------- the new cases

def test_lineage_survives_repack():
    from roaringbitmap_tpu_torch.analytics import BsiColumn

    vals = mk_values(14)
    _, ts = both_sets(vals)
    col = BsiColumn("price", np.arange(100, dtype=np.uint32),
                    np.arange(100), device=CPU)
    ts.attach_column(col)
    uid = ts.uid
    te = BatchEngine(ts, result_cache=None)
    ms = tms.MultiSetBatchEngine([te, DeviceBitmapSet(
        [TRB.from_values(v) for v in mk_values(15, n=3)], device=CPU)])
    pool = [tms.BatchGroup(0, [TQ("or", (0, 1)), TQ("and", (2, 3))]),
            tms.BatchGroup(1, [TQ("xor", (0, 1, 2))])]
    ms.execute(pool)
    rows0 = ms._rows[0]
    stale_src = te._row_src
    ts.apply_delta(adds={2: [(0xC000 + k) << 16 for k in range(40)]})
    assert ts.uid == uid and ts.columns == {"price": col}
    assert ts.structure_version == 1
    assert ts.source_versions[2] == ts.version == 1
    assert ts._n_rows != rows0
    got = ms.execute(pool)
    assert ms._rows[0] == ts._n_rows and te._row_src is not stale_src
    hosts = host_apply([TRB.from_values(v) for v in vals],
                       {2: [(0xC000 + k) << 16 for k in range(40)]}, {})
    assert got[0][0].cardinality == (hosts[0] | hosts[1]).cardinality
    assert got[0][1].cardinality == (hosts[2] & hosts[3]).cardinality
    q = texpr.ExprQuery(texpr.sum_("price", found=texpr.ref(0)))
    assert te.execute([q])[0].value == te._execute_sequential([q])[0].value


def test_host_twin_stays_version_fresh():
    vals = mk_values(16, n=3)
    _, ts = both_sets(vals)
    hosts = [TRB.from_values(v) for v in vals]
    assert ts.host_bitmaps() == hosts
    d1 = ({0: [1, 2, 3]}, {1: [int(vals[1][0])]})
    ts.apply_delta(*d1)
    hosts = host_apply(hosts, *d1)
    # advanced incrementally: the twin is keyed by the new version
    assert ts._host_cache[0] == ts.version == 1
    assert ts.host_bitmaps() == hosts
    ts._host_cache = None
    d2 = ({2: [5]}, {})
    ts.apply_delta(*d2)
    hosts = host_apply(hosts, *d2)
    # rebuilt from the patched image on demand
    assert ts._host_cache is None and ts.host_bitmaps() == hosts
    assert ts._host_cache[0] == 2


@pytest.mark.parametrize("threaded", [False, True])
def test_maintenance_deferred_commit(threaded):
    vals = mk_values(17)
    js, ts = both_sets(vals)
    jw, tw = JWorker(start=threaded), MaintenanceWorker(start=threaded)
    je = _keep(JEngine(js, result_cache=None))
    te = BatchEngine(ts, result_cache=None)
    qs = [TQ("or", (0, 1, 2), form="bitmap"), TQ("xor", (1, 3))]
    pre = te.execute(qs)
    if threaded:
        # hold both commits until the in-between patch has landed
        gate = threading.Event()
        jw.submit(gate.wait, kind="gate")
        tw.submit(gate.wait, kind="gate")
    structural = {1: [(0xBEEF << 16) + 7]}
    a = js.apply_delta(adds=structural, worker=jw)
    b = ts.apply_delta(adds=structural, worker=tw)
    assert report(a) == report(b) and b["mode"] == "repack_queued"
    assert ts.version == 0
    same_results(te.execute(qs), pre)          # the pre-delta image serves
    b2 = ts.apply_delta(adds={0: [42]}, worker=tw)   # a patch in between
    a2 = js.apply_delta(adds={0: [42]}, worker=jw)
    assert report(a2) == report(b2) and b2["mode"] == "patch"
    if threaded:
        gate.set()
    jw.drain()
    tw.drain()
    assert tw.jobs_done == (2 if threaded else 1) and tw.jobs_failed == 0
    same_lineage(js, ts)
    assert ts.structure_version == 1
    same_results(te.execute(qs), je.execute([jq(q) for q in qs]))
    hosts = host_apply(host_apply([TRB.from_values(v) for v in vals],
                                  structural, {}), {0: [42]}, {})
    assert te.execute(qs)[0].bitmap == hosts[0] | hosts[1] | hosts[2]
    tw.stop()
    jw.stop()


def test_maintenance_failure_keeps_the_pre_delta_image(monkeypatch):
    vals = mk_values(18)
    _, ts = both_sets(vals)
    te = BatchEngine(ts, result_cache=None)
    qs = [TQ("or", (0, 1, 2), form="bitmap")]
    pre = te.execute(qs)
    tw = MaintenanceWorker(start=False)

    def boom(*a, **k):
        raise RuntimeError("repack failed")

    monkeypatch.setattr(tdelta, "repack_in_place", boom)
    rep = ts.apply_delta(adds={1: [(0xBEEF << 16) + 7]}, worker=tw)
    assert rep["mode"] == "repack_queued"
    tw.drain()
    assert tw.jobs_failed == 1 and tw.jobs_done == 0
    assert isinstance(tw.last_error, RuntimeError)
    assert ts.version == 0 and ts.structure_version == 0
    same_results(te.execute(qs), pre)
    # the worker keeps going after a failure
    tw.submit(lambda: None)
    tw.drain()
    assert tw.jobs_done == 1


class _StubJournal:
    def __init__(self, ds):
        self.ds = ds
        self.calls = []

    def wal_delta(self, adds, removes):
        ds = self.ds
        self.calls.append((adds, removes, ds.version,
                           None if ds.words is None else ds.words.clone()))
        return len(self.calls)


class _JStub:
    def __init__(self):
        self.calls = []

    def wal_delta(self, adds, removes):
        self.calls.append((adds, removes))
        return len(self.calls)


def test_journal_appends_before_apply():
    js, ts = both_sets(mk_values(19, n=3))
    tj, jj = _StubJournal(ts), _JStub()
    words0 = ts.words.clone()
    kw = dict(adds={0: [9, 3, 3]}, removes={2: [int(mk_values(19)[2][0])]})
    a = jdelta.apply_delta(js, journal=jj, **kw)
    b = ts.apply_delta(journal=tj, **kw)
    assert report(a) == report(b) and b["mode"] == "patch"
    (adds, removes, version, words), = tj.calls
    # journaled before any state moved: the old version and image
    assert version == 0 and torch.equal(words, words0)
    (jadds, jremoves), = jj.calls
    for x, y in ((adds, jadds), (removes, jremoves)):
        assert x.keys() == y.keys()
        assert all(np.array_equal(x[k], y[k]) for k in x)
    # a delta that normalizes to nothing is not journaled
    jdelta.apply_delta(js, adds={1: []}, journal=jj)
    ts.apply_delta(adds={1: []}, journal=tj)
    assert len(tj.calls) == len(jj.calls) == 1
    # a refused delta was journaled first, as in the JAX package
    for fn, j in ((lambda **k: jdelta.apply_delta(js, **k), jj),
                  (ts.apply_delta, tj)):
        with pytest.raises(ValueError):
            fn(adds={0: [(0x6666 << 16) + 1]}, repack="never", journal=j)
    assert len(tj.calls) == len(jj.calls) == 2


def _u48_values(seed):
    rng = np.random.default_rng(seed)
    return [np.concatenate([rng.integers(0, 1 << 17, 500),
                            rng.integers(1 << 32, (1 << 32) + (1 << 17), 500)]
                           ).astype(np.uint64) for _ in range(6)]


def test_delta_on_u48_key_set():
    vals = _u48_values(21)
    js = _keep(JSet([J64.from_values(v) for v in vals], layout="dense"))
    ts = DeviceBitmapSet([T64.from_values(v) for v in vals], layout="dense",
                         device=CPU)
    assert ts.keys.dtype == js.keys.dtype == np.uint64
    rep = both_delta(js, ts, adds={0: [5, 6]},
                     removes={1: [int(vals[1].min())]})
    assert rep["mode"] == "patch"
    same_lineage(js, ts)
    for j, t in zip(js.host_bitmaps(), ts.host_bitmaps()):
        assert type(t) is T64
        assert np.array_equal(j.to_array(), t.to_array())
    rep = both_delta(js, ts, adds={0: [(0x7777 << 16) + 1]})
    assert rep["mode"] == "repack" and rep["repack_reason"] == "structural"
    same_lineage(js, ts)
    for j, t in zip(js.host_bitmaps(), ts.host_bitmaps()):
        assert np.array_equal(j.to_array(), t.to_array())
    for op in ("or", "xor", "and"):
        assert np.array_equal(js.aggregate(op).to_array(),
                              ts.aggregate(op).to_array())
    for s in (js, ts):
        with pytest.raises(ValueError, match="u32 universe"):
            s.apply_delta(adds={0: [(1 << 32) + 5]})


def test_cached_subtree_over_u48_keys():
    """Cached rows keep the set's key dtype: a subtree injected over u48
    keys past 2^16 answers as the host oracle on every rung (the JAX
    package casts them to u16, hidden behind ROADMAP C5)."""
    vals = _u48_values(22)
    ts = DeviceBitmapSet([T64.from_values(v) for v in vals], layout="dense",
                         device=CPU)
    te = BatchEngine(ts, result_cache=ResultCache(8 << 20))
    hosts = ts.host_bitmaps()
    te.execute([texpr.ExprQuery(texpr.or_(0, 4), form="bitmap")])
    e = texpr.xor(texpr.or_(0, 4), texpr.ref(5))
    want = texpr.evaluate_host(e, hosts)
    assert te.plan([texpr.ExprQuery(e)]).exprs[0].n_cached == 1
    for rung in RUNGS:
        got = te.execute([texpr.ExprQuery(e, form="bitmap")], engine=rung,
                         fallback=False)
        assert np.array_equal(got[0].bitmap.to_array(), want.to_array())


def test_repack_keeps_the_image_it_replaces():
    """The repack swaps a new layout in: a tensor handle to the old image
    stays the old image (no in-place rebuild under a reader)."""
    _, ts = both_sets(mk_values(23, n=3))
    old = ts.words
    snap = old.clone()
    ts.apply_delta(adds={0: [(0x5555 << 16) + 1]})
    assert ts.words is not old and torch.equal(old, snap)
    # a patch, by contrast, writes the live image in place
    live = ts.words
    ptr = live.data_ptr()
    ts.apply_delta(adds={1: [3]})
    assert ts.words is live and live.data_ptr() == ptr
    assert to_u32(live).any()
