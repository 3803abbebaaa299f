"""Byte-backed sources on the port's device paths, on the CPU.

The same numpy-seeded bitmaps enter each engine twice, as heap
``RoaringBitmap``s and as the port's ``buffer.ImmutableRoaringBitmap``s
over their serialized bytes, and must give the same results bit for bit,
equal to the JAX package's on its own immutables: the wide ops, pairwise,
``DeviceBitmapSet`` in every layout, batches and expressions on every rung,
the mesh path's byte ingest, the fast-aggregation strategies, value columns
over an ``ImmutableBitSliceIndex`` and a mapped ``RangeBitmap``, and the
64-bit entry points over ``Roaring64NavigableMap``s.  Everything is exact.
"""

import gc

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.buffer import ImmutableRoaringBitmap as JIM
from roaringbitmap_tpu.bsi.immutable import ImmutableBitSliceIndex as JIBSI
from roaringbitmap_tpu.core.bitmap64 import Roaring64NavigableMap as JNM
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import aggregation as tagg
from roaringbitmap_tpu_torch.analytics import BsiColumn, RangeColumn
from roaringbitmap_tpu_torch.bsi import (ImmutableBitSliceIndex,
                                         RoaringBitmapSliceIndex)
from roaringbitmap_tpu_torch.buffer import ImmutableRoaringBitmap as TIM
from roaringbitmap_tpu_torch.core.bitmap64 import (Roaring64Bitmap,
                                                   Roaring64NavigableMap)
from roaringbitmap_tpu_torch.core.bitset import RoaringBitSet
from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap
from roaringbitmap_tpu_torch.core.writer import RoaringBitmapWriter
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel import fast_aggregation as tfast
from roaringbitmap_tpu_torch.parallel import sharding
from roaringbitmap_tpu_torch.parallel.aggregation import (DeviceBitmap,
                                                          DeviceBitmapSet,
                                                          DevicePairSet)
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           BatchQuery,
                                                           random_query_pool)

CPU = "cpu"
LAYOUTS = ["dense", "compact", "counts"]


def _values(seed: int = 0x14, n: int = 8) -> list:
    """Mixed shapes: sparse arrays, a dense bitmap chunk, runs, a shared
    core so the AND keeps keys."""
    rng = np.random.default_rng(seed)
    core = rng.integers(0, 1 << 18, 1500)
    out = []
    for i in range(n):
        parts = [core, rng.integers(0, 1 << 19, 1000)]
        if i % 3 == 0:
            parts.append((3 << 16) + rng.choice(1 << 16, 6000, replace=False))
        if i % 4 == 1:
            s = int(rng.integers(0, 1 << 18))
            parts.append(np.arange(s, s + 9000))
        out.append(np.unique(np.concatenate(parts)).astype(np.uint32))
    return out


def _heap(cls=TRB, runs: bool = True) -> list:
    bms = [cls.from_values(v) for v in _values()]
    if runs:
        for b in bms[1::4]:
            b.run_optimize()
    return bms


def _imms(bms, cls=TIM) -> list:
    return [cls(memoryview(b.serialize())) for b in bms]


def _ser(x):
    return x.serialize()


@pytest.fixture(scope="module", autouse=True)
def _drop_jax_objects():
    """The JAX sets built here register with the JAX package's HBM ledger:
    collect them when the module ends."""
    yield
    gc.collect()


# ------------------------------------------------------------ wide ops

@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("op", ["or_", "xor", "and_"])
def test_wide_ops_over_immutables(op, engine):
    heap = _heap()
    ims = _imms(heap)
    kw = {} if op == "and_" else {"engine": engine}
    got = getattr(tagg, op)(ims, device=CPU, fallback=False, **kw)
    want = getattr(tagg, op)(heap, device=CPU, fallback=False, **kw)
    jwant = getattr(jagg, op)(_imms(_heap(JRB), JIM), fallback=False,
                              **({} if op == "and_" else {"engine": "xla"}))
    assert type(got) is TRB
    assert _ser(got) == _ser(want) == _ser(jwant)
    assert got.cardinality > 0
    # under the guard too, and mixed with heap sources
    mixed = [b if i % 2 else im for i, (b, im) in enumerate(zip(heap, ims))]
    assert _ser(getattr(tagg, op)(mixed, device=CPU)) == _ser(want)


@pytest.mark.parametrize("op", ["or", "xor", "and"])
def test_wide_cardinalities_over_immutables(op):
    heap = _heap()
    ims = _imms(heap)
    fn = getattr(tagg, f"{op}_cardinality")
    kw = {} if op == "and" else {"engine": "cuda"}
    got = fn(ims, device=CPU, **kw)
    assert got == fn(heap, device=CPU, **kw) == getattr(
        jagg, f"{op}_cardinality")(_imms(_heap(JRB), JIM))


def test_single_immutable_and_host_fold():
    """One source comes back as a heap copy; the guard's host fold and the
    shadow check start from a copy of an immutable seed."""
    heap = _heap()
    im = _imms(heap[:1])[0]
    for fn in (tagg.or_, tagg.xor, tagg.and_):
        out = fn([im], device=CPU)
        assert type(out) is TRB and _ser(out) == _ser(heap[0])
    ims = _imms(heap)
    for op in ("or", "xor", "and"):
        assert _ser(tagg._sequential_reduce(op, ims)) == _ser(
            tagg._sequential_reduce(op, heap))


def test_wide_and_decodes_only_surviving_containers():
    """The AND intersects keys first and decodes only the surviving
    containers of a byte-backed source."""
    rng = np.random.default_rng(5)
    wide = TRB.from_values(np.concatenate(
        [(k << 16) + rng.choice(1 << 16, 300, replace=False)
         for k in range(64)]).astype(np.uint32))
    probe = TRB.from_values((7 << 16) + np.arange(0, 1 << 16, 5,
                                                  dtype=np.uint32))
    im = TIM(wide.serialize())
    got = tagg.and_([im, probe], device=CPU)
    assert _ser(got) == _ser(wide & probe) and len(im._cache) == 1


def test_pairwise_over_immutables():
    heap = _heap()
    pairs = list(zip(heap[0::2], heap[1::2]))
    ipairs = [(TIM(a.serialize()), b) for a, b in pairs]
    for op in ("or", "and", "xor", "andnot"):
        got = tagg.pairwise(op, ipairs, device=CPU)
        want = tagg.pairwise(op, pairs, device=CPU)
        assert [_ser(x) for x in got] == [_ser(x) for x in want]
        assert np.array_equal(
            tagg.pairwise_cardinality(op, ipairs, device=CPU),
            [w.cardinality for w in want])
    for layout in ("dense", "compact"):
        ps = DevicePairSet(ipairs, layout=layout, device=CPU)
        assert np.array_equal(ps.cardinalities("xor"),
                              DevicePairSet(pairs, layout=layout,
                                            device=CPU).cardinalities("xor"))


def test_device_bitmap_and_explain_over_immutables():
    heap = _heap()
    im = TIM(heap[0].serialize())
    a, b = DeviceBitmap.from_host(im, device=CPU), DeviceBitmap.from_host(
        heap[1], device=CPU)
    assert _ser((a | b).materialize()) == _ser(heap[0] | heap[1])
    assert tagg.explain_wide("or", _imms(heap), device=CPU) == \
        tagg.explain_wide("or", heap, device=CPU)


# --------------------------------------------------------- resident sets

@pytest.mark.parametrize("layout", LAYOUTS + ["auto"])
def test_device_set_of_immutables(layout):
    """Every layout built from immutables equals the heap-built set: the
    same layout choice, packed rows and row sources, aggregates on every
    engine, and host copies; and the JAX package's set of its immutables."""
    heap = _heap()
    ims = _imms(heap)
    ts = DeviceBitmapSet(ims, layout=layout, device=CPU)
    th = DeviceBitmapSet(heap, layout=layout, device=CPU)
    # the JAX set over its immutables once, on the layout "auto" picks
    js = (jagg.DeviceBitmapSet(_imms(_heap(JRB), JIM), layout=layout)
          if layout == "auto" else None)
    assert ts.layout == th.layout == (ts.layout if js is None else js.layout)
    assert np.array_equal(ts.row_src, th.row_src)
    engines = ["cuda", "torch"] + (["cuda-nibble"] if ts.layout != "dense"
                                   else [])
    ops = ("or", "xor") if ts.layout == "counts" else ("or", "xor", "and")
    for op in ops:
        want = _ser(th.aggregate(op, engine="torch"))
        if js is not None:
            assert _ser(js.aggregate(op, engine="xla")) == want
        for engine in engines:
            if op == "and" and engine == "cuda-nibble":
                continue
            assert _ser(ts.aggregate(op, engine=engine)) == want
    assert [_ser(b) for b in ts.host_bitmaps()] == \
        [_ser(b) for b in th.host_bitmaps()]
    assert ts.host_bitmaps() == heap


def test_device_set_of_bytes_views_and_immutables_mixed():
    heap = _heap()
    srcs = [heap[0], heap[1].serialize(), TIM(heap[2].serialize())] + heap[3:]
    ds = DeviceBitmapSet(srcs, layout="compact", device=CPU)
    want = DeviceBitmapSet(heap, layout="compact", device=CPU)
    assert _ser(ds.aggregate("or")) == _ser(want.aggregate("or"))


@pytest.mark.parametrize("engine", ["megakernel", "cuda", "torch"])
@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_batches_over_an_immutable_set(layout, engine):
    """Flat and expression batches over a set built from immutables, and
    expressions with an immutable ad-hoc leaf, equal the heap set's."""
    heap = _heap()
    ims = _imms(heap)
    te = BatchEngine(DeviceBitmapSet(ims, layout=layout, device=CPU))
    he = BatchEngine(DeviceBitmapSet(heap, layout=layout, device=CPU))
    flat = [BatchQuery(q.op, q.operands, form="bitmap")
            for q in random_query_pool(len(heap), 8, seed=3)]
    exprs = texpr.random_expr_pool(len(heap), 6, depth=2, seed=3,
                                   form="bitmap")
    adhoc = texpr.ExprQuery(texpr.and_(texpr.or_(0, 1),
                                       texpr.AdHoc(ims[5])), form="bitmap")
    pool = flat + exprs + [adhoc]
    got = te.execute(pool, engine=engine)
    want = he.execute(pool, engine="torch")
    assert [(r.cardinality, _ser(r.bitmap)) for r in got] == \
        [(r.cardinality, _ser(r.bitmap)) for r in want]
    assert got[-1].bitmap == (heap[0] | heap[1]) & heap[5]


def test_adhoc_leaf_over_an_immutable():
    """Regression (ROADMAP C7): ``expr.AdHoc`` snapshots its bitmap with
    ``clone()``, which the JAX package's ``ImmutableRoaringBitmap`` lacks:
    there the leaf raises AttributeError.  The port's immutable clones to a
    heap copy, so the leaf snapshots and evaluates it."""
    heap = _heap()
    im = TIM(heap[2].serialize())
    leaf = texpr.AdHoc(im)
    assert type(leaf.bm) is TRB and _ser(leaf.bm) == _ser(heap[2])
    with pytest.raises(AttributeError):
        jexpr.AdHoc(JIM(heap[2].serialize()))


def test_sharded_paths_wrap_bytes_as_immutables():
    heap = _heap()
    blobs = [b.serialize() for b in heap]
    wrapped = sharding._wrap_bytes(blobs)
    assert all(type(w) is TIM for w in wrapped)
    mesh = sharding.Mesh(np.array([CPU] * 4).reshape(2, 2), ("rows", "lanes"))
    for op in ("or", "xor", "and"):
        want = getattr(tagg, op + "_")(heap, device=CPU) if op != "xor" \
            else tagg.xor(heap, device=CPU)
        for src in (blobs, _imms(heap)):
            for ingest in ("dense", "compact"):
                if op == "and" and ingest == "compact":
                    continue
                k, w, c = sharding.wide_aggregate_sharded(
                    mesh, op, src, ingest=ingest)
                assert int(np.asarray(c).sum()) == want.cardinality


def test_fast_aggregation_strategies_over_immutables():
    heap = _heap()
    ims = _imms(heap)
    for name in ("naive_or", "naive_xor", "naive_and", "priorityqueue_or",
                 "priorityqueue_xor"):
        got, want = getattr(tfast, name)(ims), getattr(tfast, name)(heap)
        assert _ser(got) == _ser(want), name
    assert _ser(tfast.naive_andnot(ims[0], device=CPU)) == _ser(heap[0])
    assert _ser(tfast.naive_andnot(ims[0], *ims[1:], device=CPU)) == _ser(
        tfast.naive_andnot(heap[0], *heap[1:], device=CPU))
    assert _ser(tfast.priorityqueue_or(ims[:1])) == _ser(heap[0])
    assert _ser(tfast.horizontal_or(ims, device=CPU)) == _ser(
        tfast.horizontal_or(heap, device=CPU))
    assert _ser(tfast.work_shy_and(ims, device=CPU)) == _ser(
        tfast.work_shy_and(heap, device=CPU))


def test_writer_and_bitset_sources():
    """Writer-built bitmaps and RoaringBitSets (taken as their backing
    bitmaps) feed the wide ops and resident sets."""
    vals = _values()
    built = []
    for v in vals:
        w = RoaringBitmapWriter.wizard().optimise_for_runs().get()
        w.add_many(v[::-1].copy())
        built.append(w.get())
    heap = _heap(runs=False)
    assert [b.to_array().tolist() for b in built] == \
        [b.to_array().tolist() for b in heap]
    sets = [RoaringBitSet(b) for b in heap]
    want = tagg.or_(heap, device=CPU)
    assert _ser(tagg.or_(built, device=CPU)) == _ser(want)
    assert _ser(tagg.or_(sets, device=CPU)) == _ser(want)
    assert _ser(tagg.or_(*sets, device=CPU)) == _ser(want)
    assert _ser(DeviceBitmapSet(sets, device=CPU).aggregate("or")) == \
        _ser(want)


# ---------------------------------------------------------- value columns

def _value_world():
    heap = _heap()
    rng = np.random.default_rng(77)
    ids = np.unique(rng.integers(0, 1 << 18, 4000)).astype(np.uint32)
    prices = rng.integers(0, 1 << 20, ids.size)
    ts = rng.integers(0, 1 << 40, 70_000)
    return heap, ids, prices, ts


def _value_pool():
    m = texpr
    return [m.ExprQuery(m.and_(m.or_(0, 1), m.range_("price", 1000, 600_000)),
                        form="bitmap"),
            m.ExprQuery(m.cmp("price", "ge", 1 << 19), form="bitmap"),
            m.ExprQuery(m.cmp("ts", "lt", 1 << 38), form="bitmap"),
            m.ExprQuery(m.and_(2, m.range_("ts", 1 << 30, 1 << 39)),
                        form="bitmap"),
            m.ExprQuery(m.sum_("price", found=m.or_(0, 3))),
            m.ExprQuery(m.sum_("ts", found=m.and_(m.or_(1, 2),
                                                  m.cmp("ts", "ge", 5)))),
            m.ExprQuery(m.top_k("price", 20, found=m.or_(4, 5))),
            m.ExprQuery(m.top_k("ts", 7))]


@pytest.mark.parametrize("engine", ["megakernel", "cuda", "torch"])
def test_mapped_value_columns(engine):
    """A ``BsiColumn`` over an ``ImmutableBitSliceIndex`` of the serialized
    index and a ``RangeColumn`` over a mapped ``RangeBitmap`` answer every
    value batch as the heap-built columns do; the JAX package's bytes map
    in the port."""
    heap, ids, prices, ts = _value_world()
    heap_price = BsiColumn("price", ids, prices, device=CPU)
    heap_ts = RangeColumn("ts", ts, device=CPU)
    imm = ImmutableBitSliceIndex(heap_price.host.serialize_buffer())
    mapped = RangeBitmap.map(heap_ts.host.serialize())
    cols = {"price": BsiColumn.from_bsi("price", imm, device=CPU),
            "ts": RangeColumn.from_range_bitmap("ts", mapped, device=CPU)}
    assert cols["price"].host is imm and cols["ts"].host is mapped
    assert np.array_equal(cols["ts"].values, heap_ts.values)
    for a, b in ((cols["price"], heap_price), (cols["ts"], heap_ts)):
        assert np.array_equal(a.slices_np, b.slices_np)
        assert np.array_equal(a.ebm_np, b.ebm_np)
        assert (a.min_value, a.max_value) == (b.min_value, b.max_value)
    te = BatchEngine(DeviceBitmapSet(_imms(heap), device=CPU))
    he = BatchEngine(DeviceBitmapSet(heap, device=CPU))
    for c in cols.values():
        te._ds.attach_column(c)
    for c in (heap_price, heap_ts):
        he._ds.attach_column(c)
    pool = _value_pool()
    got = te.execute(pool, engine=engine)
    want = he.execute(pool, engine="torch")
    assert [(r.cardinality, r.value, None if r.bitmap is None
             else _ser(r.bitmap)) for r in got] == \
        [(r.cardinality, r.value, None if r.bitmap is None
          else _ser(r.bitmap)) for r in want]
    # a delta copies the mapped BSI to the heap first, then answers exact
    cols["price"].apply_delta({int(ids[0]): 5, 7: 99}, removes=[int(ids[3])])
    heap_price.apply_delta({int(ids[0]): 5, 7: 99}, removes=[int(ids[3])])
    assert type(cols["price"].host) is RoaringBitmapSliceIndex
    assert te.execute(pool[:2], engine=engine)[1].cardinality == \
        he.execute(pool[:2], engine="torch")[1].cardinality


def test_immutable_bsi_matches_jax_both_ways():
    rng = np.random.default_rng(78)
    ids = np.unique(rng.integers(0, 1 << 20, 3000)).astype(np.uint32)
    vals = rng.integers(0, 1 << 24, ids.size)
    tb = RoaringBitmapSliceIndex.from_pairs(ids, vals)
    from roaringbitmap_tpu.bsi import RoaringBitmapSliceIndex as JBSI
    from roaringbitmap_tpu.bsi import Operation as JOp
    from roaringbitmap_tpu_torch.bsi import Operation as TOp

    jbsi = JBSI.from_pairs(ids, vals)
    tblob, jblob = tb.serialize_buffer(), jbsi.serialize_buffer()
    assert tblob == jblob
    found = TRB.from_values(ids[::3])
    jfound = JRB.from_values(ids[::3])
    for t, j in ((ImmutableBitSliceIndex(jblob), JIBSI(tblob)),):
        for op in ("EQ", "NEQ", "LT", "LE", "GT", "GE", "RANGE"):
            a, b = int(vals[5]), int(vals[9])
            lo, hi = min(a, b), max(a, b)
            got = t.compare(TOp[op], lo, hi)
            assert _ser(got) == _ser(j.compare(JOp[op], lo, hi))
            assert _ser(t.compare(TOp[op], lo, hi, found)) == _ser(
                j.compare(JOp[op], lo, hi, jfound))
        assert t.sum(found) == j.sum(jfound)
        assert _ser(t.top_k(50)) == _ser(j.top_k(50))
        assert t.get_value(int(ids[3])) == j.get_value(int(ids[3]))
        assert t.serialize_buffer() == jblob
        assert t.to_mutable() == tb
        with pytest.raises(TypeError):
            t.set_value(1, 2)
    for cut in (0, 8, 9, 12, 40, len(tblob) - 1):
        errs = []
        for cls in (ImmutableBitSliceIndex, JIBSI):
            try:
                cls(tblob[:cut]).ebm.to_bitmap()
                errs.append(None)
            except Exception as e:
                errs.append(type(e).__name__)
        assert errs[0] == errs[1], cut


# ------------------------------------------------------------ 64-bit tier

def _navmaps(cls=Roaring64NavigableMap, n: int = 8) -> list:
    rng = np.random.default_rng(64)
    highs = np.array([0, 1, 1 << 31, (1 << 32) - 1], np.uint64)
    out = []
    for i in range(n):
        v = rng.integers(0, 1 << 21, 4000).astype(np.uint64)
        out.append(cls.from_values((highs[i % 4] << np.uint64(32)) | v))
    common = cls.from_values(np.arange(100, 900, dtype=np.uint64)
                             | (np.uint64(1) << np.uint64(63)))
    return out, [cls.from_values(np.concatenate(
        [m.to_array(), common.to_array()])) for m in out]


@pytest.mark.parametrize("op", ["or64", "xor64", "and64"])
def test_wide_64_over_navigable_maps(op):
    """or64/xor64/and64 take Roaring64NavigableMaps as their Roaring64Bitmap
    twins (shared containers); the JAX package needs ``to_roaring64()``
    first (ROADMAP C)."""
    nms, with_common = _navmaps()
    jnms, jwith = _navmaps(JNM)
    src, jsrc = (with_common, jwith) if op == "and64" else (nms, jnms)
    got = getattr(tagg, op)(src, device=CPU)
    want = getattr(tagg, op)([m.to_roaring64() for m in src], device=CPU)
    jwant = getattr(jagg, op)([m.to_roaring64() for m in jsrc],
                              fallback=False)
    assert type(got) is Roaring64Bitmap
    assert got.serialize() == want.serialize() == jwant.serialize()
    assert got.cardinality > 0
    assert getattr(tagg, op)(*src[:3], device=CPU).serialize() == getattr(
        tagg, op)([m.to_roaring64() for m in src[:3]], device=CPU).serialize()


@pytest.mark.parametrize("layout", LAYOUTS)
def test_u48_device_set_of_navigable_maps(layout):
    nms, _ = _navmaps()
    ts = DeviceBitmapSet(nms, layout=layout, device=CPU)
    th = DeviceBitmapSet([m.to_roaring64() for m in nms], layout=layout,
                         device=CPU)
    assert ts.keys.dtype == np.uint64 and np.array_equal(ts.keys, th.keys)
    for op in ("or", "xor"):
        got = ts.aggregate(op)
        assert type(got) is Roaring64Bitmap
        assert got.serialize() == th.aggregate(op).serialize()
    eng = BatchEngine(ts)
    flat = [BatchQuery(q.op, q.operands, form="bitmap")
            for q in random_query_pool(len(nms), 6, seed=9)]
    assert [r.bitmap.serialize() for r in eng.execute(flat)] == \
        [r.bitmap.serialize() for r in BatchEngine(th).execute(flat)]
