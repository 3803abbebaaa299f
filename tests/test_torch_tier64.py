"""The port's 64-bit tier against roaringbitmap_tpu: ``or64`` / ``xor64`` /
``and64``, ``DeviceBitmapSet`` over ``Roaring64Bitmap``s in the dense,
compact, counts and "auto" layouts, ``BatchEngine`` batches, and
``DeviceBitmap`` probes (negative int64 and top-half u64 probes,
``range_cardinality`` over the top half, the tier mismatch).

Bitmap i lies in the high-32 bucket b(i) = [0, 1, 2^31, 2^32 - 1][i % 4], so
the u48 keys cross 2^32 and 2^63.  The JAX side runs as its own tests run it
on the CPU (the "xla" engine, ``fallback=False``); the port runs on
``device="cpu"`` with both engines ("cuda" takes the kernels' plain
versions for CPU tensors).  Bit-exact: members, cardinalities and
``serialize()`` bytes.
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEng
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine as TEng
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ

torch.set_num_threads(2)

CPU = "cpu"
BUCKETS = (0, 1, 2**31, 2**32 - 1)


def _values(seed: int, n: int) -> list[np.ndarray]:
    """n value sets: bitmap i in bucket b(i), sharing a common part per
    bucket (so wide ANDs keep keys), with a bitmap container every third
    set and a few keys of the top of the universe."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, 1 << 20, 1500)
    out = []
    for i in range(n):
        base = np.uint64(BUCKETS[i % 4]) << np.uint64(32)
        low = np.concatenate([common, rng.integers(0, 1 << 20, 2500)])
        if i % 3 == 0:
            low = np.concatenate([low, (5 << 16) + rng.choice(
                1 << 16, 7000, replace=False)])
        out.append(base | low.astype(np.uint64))
    return out


@pytest.fixture(scope="module")
def sets():
    vals = _values(11, 12)
    return ([T64.from_values(v) for v in vals],
            [J64.from_values(v) for v in vals])


def _same(got, want) -> None:
    assert isinstance(got, T64)
    assert np.array_equal(got.keys, want.keys)
    assert got.serialize() == want.serialize()


@pytest.mark.parametrize("engine", ["cuda", "torch"])
def test_wide_calls(sets, engine):
    tb, jb = sets
    for name in ("or64", "xor64"):
        got = getattr(tagg, name)(tb, engine=engine, device=CPU)
        _same(got, getattr(jagg, name)(*jb, engine="xla", fallback=False))
    # one bucket: the common part survives the AND
    sub_t, sub_j = tb[::4], jb[::4]
    got = tagg.and64(*sub_t, engine=engine, device=CPU)
    want = jagg.and64(*sub_j, engine="xla", fallback=False)
    _same(got, want)
    assert got.cardinality > 1000
    _same(tagg.and64(*tb, engine=engine, device=CPU),
          jagg.and64(*jb, engine="xla", fallback=False))
    assert tagg.or_cardinality(tb, engine=engine, device=CPU) == \
        jagg.or_cardinality(*jb, engine="xla", fallback=False)
    assert tagg.xor_cardinality(tb, engine=engine, device=CPU) == \
        jagg.xor_cardinality(*jb, engine="xla", fallback=False)
    assert tagg.and_cardinality(*sub_t, device=CPU) == \
        jagg.and_cardinality(*sub_j, fallback=False)
    assert isinstance(tagg.or64([], device=CPU), T64)
    assert isinstance(tagg.and64(tb[0], T64(), device=CPU), T64)


@pytest.mark.parametrize("layout", ["dense", "compact", "counts", "auto"])
def test_resident_set_layouts(sets, layout):
    tb, jb = sets
    ts = tagg.DeviceBitmapSet(tb, layout=layout, device=CPU)
    js = jagg.DeviceBitmapSet(jb, layout=layout)
    assert ts.layout == js.layout
    assert ts.keys.dtype == np.uint64
    assert np.array_equal(ts.keys, js.keys)
    for op in ("or", "xor", "and"):
        want = js.aggregate(op, engine="xla")
        for engine in ("cuda", "torch", "cuda-nibble"):
            _same(ts.aggregate(op, engine=engine), want)
    assert [h.serialize() for h in ts.host_bitmaps()] == \
        [b.serialize() for b in jb]


def test_batch_engine(sets):
    tb, jb = sets
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    je = JEng(jagg.DeviceBitmapSet(jb))
    ops = [("or", (0, 3, 5)), ("and", (0, 4, 8)), ("xor", (1, 2, 7)),
           ("andnot", (2, 6, 10)), ("and", (1, 2))]
    tq = [TQ(op, o, form="bitmap") for op, o in ops]
    jq = [JQ(op, o, form="bitmap") for op, o in ops]
    want = je.execute(jq, engine="xla", fallback=False)
    for engine in ("cuda", "torch"):
        got = te.execute(tq, engine=engine)
        for g, w in zip(got, want):
            assert g.cardinality == w.cardinality
            _same(g.bitmap, w.bitmap)
    # the JAX expression compiler fails on u48 keys (ROADMAP C), so the
    # expression is held against JAX's host algebra on the same values
    e = texpr.ExprQuery(texpr.and_(texpr.or_(0, 4), texpr.not_(8)),
                        form="bitmap")
    got = te.execute([e], engine="megakernel")[0]
    want = (jb[0] | jb[4]) - jb[8]
    _same(got.bitmap, want)
    assert got.cardinality == want.cardinality > 0
    assert te.last_timings["engine"] == "megakernel"


@pytest.fixture(scope="module")
def device_pair(sets):
    tb, jb = sets
    return (tagg.DeviceBitmap.aggregate(
                tagg.DeviceBitmapSet(tb, device=CPU), "or"),
            jagg.DeviceBitmap.aggregate(jagg.DeviceBitmapSet(jb), "or",
                                        engine="xla"))


def test_device_bitmap_probes(device_pair):
    tdb, jdb = device_pair
    host = tdb.materialize()
    _same(host, jdb.materialize())
    rng = np.random.default_rng(12)
    members = host.to_array()
    probes = np.concatenate([
        members[::101], members[::103] + np.uint64(1),
        rng.integers(0, 2**64, 2000, dtype=np.uint64),
        np.array([0, 2**32, 2**63 - 1, 2**63, 2**64 - 1], np.uint64)])
    got = tdb.contains_batch(probes)
    assert np.array_equal(got, jdb.contains_batch(probes))
    assert np.array_equal(got, [host.contains(int(v)) for v in probes])
    assert got.sum() > 10
    signed = np.concatenate([members[:50].astype(np.int64),
                             np.array([-1, -(2**63), 5], np.int64)])
    assert np.array_equal(tdb.contains_batch(signed),
                          jdb.contains_batch(signed))
    assert not tdb.contains_batch(np.array([-1, -7], np.int64)).any()
    for bad in (np.array([5.0]), np.array([True]),
                np.array([5, "x"], dtype=object)):
        with pytest.raises(TypeError, match="integer probes"):
            tdb.contains_batch(bad)
    assert tdb.contains_batch(np.array([])).shape == (0,)


@pytest.mark.parametrize("start,stop", [
    (0, 1 << 64), (1 << 63, 1 << 64), (0, 1 << 63), (1 << 32, 2 << 32),
    ((2**32 - 1) << 32, 1 << 64), (((2**31) << 32) + 5, ((2**31) << 32) + 9),
    (-5, 1 << 70), (9, 3)])
def test_range_cardinality_top_half(device_pair, start, stop):
    tdb, jdb = device_pair
    host = tdb.materialize().to_array()

    def at_least(x):        # members >= x, x a Python int
        return 0 if x >= 1 << 64 else int(
            np.count_nonzero(host >= np.uint64(max(x, 0))))

    want = max(0, at_least(start) - at_least(stop))
    assert tdb.range_cardinality(start, stop) == want
    if start <= stop:       # JAX miscounts a reversed range (ROADMAP C)
        assert jdb.range_cardinality(start, stop) == want


def test_top_half_values():
    """A set of values all >= 2^63: keys past int64 stay u64 on the host."""
    vals = (np.uint64(1) << np.uint64(63)) + np.arange(100, dtype=np.uint64)
    db = tagg.DeviceBitmap.aggregate(
        tagg.DeviceBitmapSet([T64.from_values(vals)], device=CPU), "or")
    jdb = jagg.DeviceBitmap.aggregate(
        jagg.DeviceBitmapSet([J64.from_values(vals)]), "or")
    for start, stop in ((0, 1 << 64), ((1 << 63) + 50, 1 << 64),
                        (0, 1 << 63)):
        assert db.range_cardinality(start, stop) == \
            jdb.range_cardinality(start, stop)
    assert db.contains_batch(vals).all()


def test_tier_mismatch(device_pair):
    tdb, _ = device_pair
    d32 = tagg.DeviceBitmap.from_host(TRB.bitmap_of(1, 2), device=CPU)
    for op in ("__and__", "__or__", "__xor__", "__sub__"):
        with pytest.raises(TypeError, match="tiers"):
            getattr(d32, op)(tdb)
    both = tdb & tdb
    assert both.cardinality() == tdb.cardinality()


def test_expressions_over_u48_keys():
    """Expression queries over a 64-bit set whose keys pass 2^16 are exact
    on every rung, held against JAX's Roaring64Bitmap host algebra on the
    same values (serialized bytes).  Pinned reference fault (ROADMAP C):
    the JAX compiler casts combine-node keys to u16, so the same queries
    fail there: an and/andnot shape raises TypeError in the megakernel
    assembler (for every rung, since the plan assembles it), and an or of
    two ands comes back empty."""
    from roaringbitmap_tpu.parallel import expr as jexpr

    vals = [(np.uint64(b) << np.uint64(32))
            | np.arange(10 * i, 5000 + 10 * i, dtype=np.uint64)
            for i, b in enumerate([1, 1, 1, 2**31])]
    tb = [T64.from_values(v) for v in vals]
    jb = [J64.from_values(v) for v in vals]
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    cases = [
        (texpr.and_(texpr.or_(0, 1), texpr.not_(2)), (jb[0] | jb[1]) - jb[2]),
        (texpr.or_(texpr.and_(0, 1), texpr.and_(1, 2)),
         (jb[0] & jb[1]) | (jb[1] & jb[2])),
        (texpr.xor(texpr.or_(0, 3), texpr.and_(1, 2)),
         (jb[0] | jb[3]) ^ (jb[1] & jb[2]))]
    for e, want in cases:
        assert want.cardinality > 0
        for rung in ("megakernel", "cuda", "torch"):
            got = te.execute([texpr.ExprQuery(e, form="bitmap")],
                             engine=rung)[0]
            assert te.last_timings["engine"] == rung
            _same(got.bitmap, want)
            assert got.cardinality == want.cardinality
    je = JEng(jagg.DeviceBitmapSet(jb))
    with pytest.raises(TypeError):
        je.execute([jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1),
                                               jexpr.not_(2)))],
                   engine="xla", fallback=False)
    bad = je.execute([jexpr.ExprQuery(jexpr.or_(jexpr.and_(0, 1),
                                                jexpr.and_(1, 2)))],
                     engine="xla", fallback=False)[0]
    assert bad.cardinality == 0 != cases[1][1].cardinality


def test_empty_results_keep_the_tier():
    """An expression the compiler proves empty (an AND of bitmaps in
    different high-32 buckets) and a flat query without operands come
    back as an empty Roaring64Bitmap on every rung, as the host fold
    gives it."""
    tb = [T64.from_values((np.uint64(b) << np.uint64(32))
                          | np.arange(100, dtype=np.uint64))
          for b in BUCKETS]
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    pool = [texpr.ExprQuery(texpr.and_(0, 1), form="bitmap"),
            texpr.ExprQuery(texpr.and_(texpr.or_(0, 2), 3), form="bitmap"),
            TQ("andnot", (), form="bitmap")]
    for rung in ("megakernel", "cuda", "torch"):
        for q, r in zip(pool, te.execute(pool, engine=rung)):
            assert isinstance(r.bitmap, T64) and r.bitmap.is_empty()
    for q in pool[:2]:
        assert texpr.evaluate_host(q.expr, tb) == T64()
    assert te._execute_sequential(pool[2:])[0].bitmap == T64()
