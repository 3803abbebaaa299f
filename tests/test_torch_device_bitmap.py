"""The port's ``DeviceBitmap`` and ``aggregate_range_cardinality`` against
roaringbitmap_tpu.

Composition (& | ^ - and_not) of device results equals JAX's DeviceBitmap
and the host algebra; range cardinalities at 0, at multiples of 2^16 and at
0xFFFFFFFF; ``contains_batch`` over members, non-members, probes of 2^32 and
more, negative int64 probes, an empty batch and float probes (TypeError);
and mixed key tiers (TypeError).  The port runs on ``device="cpu"``.
Bit-exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops.words import to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg

torch.set_num_threads(2)

CPU = "cpu"
EDGES = [0, 0xFFFF, 0x10000, 0x80000000, 0xFFFFFFFF]
RANGES = [(0, 0), (0, 1), (0, 1 << 16), (1 << 16, 3 << 16), (5, 70000),
          (0xFFFF, 0x10001), (0x80000000, 0xFFFFFFFF), (0xFFFFFFFF, 1 << 32),
          (0, 1 << 32), (7 << 16, 7 << 16), (9, 3), (-5, 1 << 40)]


def _values(seed: int, n: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = rng.integers(0, 1 << 19, 4000)
        if i % 3 == 0:     # a bitmap container
            v = np.concatenate([v, (i % 8 << 16) + rng.integers(0, 1 << 16,
                                                               9000)])
        out.append(np.concatenate([v, EDGES]).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def agg_pair():
    """OR over one 8-bitmap set, XOR over another, in both packages."""
    out = {}
    for name, seed, op in (("a", 100, "or"), ("b", 200, "xor")):
        vals = _values(seed, 8)
        j = [JRB.from_values(v) for v in vals]
        t = [TRB.from_values(v) for v in vals]
        js = jagg.DeviceBitmapSet(j, layout="dense")
        ts = tagg.DeviceBitmapSet(t, layout="compact", device=CPU)
        out[name] = (jagg.DeviceBitmap.aggregate(js, op, engine="xla"),
                     tagg.DeviceBitmap.aggregate(ts, op, engine="cuda-nibble"),
                     ts)
    return out


def _same(tb, jb):
    assert np.array_equal(tb.to_array(), jb.to_array())
    assert tb.serialize() == jb.serialize()


def _same_db(got, want):
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(to_u32(got.words), np.asarray(want.words))
    assert np.array_equal(got.cards().numpy(), np.asarray(want.cards()))


@pytest.mark.parametrize("op", ["__and__", "__or__", "__xor__", "__sub__",
                                "and_not"])
def test_compose_matches_jax_and_host(agg_pair, op):
    ja, ta, _ = agg_pair["a"]
    jb, tb, _ = agg_pair["b"]
    _same_db(ta, ja)
    _same_db(tb, jb)
    got = getattr(ta, op)(tb)
    want = getattr(ja, op)(jb)
    _same_db(got, want)
    host = getattr(ta.materialize(), op if op != "and_not" else "__sub__")(
        tb.materialize())
    assert got.materialize() == host
    _same(got.materialize(), want.materialize())
    assert got.cardinality() == host.cardinality == want.cardinality()


def test_compose_chain_and_repr():
    a = TRB.from_values(np.arange(0, 100000, 3, dtype=np.uint32))
    b = TRB.from_values(np.arange(0, 100000, 5, dtype=np.uint32))
    c = TRB.from_values(np.arange(0, 100000, 7, dtype=np.uint32))
    da, db, dc = (tagg.DeviceBitmap.from_host(x, device=CPU)
                  for x in (a, b, c))
    plan = (da | db) & dc - (da & db)
    want = ((a | b) & c) - (a & b)
    assert plan.materialize() == want
    assert plan.range_cardinality(1000, 50000) == want.range_cardinality(
        1000, 50000)
    assert plan.hbm_bytes() == plan.keys.size * 2048 * 4
    assert repr(plan) == (f"DeviceBitmap(keys={plan.keys.size}, "
                          f"hbm={plan.hbm_bytes()}B)")


def test_disjoint_and_empty():
    a = TRB.bitmap_of(1, 2, 3)
    b = TRB.bitmap_of((5 << 16) + 1)
    da, db = (tagg.DeviceBitmap.from_host(x, device=CPU) for x in (a, b))
    assert (da | db).materialize() == (a | b)
    empty = da & db
    assert empty.cardinality() == 0 and empty.materialize() == TRB()
    none = tagg.DeviceBitmap.from_host(TRB(), device=CPU)
    assert (none | da).materialize() == a
    assert not none.contains_batch(np.array([1, 2], np.uint32)).any()
    assert none.range_cardinality(0, 1 << 32) == 0


@pytest.mark.parametrize("start,stop", RANGES)
def test_range_cardinality_matches_jax(agg_pair, start, stop):
    ja, ta, ts = agg_pair["a"]
    want = ta.materialize().range_cardinality(start, stop)
    if stop >= start:
        assert ja.range_cardinality(start, stop) == want
    assert ta.range_cardinality(start, stop) == want
    assert ts.aggregate_range_cardinality("or", start, stop) == want
    assert ts.aggregate_range_cardinality("or", start, stop,
                                          engine="torch") == want


def test_reversed_range_is_empty(agg_pair):
    """A reversed range counts nothing, as the host's rangeCardinality
    says.  The JAX device function counts the word holding ``start`` there
    (its u32 cast of a negative bit count gives the all-ones mask): a fault
    of the reference, not followed."""
    ja, ta, ts = agg_pair["a"]
    host = ta.materialize()
    assert host.range_cardinality(9, 3) == 0
    assert ta.range_cardinality(9, 3) == 0
    assert ts.aggregate_range_cardinality("or", 9, 3) == 0
    assert ja.range_cardinality(9, 3) == host.range_cardinality(0, 32) > 0


def test_range_cardinality_word_edges():
    """Ranges that start and stop inside, and at the edges of, one 32-bit
    word: the mask of a whole word is all ones."""
    vals = np.concatenate([np.arange(0, 96), [0xFFFFFFE0 + i for i in
                                              range(32)]]).astype(np.uint32)
    rb = TRB.from_values(vals)
    jdb = jagg.DeviceBitmap.from_host(JRB.from_values(vals))
    db = tagg.DeviceBitmap.from_host(rb, device=CPU)
    for start in (0, 1, 31, 32, 33, 64, 0xFFFFFFE0, 0xFFFFFFFF):
        for stop in (start, start + 1, start + 31, start + 32, start + 33,
                     1 << 32):
            want = rb.range_cardinality(start, stop)
            assert db.range_cardinality(start, stop) == want, (start, stop)
            assert jdb.range_cardinality(start, stop) == want, (start, stop)


def test_contains_batch(agg_pair):
    ja, ta, _ = agg_pair["a"]
    host = ta.materialize()
    rng = np.random.default_rng(3)
    members = host.to_array()
    probes = np.concatenate([
        members[::17], rng.integers(0, 1 << 20, 2000).astype(np.uint32),
        np.array(EDGES, np.uint32)])
    got = ta.contains_batch(probes)
    assert got.dtype == bool and got.shape == probes.shape
    assert np.array_equal(got, ja.contains_batch(probes))
    assert np.array_equal(got, np.array([host.contains(int(v))
                                         for v in probes]))
    assert got[:members[::17].size].all()
    # 2-D batches keep their shape
    assert np.array_equal(ta.contains_batch(probes[:12].reshape(3, 4)),
                          got[:12].reshape(3, 4))


def test_contains_batch_out_of_range():
    db = tagg.DeviceBitmap.from_host(TRB.bitmap_of(5, 0xFFFFFFFF), device=CPU)
    big = np.array([5, 5 + (1 << 32), (1 << 63) + 5, 0xFFFFFFFF,
                    0xFFFFFFFF + (1 << 32)], dtype=np.uint64)
    assert db.contains_batch(big).tolist() == [True, False, False, True,
                                               False]
    neg = np.array([-1, 5, -(1 << 40) + 5, 1 << 32], dtype=np.int64)
    assert db.contains_batch(neg).tolist() == [False, True, False, False]
    small = np.array([-1, 5, 6], dtype=np.int8)
    assert db.contains_batch(small).tolist() == [False, True, False]
    jdb = jagg.DeviceBitmap.from_host(JRB.bitmap_of(5, 0xFFFFFFFF))
    assert db.contains_batch(neg).tolist() == jdb.contains_batch(neg).tolist()


def test_contains_batch_empty_and_non_integer():
    db = tagg.DeviceBitmap.from_host(TRB.bitmap_of(5), device=CPU)
    empty = db.contains_batch([])
    assert empty.dtype == bool and empty.shape == (0,)
    with pytest.raises(TypeError, match="integer probes"):
        db.contains_batch(np.array([5.0, 4294967296.0]))
    with pytest.raises(TypeError, match="integer probes"):
        db.contains_batch(np.array([True, False]))
    with pytest.raises(TypeError, match="integer probes"):
        db.contains_batch(np.array([5, "x"], dtype=object))


def test_mixed_tiers_rejected():
    """u16 keys (the 32-bit tier) never combine with u64 keys; the u64
    tier probes and materializes on its own (core/bitmap64)."""
    db = tagg.DeviceBitmap.from_host(TRB.bitmap_of(5), device=CPU)
    wide = tagg.DeviceBitmap(np.array([0], np.uint64), db.words.clone())
    for op in ("__and__", "__or__", "__xor__", "__sub__"):
        with pytest.raises(TypeError, match="different tiers"):
            getattr(db, op)(wide)
    assert wide.contains_batch(np.array([5, 6], np.uint64)).tolist() == [
        True, False]
    assert wide.materialize().to_array().tolist() == [5]
    assert type(wide.materialize()).__name__ == "Roaring64Bitmap"
    assert wide.range_cardinality(0, 1 << 64) == 1


@pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
def test_empty_key_set_range_count(layout):
    """Pinned reference fault (ROADMAP C4): over an empty key set the JAX
    range count builds its bounds as shape (0,) instead of (0, 1) and
    raises TypeError; the port counts 0."""
    assert tagg.DeviceBitmap.from_host(TRB(), device=CPU).range_cardinality(
        0, 10) == 0
    ts = tagg.DeviceBitmapSet([TRB()], layout=layout, device=CPU)
    assert ts.aggregate_range_cardinality("or", 0, 10) == 0
    with pytest.raises(TypeError, match="incompatible shapes"):
        jagg.DeviceBitmap.from_host(JRB()).range_cardinality(0, 10)
    with pytest.raises(TypeError, match="incompatible shapes"):
        jagg.DeviceBitmapSet([JRB()], layout=layout
                             ).aggregate_range_cardinality("or", 0, 10)
