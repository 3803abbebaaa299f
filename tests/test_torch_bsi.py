"""The port's bit-sliced index against roaringbitmap_tpu.bsi.

The same seeded (row id, value) pairs build the host
``RoaringBitmapSliceIndex`` of both packages: slices, queries, the
combining operations and both serialized forms must be equal, byte for
byte.  ``DeviceBSI`` and ``DeviceRangeBitmap`` on ``device="cpu"`` (plain
PyTorch scans) must equal the JAX device tiers on the CPU and the host
oracles, chained probes included.  Everything is compared exactly.
"""

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.bsi import DeviceBSI as JDeviceBSI
from roaringbitmap_tpu.bsi import Operation as JOp
from roaringbitmap_tpu.bsi import RoaringBitmapSliceIndex as JBSI
from roaringbitmap_tpu.bsi.device import DeviceRangeBitmap as JDeviceRange
from roaringbitmap_tpu.core.rangebitmap import RangeBitmap as JRange
from roaringbitmap_tpu.format.spec import InvalidRoaringFormat as JBad
from roaringbitmap_tpu_torch import InvalidRoaringFormat, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.bsi import (DeviceBSI, DeviceRangeBitmap,
                                         Operation, RoaringBitmapSliceIndex)
from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap

OPS = ["EQ", "NEQ", "LT", "LE", "GT", "GE", "RANGE"]


def _pairs(seed: int = 0xB51, n: int = 6000, uni: int = 1 << 18,
           vmax: int = 50000):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, uni, n).astype(np.uint32)    # duplicates: last wins
    return ids, rng.integers(0, vmax, n).astype(np.int64)


def _arr(bm) -> list:
    return bm.to_array().tolist()


@pytest.fixture(scope="module")
def pair():
    ids, vals = _pairs()
    return JBSI.from_pairs(ids, vals), RoaringBitmapSliceIndex.from_pairs(
        ids, vals)


@pytest.fixture(scope="module")
def found():
    rng = np.random.default_rng(7)
    v = np.unique(rng.integers(0, 1 << 19, 40000)).astype(np.uint32)
    return JRB.from_values(v), TRB.from_values(v)


def _same_index(j, t):
    assert (t.min_value, t.max_value, t.bit_count()) == (
        j.min_value, j.max_value, j.bit_count())
    assert _arr(t.ebm) == _arr(j.ebm)
    for js, ts in zip(j.slices, t.slices):
        assert _arr(ts) == _arr(js)


def test_from_pairs_matches_jax(pair):
    _same_index(*pair)


def _args(j, op):
    """Predicate arguments inside, at and outside the stored domain."""
    stored = j.get_value(int(j.ebm.to_array()[11]))[0]
    if op == "RANGE":
        return [(300, 31000), (-5, 10 ** 9), (j.max_value + 1, 10 ** 9)]
    return [(stored, 0), (j.min_value, 0), (j.max_value + 3, 0), (-1, 0)]


@pytest.mark.parametrize("op", OPS)
def test_host_compare_matches_jax(pair, found, op):
    j, t = pair
    for a, b in _args(j, op):
        for jf, tf in ((None, None), found):
            got = t.compare(Operation[op], a, b, tf)
            assert _arr(got) == _arr(j.compare(JOp[op], a, b, jf)), (a, b)


def test_host_sum_topk_values_match_jax(pair, found):
    (j, t), (jf, tf) = pair, found
    assert t.sum() == j.sum() and t.sum(tf) == j.sum(jf)
    for k in (0, 1, 17, 400):
        assert _arr(t.top_k(k)) == _arr(j.top_k(k))
        assert _arr(t.top_k(k, t.ebm & tf)) == _arr(j.top_k(k, j.ebm & jf))
    with pytest.raises(ValueError):
        t.top_k(t.cardinality + 1)
    cols = np.arange(0, 1 << 18, 97, dtype=np.uint32)
    for a, b in zip(t.get_values(cols), j.get_values(cols)):
        assert np.array_equal(a, b)
    for c in cols[:40]:
        assert t.get_value(int(c)) == j.get_value(int(c))
    assert t.to_pair_list(tf) == j.to_pair_list(jf)
    assert _arr(t.in_values({1, 2, 300, 4000}, tf)) == _arr(
        j.in_values({1, 2, 300, 4000}, jf))
    _same_index(j.transpose_with_count(jf), t.transpose_with_count(tf))


def test_combining_matches_jax():
    a_ids, a_vals = _pairs(1, 800, 1 << 17, 3000)
    b_ids, b_vals = _pairs(2, 800, 1 << 17, 90000)
    ja, jb = JBSI.from_pairs(a_ids, a_vals), JBSI.from_pairs(b_ids, b_vals)
    ta = RoaringBitmapSliceIndex.from_pairs(a_ids, a_vals)
    tb = RoaringBitmapSliceIndex.from_pairs(b_ids, b_vals)
    ja.add(jb)
    ta.add(tb)
    _same_index(ja, ta)
    ja.merge_overwrite(JBSI.from_pairs(b_ids[:50], b_vals[:50] // 3))
    ta.merge_overwrite(RoaringBitmapSliceIndex.from_pairs(
        b_ids[:50], b_vals[:50] // 3))
    _same_index(ja, ta)
    for c, v in ((5, 70000), (int(a_ids[3]), 1), (1 << 20, 2 ** 31 - 1)):
        ja.set_value(c, v)
        ta.set_value(c, v)
    _same_index(ja, ta)
    ja.set_values([(9, 4), (10, 40000)])
    ta.set_values([(9, 4), (10, 40000)])
    _same_index(ja, ta)
    jd = JBSI.from_pairs(np.array([1 << 21], np.uint32), np.array([6]))
    td = RoaringBitmapSliceIndex.from_pairs(np.array([1 << 21], np.uint32),
                                            np.array([6]))
    ja.merge(jd)
    ta.merge(td)
    _same_index(ja, ta)
    with pytest.raises(ValueError):
        ta.merge(td)
    assert ta == ta.clone() and ta != tb
    with pytest.raises(ValueError):
        RoaringBitmapSliceIndex.from_pairs(np.array([1], np.uint32),
                                           np.array([-1]))


@pytest.mark.parametrize("form", ["buffer", "stream"])
def test_serialization_matches_jax(pair, form):
    j, t = pair
    data = getattr(t, f"serialize_{form}")()
    assert data == getattr(j, f"serialize_{form}")()
    back = getattr(RoaringBitmapSliceIndex, f"deserialize_{form}")(data)
    _same_index(j, back)
    if form == "buffer":
        assert len(data) == t.serialized_size_in_bytes()
        assert t.serialize() == data
        assert RoaringBitmapSliceIndex.deserialize(data) == t


def _run_pairs():
    """Dense ids with values in long runs: run containers win in the ebm
    and in the high slices."""
    ids = np.arange(0, 3 << 16, dtype=np.uint32)
    return ids, (ids // 3000).astype(np.int64)


@pytest.fixture(scope="module")
def run_pair():
    ids, vals = _run_pairs()
    j, t = JBSI.from_pairs(ids, vals), RoaringBitmapSliceIndex.from_pairs(
        ids, vals)
    assert not t.has_run_compression()
    j.run_optimize()
    t.run_optimize()
    return j, t


@pytest.mark.parametrize("form", ["buffer", "stream"])
def test_run_optimized_serialization_matches_jax(run_pair, form):
    """A run-optimized index writes the run flag and run containers byte
    for byte as the JAX package does, and each package reads the other's
    bytes back run-optimized."""
    j, t = run_pair
    assert t.has_run_compression() and j.has_run_compression()
    assert t.ebm.has_run_compression()
    data = getattr(t, f"serialize_{form}")()
    assert data == getattr(j, f"serialize_{form}")()
    plain = RoaringBitmapSliceIndex.from_pairs(*_run_pairs())
    assert len(data) < len(getattr(plain, f"serialize_{form}")())
    for reader in (RoaringBitmapSliceIndex, JBSI):
        back = getattr(reader, f"deserialize_{form}")(data)
        assert back.has_run_compression()
        _same_index(j, back)
        assert getattr(back, f"serialize_{form}")() == data


def test_run_optimized_index_answers_as_before(run_pair):
    """``DeviceBSI`` and ``BsiColumn`` built from a run-optimized index
    answer as from the plain one."""
    from roaringbitmap_tpu_torch.analytics import BsiColumn

    _, t = run_pair
    plain = RoaringBitmapSliceIndex.from_pairs(*_run_pairs())
    dr, dp = DeviceBSI(t, device="cpu"), DeviceBSI(plain, device="cpu")
    cr = BsiColumn.from_bsi("v", t, device="cpu")
    cp = BsiColumn.from_bsi("v", plain, device="cpu")
    for op, a, b in (("GE", 40, 0), ("EQ", 7, 0), ("RANGE", 3, 50),
                     ("LT", 12, 0)):
        want = plain.compare(Operation[op], a, b)
        assert _arr(t.compare(Operation[op], a, b)) == _arr(want)
        assert _arr(dr.compare(Operation[op], a, b)) == _arr(
            dp.compare(Operation[op], a, b)) == _arr(want)
        assert _arr(cr.host_filter(op.lower() if op != "RANGE" else "range",
                                   a, b)) == _arr(want)
    assert dr.sum() == dp.sum() == plain.sum()
    assert cr.host_sum(None) == cp.host_sum(None)
    assert _arr(dr.top_k(100)) == _arr(dp.top_k(100))


@pytest.mark.parametrize("cut", [0, 5, 9, 40, -1])
def test_truncated_buffer_raises_alike(pair, cut):
    j, t = pair
    data = t.serialize_buffer()[:cut]
    with pytest.raises(JBad):
        JBSI.deserialize_buffer(data)
    with pytest.raises(InvalidRoaringFormat):
        RoaringBitmapSliceIndex.deserialize_buffer(data)


def test_vlong_round_trip():
    from roaringbitmap_tpu.bsi.slice_index import write_vlong as jwrite
    from roaringbitmap_tpu_torch.bsi.slice_index import (read_vlong,
                                                         write_vlong)
    for v in (0, 1, -1, 127, -112, -113, 128, 300, 2 ** 31 - 1, -2 ** 40,
              2 ** 62):
        out, jout = bytearray(), bytearray()
        write_vlong(out, v)
        jwrite(jout, v)
        assert out == jout
        assert read_vlong(memoryview(bytes(out)), 0) == (v, len(out))


# ---------------------------------------------------------------- device


@pytest.fixture(scope="module")
def devices(pair):
    j, t = pair
    return JDeviceBSI(j), DeviceBSI(t, device="cpu")


@pytest.mark.parametrize("op", OPS)
def test_device_compare_matches_jax(pair, devices, found, op):
    j, t = pair
    jd, td = devices
    for a, b in _args(j, op):
        for jf, tf in ((None, None), found):
            got = td.compare(Operation[op], a, b, tf)
            assert _arr(got) == _arr(jd.compare(JOp[op], a, b, jf))
            assert _arr(got) == _arr(t.compare(Operation[op], a, b, tf))
            assert td.compare_cardinality(Operation[op], a, b, tf) \
                == got.cardinality


def test_device_sum_topk_match_jax(devices, pair, found):
    (jd, td), (j, t), (jf, tf) = devices, pair, found
    assert td.sum() == jd.sum() == t.sum()
    assert td.sum(tf) == t.sum(tf)
    assert td.sum(tf)[0] == jd.sum(jf)[0]
    for k in (0, 1, 100, 1000):
        got = td.top_k(k)
        assert _arr(got) == _arr(jd.top_k(k)) == _arr(t.top_k(k))
    sub = t.ebm & tf
    assert _arr(td.top_k(50, sub)) == _arr(t.top_k(50, sub))
    assert td.hbm_bytes() == (td.depth + 1) * td.keys.size * 8192
    with pytest.raises(ValueError):
        td.top_k(t.cardinality + 1)


def test_device_sum_counts_found_rows_outside_the_index(devices, pair,
                                                        found):
    """Regression: the reference DeviceBSI.sum counts the found set after
    densifying it over the index's keys, so found rows under other keys
    drop out of the count (19,164 of 38,525 here) while the host sum counts
    them all; the port's count is the host's."""
    (jd, td), (j, t), (jf, tf) = devices, pair, found
    assert not np.isin(tf.keys, td.keys).all()
    assert td.sum(tf)[1] == t.sum(tf)[1] == j.sum(jf)[1] == tf.cardinality
    assert jd.sum(jf)[1] < tf.cardinality


@pytest.mark.parametrize("op,value,end", [("GE", 20000, 0),
                                          ("RANGE", 300, 31000),
                                          ("NEQ", 77, 0)])
def test_device_chained_compare_matches_jax(devices, op, value, end):
    jd, td = devices
    got = int(td.chained_compare_cardinality(Operation[op], value, 3, end)())
    want = int(jd.chained_compare_cardinality(JOp[op], value, 3, end)())
    assert got == want == (3 * td.compare_cardinality(
        Operation[op], value, end)) % 2 ** 32


def test_device_chained_sum_topk_match_jax(devices):
    jd, td = devices
    assert int(td.chained_sum_cardinality(4)()) == int(
        jd.chained_sum_cardinality(4)()) == (4 * td.sum()[0]) % 2 ** 32
    assert int(td.chained_topk_cardinality(100, 3)()) == int(
        jd.chained_topk_cardinality(100, 3)())


@pytest.fixture(scope="module")
def range_pair():
    rng = np.random.default_rng(0xD1)
    vals = rng.integers(0, 1 << 45, 70000).astype(np.uint64)
    app = JRange.appender(int(vals.max()))
    app.add_many(vals)
    jr = app.build()
    tr = RangeBitmap.from_values(vals)
    return vals, jr, tr, JDeviceRange(jr), DeviceRangeBitmap(tr,
                                                             device="cpu")


@pytest.mark.parametrize("op", ["lte", "lt", "gte", "gt", "eq", "neq",
                                "between"])
def test_device_range_bitmap_matches_jax(range_pair, op):
    vals, jr, tr, jd, td = range_pair
    ctx_v = np.arange(1000, 69000, 3, dtype=np.uint32)
    ctxs = ((None, None), (JRB.from_values(ctx_v), TRB.from_values(ctx_v)))
    args = ([(int(vals[5]),), (0,), (-1,), (int(vals.max()),),
             (1 << 44,), (1 << 46,)] if op != "between"
            else [(1 << 40, 1 << 44), (-3, 1 << 50), (7, 3),
                  (int(vals[9]), int(vals[9]))])
    for a in args:
        for jc, tc in ctxs:
            got = getattr(td, op)(*a, context=tc)
            assert _arr(got) == _arr(getattr(jd, op)(*a, context=jc)), a
            assert _arr(got) == _arr(getattr(tr, op)(*a, context=tc)), a
            assert getattr(td, f"{op}_cardinality")(*a, context=tc) \
                == got.cardinality


@pytest.mark.parametrize("op,a,b", [("lte", 1 << 43, 0), ("between",
                                                          1 << 40, 1 << 44)])
def test_device_range_chained_matches_jax(range_pair, op, a, b):
    *_, jd, td = range_pair
    got = int(td.chained_cardinality(op, a, b, 3)())
    assert got == int(jd.chained_cardinality(op, a, b, 3)())
    assert got == 3 * td._card(op, a, b, None)
