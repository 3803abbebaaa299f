"""The port's host RangeBitmap against roaringbitmap_tpu.core.rangebitmap.

The same seeded value vectors build both packages' RangeBitmaps: the port's
vectorized ``RangeBitmap.from_values`` must give, slice for slice, what its
``Appender`` and the JAX appender give, and every query and cardinality
form (with and without a context) must return the same rows.  Everything is
compared exactly.
"""

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.core.rangebitmap import RangeBitmap as JRange
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.core.rangebitmap import Appender, RangeBitmap

#: (seed, rows, max value): a partial last chunk, 64-bit values, one row,
#: constant values, several full chunks
SHAPES = [(1, 70000, 1 << 40), (2, 3000, (1 << 63) - 1), (3, 1, 9),
          (4, 5000, 0), (5, 1 << 17, 1000)]


def _values(seed, rows, vmax):
    rng = np.random.default_rng(seed)
    if vmax == 0:
        return np.full(rows, 7, np.uint64)
    return rng.integers(0, vmax, rows, dtype=np.uint64)


def _arr(bm) -> list:
    return bm.to_array().tolist()


def _jax(vals, mx):
    app = JRange.appender(mx)
    app.add_many(vals)
    return app.build()


@pytest.mark.parametrize("seed,rows,vmax", SHAPES)
def test_vectorized_build_equals_appenders(seed, rows, vmax):
    vals = _values(seed, rows, vmax)
    mx = int(vals.max())
    fast = RangeBitmap.from_values(vals)
    app = Appender(mx)
    half = rows // 2
    app.add_many(vals[:half])
    for v in vals[half:half + 3]:
        app.add(int(v))
    app.add_many(vals[half + 3:])
    slow = app.build()
    jr = _jax(vals, mx)
    assert (fast.row_count, fast.max_value) == (slow.row_count,
                                                slow.max_value) == (
        jr.row_count, jr.max_value)
    assert len(fast.slices) == len(slow.slices) == len(jr.slices)
    for f, s, j in zip(fast.slices, slow.slices, jr.slices):
        assert f == s
        assert np.array_equal(f.keys, j.keys)
        assert _arr(f) == _arr(j)


def test_builders_reject_like_jax():
    with pytest.raises(ValueError):
        RangeBitmap.from_values(np.array([5], np.uint64), max_value=4)
    with pytest.raises(ValueError):
        Appender(4).add(5)
    with pytest.raises(ValueError):
        Appender(-1)
    app = Appender(10)
    app.add_many(np.array([1, 2], np.uint64))
    app.clear()
    assert app.build().row_count == 0


@pytest.fixture(scope="module", params=SHAPES[:3], ids=["40bit", "63bit",
                                                        "one-row"])
def built(request):
    vals = _values(*request.param)
    return vals, _jax(vals, int(vals.max())), RangeBitmap.from_values(vals)


@pytest.mark.parametrize("op", ["lte", "lt", "gte", "gt", "eq", "neq",
                                "between"])
def test_queries_match_jax(built, op):
    vals, jr, tr = built
    rows = vals.size
    ctx_v = np.arange(0, rows + 70000, 5, dtype=np.uint32)
    ctxs = ((None, None), (JRB.from_values(ctx_v), TRB.from_values(ctx_v)))
    mx = int(vals.max())
    if op == "between":
        args = [(int(vals.min()), mx), (mx // 4, mx // 2), (-3, 10),
                (int(vals[0]), int(vals[0])), (9, 3), (mx + 1, mx + 9)]
    else:
        args = [(int(vals[0]),), (0,), (-1,), (mx,), (mx + 1,), (mx // 3,),
                (1 << 64,)]
    for a in args:
        for jc, tc in ctxs:
            got = getattr(tr, op)(*a, context=tc)
            assert _arr(got) == _arr(getattr(jr, op)(*a, context=jc)), a
            assert getattr(tr, f"{op}_cardinality")(*a, context=tc) == \
                getattr(jr, f"{op}_cardinality")(*a, context=jc)
