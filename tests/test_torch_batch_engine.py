"""The port's batch engine against roaringbitmap_tpu.parallel.batch_engine.

The same seeded bitmaps and query pools go through both packages: the JAX
engine on its "xla" rung with ``fallback=False``, the port on
``device="cpu"`` on its "cuda" rung (each kernel's plain version, as CPU
tensors take it) and its "torch" rung.  Plans (bucket signatures and host
arrays) and results (cardinalities and members) must be equal, and equal to
the host reference ``_sequential_one``.
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import batch_engine as jbe
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.parallel import batch_engine as tbe
from roaringbitmap_tpu_torch.parallel import expr as texpr

N = 16
LAYOUTS = ["dense", "compact", "counts"]


def _values(seed: int = 0xBA7, n: int = N) -> list:
    """n value sets over 2^17: sparse, clustered and run-heavy."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            v = rng.integers(0, 1 << 17, 1200)
        elif kind == 1:
            v = (int(rng.integers(0, 2)) << 16) + rng.integers(0, 1 << 16,
                                                               6000)
        else:
            s = int(rng.integers(0, 1 << 17))
            v = np.arange(s, s + int(rng.integers(100, 9000))) % (1 << 17)
        out.append(np.unique(v).astype(np.uint32))
    return out


@pytest.fixture(scope="module")
def pair():
    vals = _values()
    return ([JRB.from_values(v) for v in vals],
            [TRB.from_values(v) for v in vals])


_ENGINES = {}


def _engines(pair, layout):
    if layout not in _ENGINES:
        j, t = pair
        _ENGINES[layout] = (
            jbe.BatchEngine.from_bitmaps(j, layout=layout),
            tbe.BatchEngine(DeviceBitmapSet(t, layout=layout, device="cpu")))
    return _ENGINES[layout]


def _pool(form: str) -> list:
    pool = tbe.random_query_pool(N, 24, seed=7, max_operands=8)
    pool += [tbe.BatchQuery("and", (0, 0, 3)), tbe.BatchQuery("andnot", (5,)),
             tbe.BatchQuery("or", ()), tbe.BatchQuery("xor", (2, 9, 2))]
    return [tbe.BatchQuery(q.op, q.operands, form=form) for q in pool]


def _jpool(pool):
    return [jbe.BatchQuery(q.op, q.operands, form=q.form) for q in pool]


def _same(got, want, pool):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.cardinality == w.cardinality, i
        if pool[i].form == "bitmap":
            assert np.array_equal(g.bitmap.to_array(), w.bitmap.to_array()), i


def test_pool_generator_matches_jax():
    for seed in (0xBA7C, 3):
        t = tbe.random_query_pool(N, 20, seed=seed)
        j = jbe.random_query_pool(N, 20, seed=seed)
        assert [(q.op, q.operands) for q in t] == [(q.op, q.operands)
                                                   for q in j]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_parity(pair, layout):
    jeng, teng = _engines(pair, layout)
    pool = _pool("bitmap")[:12] + [
        texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)))]
    jpool = _jpool(pool[:-1]) + [jbe.expr_mod.ExprQuery(
        jbe.expr_mod.and_(jbe.expr_mod.or_(0, 1), jbe.expr_mod.not_(2)))]
    jplan, tplan = jeng.plan(jpool), teng.plan(pool)
    assert [b.signature for b in tplan] == [b.signature for b in jplan]
    assert tplan.owner == jplan.owner
    for jb, tb in zip(jplan, tplan):
        assert tb.qids == jb.qids
        for k in ("gather", "valid", "flat_seg", "flat_head", "heads_ok",
                  "key_keep", "head_gather", "head_ok"):
            if k in jb.arrays:
                assert np.array_equal(tb.host[k], np.asarray(jb.arrays[k])), k
            else:
                assert k not in tb.host, k


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("form", ["cardinality", "bitmap"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_flat_pool_matches_jax(pair, layout, form, engine):
    jeng, teng = _engines(pair, layout)
    pool = _pool(form)
    want = jeng.execute(_jpool(pool), engine="xla", fallback=False)
    got = teng.execute(pool, engine=engine)
    assert teng.last_timings["engine"] == engine
    _same(got, want, pool)
    _same(got, teng._execute_sequential(pool), pool)


def test_auto_on_cpu_is_torch(pair):
    _, teng = _engines(pair, "dense")
    pool = _pool("cardinality")[:4] + [texpr.ExprQuery(texpr.or_(
        texpr.and_(0, 1), texpr.xor(2, 3)))]
    assert tbe.resolve_query_engine("auto", pool, teng.device) == "torch"
    teng.execute(pool)
    assert teng.last_timings["engine"] == "torch"
    assert list(teng.cardinalities(pool)) == [
        r.cardinality for r in teng._execute_sequential(pool)]


def test_from_numpy_state_with_row_src(pair):
    j, t = pair
    js = jagg.DeviceBitmapSet(j, layout="dense")
    p = js._packed
    state = {"keys": js.keys, "n": js.n, "block": js.block,
             "blk_seg": p.blk_seg, "n_blocks": p.n_blocks,
             "seg_sizes": p.seg_sizes, "seg_offsets": p.seg_offsets,
             "words": np.asarray(js.words)}
    bare = DeviceBitmapSet.from_numpy_state(state, device="cpu")
    with pytest.raises(ValueError, match="row_src"):
        tbe.BatchEngine(bare)
    ts = DeviceBitmapSet.from_numpy_state(state | {"row_src": p.row_src},
                                          device="cpu")
    assert np.array_equal(ts.row_src, p.row_src)
    hosts = ts.host_bitmaps()
    assert all(np.array_equal(h.to_array(), b.to_array())
               for h, b in zip(hosts, t))
    pool = _pool("bitmap")
    got = tbe.BatchEngine(ts).execute(pool, engine="cuda")
    want = jbe.BatchEngine(js).execute(_jpool(pool), engine="xla",
                                       fallback=False)
    _same(got, want, pool)


def test_typed_errors(pair):
    jeng, teng = _engines(pair, "dense")
    for bad in ((0, N), (-1, 2)):
        with pytest.raises(IndexError):
            jeng.execute([jbe.BatchQuery("or", bad)], fallback=False)
        with pytest.raises(IndexError):
            teng.execute([tbe.BatchQuery("or", bad)])
    for mod in (jbe, tbe):
        with pytest.raises(ValueError):
            mod.BatchQuery("nand", (0, 1))
        with pytest.raises(ValueError):
            mod.BatchQuery("or", (0, 1), form="words")
    with pytest.raises(IndexError):
        teng.execute([texpr.ExprQuery(texpr.and_(0, texpr.or_(1, N)))])
    with pytest.raises(ValueError):
        teng.execute(_pool("bitmap")[:2], engine="xla")


def test_plan_cache(pair):
    _, teng = _engines(pair, "compact")
    pool = _pool("cardinality")[:6]
    before = teng.cache_stats()["plans"]["hits"]
    assert teng.plan(pool) is teng.plan(list(pool))
    assert teng.cache_stats()["plans"]["hits"] == before + 1


def test_b1_plain_empty_segments():
    """Segments without rows reduce to zero rows in B1's plain version, as
    the kernel leaves them (the flat batch layout has such segments)."""
    rng = np.random.default_rng(5)
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (6, 2048),
                                          dtype=np.int64).astype(np.int32))
    seg = torch.tensor([1, 1, 3, 3, 3, 4], dtype=torch.int32)
    for op in ("or", "and", "xor", "andnot"):
        heads, cards = kernels.segmented_reduce(op, words, seg, 6)
        assert not heads[[0, 2, 5]].any() and not cards[[0, 2, 5]].any()
        fn = {"or": np.bitwise_or, "and": np.bitwise_and,
              "xor": np.bitwise_xor}.get(op)
        w = words.numpy()
        for k, rows in ((1, [0, 1]), (3, [2, 3, 4]), (4, [5])):
            want = (w[rows[0]] & ~np.bitwise_or.reduce(w[rows[1:]], axis=0)
                    if op == "andnot" and len(rows) > 1 else
                    w[rows[0]] if len(rows) == 1 else
                    fn.reduce(w[rows], axis=0))
            assert np.array_equal(heads[k].numpy(), want), (op, k)
