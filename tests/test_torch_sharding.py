"""The port's sharded wide aggregation against
roaringbitmap_tpu.parallel.sharding.

The JAX package runs on the conftest's 8 virtual CPU devices; the port on a
CPU mesh of 8 shards (the device "cpu" repeated, or "cpu:0".."cpu:7", which
the port treats as distinct devices: then a shard holds only its own rows
and the replicated rows come back through the OR butterfly).  The same
numpy-seeded inputs go through both; keys, words and cardinalities are held
equal, exact.  Also here: B1's plain version at every row width and the
mesh vocabulary (``SpecLayout``, ``global_mesh``, ``_arrange``); the
combine-mode B5 streams are held in ``test_torch_sharded_engine.py``."""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import sharding as jsh
from roaringbitmap_tpu.utils import datasets as jdatasets
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops import packing as tpacking
from roaringbitmap_tpu_torch.parallel import multihost
from roaringbitmap_tpu_torch.parallel import sharding as tsh
from roaringbitmap_tpu_torch.utils import datasets as tdatasets

torch.set_num_threads(2)

MESH_SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]


def _jmesh(rows, lanes):
    return JMesh(np.array(jax.devices()[:rows * lanes]).reshape(rows, lanes),
                 ("rows", "lanes"))


def _tmesh(rows, lanes, distinct=False):
    devs = ([f"cpu:{i}" for i in range(rows * lanes)] if distinct
            else ["cpu"] * (rows * lanes))
    return tsh.Mesh(np.array(devs).reshape(rows, lanes), ("rows", "lanes"))


@pytest.fixture(scope="module")
def workload():
    return (jdatasets.synthetic_bitmaps(16, seed=3, universe=1 << 20,
                                        density=0.02),
            tdatasets.synthetic_bitmaps(16, seed=3, universe=1 << 20,
                                        density=0.02))


def _same(jres, tres):
    for a, b in zip(jres, tres):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        assert np.array_equal(a, b)


def _both(op, jbms, tbms, shape, ingest="dense", distinct=False):
    j = jsh.wide_aggregate_sharded(_jmesh(*shape), op, jbms, ingest=ingest,
                                   fallback=False)
    t = tsh.wide_aggregate_sharded(_tmesh(*shape, distinct), op, tbms,
                                   ingest=ingest, fallback=False)
    _same(j, t)
    return t


def _fold(op, bms):
    acc = bms[0].clone()
    for b in bms[1:]:
        acc = acc | b if op == "or" else (acc ^ b if op == "xor"
                                          else acc & b)
    return acc


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_or_all_mesh_shapes(workload, shape):
    keys, words, cards = _both("or", *workload, shape)
    assert tpacking.unpack_result(keys, words, cards) == _fold("or",
                                                               workload[1])


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_xor_all_mesh_shapes(workload, shape):
    keys, words, cards = _both("xor", *workload, shape, distinct=True)
    assert tpacking.unpack_result(keys, words, cards) == _fold("xor",
                                                               workload[1])


def test_ragged_aggregator_rejects_and():
    with pytest.raises(ValueError):
        jsh.make_sharded_aggregator(_jmesh(8, 1), "and", 4, 2)
    with pytest.raises(ValueError):
        tsh.make_sharded_aggregator(_tmesh(8, 1), "and", 4, 2)


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_and_matches_host(workload, shape):
    keys, words, cards = _both("and", *workload, shape)
    assert tpacking.unpack_result(keys, words, cards) == _fold("and",
                                                               workload[1])


def test_sharded_and_nonempty(workload):
    base = np.arange(0, 300000, 7, dtype=np.uint32)
    jbms = [JRB.from_values(base) | b for b in workload[0][:6]]
    tbms = [TRB.from_values(base) | b for b in workload[1][:6]]
    keys, words, cards = _both("and", jbms, tbms, (4, 2), distinct=True)
    got = tpacking.unpack_result(keys, words, cards)
    assert got == _fold("and", tbms)
    assert got.cardinality >= base.size


@pytest.mark.parametrize("op", ["or", "xor", "and"])
def test_sharded_dataset_scale_parity(op):
    """A larger seeded set (the dataset-scale case of the JAX suite, which
    skips without the census zips): 64 bitmaps over 2^22."""
    jb = jdatasets.synthetic_bitmaps(64, seed=11, universe=1 << 22,
                                     density=0.004)
    tb = tdatasets.synthetic_bitmaps(64, seed=11, universe=1 << 22,
                                     density=0.004)
    keys, words, cards = _both(op, jb, tb, (4, 2))
    assert tpacking.unpack_result(keys, words, cards) == _fold(op, tb)


def _compact_inputs(rng_seed=0xC0FFEE):
    rng = np.random.default_rng(rng_seed)
    vals = []
    for i in range(12):
        v = [rng.integers(0, 1 << 20, 600),
             (2 << 16) + rng.integers(0, 9000, 6000)]
        start = (3 << 16) + int(rng.integers(0, 900))
        v.append(np.arange(start, start + 5000 + 97 * i))
        vals.append(np.concatenate(v).astype(np.uint32))
    jb, tb = [], []
    for v in vals:
        a, b = JRB.from_values(v), TRB.from_values(v)
        a.run_optimize()
        b.run_optimize()
        jb.append(a)
        tb.append(b)
    return jb, tb


@pytest.mark.parametrize("shape", MESH_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_compact_ingest_sharded_parity(shape):
    """Compact ingest (streams per shard, densified there) equals the
    dense ingest and the JAX package's, bitmaps and serialized bytes."""
    jb, tb = _compact_inputs()
    for op in ("or", "xor"):
        kd, wd, cd = _both(op, jb, tb, shape)
        for jsrc, tsrc in ((jb, tb), ([b.serialize() for b in jb],
                                      [b.serialize() for b in tb])):
            kc, wc, cc = _both(op, jsrc, tsrc, shape, ingest="compact")
            assert (tpacking.unpack_result(kc, wc, cc)
                    == tpacking.unpack_result(kd, wd, cd))


def test_sharded_ingest_validation_and_bytes_and():
    rng = np.random.default_rng(5)
    vals = [np.concatenate([np.arange(5, 400),
                            ((i + 1) << 16) + rng.integers(0, 5000, 100)])
            .astype(np.uint32) for i in range(4)]
    jb = [JRB.from_values(v) for v in vals]
    tb = [TRB.from_values(v) for v in vals]
    with pytest.raises(ValueError, match="unknown ingest"):
        jsh.wide_aggregate_sharded(_jmesh(4, 2), "or", jb, ingest="streams")
    with pytest.raises(ValueError, match="unknown ingest"):
        tsh.wide_aggregate_sharded(_tmesh(4, 2), "or", tb, ingest="streams")
    keys, words, cards = _both("and", [b.serialize() for b in jb],
                               [b.serialize() for b in tb], (4, 2),
                               ingest="compact")
    want = tb[0] & tb[1] & tb[2] & tb[3]
    assert want.cardinality
    assert tpacking.unpack_result(keys, words, cards) == want


def test_dense_ingest_accepts_bytes():
    rng = np.random.default_rng(6)
    vals = [rng.integers(0, 1 << 18, 2000).astype(np.uint32)
            for _ in range(6)]
    keys, words, cards = _both(
        "or", [JRB.from_values(v).serialize() for v in vals],
        [TRB.from_values(v).serialize() for v in vals], (4, 2))
    assert tpacking.unpack_result(keys, words, cards) == TRB.from_values(
        np.concatenate(vals))


def test_sharded_bsi_parity():
    from roaringbitmap_tpu.bsi.slice_index import (
        Operation as JOp, RoaringBitmapSliceIndex as JBSI)
    from roaringbitmap_tpu_torch.bsi.slice_index import (
        Operation as TOp, RoaringBitmapSliceIndex as TBSI)

    rng = np.random.default_rng(17)
    cols = np.unique(rng.integers(0, 1 << 20, 6000)).astype(np.uint32)
    vals = rng.integers(0, 1 << 16, cols.size).astype(np.uint64)
    jb = jsh.ShardedBSI(_jmesh(4, 2), JBSI.from_pairs(cols, vals))
    tbsi = TBSI.from_pairs(cols, vals)
    tb = tsh.ShardedBSI(_tmesh(4, 2), tbsi)
    thr = int(np.median(vals))
    for name in ("LT", "GE", "EQ", "NEQ", "LE", "GT"):
        want = tbsi.compare(TOp[name], thr, 0, None).cardinality
        assert tb.compare_cardinality(TOp[name], thr) == want
        assert jb.compare_cardinality(JOp[name], thr) == want
    a, b = int(np.quantile(vals, 0.2)), int(np.quantile(vals, 0.8))
    assert (tb.compare_cardinality(TOp.RANGE, a, b)
            == jb.compare_cardinality(JOp.RANGE, a, b)
            == tbsi.compare(TOp.RANGE, a, b, None).cardinality)
    assert tb.compare_cardinality(TOp.LT, -5) == 0
    assert tb.compare_cardinality(TOp.LE, 1 << 40) == tbsi.ebm.cardinality
    assert tb.sum() == jb.sum() == tbsi.sum()


def test_sharded_64bit_tier():
    """Roaring64Bitmaps ride the same sharded ops: the segment axis is
    the u48 high key; the results restore the 64-bit class."""
    from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
    from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64

    rng = np.random.default_rng(5)
    vals = [rng.integers(0, 1 << 40, 5000, dtype=np.uint64)
            for _ in range(8)]
    jb = [J64.from_values(v) for v in vals]
    tb = [T64.from_values(v) for v in vals]
    for op in ("or", "xor", "and"):
        keys, words, cards = _both(op, jb, tb, (4, 2))
        got = tpacking.unpack_result(keys, words, cards)
        assert isinstance(got, T64)
        assert got == _fold(op, tb), op


def test_sharded_bsi_topk():
    from roaringbitmap_tpu.bsi.slice_index import RoaringBitmapSliceIndex as J
    from roaringbitmap_tpu_torch.bsi.device import DeviceBSI
    from roaringbitmap_tpu_torch.bsi.slice_index import (
        RoaringBitmapSliceIndex as T)

    rng = np.random.default_rng(23)
    cols = np.unique(rng.integers(0, 1 << 19, 4000)).astype(np.uint32)
    vals = rng.integers(0, 1 << 12, cols.size).astype(np.uint64)
    tbsi = T.from_pairs(cols, vals)
    jb = jsh.ShardedBSI(_jmesh(4, 2), J.from_pairs(cols, vals))
    tb = tsh.ShardedBSI(_tmesh(4, 2, distinct=True), tbsi)
    db = DeviceBSI(tbsi, device="cpu")
    from roaringbitmap_tpu_torch.bsi.device import _topk_res
    from roaringbitmap_tpu_torch.ops.words import popcount

    for k in (1, 50, cols.size // 2, cols.size):
        want = int(popcount(_topk_res(db.slices, db.ebm, k)).sum())
        got = tb.top_k_cardinality(k)
        assert got == want == jb.top_k_cardinality(k), k
        assert got >= k


def test_sharded_rangebitmap_parity():
    from roaringbitmap_tpu.core.rangebitmap import RangeBitmap as JRange
    from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap as TRange

    rng = np.random.default_rng(29)
    vals = rng.integers(0, 100_000, 80_000).astype(np.uint64)
    japp = JRange.appender(int(vals.max()))
    japp.add_many(vals)
    tapp = TRange.appender(int(vals.max()))
    tapp.add_many(vals)
    trb = tapp.build()
    js = jsh.ShardedRangeBitmap(_jmesh(4, 2), japp.build())
    ts = tsh.ShardedRangeBitmap(_tmesh(4, 2), trb)
    thr = int(np.median(vals))
    lo, hi = int(np.percentile(vals, 25)), int(np.percentile(vals, 75))
    for name in ("lte", "lt", "gte", "gt", "eq", "neq"):
        got = getattr(ts, f"{name}_cardinality")(thr)
        assert got == getattr(js, f"{name}_cardinality")(thr)
        assert got == getattr(trb, name)(thr).cardinality
    assert ts.between_cardinality(lo, hi) == js.between_cardinality(lo, hi) \
        == trb.between(lo, hi).cardinality
    assert ts.lte_cardinality(-1) == 0
    assert ts.gte_cardinality(0) == ts.rows
    assert ts.between_cardinality(hi, lo) == 0
    assert ts.between_cardinality(-5, 1 << 40) == ts.rows


def test_sharded_key_budget_guard():
    for mod, mesh in ((jsh, _jmesh(4, 2)), (tsh, _tmesh(4, 2))):
        with pytest.raises(mod.ShardedKeyBudgetError, match="ceiling"):
            mod.make_sharded_aggregator(
                mesh, "or", mod.MAX_KEYS_PER_SHARD_PASS + 1, 2)
    assert tsh.MAX_KEYS_PER_SHARD_PASS == jsh.MAX_KEYS_PER_SHARD_PASS


@pytest.mark.parametrize("ingest", ["dense", "compact"])
def test_sharded_chunked_wide_keyspace(ingest):
    """Past 4,096 keys the key axis chunks; results equal the JAX
    package's and the host fold."""
    n_keys = 2 * tsh.MAX_KEYS_PER_SHARD_PASS + 777
    base = np.arange(n_keys, dtype=np.uint32) << 16
    vals = [base + np.uint32(7 * i) for i in range(4)]
    vals.append((1000 << 16) + np.arange(30000, dtype=np.uint32))
    jb = [JRB.from_values(v) for v in vals]
    tb = [TRB.from_values(v) for v in vals]
    for op in ("or", "xor"):
        keys, words, cards = _both(op, jb, tb, (4, 2), ingest=ingest)
        assert keys.size == n_keys
        assert tpacking.unpack_result(keys, words, cards) == _fold(op, tb)
    assert tsh.MAX_KEYS_PER_SHARD_PASS * 8192 == 32 << 20


def test_global_mesh_single_host(workload):
    """Without a process group global_mesh is the local mesh over the
    given devices, (8, 1) by default, every factorization by lanes."""
    mesh = multihost.global_mesh(devices=["cpu"] * 8)
    assert mesh.devices.shape == (8, 1) and not mesh.multi_process
    keys, words, cards = tsh.wide_aggregate_sharded(mesh, "or", workload[1],
                                                    fallback=False)
    assert tpacking.unpack_result(keys, words, cards) == _fold("or",
                                                               workload[1])
    for lanes in (1, 2, 4, 8):
        assert multihost.global_mesh(
            lanes=lanes, devices=["cpu"] * 8).devices.shape == (8 // lanes,
                                                                lanes)
    with pytest.raises(ValueError, match="does not divide"):
        multihost.global_mesh(lanes=3, devices=["cpu"] * 8)


def test_global_mesh_groups_by_process():
    """The pure placement equals the JAX package's: host-pure columns
    even when the global order interleaves hosts."""
    from roaringbitmap_tpu.parallel import multihost as jmh

    class Dev:
        def __init__(self, i, p):
            self.id, self.process_index = i, p

    devs = [Dev(i, i % 2) for i in range(12)]
    for lanes in (None, 3):
        a = multihost._arrange(devs, lanes)
        b = jmh._arrange(devs, lanes)
        assert a.shape == b.shape
        assert [d.id for d in a.ravel()] == [d.id for d in b.ravel()]
    arr = multihost._arrange(devs, None)
    assert arr.shape == (2, 6)
    for j in range(6):
        assert len({d.process_index for d in arr[:, j]}) == 1


def test_spec_layout_vocabulary():
    from roaringbitmap_tpu.parallel import SpecLayout as JSpec

    j, t = JSpec(), tsh.SpecLayout()
    for name in ("pooled_rows", "packed_rows", "row_vec", "gather_rows",
                 "gather_vec", "replicated", "combined_heads", "heads",
                 "index_rows", "sliced_index"):
        assert tuple(getattr(t, name)()) == tuple(getattr(j, name)()), name
    import dataclasses

    with pytest.raises(dataclasses.FrozenInstanceError):
        t.row_axis = "x"


@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot"])
def test_b1_plain_at_every_width(op, width):
    """B1's plain version at each row width equals the full-width result
    sliced to that width (the lanes axis hands each shard a slice)."""
    rng = np.random.default_rng(width)
    words = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, (40, 2048),
                                          dtype=np.int64).astype(np.int32))
    seg = torch.from_numpy(np.sort(rng.integers(0, 9, 40)).astype(np.int32))
    full_h, _ = kernels.segmented_reduce(op, words, seg, 10)
    for lane in range(2048 // width):
        part = words[:, lane * width:(lane + 1) * width].contiguous()
        h, c = kernels.segmented_reduce(op, part, seg, 10)
        assert h.shape == (10, width)
        assert torch.equal(h, full_h[:, lane * width:(lane + 1) * width])
        from roaringbitmap_tpu_torch.ops.words import popcount

        assert torch.equal(c, popcount(h))
    with pytest.raises(ValueError, match="row width"):
        kernels.segmented_reduce(op, words[:, :300].contiguous(), seg, 10)


def test_mesh_validation():
    with pytest.raises(ValueError):
        tsh.Mesh(np.array(["cpu"] * 4).reshape(2, 2), ("rows",))
    with pytest.raises(ValueError, match="B1 takes"):
        tsh.wide_aggregate_sharded(
            tsh.Mesh(np.array(["cpu"] * 16).reshape(1, 16),
                     ("rows", "lanes")), "or", [TRB.from_values(
                         np.arange(9, dtype=np.uint32))], fallback=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if not torch.cuda.is_available():
            tsh.Mesh(np.array(["cuda"] * 2).reshape(2, 1),
                     ("rows", "lanes"))
        else:
            raise RuntimeError("no CUDA device (card present)")


def test_explain_and_guarded_landing(workload):
    """explain_sharded's chunk schedule equals the JAX package's; a dead
    sharded rung lands on the host fold off the card, bit-exact."""
    from roaringbitmap_tpu_torch.runtime import faults, guard

    rep = tsh.explain_sharded(_tmesh(4, 2), "or", workload[1])
    jrep = jsh.explain_sharded(_jmesh(4, 2), "or", workload[0])
    for k in ("num_keys", "passes", "max_keys_per_pass",
              "predicted_hbm_bytes"):
        assert rep[k] == jrep[k], k
    assert rep["engine_chain"] == ["sharded", "sequential"]
    guard.reset_dispatch_stats()
    with faults.inject("lowering@sharded=1.0:3"):
        keys, words, cards = tsh.wide_aggregate_sharded(
            _tmesh(4, 2), "xor", workload[1])
    assert tpacking.unpack_result(keys, words, cards) == _fold("xor",
                                                               workload[1])
    assert guard.dispatch_stats("sharding")["sequential"] == 1
