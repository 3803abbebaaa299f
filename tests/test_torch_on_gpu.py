"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (with the reason) where no CUDA device is
present, as on a CPU-only host.  The file imports neither jax nor the JAX
package, so on a GPU host without JAX it runs outside the JAX test harness:

    python -m pytest --noconftest tests/test_torch_on_gpu.py -q
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap, aggregation, obs
from roaringbitmap_tpu_torch.ops import (dense, kernels, megakernel, packing,
                                         plain_rows)
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           random_query_pool)
from roaringbitmap_tpu_torch.parallel.expr import random_expr_pool
from roaringbitmap_tpu_torch.utils.datasets import (ROW_CASES,
                                                    row_stream_case,
                                                    synthetic_bitmaps,
                                                    uscensus_like_values)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    kernels.reset_launches()
    return torch.device("cuda")


def _same(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.fixture(scope="module")
def bitmaps():
    return synthetic_bitmaps(48, seed=5, universe=1 << 21, density=0.004)


@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot"])
def test_b1_matches_plain(dev, bitmaps, op):
    pk = packing.pack_for_aggregation(bitmaps)
    w, s = as_i32(pk.words, dev), as_i32(pk.seg_ids, dev)
    got = kernels.segmented_reduce(op, w, s, pk.num_keys)
    torch.cuda.synchronize()
    assert kernels.B1.launches == 1
    _same(got, kernels.segmented_reduce_plain(op, w, s, pk.num_keys))


@pytest.mark.parametrize("op", ["or", "xor"])
def test_b2_b4_b3_match_plain(dev, bitmaps, op):
    ds = DeviceBitmapSet(bitmaps, layout="dense", device=dev)
    args = (ds.words, ds.blk_seg, ds.keys.size, ds.block)
    _same(kernels.segmented_reduce_blocked(op, *args),
          kernels.segmented_reduce_blocked_plain(op, *args))
    cs = DeviceBitmapSet(bitmaps, layout="counts", device=dev)
    cargs = (cs.counts, cs._grp_seg_counts, cs.keys.size)
    _same(kernels.counts_segmented_reduce(op, *cargs),
          kernels.counts_segmented_reduce_plain(op, *cargs))
    cv, cr = cs._chunks
    assert torch.equal(kernels.densify_chunks(cv, cr, cs._n_rows),
                       kernels.densify_chunks_plain(cv, cr, cs._n_rows))
    torch.cuda.synchronize()
    assert kernels.B2.launches == kernels.B3.launches == kernels.B4.launches == 1


@pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
def test_entry_points_on_card_match_cpu(dev, bitmaps, layout):
    on_card = DeviceBitmapSet(bitmaps, layout=layout)      # device=None
    on_cpu = DeviceBitmapSet(bitmaps, layout=layout, device="cpu")
    assert on_card.device.type == "cuda"
    for op in ("or", "xor", "and"):
        words, cards = on_card.aggregate_device(op)
        want_w, want_c = on_cpu.aggregate_device(op)
        assert np.array_equal(to_u32(words), to_u32(want_w))
        assert np.array_equal(cards.cpu().numpy(), want_c.numpy())
    assert aggregation.or_(bitmaps) == aggregation.or_(bitmaps, device="cpu")
    assert (aggregation.xor_cardinality(bitmaps)
            == aggregation.xor_cardinality(bitmaps, device="cpu"))


@pytest.mark.parametrize("op", ["or", "xor"])
def test_b6_matches_plain(dev, bitmaps, op):
    """B6 at a compact set's shape, with dense-wire rows folded in."""
    bms = list(bitmaps)
    bms[0] = bms[0] | RoaringBitmap.from_values(
        np.arange(1 << 17, (1 << 17) + 30000, dtype=np.uint32))
    ds = DeviceBitmapSet(bms, layout="compact", device=dev)
    assert ds._streams[0].shape[0] > 0
    counts = dense.nibble_counts_impl(*ds._streams[2:], ds._n_groups,
                                      ds._total_values)
    dp = dense.dense_partial_impl(op, ds._streams[0], ds._dseg, *ds._dmeta,
                                  ds.keys.size)
    args = (counts, dp, ds._grp_seg, ds.keys.size)
    _same(kernels.fused_nibble_reduce(op, *args),
          kernels.fused_nibble_reduce_plain(op, *args))
    torch.cuda.synchronize()
    assert kernels.B6.launches == 1
    kernels.reset_launches()
    got = ds.aggregate(op, engine="cuda-nibble")
    assert kernels.B6.launches == 1 and kernels.B4.launches == 0
    assert got == ds.aggregate(op, engine="torch")
    reps = 3
    total = ds.chained_wide_or(reps, engine="cuda-nibble")()
    assert int(total) == (reps * ds.aggregate("or").cardinality) % 2**32
    assert kernels.B6.launches == 1 + reps


def _same_results(got, want):
    for g, w in zip(got, want):
        assert g.cardinality == w.cardinality
        assert g.bitmap == w.bitmap


def test_b5_matches_plain_on_random_stream(dev):
    mega, banks = megakernel.random_plan(
        11, n_steps=2048, slots_pad=256, out_pad=32, card_pad=64,
        bank_rows=(64, 8, 8))
    tb = [as_i32(b, dev) for b in banks]
    got = megakernel.raw_call(mega, *tb)
    torch.cuda.synchronize()
    assert kernels.B5.launches == 1
    _same(got, megakernel.raw_call_plain(mega, *tb))


def test_b5_matches_plain_on_pool_plan(dev, bitmaps):
    ds = DeviceBitmapSet(bitmaps, layout="dense", device=dev)
    eng = BatchEngine(ds)
    pool = random_expr_pool(len(bitmaps), 4, depth=2, form="bitmap")
    plan = eng.plan(pool)
    assert plan.mega.fits()
    banks = (ds.words, plan.mega.device_arrays(dev)["extra"],
             torch.zeros((1, 2048), dtype=torch.int32, device=dev))
    _same(megakernel.raw_call(plan.mega, *banks),
          megakernel.raw_call_plain(plan.mega, *banks))
    kernels.reset_launches()
    got = eng.execute(pool)
    assert eng.last_timings["engine"] == "megakernel"
    assert kernels.B5.launches == 1
    _same_results(got, eng.execute(pool, engine="torch"))


def test_flat_batch_launches_b1(dev, bitmaps):
    eng = BatchEngine(DeviceBitmapSet(bitmaps, layout="dense"))
    pool = random_query_pool(len(bitmaps), 16)
    kernels.reset_launches()
    got = eng.execute(pool)
    assert eng.last_timings["engine"] == "cuda"
    assert kernels.B1.launches > 0 and kernels.B5.launches == 0
    _same_results(got, eng.execute(pool, engine="torch"))


def _densify_case(case: str):
    """(chunk_vals, chunk_row, n_rows) from the packer for B3's edge cases."""
    rng = np.random.default_rng(3)
    if case == "all padding":
        cv, cr = packing.chunk_value_stream(np.zeros(0, np.uint16),
                                            np.zeros(0, np.int32),
                                            np.zeros(0, np.int32), 9)
        return cv, cr, 9
    n_rows, rows, sizes = {
        "empty rows": (40, [3, 17, 18, 39], [130, 10, 260, 5]),
        "32 chunks a row": (6, [0, 2, 5], [4096, 4096, 4000]),
        "one row": (1, [0], [4096])}[case]
    pieces = [np.sort(rng.choice(1 << 16, n, replace=False)) for n in sizes]
    cv, cr = packing.chunk_value_stream(
        np.concatenate(pieces).astype(np.uint16), np.array(sizes, np.int32),
        np.array(rows, np.int32), n_rows)
    return cv, cr, n_rows


@pytest.mark.parametrize("case", ["empty rows", "all padding",
                                  "32 chunks a row", "one row"])
def test_b3_edge_cases_match_plain(dev, case):
    """B3 writes every row itself (the image is not zero-filled first): rows
    without chunks, padding chunks and full rows equal the plain version,
    also over an output buffer that held garbage before."""
    cv, cr, n_rows = _densify_case(case)
    if case == "32 chunks a row":
        assert np.bincount(cr)[0] == 32
    tv, tr = as_i32(cv, dev), as_i32(cr, dev)
    junk = torch.full((n_rows, 2048), -1, dtype=torch.int32, device=dev)
    del junk                      # the allocator hands this memory back
    got = kernels.densify_chunks(tv, tr, n_rows)
    torch.cuda.synchronize()
    assert kernels.B3.launches == 1
    assert torch.equal(got, kernels.densify_chunks_plain(tv, tr, n_rows))


def _short_plan(n_steps: int, seed: int):
    """A stream of exactly ``n_steps`` steps over the three banks: a TAKE
    first and, from 4 steps on, one just before the last step; row and slot
    ops between; the last step an OUT of the slot written last (one step: a
    VAGG_CARD; two: a LOAD_ROW and its OUT)."""
    rng = np.random.default_rng(seed)
    bank_rows = (8, 4, 4)
    banks = [rng.integers(0, 1 << 32, (r, 2048), dtype=np.uint64)
             .astype(np.uint32) for r in bank_rows]
    em = megakernel._Emitter()
    body = (megakernel.LOAD_ROW, megakernel.OR_ROW, megakernel.XOR_ROW,
            megakernel.AND_ROW, megakernel.ANDNOT_ROW, megakernel.VSCAN_HI,
            megakernel.OR_SLOT, megakernel.ACC_POP, megakernel.CARD,
            megakernel.VAGG_CARD)
    last = [1]

    def emit(opc):
        b = int(rng.integers(3))
        card = opc in (megakernel.CARD, megakernel.VAGG_CARD)
        dst = int(rng.integers(3, 8))
        em.emit(opc, dst=dst, src=int(rng.integers(8)),
                row=int(rng.integers(bank_rows[b])), bank=b,
                crow=int(rng.integers(4)) if card else None)
        if not card:
            last[0] = dst

    if n_steps == 1:
        emit(megakernel.VAGG_CARD)
    elif n_steps == 2:
        emit(megakernel.LOAD_ROW)
        em.emit(megakernel.OUT, src=last[0], orow=0)
    else:
        em.emit(megakernel.TAKE, dst=1, src=0, imm=1)
        for _ in range(n_steps - 2 - (n_steps >= 4)):
            emit(body[int(rng.integers(len(body)))])
        if n_steps >= 4:
            em.emit(megakernel.TAKE, dst=2, src=int(rng.integers(3, 8)),
                    imm=int(rng.integers(-(1 << 31), 1 << 31)))
        em.emit(megakernel.OUT, src=last[0], orow=0)
    host = em.finish(8, 4, 4)
    host["extra"] = banks[1]
    mega = megakernel.MegaPlan("full", len(em.ops), host["opc"].size, 8, 8,
                               4, 4, host, extra_rows=bank_rows[1])
    assert mega.n_steps == n_steps
    return mega, banks


D = megakernel.PREFETCH_DEPTH


@pytest.mark.parametrize("n_steps", [1, 2, D - 1, D, D + 1])
def test_b5_short_streams_match_plain(dev, n_steps):
    """Streams shorter than, as long as and just past the prefetch depth
    D, with TAKEs in the first and the last D steps."""
    mega, banks = _short_plan(n_steps, seed=n_steps)
    tb = [as_i32(b, dev) for b in banks]
    got = megakernel.raw_call(mega, *tb)
    torch.cuda.synchronize()
    assert kernels.B5.launches == 1
    _same(got, megakernel.raw_call_plain(mega, *tb))


def test_b5_long_stream_with_edge_takes(dev):
    """A 4,096-step random stream over all opcodes, with TAKEs put at its
    first step and just before its last."""
    mega, banks = megakernel.random_plan(
        13, n_steps=4096, slots_pad=256, out_pad=32, card_pad=64,
        bank_rows=(64, 8, 8))
    h = mega.host
    for i in (0, mega.n_steps - 2):
        h["opc"][i], h["dst"][i], h["src"][i] = megakernel.TAKE, 3, 5
        h["imm"][i], h["row"][i], h["bank"][i] = 1 << 20, 0, 0
        h["orow"][i], h["crow"][i] = mega.out_pad, mega.card_pad
    tb = [as_i32(b, dev) for b in banks]
    got = megakernel.raw_call(mega, *tb)
    torch.cuda.synchronize()
    _same(got, megakernel.raw_call_plain(mega, *tb))


def _value_set(dev):
    """A 2^20-row search-shard set with a BSI and a 40-bit range column."""
    from roaringbitmap_tpu_torch.analytics import BsiColumn, RangeColumn

    bms = synthetic_bitmaps(16, seed=9, universe=1 << 20, density=1 / 64)
    ds = DeviceBitmapSet(bms, layout="dense", device=dev)
    rng = np.random.default_rng(9)
    rows = 1 << 20
    ds.attach_column(BsiColumn("price", np.arange(rows, dtype=np.uint32),
                               rng.integers(0, 2**31 - 1, rows), device=dev))
    ds.attach_column(RangeColumn("ts", rng.integers(0, 1 << 40, rows),
                                 device=dev))
    return bms, ds


def test_value_batch_runs_in_one_b5_launch(dev):
    from roaringbitmap_tpu_torch.parallel import expr

    bms, ds = _value_set(dev)
    eng = BatchEngine(ds)
    pool = [expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.range_(
                "price", 1 << 28, 1 << 30)), form="bitmap"),
            expr.ExprQuery(expr.andnot(expr.cmp("ts", "ge", 1 << 39),
                                       expr.ref(2))),
            expr.ExprQuery(expr.sum_("price", found=expr.or_(3, 4))),
            expr.ExprQuery(expr.top_k("price", 100, found=expr.or_(5, 6)),
                           form="bitmap")]
    plan = eng.plan(pool)
    assert plan.mega.fits() and plan.mega.n_vscan and plan.mega.n_vagg
    kernels.reset_launches()
    got = eng.execute(pool)
    assert eng.last_timings["engine"] == "megakernel"
    assert kernels.B5.launches == 1
    want = eng.execute(pool, engine="torch")
    for g, w in zip(got, want):
        assert (g.cardinality, g.value, g.bitmap) == (w.cardinality, w.value,
                                                      w.bitmap)
    cols = ds.columns
    card, value, _ = expr.evaluate_host_agg(pool[2].expr, bms, cols)
    assert (got[2].cardinality, got[2].value) == (card, value)
    assert got[0].bitmap == expr.evaluate_host(pool[0].expr, bms, cols)


def test_device_bsi_matches_host_oracle(dev):
    from roaringbitmap_tpu_torch.bsi import (DeviceBSI, Operation,
                                             RoaringBitmapSliceIndex)

    rng = np.random.default_rng(4)
    ids = np.unique(rng.integers(0, 1 << 22, 300000)).astype(np.uint32)
    host = RoaringBitmapSliceIndex.from_pairs(
        ids, rng.integers(0, 2**31 - 1, ids.size))
    dbsi = DeviceBSI(host, device=dev)
    assert dbsi.compare(Operation.RANGE, 1 << 29, 1 << 30) == host.compare(
        Operation.RANGE, 1 << 29, 1 << 30)
    assert dbsi.sum() == host.sum()
    assert dbsi.top_k(500) == host.top_k(500)


def _lifted(bms):
    """32-bit bitmaps lifted into the high-32 buckets 0, 1, 2^31 and
    2^32 - 1 (bitmap i in bucket i % 4), reusing their containers."""
    from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap

    buckets = (0, 1, 2**31, 2**32 - 1)
    return [Roaring64Bitmap(
        (np.uint64(buckets[i % 4]) << np.uint64(16))
        | b.keys.astype(np.uint64), list(b.containers))
        for i, b in enumerate(bms)]


@pytest.mark.parametrize("op", ["or", "xor"])
def test_b2_on_u48_keys_matches_plain(dev, bitmaps, op):
    """The 64-bit dense set: B2 over u48 segments, bit-equal to its plain
    version and to the host fold, with the keys u64 on the host."""
    lifted = _lifted(bitmaps)
    ds = DeviceBitmapSet(lifted, layout="dense", device=dev)
    assert ds.keys.dtype == np.uint64 and int(ds.keys[-1]) >> 16 == 2**32 - 1
    args = (ds.words, ds.blk_seg, ds.keys.size, ds.block)
    got = kernels.segmented_reduce_blocked(op, *args)
    torch.cuda.synchronize()
    assert kernels.B2.launches == 1
    _same(got, kernels.segmented_reduce_blocked_plain(op, *args))
    want = aggregation._sequential_reduce(op, lifted)
    assert ds.aggregate(op) == want
    assert aggregation.or64(lifted) == aggregation._sequential_reduce(
        "or", lifted)


def test_classify_real_cuda_oom(dev):
    """A real allocation past the card's memory: torch raises its
    OutOfMemoryError, which the guard's taxonomy types as
    ResourceExhausted."""
    from roaringbitmap_tpu_torch.runtime import errors

    free, total = torch.cuda.mem_get_info(dev)
    with pytest.raises(torch.OutOfMemoryError) as info:
        torch.empty(2 * total, dtype=torch.uint8, device=dev)
    assert isinstance(errors.classify(info.value), errors.ResourceExhausted)
    torch.cuda.empty_cache()


def test_guard_never_demotes_on_the_card(dev, bitmaps):
    """On the card a lowering fault on the "cuda" rung re-raises typed: no
    demotion to the plain version, no landing on the host, no launch."""
    from roaringbitmap_tpu_torch.runtime import errors, faults, guard

    guard.reset_dispatch_stats()
    kernels.reset_launches()
    with faults.inject("lowering@cuda:1"):
        with pytest.raises(errors.EngineLoweringError):
            aggregation.or_(bitmaps, engine="cuda", device=dev)
    assert guard.dispatch_stats("aggregation") == {
        "retries": 0, "demotions": 0, "sequential": 0}
    assert kernels.B2.launches == 0


# ------------------------------------------------ the pooled engine

def _tenants(bitmaps, dev, n_t=4):
    """``bitmaps`` dealt into n_t tenants, the last one compact (B3 rebuilds
    it inside each pooled launch)."""
    per = len(bitmaps) // n_t
    return [DeviceBitmapSet(bitmaps[t * per:(t + 1) * per],
                            layout="compact" if t == n_t - 1 else "dense",
                            device=dev) for t in range(n_t)], per


def _pool_same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same_results(g, w)


def _bitmap_pool(per, n_t, q, seed):
    from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery
    from roaringbitmap_tpu_torch.parallel.multiset import (
        BatchGroup, random_multiset_pool)

    return [BatchGroup(g.set_id, [BatchQuery(x.op, x.operands, form="bitmap")
                                  for x in g.queries])
            for g in random_multiset_pool([per] * n_t, q, seed=seed)]


def test_pooled_launch_matches_plain(dev, bitmaps):
    """One pooled launch over four tenants: one B1 launch per op group and
    one B3 launch for the compact tenant; equal to the plain rung on the
    card, the per-set loop and the same pool on the CPU."""
    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine

    sets, per = _tenants(bitmaps, dev)
    ms = MultiSetBatchEngine(sets)
    pool = _bitmap_pool(per, len(sets), 32, 3)
    kernels.reset_launches()
    got = ms.execute(pool)
    plan = ms._plan_pool(ms._flatten(pool)[0])
    assert kernels.B1.launches == len(plan.op_groups)
    assert kernels.B3.launches == 1
    _pool_same(got, ms.execute(pool, engine="torch"))
    _pool_same(got, [ms._engines[g.set_id].execute(list(g.queries))
                     for g in pool])
    cpu_sets, _ = _tenants(bitmaps, "cpu")
    _pool_same(got, MultiSetBatchEngine(cpu_sets).execute(pool))


def test_traced_pooled_dispatch_has_device_time(dev, bitmaps, tmp_path):
    """One traced pooled dispatch on the card: its ``multiset.cost`` event
    carries CUDA-event device time (> 0), the pool's predicted bytes and a
    roofline fraction in (0, 1] against the H100 row; its memory event's
    measured peak is within the prediction; the dump validates."""
    import importlib.util
    import json
    import os

    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine

    sets, per = _tenants(bitmaps, dev)
    ms = MultiSetBatchEngine(sets)
    pool = _bitmap_pool(per, len(sets), 32, 3)
    ms.execute(pool)                     # warm: the first run is eager
    path = tmp_path / "pool.jsonl"
    obs.enable(str(path))
    try:
        ms.execute(pool)
    finally:
        obs.disable()
    spans = [json.loads(line) for line in open(path)]
    (d,) = [s for s in spans if s["name"] == "multiset.dispatch"]
    (cost,) = [e for e in d["events"] if e["name"] == "multiset.cost"]
    (mem,) = [e for e in d["events"] if e["name"] == "multiset.memory"]
    assert cost["device_ms"] > 0
    assert cost["bytes_accessed"] == ms.predict_dispatch_bytes(pool)
    assert 0.0 < cost["roofline_fraction"] <= 1.0
    assert 0 <= mem["measured_peak_bytes"] <= mem["predicted_bytes"]
    spec = importlib.util.spec_from_file_location(
        "check_trace", os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "tools", "check_trace.py"))
    ct = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ct)
    assert ct.validate(str(path)) == []


def test_pooled_expression_pool_is_one_b5_launch(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel.multiset import (BatchGroup,
                                                           MultiSetBatchEngine)

    sets, per = _tenants(bitmaps, dev)
    ms = MultiSetBatchEngine(sets)
    pool = [BatchGroup(t, random_expr_pool(per, 1, depth=2, seed=t,
                                           form="bitmap"))
            for t in range(len(sets))]
    kernels.reset_launches()
    got = ms.execute(pool)
    assert kernels.B5.launches == 1 and kernels.B1.launches == 0
    _pool_same(got, ms.execute(pool, engine="cuda"))


def test_pooled_pipeline_at_depth_2(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
    from roaringbitmap_tpu_torch.runtime import guard

    sets, per = _tenants(bitmaps, dev)
    ms = MultiSetBatchEngine(sets)
    pools = [_bitmap_pool(per, len(sets), 16, s) for s in range(10, 14)]
    want = [ms.execute(p) for p in pools]
    got = ms.execute_pipelined(pools,
                               policy=guard.GuardPolicy(pipeline_depth=2))
    for g, w in zip(got, want):
        _pool_same(g, w)
    st = ms.last_pipeline
    assert st["launches"] == len(pools) and st["depth"] == 2
    assert 0.0 < st["overlap_ratio"] <= 1.0


def test_pooled_proactive_split_within_the_model(dev, bitmaps):
    """Under a third of the pool's prediction the pool is halved before
    dispatch; every launch's prediction fits the budget and its measured
    peak fits its prediction."""
    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
    from roaringbitmap_tpu_torch.runtime import guard

    sets, per = _tenants(bitmaps, dev)
    ms = MultiSetBatchEngine(sets)
    pool = _bitmap_pool(per, len(sets), 32, 5)
    want = ms.execute(pool)
    pooled = ms._flatten(pool)[0]
    budget = ms.predict_dispatch_bytes(pooled) // 3
    got = ms.execute(pool, policy=guard.GuardPolicy(hbm_budget=budget))
    _pool_same(got, want)
    assert ms.proactive_split_count > 0
    for sub in ms._launch_iter(pooled, "cuda", budget):
        pred = ms.predict_dispatch_bytes(sub, "cuda")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms._launch_once(sub, "cuda")
        assert torch.cuda.max_memory_allocated() - base <= pred <= budget


# ------------------------------------------------------- mutable tenants

def test_patch_writes_only_its_rows_in_place(dev, bitmaps):
    """A delta patches the resident tensor in place: the same storage, the
    touched rows changed as the host masks say, every other row as it was;
    the result equals the host fold of the mutated sources."""
    ds = DeviceBitmapSet(bitmaps[:16], layout="dense", device=dev)
    words, ptr = ds.words, ds.words.data_ptr()
    before = ds.words.clone()
    srcs = [b.clone() for b in ds.host_bitmaps()]
    adds = {0: srcs[0].to_array()[:5] ^ np.uint32(1), 3: [7, 11]}
    removes = {5: srcs[5].to_array()[:40]}
    rep = ds.apply_delta(adds=adds, removes=removes)
    assert rep["mode"] == "patch"
    assert ds.words is words and ds.words.data_ptr() == ptr
    rows = ds._delta_journal[-1][1].astype(np.int64)
    assert rows.size == rep["rows_patched"]
    other = np.setdiff1d(np.arange(ds._n_rows), rows)
    idx = torch.from_numpy(other).to(dev)
    assert torch.equal(ds.words[idx], before[idx])
    _, _, add, rem = ds._delta_journal[-1]
    want = (to_u32(before[torch.from_numpy(rows).to(dev)]) | add) & ~rem
    assert np.array_equal(to_u32(ds.words[torch.from_numpy(rows).to(dev)]),
                          want)
    for src, vals in adds.items():
        srcs[src] = srcs[src] | RoaringBitmap.from_values(
            np.asarray(vals, np.uint32))
    for src, vals in removes.items():
        srcs[src] = srcs[src] - RoaringBitmap.from_values(vals)
    acc = srcs[0]
    for b in srcs[1:]:
        acc = acc | b
    assert ds.aggregate("or") == acc


def test_cache_entry_rows_live_on_the_card(dev, bitmaps):
    from roaringbitmap_tpu_torch.mutation import ResultCache
    from roaringbitmap_tpu_torch.parallel import expr

    tc = ResultCache(64 << 20)
    eng = BatchEngine(DeviceBitmapSet(bitmaps[:16], layout="dense",
                                      device=dev), result_cache=tc)
    eng.execute([expr.ExprQuery(expr.or_(0, 4), form="bitmap")])
    (entry,) = tc._data.values()
    assert entry.words.is_cuda and entry.words.dtype == torch.int32
    assert entry.words.shape == (entry.keys.size, 2048)


def test_injected_b5_plan_matches_torch(dev, bitmaps):
    """A plan with a cached subtree injected runs as one B5 launch on the
    card, equal to the same plan on the "torch" rung and to the host; the
    entry's rows are unchanged after it."""
    from roaringbitmap_tpu_torch.mutation import ResultCache
    from roaringbitmap_tpu_torch.parallel import expr

    tc = ResultCache(64 << 20)
    ds = DeviceBitmapSet(bitmaps[:16], layout="dense", device=dev)
    eng = BatchEngine(ds, result_cache=tc)
    eng.execute([expr.ExprQuery(expr.or_(0, 4), form="bitmap")])
    (entry,) = tc._data.values()
    saved = entry.words.clone()
    q = [expr.ExprQuery(expr.and_(expr.or_(0, 4), expr.not_(5)),
                        form="bitmap"),
         expr.ExprQuery(expr.xor(expr.or_(0, 4), expr.or_(6, 7)),
                        form="bitmap")]
    plan = eng.plan(q)
    assert all(s.n_cached >= 1 for s in plan.exprs)
    kernels.reset_launches()
    got = eng.execute(q, engine="megakernel", fallback=False)
    assert kernels.B5.launches == 1
    want = eng.execute(q, engine="torch", fallback=False)
    _same_results(got, want)
    hosts = ds.host_bitmaps()
    for qq, r in zip(q, got):
        assert r.bitmap == expr.evaluate_host(qq.expr, hosts)
    assert torch.equal(entry.words, saved)


# ------------------------------------------- the lattice: captured graphs

#: covers the pools below: 32 keys a bitmap at a 2^21 universe, at most 6
#: operands a flat query and 4 a reduce node
GRAPH_PROFILE = "q=16,;rows=256,;keys=32,;heads=both;expr=2;pool=64,"


@pytest.fixture
def lattice_off():
    from roaringbitmap_tpu_torch.runtime import lattice

    lattice.deactivate()
    obs.reset()
    yield lattice
    lattice.deactivate()


def _graph_pools(n):
    flat = [q for q in random_query_pool(n, 12, seed=4, max_operands=6)]
    exprs = random_expr_pool(n, 4, depth=2, seed=4, form="bitmap")
    return flat, exprs


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_replay_equals_the_eager_rung(dev, bitmaps, lattice_off, layout):
    """A warmed engine replays its graphs (B1 on "cuda", B5 on
    "megakernel", B3 inside both for a compact set), equal to the same
    batches with no lattice; the replays add the graphs' launches."""
    eng = BatchEngine(DeviceBitmapSet(bitmaps[:16], layout=layout,
                                      device=dev))
    flat, exprs = _graph_pools(16)
    want = {rung: eng.execute(flat + exprs, engine=rung, fallback=False)
            for rung in ("cuda", "megakernel")}
    # the mixed batch is its own expression signature: warmed as a
    # prepared batch (on "cuda" and "megakernel") before the seal
    lattice_off.activate(GRAPH_PROFILE)
    eng.warmup(queries=flat + exprs, engine="cuda")
    rep = eng.warmup(profile=GRAPH_PROFILE)
    assert rep["graphs"] >= 3 and rep["pool_bytes"] > 0
    captures = eng._programs.captures
    for rung in ("cuda", "megakernel"):
        kernels.reset_launches()
        got = eng.execute(flat + exprs, engine=rung, fallback=False)
        torch.cuda.synchronize()
        _same_results(got, want[rung])
        k = kernels.B1 if rung == "cuda" else kernels.B5
        assert k.launches >= 1, rung
        if layout == "compact":
            assert kernels.B3.launches >= 1
    assert eng._programs.captures == captures
    assert lattice_off.escape_total() == 0


def test_b5_replay_reads_its_step_count(dev, lattice_off):
    """Two plans of one stream shape with different step counts through one
    captured B5 launch: each equals its own plain version."""
    from roaringbitmap_tpu_torch.runtime import programs

    m1, banks = megakernel.random_plan(1, n_steps=300, slots_pad=32,
                                       out_pad=8, card_pad=16,
                                       bank_rows=(16, 8, 8))
    m2, _ = megakernel.random_plan(2, n_steps=420, slots_pad=32, out_pad=8,
                                   card_pad=16, bank_rows=(16, 8, 8))
    assert m1.steps_pad == m2.steps_pad and m1.n_steps != m2.n_steps
    banks = [as_i32(b, dev) for b in banks]
    cache = programs.ProgramCache(dev, "test")

    def run(ops):
        return megakernel.raw_call(m1, *banks, stream=ops["stream"],
                                   steps_dev=ops["steps"])

    for m in (m1, m2, m1):
        pack = programs.pack_operands(
            {"stream": m.stream_host(),
             "steps": np.array([m.n_steps], np.int32)}, dev)
        key = ("b5", pack.layout)
        cache.prepare(key, "megakernel", None, run, pack)  # capture: no run
        kernels.reset_launches()
        got = cache.dispatch(key, "megakernel", None, run, pack)
        torch.cuda.synchronize()
        assert kernels.B5.launches == 1
        _same(got, [t.cpu() for t in megakernel.raw_call_plain(m, *banks)])
    assert cache.captures == 1 and cache.replays == 3


def test_patch_then_replay_is_exact(dev, bitmaps, lattice_off):
    ds = DeviceBitmapSet(bitmaps[:16], layout="dense", device=dev)
    eng = BatchEngine(ds)
    flat, exprs = _graph_pools(16)
    lattice_off.activate(GRAPH_PROFILE)
    eng.warmup(queries=flat + exprs, engine="cuda")
    eng.warmup(profile=GRAPH_PROFILE)
    eng.execute(flat + exprs, engine="megakernel")
    captures = eng._programs.captures
    srcs = ds.host_bitmaps()
    rep = ds.apply_delta(adds={1: srcs[1].to_array()[:9] ^ np.uint32(3)},
                         removes={2: srcs[2].to_array()[:50]})
    assert rep["mode"] == "patch"
    want = eng._execute_sequential(flat + exprs)
    for rung in ("cuda", "megakernel"):
        got = eng.execute(flat + exprs, engine=rung)
        _same_results(got, want)
    assert eng._programs.captures == captures
    assert lattice_off.escape_total() == 0


def test_repack_retires_graphs(dev, bitmaps, lattice_off):
    ds = DeviceBitmapSet(bitmaps[:16], layout="dense", device=dev)
    eng = BatchEngine(ds)
    flat, _ = _graph_pools(16)
    eng.warmup(profile=GRAPH_PROFILE)
    eng.execute(flat)
    graphs, pool = eng._programs.graphs, eng._programs.pool_bytes()
    assert graphs >= 1 and pool > 0
    ds.apply_delta(adds={0: [1, 2, 3]}, repack="always")
    got = eng.execute(flat)
    assert eng._programs.retired == graphs
    assert eng._programs.generation == 1
    assert lattice_off.escape_total() == 1     # the re-capture, post-seal
    _same_results(got, eng._execute_sequential(flat))


def test_failed_capture_raises_typed(dev, bitmaps, lattice_off,
                                     monkeypatch):
    """A device part that cannot be captured (a read of a device value on
    the host inside it) raises GraphCaptureError; nothing runs it eagerly
    instead."""
    from roaringbitmap_tpu_torch.runtime import errors

    eng = BatchEngine(DeviceBitmapSet(bitmaps[:16], layout="dense",
                                      device=dev))
    words = eng._words

    def syncing(e):
        w = words(e)
        int(w[0, 0])
        return w

    monkeypatch.setattr(eng, "_words", syncing)
    lattice_off.activate(GRAPH_PROFILE)
    pool = random_query_pool(16, 4, seed=1, max_operands=6)
    assert eng.plan(pool).point is not None
    with pytest.raises(errors.GraphCaptureError):
        eng.execute(pool, engine="cuda", fallback=False)
    assert eng._programs.captures == 0
    torch.cuda.synchronize()


# ------------------------------------------------- the serving stack

def _serving_tenants(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine

    hosts = [bitmaps[0:12], bitmaps[12:24], bitmaps[24:36]]
    sets = [DeviceBitmapSet(b, layout="dense" if i < 2 else "compact",
                            device=dev) for i, b in enumerate(hosts)]
    return hosts, MultiSetBatchEngine(sets, result_cache=None)


def test_serving_loop_on_the_card(dev, bitmaps, lattice_off):
    """A mixed stream through ``ServingLoop`` (its pump on a
    ``PumpDriver`` thread) equals the host oracle and launches B5 and B3
    from the loop (its pools hold an expression: the megakernel rung),
    then a flat-only stream launches B1; no pump error is counted."""
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery
    from roaringbitmap_tpu_torch.serving import (ServingLoop, ServingPolicy,
                                                 ServingRequest)

    hosts, ms = _serving_tenants(dev, bitmaps)
    loop = ServingLoop(ms, ServingPolicy(pool_target=8,
                                         default_deadline_ms=600_000.0))
    assert loop.device.type == "cuda"
    rng = np.random.default_rng(3)
    reqs = []
    for i in range(24):
        sid = i % 3
        if i % 3 == 1:
            q = expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.not_(2)),
                               form="bitmap")
        else:
            ops = tuple(int(x) for x in rng.choice(12, 3, replace=False))
            q = BatchQuery(("or", "and", "xor")[i % 3], ops, form="bitmap")
        reqs.append(ServingRequest(sid, q, tenant=f"t{sid}"))
    flat = [ServingRequest(i % 3, BatchQuery("or", (i, i + 1, i + 2),
                                             form="bitmap"))
            for i in range(8)]
    obs.reset()
    launches = []
    drv = loop.start_pump(interval_s=0.002)
    try:
        tickets = []
        for stream in (reqs, flat):
            kernels.reset_launches()
            tickets += [loop.submit(r) for r in stream]
            loop.drain()
            torch.cuda.synchronize()
            launches.append((kernels.B1.launches, kernels.B3.launches,
                             kernels.B5.launches))
    finally:
        drv.stop()
    assert drv.errors == 0
    assert "rb_serving_pump_errors_total" not in obs.snapshot()["counters"]
    for t in tickets:
        assert t.ok, t.error
        ref = ms._engines[t.request.set_id]._sequential_result(t.query)
        assert t.result.bitmap == ref.bitmap
    (_b1, b3, b5), (b1, _, _) = launches
    assert b5 >= 1 and b3 >= 1 and b1 >= 1, launches


def test_resident_lane_and_recovery_on_the_card(dev, bitmaps, lattice_off,
                                                tmp_path):
    """The ring lane replays warmed graphs (the dispatch count flat) equal
    to the one-shot loop; a durable tenant crashed at ``pre_apply``
    recovers onto the card equal to its never-crashed twin."""
    from roaringbitmap_tpu_torch.mutation import durability
    from roaringbitmap_tpu_torch.parallel import expr
    from roaringbitmap_tpu_torch.runtime import errors, faults
    from roaringbitmap_tpu_torch.serving import (ServingLoop, ServingPolicy,
                                                 ServingRequest)

    hosts, ms = _serving_tenants(dev, bitmaps)
    q = [expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.not_(2))),
         expr.ExprQuery(expr.xor(expr.or_(3, 4), 5))]
    groups = [(s, [q[s % 2]]) for s in range(3)]
    want = ms.execute(groups, engine="megakernel")
    # every set's row selection (3 leaves x 32 keys) fits the pool rung;
    # the pool's DAGs are warmed under the lattice before its seal
    profile = "q=4,;rows=128,;keys=32,;heads=both;expr=2;pool=256,"
    lattice_off.activate(profile)
    ms.warmup(pools=[groups], engine="megakernel")
    ms.warmup(profile=profile)
    loop = ServingLoop(ms, ServingPolicy(
        pool_target=3, resident=True, engine="megakernel",
        default_deadline_ms=600_000.0))
    obs.reset()
    tickets = [loop.submit(ServingRequest(s, q[s % 2])) for s in range(3)]
    loop.drain()
    assert "rb_serving_dispatches_total" not in obs.snapshot()["counters"]
    assert loop._resident.stats["served"] == 1
    for t, w in zip(tickets, [r for rows in want for r in rows]):
        assert t.result.cardinality == w.cardinality
    lattice_off.deactivate()

    ds = DeviceBitmapSet(hosts[0], layout="dense", device=dev)
    twin = DeviceBitmapSet(hosts[0], layout="dense", device=dev)
    ten = durability.DurableTenant(ds, root=str(tmp_path), tenant="d",
                                   policy=durability.FlushPolicy("always"))
    adds = {1: np.array([5, 70000, 1 << 20], np.uint32)}
    ten.apply_delta(adds=adds)
    twin.apply_delta(adds=adds)
    nxt = {2: np.array([9, 99], np.uint32)}
    with faults.inject("crash@pre_apply=1.0:1"):
        with pytest.raises(errors.InjectedCrash):
            ten.apply_delta(adds=nxt)
    twin.apply_delta(adds=nxt)
    rec, rep = durability.recover_tenant(root=str(tmp_path), tenant="d")
    assert rec.ds.device.type == "cuda" and rep["replayed"] == 2
    assert torch.equal(rec.ds.words, twin.words)
    assert rec.ds.host_bitmaps() == twin.host_bitmaps()
    rec.close()


# ------------------------------------------------------------ mesh and pod

@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot"])
def test_b1_at_every_width_matches_plain(dev, bitmaps, op, width):
    pk = packing.pack_for_aggregation(bitmaps)
    w = as_i32(np.ascontiguousarray(pk.words[:, :width]), dev)
    s = as_i32(pk.seg_ids, dev)
    got = kernels.segmented_reduce(op, w, s, pk.num_keys)
    torch.cuda.synchronize()
    assert kernels.B1.launches == 1 and got[0].shape[1] == width
    _same(got, kernels.segmented_reduce_plain(op, w, s, pk.num_keys))


def test_sharded_wide_ops_on_the_card(dev, bitmaps):
    """The wide ops over meshes of logical shards on one card equal the
    single-device ops, with B1 launched at width 2048 / lanes."""
    from roaringbitmap_tpu_torch.parallel import sharding

    for rows, lanes in ((1, 1), (4, 1), (2, 2), (8, 1), (1, 8)):
        mesh = sharding.Mesh(np.array(["cuda"] * (rows * lanes)).reshape(
            rows, lanes), ("rows", "lanes"))
        for op, fn in (("or", aggregation.or_), ("xor", aggregation.xor),
                       ("and", aggregation.and_)):
            kernels.reset_launches()
            k, w, c = sharding.wide_aggregate_sharded(mesh, op, bitmaps,
                                                      fallback=False)
            # an AND whose key intersection is empty launches nothing
            assert kernels.B1.launches >= 1 or (op == "and" and not k.size)
            assert packing.unpack_result(k, w, c) == fn(bitmaps, device=dev)


def test_sharded_engine_on_the_card(dev, bitmaps, lattice_off):
    """The sharded engine over 4x1 / 2x2 meshes of one card equals the
    pooled engine; an expression pool is one B5 combine-mode launch; a
    sealed vocabulary replays captured graphs with zero escapes."""
    from roaringbitmap_tpu_torch.parallel import (BatchGroup, BatchQuery,
                                                  MultiSetBatchEngine,
                                                  ShardedBatchEngine, expr)
    from roaringbitmap_tpu_torch.parallel.sharding import Mesh
    from roaringbitmap_tpu_torch.runtime import lattice

    sets = [DeviceBitmapSet(bitmaps[i * 12:(i + 1) * 12], layout=lay,
                            device=dev)
            for i, lay in enumerate(("dense", "compact", "dense", "dense"))]
    pool = [BatchGroup(s, [BatchQuery(op, (0, 1, 2, 3), form="bitmap")
                           for op in ("or", "and", "xor", "andnot")]
                       + [expr.ExprQuery(expr.and_(expr.or_(0, 1),
                                                   expr.not_(2)))])
            for s in range(4)]
    want = MultiSetBatchEngine(sets).execute(pool, engine="cuda")
    for shape, placement in (((4, 1), "sharded"), ((2, 2), "replicated")):
        eng = ShardedBatchEngine(sets, mesh=Mesh(np.array(
            ["cuda"] * 4).reshape(shape), ("rows", "data")),
            placement=placement)
        kernels.reset_launches()
        got = eng.execute(pool)
        assert kernels.B5.launches == 1 and kernels.B1.launches >= 4
        for a, b in zip(got, want):
            assert [r.cardinality for r in a] == [r.cardinality for r in b]
            assert [r.bitmap for r in a[:4]] == [r.bitmap for r in b[:4]]
    eng.warmup(profile=GRAPH_PROFILE, pools=[pool])
    assert eng._programs.graphs >= 1
    got = eng.execute(pool)
    assert lattice.escape_total() == 0
    for a, b in zip(got, want):
        assert [r.cardinality for r in a] == [r.cardinality for r in b]


def test_sharded_sections_past_capacity_split_on_the_card(dev, bitmaps,
                                                          monkeypatch):
    """Fused sections past B5's step cap run as several combine-mode
    launches, one a stream, each under the cap; equal to the pooled
    engine, nothing demoted."""
    from roaringbitmap_tpu_torch.ops import megakernel
    from roaringbitmap_tpu_torch.parallel import (BatchGroup,
                                                  MultiSetBatchEngine,
                                                  ShardedBatchEngine, expr)
    from roaringbitmap_tpu_torch.parallel.sharding import Mesh
    from roaringbitmap_tpu_torch.runtime import guard

    sets = [DeviceBitmapSet(bitmaps[i * 12:(i + 1) * 12], layout="dense",
                            device=dev) for i in range(4)]
    pool = [BatchGroup(s, expr.random_expr_pool(12, 6, depth=2, seed=s))
            for s in range(4)]
    want = MultiSetBatchEngine(sets).execute(pool, engine="cuda")
    eng = ShardedBatchEngine(sets, mesh=Mesh(np.array(["cuda"] * 4).reshape(
        4, 1), ("rows", "data")), placement="sharded")
    pooled = tuple(eng._single._flatten(pool)[0])
    cap = max(eng._plan(pooled).megas[0].steps_pad // 2, 1)
    monkeypatch.setattr(megakernel, "MAX_STEPS", cap)
    eng._plans.clear()
    plan = eng._plan(pooled)
    assert plan.megas is not None and len(plan.megas) >= 2
    guard.reset_dispatch_stats()
    kernels.reset_launches()
    got = eng.execute(pool)
    assert kernels.B5.launches == len(plan.megas)
    assert kernels.B5.variants == {"combine": len(plan.megas)}
    assert guard.dispatch_stats("sharded_engine")["demotions"] == 0
    for a, b in zip(got, want):
        assert [r.cardinality for r in a] == [r.cardinality for r in b]


# ------------------------------------- engine leftovers on the card (17a-f)

def test_flagship_runs_b1_on_the_card(dev):
    from roaringbitmap_tpu_torch.models import flagship

    args = flagship.example_inputs(32, seed=2)        # device=None: the card
    assert args[0].device.type == "cuda"
    words, cards = flagship.forward(*args)
    torch.cuda.synchronize()
    assert kernels.B1.launches == 1
    cpu = flagship.forward(*flagship.example_inputs(32, seed=2,
                                                    device="cpu"))
    assert torch.equal(words.cpu(), cpu[0]) and torch.equal(cards.cpu(),
                                                            cpu[1])


def test_evaluate_is_one_b5_launch(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel import expr

    ds = DeviceBitmapSet(bitmaps, layout="dense")
    pool = random_expr_pool(len(bitmaps), 4, depth=2, seed=3, form="bitmap")
    want = BatchEngine(ds).execute(pool, engine="torch")
    kernels.reset_launches()
    for q, w in zip(pool, want):
        assert ds.evaluate(q) == w.bitmap
        assert ds.evaluate(q, form="cardinality") == w.cardinality
    torch.cuda.synchronize()
    assert kernels.B5.launches == 2 * len(pool) and kernels.B1.launches == 0
    hits = ds._expr_engine._plans.stats()["hits"]
    ds.evaluate(pool[0])
    assert ds._expr_engine._plans.stats()["hits"] == hits + 1
    assert ds.evaluate(expr.or_(0, 1)) == (bitmaps[0] | bitmaps[1]).cardinality


def test_chained_cardinality_on_the_card(dev, bitmaps):
    eng = BatchEngine(DeviceBitmapSet(bitmaps, layout="dense"))
    pool = random_query_pool(len(bitmaps), 16, seed=4)
    total = sum(r.cardinality for r in eng.execute(pool))
    plan = eng.plan(pool)
    kernels.reset_launches()
    got = eng.chained_cardinality(pool, 8)()
    assert got.device.type == "cuda" and int(got) == (8 * total) % (1 << 32)
    assert kernels.B1.launches == 8 * len(plan)


def test_torch_vmap_rung_on_the_card(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel import multiset
    from roaringbitmap_tpu_torch.runtime import guard

    eng = BatchEngine(DeviceBitmapSet(bitmaps, layout="dense"))
    pool = random_query_pool(len(bitmaps), 16, seed=6)
    pool = [type(q)(q.op, q.operands, form="bitmap") for q in pool]
    guard.reset_dispatch_stats()
    want = eng.execute(pool)
    assert eng.last_timings["engine"] == "cuda"
    got = eng.execute(pool, engine="torch-vmap")
    assert eng.last_timings["engine"] == "torch-vmap"
    for g, w in zip(got, want):
        assert g.cardinality == w.cardinality and g.bitmap == w.bitmap
    ms = multiset.MultiSetBatchEngine.from_bitmap_sets(
        [bitmaps[:24], bitmaps[24:]], layout="dense")
    mp = multiset.random_multiset_pool([24, 24], 16, seed=7)
    a, b = ms.execute(mp, engine="torch-vmap"), ms.execute(mp)
    assert [[r.cardinality for r in g] for g in a] == \
        [[r.cardinality for r in g] for g in b]
    assert guard.dispatch_stats("batch_engine")["demotions"] == 0
    from roaringbitmap_tpu_torch.parallel.batch_engine import ENGINES

    assert guard.chain_from("megakernel", ENGINES, dev) == \
        ("megakernel", "cuda")


def test_node_at_a_time_on_the_card(dev, bitmaps):
    from roaringbitmap_tpu_torch.parallel import expr

    eng = BatchEngine(DeviceBitmapSet(bitmaps, layout="dense"))
    pool = random_expr_pool(len(bitmaps), 8, depth=2, seed=9, form="bitmap")
    fused = eng.execute(pool)
    kernels.reset_launches()
    got = expr.execute_node_at_a_time(eng, pool)
    torch.cuda.synchronize()
    assert kernels.B1.launches > 0 and kernels.B5.launches == 0
    for g, w in zip(got, fused):
        assert g.cardinality == w.cardinality and g.bitmap == w.bitmap


def test_warmed_delta_rung_replays_a_graph(dev, bitmaps):
    vals = [b.to_array() for b in bitmaps[:8]]
    warm = DeviceBitmapSet([RoaringBitmap.from_values(v) for v in vals],
                           layout="dense")
    eager = DeviceBitmapSet([RoaringBitmap.from_values(v) for v in vals],
                            layout="dense")
    rep = warm.warmup_delta(8)
    assert rep["compiled"] is True
    progs = list(warm._delta_programs.values())
    assert progs and all(p.graph is not None for p in progs)
    rng = np.random.default_rng(1)
    for _ in range(6):
        adds = {int(s): vals[s][rng.integers(0, vals[s].size, 30)] ^ 1
                for s in rng.choice(8, 3, replace=False)}
        removes = {int(s): vals[s][rng.integers(0, vals[s].size, 30)]
                   for s in rng.choice(8, 2, replace=False)}
        ra = warm.apply_delta(adds=adds, removes=removes, repack="never")
        rb = eager.apply_delta(adds=adds, removes=removes, repack="never")
        assert ra["mode"] == rb["mode"] == "patch"
        assert torch.equal(warm.words, eager.words)
    assert [b.serialize() for b in warm.host_bitmaps()] == \
        [b.serialize() for b in eager.host_bitmaps()]
    warm.apply_delta(adds={0: [(200 << 16) + 1]})        # structural: repack
    assert warm._delta_programs == {} and warm._delta_pool is None
    eager.apply_delta(adds={0: [(200 << 16) + 1]})
    warm.apply_delta(adds={1: [5]})
    eager.apply_delta(adds={1: [5]})
    assert torch.equal(warm.words, eager.words)


def test_wide_ops_over_immutables_on_the_card(dev, bitmaps):
    """chip_smoke 18a at a small size: the wide ops over
    ``ImmutableRoaringBitmap``s launch the kernels and equal the heap
    sources' results."""
    from roaringbitmap_tpu_torch.buffer import ImmutableRoaringBitmap

    ims = [ImmutableRoaringBitmap(memoryview(b.serialize())) for b in bitmaps]
    for fn in (aggregation.or_, aggregation.xor, aggregation.and_):
        assert fn(ims) == fn(bitmaps)
    kernels.reset_launches()
    assert aggregation.or_cardinality(ims) == \
        aggregation.or_(bitmaps).cardinality
    torch.cuda.synchronize()
    assert kernels.B1.launches == 1 and kernels.B2.launches == 1
    for layout in ("dense", "compact", "counts"):
        a = DeviceBitmapSet(ims, layout=layout)
        b = DeviceBitmapSet(bitmaps, layout=layout)
        for op in ("or", "xor"):
            assert a.aggregate(op) == b.aggregate(op)


def test_mapped_value_columns_on_the_card(dev, bitmaps):
    """chip_smoke 18d at a small size: a ``BsiColumn`` over an
    ``ImmutableBitSliceIndex`` and a ``RangeColumn`` over a mapped
    ``RangeBitmap`` give a value batch the heap columns' answers, in one B5
    launch."""
    from roaringbitmap_tpu_torch.analytics import BsiColumn, RangeColumn
    from roaringbitmap_tpu_torch.bsi import ImmutableBitSliceIndex
    from roaringbitmap_tpu_torch.core.rangebitmap import RangeBitmap
    from roaringbitmap_tpu_torch.parallel import expr

    rng = np.random.default_rng(18)
    ids = np.unique(rng.integers(0, 1 << 21, 20_000)).astype(np.uint32)
    price = BsiColumn("price", ids, rng.integers(0, 1 << 30, ids.size))
    ts = RangeColumn("ts", rng.integers(0, 1 << 40, 1 << 17))
    iprice = BsiColumn.from_bsi("price", ImmutableBitSliceIndex(
        price.host.serialize_buffer()))
    its = RangeColumn.from_range_bitmap("ts", RangeBitmap.map(
        ts.host.serialize()))
    pool = [expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.range_(
                "price", 1 << 20, 1 << 29)), form="bitmap"),
            expr.ExprQuery(expr.andnot(expr.cmp("ts", "lt", 1 << 38),
                                       expr.ref(2))),
            expr.ExprQuery(expr.sum_("price", found=expr.or_(3, 4))),
            expr.ExprQuery(expr.top_k("ts", 50, found=expr.or_(5, 6)),
                           form="bitmap")]
    out = []
    for cols in ((price, ts), (iprice, its)):
        ds = DeviceBitmapSet(bitmaps, layout="dense")
        for c in cols:
            ds.attach_column(c)
        eng = BatchEngine(ds)
        kernels.reset_launches()
        out.append(eng.execute(pool))
        torch.cuda.synchronize()
        assert eng.last_timings["engine"] == "megakernel"
        assert kernels.B5.launches == 1
    for g, w in zip(*out):
        assert (g.cardinality, g.value, g.bitmap) == \
            (w.cardinality, w.value, w.bitmap)


# ------------------------------------------- B1's split segments (chunks)

def _split_case(case: str, width: int, dev):
    """Rows int32[M, width] (random bits, seeded), sorted ids and K, at
    shapes that make B1 split segments over chunks."""
    if case == "k1_10000":          # one segment of 10,000 rows
        lengths = [10_000]
    elif case == "mixed":           # 1-row and 2,000-row segments in turn
        lengths = [1, 2000, 1, 1, 2000, 1, 2000, 2000, 1]
    elif case == "empties":         # most segments empty, some long
        lengths = [0] * 300 + [700] + [0] * 500 + [3, 1500] + [0] * 200
    elif case == "andnot_head":     # long segments whose head rows are
        # alone at a chunk's end at the forced chunk sizes
        lengths = [7, 900, 63, 1200, 255, 3000, 1]
    else:
        raise ValueError(case)
    k = len(lengths)
    ids = np.concatenate([np.repeat(np.arange(k, dtype=np.int32), lengths),
                          np.full(37, k, np.int32)])
    gen = torch.Generator(device=dev).manual_seed(15)
    rows = torch.randint(-(1 << 31), 1 << 31, (ids.size, width),
                         dtype=torch.int32, device=dev, generator=gen)
    return rows, as_i32(ids, dev), k


SPLIT_CASES = ("k1_10000", "mixed", "empties", "andnot_head")


@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_b1_splits_match_plain(dev, case, width):
    """B1 at shapes that split segments, through the wrapper at the
    launch's own chunk rows and at forced ones (every piece a row, and sizes
    that leave a head row alone in its chunk), all four ops: equal to the
    plain version, one launch a call."""
    w, s, k = _split_case(case, width, dev)
    for op in ("or", "and", "xor", "andnot"):
        want = kernels.segmented_reduce_plain(op, w, s, k)
        for chunk in (None, 1, 8, 64, 256):
            kernels.reset_launches()
            got = (kernels.segmented_reduce(op, w, s, k) if chunk is None
                   else kernels._launch_chunked(kernels.B1, op, w, s, k,
                                                chunk))
            torch.cuda.synchronize()
            assert kernels.B1.launches == 1
            _same(got, want)


@pytest.mark.parametrize("case", SPLIT_CASES)
def test_b2_splits_match_plain(dev, case):
    """B2 (one id per block of rows, the chunked kernel) at shapes that
    split segments, at its own chunk rows and at forced ones that cut a
    block: equal to its plain version, one B2 launch a call."""
    block = 4
    w, s, k = _split_case(case, 2048, dev)
    nb = w.shape[0] // block
    w, blk = w[:nb * block], s[:nb * block:block].contiguous()
    for op in ("or", "xor"):
        want = kernels.segmented_reduce_blocked_plain(op, w, blk, k, block)
        for chunk in (None, 3, 64):
            kernels.reset_launches()
            got = (kernels.segmented_reduce_blocked(op, w, blk, k, block)
                   if chunk is None else kernels._launch_chunked(
                       kernels.B2, op, w, blk, k, chunk, scale=block))
            torch.cuda.synchronize()
            assert kernels.B2.launches == 1 and kernels.B1.launches == 0
            _same(got, want)


def test_b1_counters_come_back_to_zero(dev):
    """The launch zeroes its counters, and every split segment's counter is
    back at 0 when the launch ends: garbage in the workspace's counters
    before a launch is 0 after it."""
    w, s, k = _split_case("mixed", 2048, dev)
    m, width = w.shape
    chunk = 8
    n = kernels.b1_num_chunks(m, chunk)
    heads = torch.empty((k, width), dtype=torch.int32, device=dev)
    cards = torch.empty(k, dtype=torch.int32, device=dev)
    work = torch.full((kernels.b1_work_words(m, width, k, chunk),), 12345,
                      dtype=torch.int32, device=dev)
    kernels.B1.launch(w.data_ptr(), s.data_ptr(), heads.data_ptr(),
                      cards.data_ptr(), work.data_ptr(), m, k, 0, width,
                      chunk, 1, torch.cuda.current_stream().cuda_stream,
                      nbytes=kernels.b1_launch_bytes(m, width, k))
    torch.cuda.synchronize()
    counters = work[2 * n * width:2 * n * width + k]
    assert not counters.any()
    _same((heads, cards), kernels.segmented_reduce_plain("or", w, s, k))


@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_b1_splits_replay_in_a_graph(dev, case, width):
    """B1 captured in a CUDA graph with split segments replays twice to the
    same bits (the captured launch zeroes its counters again each replay)."""
    w, s, k = _split_case(case, width, dev)
    want = {op: kernels.segmented_reduce_plain(op, w, s, k)
            for op in ("or", "andnot")}
    for op in want:
        kernels._launch_chunked(kernels.B1, op, w, s, k, 64)   # loads it
    torch.cuda.synchronize()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    kernels.reset_launches()
    with torch.cuda.stream(side):
        graph.capture_begin()
        outs = {op: kernels._launch_chunked(kernels.B1, op, w, s, k, 64)
                for op in want}
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    assert kernels.B1.launches == 2
    for _ in range(2):
        for got in outs.values():
            for t in got:
                t.fill_(-1)
        graph.replay()
        torch.cuda.synchronize()
        for op, got in outs.items():
            _same(got, want[op])


@pytest.fixture(scope="module")
def uscensus():
    """Eight uscensus2000-shaped segments (4,800 keys, ~45K values)."""
    return [RoaringBitmap.from_values(v) for v in uscensus_like_values(8)]


def _heavy_key_bitmaps():
    """One key holding a 4,096-value array container in each of 120
    bitmaps and a bitmap container in 40 more (~3.6 MB to read, cut into
    pieces), beside 200 light keys."""
    rng = np.random.default_rng(17)
    out = []
    for i in range(160):
        n = 4096 if i < 120 else 9000
        vals = [(7 << 16) + rng.choice(1 << 16, n, replace=False)]
        vals += [(k << 16) + rng.choice(1 << 16, 3, replace=False)
                 for k in rng.choice(np.arange(8, 208), 5, replace=False)]
        out.append(RoaringBitmap.from_values(
            np.unique(np.concatenate(vals)).astype(np.uint32)))
    return out


@pytest.mark.parametrize("shape", ["uscensus", "heavy_key"])
@pytest.mark.parametrize("op", ["or", "xor"])
def test_b7_matches_b4_and_plain(dev, uscensus, op, shape):
    bms = uscensus if shape == "uscensus" else _heavy_key_bitmaps()
    ds = DeviceBitmapSet(bms, layout="counts", device=dev)
    assert ds.reduce_path == "streams"
    if shape == "heavy_key":
        assert ds._stream_plan.n_split == 1
    k = ds.keys.size
    kernels.reset_launches()
    got = ds.aggregate_device(op)
    torch.cuda.synchronize()
    assert kernels.B7.launches == 1 and kernels.B4.launches == 0
    _same(got, kernels.counts_segmented_reduce(op, ds.counts,
                                               ds._grp_seg_counts, k))
    _same(got, kernels.stream_segmented_reduce_plain(op, *ds._streams,
                                                     ds.seg_ids, k))
    # every key cut into pieces of a few values: the last-arriver fold
    s = ds._streams
    plan = kernels.stream_reduce_plan(
        *(t.cpu().numpy() for t in (s[3], s[4], s[1])), ds.row_seg, k,
        piece_bytes=16).to(dev)
    assert plan.n_split > k // 2
    _same(got, kernels.stream_segmented_reduce(op, *s, ds.seg_ids, plan, k))
    assert kernels.B7.launches == 2


def test_b7_launch_records_its_bytes(dev, uscensus, tmp_path):
    import json

    ds = DeviceBitmapSet(uscensus, device=dev)
    assert ds.layout == "counts" and ds.reduce_path == "streams"
    obs.enable(str(tmp_path / "t.jsonl"))
    ds.aggregate_device("or")
    obs.disable()
    spans = [json.loads(line) for line in open(tmp_path / "t.jsonl")]
    (agg,) = [s for s in spans if s["name"] == "set.aggregate"]
    assert agg["tags"]["path"] == "streams"
    (ev,) = [e for e in agg["events"] if e["name"] == "kernel.launch"]
    plan = ds._stream_plan
    assert ev["kernel"] == "B7"
    assert ev["bytes"] == kernels.b7_launch_bytes(plan.values,
                                                  plan.dense_rows,
                                                  ds.keys.size)


def _row_streams(c: dict, device):
    """``row_stream_case``'s streams as int32 tensors on ``device``: the
    five compact streams and the run triple."""
    streams = tuple(as_i32(c[k].astype(np.int32) if k == "values" else c[k],
                           device)
                    for k in ("dense_words", "dense_dest", "values",
                              "val_counts", "val_dest"))
    runs = (as_i32(c["runs"].view(np.uint32), device),
            as_i32(c["run_counts"], device), as_i32(c["run_dest"], device))
    return streams, runs


@pytest.mark.parametrize("case", ROW_CASES)
def test_b8_matches_plain(dev, case):
    c = row_stream_case(case, seed=11)
    n = c["n_rows"]
    streams, runs = _row_streams(c, dev)
    got = kernels.row_build(*streams, n, int(c["values"].size), runs=runs)
    torch.cuda.synchronize()
    assert kernels.B8.launches == 1
    want = dense.densify_streams_impl(*streams, n, int(c["values"].size),
                                      runs=runs)
    assert torch.equal(got, want)
    cpu_streams, cpu_runs = _row_streams(c, "cpu")
    assert torch.equal(got.cpu(), plain_rows.build_rows(*cpu_streams, n,
                                                        runs=cpu_runs))


def _srt_segment_sources():
    """One census1881_srt_like segment (200 bitmaps, ~2,700 containers,
    ~1,400 of them runs), from the benchmark's generator."""
    import json
    from pathlib import Path

    from cardbench import gen

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "cardbench" / "configs" /
                      "census1881_srt_like.json").read_text())
    cfg["segments"] = 1
    return gen.dataset_bytes(cfg, 2**31 + 5)


def test_b8_builds_a_full_srt_segment(dev):
    sources = _srt_segment_sources()
    p = packing.pack_blocked_compact(sources, runs=True)
    s = p.streams
    assert s.kinds["run"] > 1000 and s.dense_words.shape[0] == 0
    c = {"dense_words": s.dense_words, "dense_dest": s.dense_dest,
         "values": s.values, "val_counts": s.val_counts,
         "val_dest": s.val_dest, "runs": s.runs, "run_counts": s.run_counts,
         "run_dest": s.run_dest}
    streams, runs = _row_streams(c, dev)
    got = kernels.row_build(*streams, p.n_rows, s.total_values, runs=runs)
    want = dense.densify_streams_impl(*streams, p.n_rows, s.total_values,
                                      runs=runs)
    assert torch.equal(got, want)
    ds = DeviceBitmapSet(sources, device=dev)
    assert ds.layout == "dense"
    host = DeviceBitmapSet(sources, layout="dense", device="cpu")
    for op in ("or", "xor"):
        _same(ds.aggregate_device(op), tuple(
            t.to(dev) for t in host.aggregate_device(op)))


def test_dense_build_times_b8_once(dev):
    obs.reset()
    kernels.reset_launches()
    ds = DeviceBitmapSet(_srt_segment_sources(), layout="dense", device=dev)
    # the streams stay for the or/xor (B7's run variant); B8's plan goes
    assert kernels.B8.launches == 1 and ds._row_plan is None
    assert ds.reduce_path == "streams" and ds._streams is not None
    (row,) = [r for r in obs.snapshot()["histograms"]["rb_kernel_seconds"]
              if r["labels"] == {"kernel": "b8"}]
    assert row["count"] == 1 and row["sum"] > 0


def _dense_cell_sources(name: str, segments: int = 3):
    """``segments`` segments of a benchmark configuration of the dense
    layout, from the benchmark's generator."""
    import json
    from pathlib import Path

    from cardbench import gen

    root = Path(__file__).resolve().parents[1]
    cfg = json.loads((root / "cardbench" / "configs" /
                      f"{name}.json").read_text())
    cfg["segments"] = segments
    return cfg, gen.dataset_bytes(cfg, 2**31 + 11)


@pytest.mark.parametrize("name", ["census1881_srt_like", "census1881_like"])
@pytest.mark.parametrize("op", ["or", "xor"])
def test_b7_runs_matches_b2(dev, name, op):
    """B7's run variant, as the dense set runs it (one launch), and with
    every key cut into pieces of a few entries (value, run and dense
    pieces folded by the last to finish), bit-equal to the plain reduce
    over the set's image, to B7's plain version over the streams and to B2
    over the image."""
    cfg, sources = _dense_cell_sources(name)
    ds = DeviceBitmapSet(sources, layout=cfg["layout"], device=dev)
    assert ds.layout == "dense" and ds.reduce_path == "streams"
    k = ds.keys.size
    kernels.reset_launches()
    got = ds.aggregate_device(op)
    torch.cuda.synchronize()
    assert kernels.B7.launches == 1 and kernels.B2.launches == 0
    want = kernels.segmented_reduce_plain(op, ds.words, ds.seg_ids, k)
    _same(got, want)
    s, r = ds._streams, ds._runs
    _same(kernels.stream_segmented_reduce_plain(op, *s, ds.seg_ids, k,
                                                runs=r), want)
    _same(kernels.segmented_reduce_blocked(op, ds.words, ds.blk_seg, k,
                                           ds.block), want)
    plan = kernels.stream_reduce_plan(
        *(t.cpu().numpy() for t in (s[3], s[4], s[1])), ds.row_seg, k,
        piece_bytes=64,
        run_counts=(r[1].cpu().numpy() if r is not None
                    else np.zeros(0, np.int32)),
        run_dest=(r[2].cpu().numpy() if r is not None
                  else np.zeros(0, np.int32))).to(dev)
    assert plan.n_split > k // 2
    _same(kernels.stream_segmented_reduce(op, *s, ds.seg_ids, plan, k,
                                          runs=r), want)
    if name == "census1881_srt_like":
        assert plan.runs > 0 and bool((plan.pieces[:, 9]
                                       > plan.pieces[:, 8]).any())


def test_b7_runs_after_a_patch_reads_the_image(dev, bitmaps):
    """A patch drops a dense set's streams: the or/xor then launches B2
    over the patched image, bit-equal to the set rebuilt from its host
    copies."""
    ds = DeviceBitmapSet(bitmaps, layout="dense", device=dev)
    assert ds.reduce_path == "streams"
    src = ds.host_bitmaps()[0]
    key = int(src.keys[0])
    ds.apply_delta(adds={0: [(key << 16) + 3, (key << 16) + 65535]},
                   repack="never")
    assert ds.reduce_path == "image"
    kernels.reset_launches()
    got = ds.aggregate_device("xor")
    torch.cuda.synchronize()
    assert kernels.B2.launches == 1 and kernels.B7.launches == 0
    fresh = DeviceBitmapSet(ds.host_bitmaps(), layout="dense", device=dev)
    assert fresh.reduce_path == "streams"
    _same(got, fresh.aggregate_device("xor"))
