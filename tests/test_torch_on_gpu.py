"""CUDA kernels of the port against their plain PyTorch versions, on the card.

Marked ``cuda``; each test skips (with the reason) where no CUDA device is
present, as on a CPU-only host.  The file imports neither jax nor the JAX
package, so on a GPU host without JAX it runs outside the JAX test harness:

    python -m pytest --noconftest tests/test_torch_on_gpu.py -q
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap, aggregation
from roaringbitmap_tpu_torch.ops import dense, kernels, megakernel, packing
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           random_query_pool)
from roaringbitmap_tpu_torch.parallel.expr import random_expr_pool
from roaringbitmap_tpu_torch.utils.datasets import synthetic_bitmaps

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
