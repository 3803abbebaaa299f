"""B6 (the fused nibble reduce) and the compact layout's "cuda-nibble" engine
against the JAX package.

B6's wrapper (which takes the plain version for CPU tensors) and its plain
version against ``roaringbitmap_tpu.ops.kernels.fused_nibble_reduce`` run in
Pallas interpret mode, ``dense_partial_impl`` against JAX's, and a compact
set with bitmap containers (so the dense-wire partial is not zero) through
``aggregate(op, engine="cuda-nibble")`` against the JAX set's
"pallas-nibble" and ``fast_aggregation``.  All bit-exact (tolerance 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import dense as jdense
from roaringbitmap_tpu.ops import kernels as jkernels
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import fast_aggregation as jfast
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import dense, kernels
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg

torch.set_num_threads(2)

CPU = "cpu"


def _state(js) -> dict:
    """A JAX compact set's packed arrays, as NumPy arrays (no carry_row:
    the port must default it)."""
    p = js._packed
    st = {"keys": js.keys, "n": js.n, "block": js.block, "blk_seg": p.blk_seg,
          "n_blocks": p.n_blocks, "seg_sizes": p.seg_sizes,
          "seg_offsets": p.seg_offsets}
    for name, a in zip(("dense_words", "dense_dest", "values", "val_counts",
                        "val_dest"), js._streams):
        st[name] = np.asarray(a)
    st["chunk_vals"], st["chunk_row"] = (np.asarray(a) for a in js._chunks)
    return st


def _t(a):
    return as_i32(np.asarray(a), CPU)


def _eq(got, want):
    for g, w in zip(got, want):
        g = to_u32(g) if g.dtype == torch.int32 else g.numpy()
        assert np.array_equal(g, np.asarray(w).astype(g.dtype))


def _counts(seed: int, g: int) -> np.ndarray:
    """u32[g, 4*2048] nibble counts, mostly zero, some nibbles at 8 (so the
    int32 views of whole words go negative)."""
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 9, (g, 4, 2048, 8)).astype(np.uint64)
    nib[rng.random((g, 4, 2048, 8)) < 0.7] = 0
    nib[0, :, :2] = 8
    return (nib << (4 * np.arange(8, dtype=np.uint64))).sum(
        axis=-1).astype(np.uint32).reshape(g, 4 * 2048)


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors take the plain versions: no kernel is launched or counted
    assert all(k.launches == 0 for k in kernels.KERNELS)


# 5 segments of 2, 1, 3, 1, 2 groups, then the scratch group (id K = 5)
_GRP_SEG = np.array([0, 0, 1, 2, 2, 2, 3, 4, 4, 5], np.int32)
_K = 5


def _partial(seed: int) -> np.ndarray:
    """u32[K + 1, 2048] partials: segments 1 and 3 have no dense rows (zero
    rows), the scratch row is garbage that must never be read."""
    rng = np.random.default_rng(seed)
    dp = rng.integers(0, 1 << 32, (_K + 1, 2048), dtype=np.uint64).astype(
        np.uint32)
    dp[[1, 3]] = 0
    dp[:, 0] = 0x80000000
    return dp


@pytest.mark.parametrize("op", ["or", "xor"])
def test_b6_matches_jax(op):
    counts = _counts(3, _GRP_SEG.size)
    dp = _partial(4)
    want = jkernels.fused_nibble_reduce(op, jnp.asarray(counts),
                                        jnp.asarray(dp),
                                        jnp.asarray(_GRP_SEG), _K)
    args = (_t(counts), _t(dp), _t(_GRP_SEG), _K)
    _eq(kernels.fused_nibble_reduce_plain(op, *args), want)
    _eq(kernels.fused_nibble_reduce(op, *args), want)


@pytest.mark.parametrize("op", ["and", "andnot"])
def test_b6_refuses_and_andnot(op):
    args = (_t(_counts(0, 2)), _t(np.zeros((2, 2048), np.uint32)),
            _t(np.array([0, 1], np.int32)), 1)
    with pytest.raises(ValueError, match="or/xor"):
        kernels.fused_nibble_reduce(op, *args)


def test_b6_wrapper_checks():
    counts = _t(_counts(0, 3))
    seg = _t(np.array([0, 0, 1], np.int32))
    dp = _t(np.zeros((2, 2048), np.uint32))
    with pytest.raises(ValueError, match="K \\+ 1"):
        kernels.fused_nibble_reduce("or", counts, dp[:1], seg, 1)
    with pytest.raises(ValueError, match="one id per count group"):
        kernels.fused_nibble_reduce("or", counts, dp, seg[:2], 1)
    with pytest.raises(TypeError):
        kernels.fused_nibble_reduce("or", counts, dp.long(), seg, 1)
    with pytest.raises(ValueError):   # no kernel for this device
        kernels.fused_nibble_reduce("or", counts.to("meta"), dp.to("meta"),
                                    seg.to("meta"), 1)


def _head_maps(seg_ids: np.ndarray, k: int):
    head = np.searchsorted(seg_ids, np.arange(k + 1)).astype(np.int32)
    safe = np.minimum(head, max(seg_ids.size - 1, 0))
    valid = ((head < seg_ids.size) & (seg_ids[safe] == np.arange(k + 1))
             if seg_ids.size else np.zeros(k + 1, bool))
    sizes = np.diff(np.append(head, seg_ids.size))
    return head, valid, dense.n_steps_for(int(sizes.max()))


@pytest.mark.parametrize("op", ["or", "xor"])
@pytest.mark.parametrize("dseg", [[0, 0, 0, 2, 4, 4], [3], []])
def test_dense_partial_matches_jax(op, dseg):
    dseg = np.asarray(dseg, np.int32)
    rng = np.random.default_rng(dseg.size)
    rows = rng.integers(0, 1 << 32, (dseg.size, 2048),
                        dtype=np.uint64).astype(np.uint32)
    head, valid, steps = _head_maps(dseg, _K)
    want = jdense.dense_partial_impl(op, jnp.asarray(rows), jnp.asarray(dseg),
                                     jnp.asarray(head), jnp.asarray(valid),
                                     steps, _K)
    got = dense.dense_partial_impl(op, _t(rows), _t(dseg), _t(head),
                                   torch.from_numpy(valid), steps, _K)
    assert np.array_equal(to_u32(got), np.asarray(want))


# ------------------------------------------------------- the nibble engine

def _bitmap_values(seed: int = 9) -> list[np.ndarray]:
    """Ten bitmaps over 2^18 values; the first also holds 30,000 values from
    2^17 on, so it has a bitmap container (the dense-wire stream), and two
    more get one each: key 2 has two dense rows, key 0 one, key 1 none."""
    rng = np.random.default_rng(seed)
    vals = [rng.integers(0, 1 << 18, 4000).astype(np.uint32)
            for _ in range(10)]
    extra = {0: np.arange(1 << 17, (1 << 17) + 30000),
             4: np.arange((1 << 17) + 5000, (1 << 17) + 15000),
             7: np.arange(0, 40000, 2)}
    for i, e in extra.items():
        vals[i] = np.concatenate([vals[i], e.astype(np.uint32)])
    return vals


@pytest.fixture(scope="module")
def compact_pair():
    vals = _bitmap_values()
    j = [JRB.from_values(v) for v in vals]
    t = [TRB.from_values(v) for v in vals]
    js = jagg.DeviceBitmapSet(j, layout="compact")
    ts = tagg.DeviceBitmapSet(t, layout="compact", device=CPU)
    assert ts._streams[0].shape[0] > 0      # dense-wire rows are present
    return j, js, ts


def _same_device(got, want):
    _eq(got, want)


@pytest.mark.parametrize("op", ["or", "xor"])
def test_compact_nibble_matches_jax(compact_pair, op):
    j, js, ts = compact_pair
    want = js.aggregate_device(op, engine="pallas-nibble")
    _same_device(ts.aggregate_device(op, engine="cuda-nibble"), want)
    host = getattr(jfast, "or_" if op == "or" else "xor")(*j)
    got = ts.aggregate(op, engine="cuda-nibble")
    assert np.array_equal(got.to_array(), host.to_array())
    for eng in ("cuda", "torch"):      # the other engines agree
        assert ts.aggregate(op, engine=eng) == got


def test_compact_nibble_and_runs_plain_and(compact_pair):
    j, js, ts = compact_pair
    _same_device(ts.aggregate_device("and", engine="cuda-nibble"),
                 js.aggregate_device("and", engine="pallas-nibble"))


def test_compact_meta_matches_jax(compact_pair):
    _, js, ts = compact_pair
    assert ts._n_groups == js._n_groups
    assert np.array_equal(ts._grp_seg.numpy(), np.asarray(js._grp_seg))
    assert np.array_equal(ts._dseg.numpy(), np.asarray(js._dseg))
    assert np.array_equal(ts._dseg_carry.numpy(), np.asarray(js._dseg_carry))
    for got, want in ((ts._dmeta, js._dmeta),
                      (ts._dmeta_carry, js._dmeta_carry)):
        assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
        assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
        assert got[2] == want[2]
    assert ts.carry_row == js._packed.carry_row


@pytest.mark.parametrize("shuffle", [False, True])
def test_from_numpy_state_nibble(compact_pair, shuffle):
    """The port's set built from the JAX set's arrays; a dense-wire stream
    in shuffled order (as the JAX native ingest may emit it) is sorted on
    load, and carry_row defaults to seg_sizes[0]."""
    j, js, _ = compact_pair
    st = _state(js)
    if shuffle:
        assert np.unique(st["dense_dest"]).size > 1
        st["dense_words"] = st["dense_words"][::-1]
        st["dense_dest"] = st["dense_dest"][::-1]
    ts = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    assert ts.carry_row == js._packed.carry_row
    assert np.all(np.diff(ts._streams[1].numpy()) >= 0)
    for op in ("or", "xor"):
        _same_device(ts.aggregate_device(op, engine="cuda-nibble"),
                     js.aggregate_device(op, engine="pallas-nibble"))


def test_counts_and_dense_resolve_nibble(compact_pair):
    """On counts "cuda-nibble" is the counts reduce (B4's plain version
    here), on dense it is "cuda"."""
    j, _, _ = compact_pair
    t = [TRB.deserialize(b.serialize()) for b in j]
    for layout in ("counts", "dense"):
        js = jagg.DeviceBitmapSet(j, layout=layout)
        ts = tagg.DeviceBitmapSet(t, layout=layout, device=CPU)
        assert ts._select_engine("cuda-nibble") == (
            "cuda-nibble" if layout == "counts" else "cuda")
        for op in ("or", "xor"):
            _same_device(ts.aggregate_device(op, engine="cuda-nibble"),
                         js.aggregate_device(op, engine="pallas-nibble"))


def test_nibble_engine_only_on_sets(compact_pair):
    _, _, ts = compact_pair
    with pytest.raises(ValueError, match="unknown engine"):
        tagg.or_([TRB.bitmap_of(1), TRB.bitmap_of(2)], engine="cuda-nibble",
                 device=CPU)
    with pytest.raises(ValueError, match="unknown engine"):
        ts.aggregate("or", engine="pallas-nibble")


def test_compact_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        tagg.DeviceBitmapSet([TRB.bitmap_of(1, 2)], layout="compact")
