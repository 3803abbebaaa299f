"""The port's host tier (containers, bitmap, format, packing, layout choice)
against roaringbitmap_tpu, array for array.

Inputs are numpy-seeded value sets built into a bitmap in each package, or
serialized bytes (with run containers) fed to both; every comparison is
bit-exact, including serialize() bytes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.format import spec as jspec
from roaringbitmap_tpu.insights import analysis as janalysis
from roaringbitmap_tpu.ops import packing as jpacking
from roaringbitmap_tpu_torch import InvalidRoaringFormat, RoaringBitmap as TRB
from roaringbitmap_tpu_torch.format import spec as tspec
from roaringbitmap_tpu_torch.insights import analysis as tanalysis
from roaringbitmap_tpu_torch.ops import packing as tpacking
from roaringbitmap_tpu_torch.utils import datasets as tdatasets

torch.set_num_threads(2)


def _value_sets(seed: int, n: int) -> list[np.ndarray]:
    """Sparse, dense (bitmap-container) and run-heavy value sets, with the
    edge values 0, 0x80000000 and 0xFFFFFFFF."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            v = rng.integers(0, 1 << 20, 300)
        elif kind == 1:
            base = int(rng.integers(0, 16)) << 16
            v = base + rng.integers(0, 1 << 16, 6000)
        else:
            s = int(rng.integers(0, 1 << 20))
            v = np.arange(s, s + int(rng.integers(100, 9000)))
        v = np.concatenate([v, [0, 0x80000000, 0xFFFFFFFF][: 1 + i % 3]])
        out.append(v.astype(np.uint32))
    return out


def _pair(seed: int, n: int, runs: bool = False):
    """(JAX bitmaps, port bitmaps) over the same values.  With runs, the JAX
    bitmaps are run-optimized and the port's are decoded from their bytes."""
    vals = _value_sets(seed, n)
    j = [JRB.from_values(v) for v in vals]
    if runs:
        for b in j:
            b.run_optimize()
        return j, [TRB.deserialize(b.serialize()) for b in j]
    return j, [TRB.from_values(v) for v in vals]


def _same_streams(a, b):
    names = {f.name for f in dataclasses.fields(b)}
    for f in dataclasses.fields(a):
        if f.name not in names:
            # the port's own: a run stream only where asked for, and the
            # containers by kind
            assert f.name == "kinds" or getattr(a, f.name) is None, f.name
            continue
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f.name
            assert np.array_equal(x, y), f.name
        else:
            assert x == y, f.name


def _same_blocked(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if f.name == "streams":
            _same_streams(x, y)
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y), f.name
            assert x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("runs", [False, True])
def test_bitmap_build_and_serialize_bytes(runs):
    j, t = _pair(0, 6, runs=runs)
    for jb, tb in zip(j, t):
        assert tb.serialize() == jb.serialize()
        assert np.array_equal(tb.to_array(), jb.to_array())
        assert tb.cardinality == jb.cardinality
        assert tb.serialized_size_in_bytes() == jb.serialized_size_in_bytes()
        assert tb.container_count() == jb.container_count()
        assert TRB.deserialize(tb.serialize()) == tb
        assert tb.clone() == tb and not tb.is_empty()


@pytest.mark.parametrize("op", ["|", "&", "^", "-"])
def test_host_fold_ops_match(op):
    j, t = _pair(1, 6, runs=True)
    fj, ft = j[0], t[0]
    for jb, tb in zip(j[1:], t[1:]):
        fj, ft = eval(f"fj {op} jb"), eval(f"ft {op} tb")
        assert ft.serialize() == fj.serialize()
        assert np.array_equal(ft.to_array(), fj.to_array())


def test_bitmap_of_and_module_ops():
    from roaringbitmap_tpu_torch.core import bitmap as tb

    a = TRB.bitmap_of(0, 5, 0x80000000, 0xFFFFFFFF)
    b = TRB.bitmap_of(5, 6, 0xFFFFFFFF)
    assert tb.or_(a, b).to_array().tolist() == [0, 5, 6, 0x80000000, 0xFFFFFFFF]
    assert tb.and_(a, b).to_array().tolist() == [5, 0xFFFFFFFF]
    assert tb.xor(a, b).to_array().tolist() == [0, 6, 0x80000000]
    assert tb.andnot(a, b).to_array().tolist() == [0, 0x80000000]
    assert TRB().is_empty() and TRB().cardinality == 0


@pytest.mark.parametrize("size", [2, 4, 7])
def test_truncated_stream_raises(size):
    blob = JRB.from_values(_value_sets(2, 1)[0]).serialize()
    with pytest.raises(InvalidRoaringFormat):
        TRB.deserialize(blob[:size])
    with pytest.raises(InvalidRoaringFormat):
        tpacking.pack_blocked_compact([blob[:size]])


def test_truncated_payload_raises_in_both():
    j, _ = _pair(3, 3, runs=True)
    for b in j:
        blob = b.serialize()[:-3]
        with pytest.raises(jspec.InvalidRoaringFormat):
            jspec.deserialize(blob)
        with pytest.raises(InvalidRoaringFormat):
            tspec.deserialize(blob)
        with pytest.raises(InvalidRoaringFormat):
            tpacking.pack_blocked_compact([blob])


@pytest.mark.parametrize("blocked_args", [
    dict(), dict(block=8, round_blocks=64, carry_slot=False),
    dict(min_block=4), dict(block=16)])
@pytest.mark.parametrize("runs", [False, True])
@pytest.mark.parametrize("n", [8, 9])
def test_pack_blocked_compact(blocked_args, runs, n):
    # every bitmap holds key 0: with n = 8, segment 0 fills its blocks and
    # the carry slot adds one
    j, t = _pair(4, n, runs=runs)
    want = jpacking.pack_blocked_compact(j, **blocked_args)
    got = tpacking.pack_blocked_compact(t, **blocked_args)
    _same_blocked(got, want)


def test_pack_blocked_compact_byte_backed():
    """Serialized bytes and SerializedViews ingest like the bitmaps they
    encode (JAX side fed views, so its NumPy packer runs)."""
    j, _ = _pair(5, 7, runs=True)
    blobs = [b.serialize() for b in j]
    want = jpacking.pack_blocked_compact([jspec.SerializedView(x) for x in blobs])
    got = tpacking.pack_blocked_compact(blobs)
    _same_blocked(got, want)
    got_views = tpacking.pack_blocked_compact(
        [tspec.SerializedView(x) for x in blobs])
    _same_blocked(got_views, want)


@pytest.mark.parametrize("pad", [True, False])
def test_chunk_value_stream(pad):
    j, t = _pair(6, 6, runs=True)
    s = tpacking.pack_blocked_compact(t).streams
    want = jpacking.chunk_value_stream(s.values, s.val_counts, s.val_dest,
                                       s.n_rows, pad_chunks_pow2=pad)
    got = tpacking.chunk_value_stream(s.values, s.val_counts, s.val_dest,
                                      s.n_rows, pad_chunks_pow2=pad)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    assert tpacking.CHUNK_PAD == jpacking.CHUNK_PAD
    assert tpacking.CHUNK_VALUES == jpacking.CHUNK_VALUES


def test_pad_streams_pow2():
    j, t = _pair(7, 5)
    want = jpacking.pad_streams_pow2(
        jpacking.pack_blocked_compact(j, block=8).streams)
    got = tpacking.pad_streams_pow2(
        tpacking.pack_blocked_compact(t, block=8).streams)
    _same_streams(got, want)
    assert got.transfer_bytes() == want.transfer_bytes()


@pytest.mark.parametrize("pad_rows", [True, False])
def test_pack_for_aggregation(pad_rows):
    j, t = _pair(8, 6, runs=True)
    want = jpacking.pack_for_aggregation(j, pad_rows=pad_rows)
    got = tpacking.pack_for_aggregation(t, pad_rows=pad_rows)
    for f in dataclasses.fields(want):
        x, y = getattr(got, f.name), getattr(want, f.name)
        assert np.array_equal(x, y), f.name


def test_blocked_ragged_meta_and_block_count():
    j, t = _pair(9, 8)
    p = tpacking.pack_blocked_compact(t)
    got = tpacking.blocked_ragged_meta(p.blk_seg, p.block, p.n_blocks,
                                       p.keys.size)
    want = jpacking.blocked_ragged_meta(p.blk_seg, p.block, p.n_blocks,
                                        p.keys.size)
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    assert got[2] == want[2]
    for block in (4, 8, 32):
        assert (tpacking.blocked_block_count(t, block)
                == jpacking.blocked_block_count(j, block))


@pytest.mark.parametrize("min_block", [4, 8])
def test_choose_block(min_block):
    for sizes in ([], [1], [1, 1, 2, 5], [4] * 9, [16, 20], [40, 33, 1]):
        s = np.array(sizes, np.int64)
        assert (tpacking.choose_block(s, min_block)
                == jpacking.choose_block(s, min_block))


def test_intersection_pack_and_masks():
    rng = np.random.default_rng(10)
    common = rng.integers(0, 1 << 20, 500)
    vals = [np.concatenate([common, rng.integers(0, 1 << 20, 400)]).astype(np.uint32)
            for _ in range(4)]
    j = [JRB.from_values(v) for v in vals]
    t = [TRB.from_values(v) for v in vals]
    assert np.array_equal(tpacking.key_presence_masks(t),
                          jpacking.key_presence_masks(j))
    keys = np.intersect1d(t[0].keys, t[1].keys)
    got = tpacking.pack_for_intersection(t[:2], keys)
    want = jpacking.pack_for_intersection(j[:2], keys)
    assert np.array_equal(got.words, want.words)
    assert np.array_equal(got.keys, want.keys)


def test_unpack_result():
    rng = np.random.default_rng(11)
    keys = np.array([0, 7, 0x8000, 0xFFFF], np.uint16)
    words = rng.integers(0, 1 << 32, (4, 2048), dtype=np.uint64).astype(np.uint32)
    words[1] = 0
    words[2, 5:] = 0   # a sparse row: array container
    words[3, 0] = 0x80000000
    cards = np.array([int(np.unpackbits(w.view(np.uint8)).sum()) for w in words])
    got = tpacking.unpack_result(keys, words, cards)
    want = jpacking.unpack_result(keys, words, cards)
    assert got.serialize() == want.serialize()
    assert np.array_equal(got.to_array(), want.to_array())
    assert 7 not in got.keys.tolist()


def _census_shaped(n: int, seed: int) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = rng.choice(1 << 16, 4, replace=False).astype(np.uint32)
        lows = rng.integers(0, 1 << 16, (4, 4)).astype(np.uint32)
        out.append(((keys[:, None] << np.uint32(16)) | lows).ravel())
    return out


@pytest.mark.parametrize("shape", ["census", "synthetic", "empty", "bytes"])
def test_choose_layout(shape):
    if shape == "census":
        vals = _census_shaped(256, 12)
    elif shape == "synthetic":
        vals = [b.to_array() for b in tdatasets.synthetic_bitmaps(
            12, seed=3, universe=1 << 20, density=0.002)]
    else:
        vals = _value_sets(13, 5)
    j = [JRB.from_values(v) for v in vals]
    t = [TRB.from_values(v) for v in vals]
    if shape == "empty":
        j, t = [], []
    if shape == "bytes":
        j = t = [b.serialize() for b in j]
    got, want = tanalysis.choose_layout(t), janalysis.choose_layout(j)
    for key in ("layout", "median_segment", "inflation_x", "dense_bytes",
                "serialized_bytes", "dense_block"):
        assert got.get(key) == want.get(key), key
    if shape == "census":
        assert got["layout"] == "counts"


def test_synthetic_bitmaps_match():
    from roaringbitmap_tpu.utils import datasets as jdatasets

    j = jdatasets.synthetic_bitmaps(6, seed=4, universe=1 << 21, density=0.004)
    t = tdatasets.synthetic_bitmaps(6, seed=4, universe=1 << 21, density=0.004)
    for jb, tb in zip(j, t):
        assert tb.serialize() == jb.serialize()


@pytest.mark.parametrize("start,stop", [
    (-5, 10), (2**32 - 3, 2**32 + 4), (-1, 2**33)])
def test_from_range_outside_universe_raises(start, stop):
    """Regression (ROADMAP C2): bounds outside [0, 2^32) raise the JAX
    package's ValueError; they are not clamped."""
    for cls in (TRB, JRB):
        with pytest.raises(ValueError, match="32-bit universe"):
            cls.from_range(start, stop)


@pytest.mark.parametrize("start,stop", [
    (0, 0), (9, 3), (5, 6), (5, 7), (5, 8), (0, 1 << 16), (7, 200000),
    (2**32 - 3, 2**32), (0, 2**32)])
def test_from_range_matches_jax(start, stop):
    """Inside the universe (and for empty or reversed ranges) the port's
    range bitmap is the JAX package's, container kinds and bytes too."""
    got, want = TRB.from_range(start, stop), JRB.from_range(start, stop)
    assert got.serialize() == want.serialize()
    assert got.cardinality == want.cardinality == max(0, stop - start)


def test_out_of_universe_probes():
    """Pinned reference fault (ROADMAP C4): the JAX host bitmap's key lookup
    casts with np.uint16 and raises OverflowError for a probe outside
    [0, 2^32), as does the JAX BSI's get_value; the port answers as the
    reference Java library does: absent, no change, the members in range,
    no value."""
    from roaringbitmap_tpu.bsi import RoaringBitmapSliceIndex as JBsi
    from roaringbitmap_tpu_torch.bsi import RoaringBitmapSliceIndex as TBsi

    vals = [0, 1, 2**32 - 1]
    t, j = TRB.bitmap_of(*vals), JRB.bitmap_of(*vals)
    assert t.contains(-1) is False and not t.contains(2**32)
    t.remove(2**32 + 1)
    assert t.to_array().tolist() == vals
    assert t.range_cardinality(-5, 2**33) == 3
    for call in (lambda: j.contains(-1), lambda: j.remove(2**32 + 1),
                 lambda: j.range_cardinality(-5, 2**33)):
        with pytest.raises(OverflowError):
            call()
    ids, values = np.array([1, 2], np.uint32), np.array([5, 6])
    assert TBsi.from_pairs(ids, values).get_value(-1) == (0, False)
    with pytest.raises(OverflowError):
        JBsi.from_pairs(ids, values).get_value(-1)
