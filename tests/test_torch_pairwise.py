"""Batched pairwise ops of the port against roaringbitmap_tpu.

``pack_pairwise`` array for array, ``pairwise`` / ``pairwise_cardinality``
for or/and/xor/andnot, empty and disjoint pairs, and ``DevicePairSet`` in
the dense and compact layouts (``cardinalities``, ``pairwise``,
``chained_cardinality``) and ``chained_pairwise_cardinality``, the port on
``device="cpu"``.  Bit-exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import packing as jpacking
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import packing
from roaringbitmap_tpu_torch.parallel import aggregation as tagg

torch.set_num_threads(2)

CPU = "cpu"
OPS = ["or", "and", "xor", "andnot"]


def _same(tb, jb):
    assert np.array_equal(tb.to_array(), jb.to_array())
    assert tb.serialize() == jb.serialize()


@pytest.fixture(scope="module")
def pairs():
    """Eight pairs over 2^20 values: sparse, dense (bitmap containers) and
    run-heavy sides, overlapping and disjoint key sets, and one pair whose
    first side is serialized bytes (the byte ingest path)."""
    rng = np.random.default_rng(7)
    vals = []
    for i in range(16):
        kind = i % 4
        if kind == 0:
            v = rng.integers(0, 1 << 20, 3000)
        elif kind == 1:
            v = (int(rng.integers(0, 16)) << 16) + rng.integers(0, 1 << 16,
                                                               9000)
        elif kind == 2:
            s = int(rng.integers(0, 1 << 20))
            v = np.arange(s, s + int(rng.integers(100, 70000)))
        else:
            v = rng.integers(0, 1 << 18, 500)
        vals.append(np.append(v, 0xFFFFFFFF).astype(np.uint32))
    j = [JRB.from_values(v) for v in vals]
    for b in j[2::4]:
        b.run_optimize()
    t = [TRB.deserialize(b.serialize()) for b in j]
    jp = list(zip(j[0::2], j[1::2]))
    tp = list(zip(t[0::2], t[1::2]))
    jp[3] = (jp[3][0].serialize(), jp[3][1])
    tp[3] = (tp[3][0].serialize(), tp[3][1])
    return jp, tp


def _same_streams(got, want):
    for name in ("dense_words", "dense_dest", "values", "val_counts",
                 "val_dest"):
        assert np.array_equal(getattr(got, name), getattr(want, name)), name
    assert got.n_rows == want.n_rows


@pytest.mark.parametrize("pad_rows", [True, False])
def test_pack_pairwise_matches_jax(pairs, pad_rows):
    jp, tp = pairs
    got = packing.pack_pairwise(tp, pad_rows=pad_rows)
    want = jpacking.pack_pairwise(jp, pad_rows=pad_rows)
    assert np.array_equal(got.keys, want.keys)
    assert np.array_equal(got.heads, want.heads)
    assert (got.m, got.n_rows) == (want.m, want.n_rows)
    _same_streams(got.a_streams, want.a_streams)
    _same_streams(got.b_streams, want.b_streams)


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("op", OPS)
def test_pairwise_matches_jax(pairs, op, engine):
    jp, tp = pairs
    want = jagg.pairwise(op, jp)
    got = tagg.pairwise(op, tp, engine=engine, device=CPU)
    assert len(got) == len(want) == len(tp)
    for g, w in zip(got, want):
        _same(g, w)
    cards = tagg.pairwise_cardinality(op, tp, engine=engine, device=CPU)
    assert cards.dtype == np.int64
    assert cards.tolist() == jagg.pairwise_cardinality(op, jp).tolist()
    assert cards.tolist() == [w.cardinality for w in want]


def test_pairwise_empty_and_disjoint():
    e = TRB()
    a = TRB.bitmap_of(1, 2, 3)
    b = TRB.bitmap_of(0x20001)
    got = tagg.pairwise("or", [(e, e), (a, b)], device=CPU)
    assert got[0].is_empty() and got[1] == (a | b)
    cards = tagg.pairwise_cardinality("and", [(e, e), (a, b)], device=CPU)
    assert cards.tolist() == [0, 0]
    assert tagg.pairwise("xor", [], device=CPU) == []
    ps = tagg.DevicePairSet([(e, e), (a, b)], device=CPU)
    assert ps.pairwise("or")[1] == (a | b)
    assert ps.cardinalities("and").tolist() == [0, 0]
    assert ps.hbm_bytes() > 0


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("op", OPS)
def test_device_pair_set_matches_jax(pairs, op, layout):
    jp, tp = pairs
    js = jagg.DevicePairSet(jp, layout=layout)
    ts = tagg.DevicePairSet(tp, layout=layout, device=CPU)
    assert ts.n_pairs == js.n_pairs == len(tp)
    assert np.array_equal(ts.keys, js.keys)
    assert ts.cardinalities(op).tolist() == js.cardinalities(op).tolist()
    for g, w in zip(ts.pairwise(op), js.pairwise(op)):
        _same(g, w)
    total = ts.chained_cardinality(op, 3)()
    assert total.dim() == 0 and total.dtype == torch.int64
    assert int(total) == int(np.asarray(js.chained_cardinality(op, 3)()))
    assert int(total) == (3 * int(ts.cardinalities(op).sum())) % 2**32


def test_pair_set_layouts_and_bytes(pairs):
    """Dense keeps the two images and drops the streams; compact keeps the
    streams only and is smaller."""
    _, tp = pairs
    dense_ps = tagg.DevicePairSet(tp, device=CPU)
    compact_ps = tagg.DevicePairSet(tp, layout="compact", device=CPU)
    assert dense_ps._a is None and dense_ps._packed.a_streams is None
    assert dense_ps.hbm_bytes() == 2 * dense_ps._n_rows * 2048 * 4
    assert compact_ps.a_words is None
    assert 0 < compact_ps.hbm_bytes() < dense_ps.hbm_bytes()
    with pytest.raises(ValueError, match="layout"):
        tagg.DevicePairSet(tp, layout="counts", device=CPU)


def test_chained_pairwise_cardinality(pairs):
    jp, tp = pairs
    fn, packed = tagg.chained_pairwise_cardinality("xor", tp, 4, device=CPU)
    jfn, jpacked = jagg.chained_pairwise_cardinality("xor", jp, 4)
    assert np.array_equal(packed.heads, jpacked.heads)
    want = sum(c.cardinality for c in jagg.pairwise("xor", jp))
    assert int(fn()) == int(np.asarray(jfn())) == (4 * want) % 2**32


def test_pairwise_checks_op_and_engine(pairs):
    jp, tp = pairs
    # an unknown op: the JAX package raises KeyError (its op table lookup);
    # the port's error is a KeyError and a ValueError at once
    for call in (lambda: jagg.pairwise("nand", jp),
                 lambda: jagg.pairwise_cardinality("nand", jp),
                 lambda: tagg.pairwise("nand", tp, device=CPU),
                 lambda: tagg.pairwise_cardinality("nand", tp, device=CPU),
                 lambda: tagg.DevicePairSet(tp[:2], device=CPU)
                 .cardinalities("nand")):
        with pytest.raises(KeyError, match="nand"):
            call()
    with pytest.raises(ValueError, match="pairwise op"):
        tagg.pairwise("nand", tp, device=CPU)
    with pytest.raises(ValueError, match="unknown engine"):
        tagg.pairwise("or", tp, engine="xla", device=CPU)
    ps = tagg.DevicePairSet(tp[:2], device=CPU)
    for engine in ("auto", "cuda", "torch"):
        assert ps.pairwise("or", engine=engine) == ps.pairwise("or")
    with pytest.raises(ValueError, match="unknown engine"):
        ps.cardinalities("or", engine="cuda-nibble")
