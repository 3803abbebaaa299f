"""The port's buffer tier (``roaringbitmap_tpu_torch.buffer``) held against
the JAX package's ``roaringbitmap_tpu.buffer``.

Every case wraps the same numpy-seeded serialized bytes in both packages'
``ImmutableRoaringBitmap`` and compares the outcome exactly: members,
cardinalities, serialized bytes, iterator walks, result classes, and the
class name of a raised error.  Bytes cross both ways (the JAX package's
bytes mapped in the port and the port's in the JAX package), corrupted and
truncated buffers raise the same error class in both, and the laziness
guarantees of the JAX suite (``tests/test_buffer.py``) hold in the port.
"""

import os
import pickle
import sys
import types

import numpy as np
import pytest

from roaringbitmap_tpu.buffer import immutable as jim
from roaringbitmap_tpu.core import bitmap as jb
from roaringbitmap_tpu.core import iterators as ji
from roaringbitmap_tpu_torch.buffer import immutable as tim
from roaringbitmap_tpu_torch.core import bitmap as tb
from roaringbitmap_tpu_torch.core import iterators as ti

JAX = types.SimpleNamespace(RB=jb.RoaringBitmap, bm=jb, it=ji,
                            IM=jim.ImmutableRoaringBitmap,
                            MUT=jim.MutableRoaringBitmap)
PORT = types.SimpleNamespace(RB=tb.RoaringBitmap, bm=tb, it=ti,
                             IM=tim.ImmutableRoaringBitmap,
                             MUT=tim.MutableRoaringBitmap)


def _values(shape: str) -> tuple[np.ndarray, bool]:
    """(u32 values, run_optimize?) of a named shape, from a fixed seed."""
    rng = np.random.default_rng(sum(map(ord, shape)) + 14)
    if shape == "empty":
        return np.empty(0, np.uint32), False
    if shape == "sparse":
        return rng.choice(1 << 22, 700, replace=False).astype(np.uint32), False
    if shape == "dense":
        base = rng.choice(1 << 16, 9000, replace=False)
        return np.concatenate([base, (3 << 16) + base[:5000]]).astype(
            np.uint32), False
    if shape == "runs":
        parts = [np.arange(s, s + n) for s, n in
                 ((10, 300), (65530, 20), (5 << 16, 1 << 16),
                  (0x7FFFFF00, 0x200))]
        return np.concatenate(parts).astype(np.uint32), True
    if shape == "edges":
        return np.array([0, 1, 63, 64, 65535, 65536, 0x7FFFFFFF, 0x80000000,
                         0xFFFFFFFE, 0xFFFFFFFF], np.uint32), False
    arr = rng.choice(1 << 16, 100, replace=False)
    bmp = (1 << 16) + rng.choice(1 << 16, 6000, replace=False)
    run = (2 << 16) + np.arange(1000, 9000)
    top = 0xFFFF0000 + rng.choice(1 << 16, 50, replace=False)
    return np.concatenate([arr, bmp, run, top]).astype(np.uint32), True


SHAPES = ["empty", "sparse", "dense", "runs", "edges", "mixed"]
PARTNER = dict(zip(SHAPES, SHAPES[1:] + SHAPES[:1]))


def _heap(ns, shape: str):
    vals, runs = _values(shape)
    rb = ns.RB.from_values(vals)
    if runs:
        rb.run_optimize()
    return rb


def _imm(ns, shape: str):
    return ns.IM(_heap(ns, shape).serialize())


def _norm(x):
    """A package-neutral form of a result, for exact comparison."""
    if isinstance(x, (jb.RoaringBitmap, tb.RoaringBitmap)):
        return ("rb", type(x).__name__, x.serialize())
    if isinstance(x, (jim.ImmutableRoaringBitmap, tim.ImmutableRoaringBitmap)):
        return ("imm", x.serialize())
    if isinstance(x, np.ndarray):
        return ("arr", str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if hasattr(x, "values") and hasattr(x, "cardinality"):   # a container
        return ("c", type(x).__name__, x.values().tolist())
    return x


def _outcome(fn, *args):
    try:
        return _norm(fn(*args))
    except Exception as e:  # the class name is part of the contract
        return ("raised", type(e).__name__)


PROBES = [0, 1, 64, 65535, 65536, 70000, 0x7FFFFFFF, 0x80000000,
          0xFFFFFFFF]
RANGES = [(0, 1), (5, 5), (10, 3), (65530, 65546), (0, 1 << 20),
          (0x7FFFFFF0, 0x80000010), ((1 << 32) - 5, 1 << 32)]


def _walk_peekable(ns, a, b):
    it = a.get_int_iterator()
    out = []
    for target in (0, 70, 65536, 0x80000000, 0xFFFFFFFF):
        it.advance_if_needed(target)
        out.append(it.peek_next() if it.has_next() else None)
        if it.has_next():
            out.append(it.next())
    return [out, list(it)]


def _walk_batches(ns, a, b):
    it = a.get_batch_iterator(1000)
    out = []
    if it.has_next():
        out.append(it.next_batch())
    it.advance_if_needed(65536)
    out.append(it.next_batch())
    it.advance_if_needed(0x80000000)
    out.append(list(it))
    return out


def _walk_rank(ns, a, b):
    it = ns.it.PeekableIntRankIterator(a)
    out = []
    for target in (3, 65536, 5 << 16, 0x7FFFFF80):
        it.advance_if_needed(target)
        if it.has_next():
            out.append((it.peek_next(), it.peek_next_rank()))
    return out


def _pointer(ns, a, b):
    p = a.get_container_pointer()
    out = []
    while p.has_container():
        out.append((p.key(), p.get_cardinality(), p.is_bitmap_container(),
                    p.is_run_container(), p.get_container()))
        p.advance()
    return out


def _collect(method, *args):
    def run(ns, a, b):
        got = []
        getattr(a, method)(*args, lambda *v: got.append(v))
        return got
    return run


def _each(method, args_list):
    return lambda ns, a, b: [
        _outcome(lambda x: getattr(a, method)(*x), x) for x in args_list]


#: read-only cases: ``a`` is the immutable, ``b`` its partner (a heap
#: bitmap of the next shape, and the same as an immutable in "*_imm")
CASES = {
    "header": lambda ns, a, b: [
        a.cardinality, len(a), a.is_empty(), bool(a),
        a.has_run_compression(), a.serialized_size_in_bytes(),
        a.get_size_in_bytes(), a.keys, len(a.containers), a.long_cardinality,
        repr(a)],
    "serialize": lambda ns, a, b: a.serialize(),
    "contains": lambda ns, a, b: [a.contains(x) for x in PROBES]
    + [x in a for x in PROBES],
    "rank": lambda ns, a, b: [a.rank(x) for x in PROBES]
    + [a.rank_long(x) for x in PROBES],
    "select": _each("select", [(0,), (3,), (699,), (10**9,)]),
    "first_last": lambda ns, a, b: [
        _outcome(f) for f in (a.first, a.last, a.first_signed, a.last_signed)],
    "next_previous": lambda ns, a, b: [
        [a.next_value(x), a.previous_value(x)] for x in PROBES],
    "absent": lambda ns, a, b: [
        [a.next_absent_value(x), a.previous_absent_value(x)] for x in PROBES],
    "range_cardinality": lambda ns, a, b: [
        a.range_cardinality(*r) for r in RANGES],
    "cardinality_exceeds": lambda ns, a, b: [
        a.cardinality_exceeds(t) for t in (-1, 0, 5, len(a) - 1, len(a))],
    "limit": lambda ns, a, b: [a.limit(n) for n in (0, 1, 301, 10 ** 9)],
    "select_range": _each("select_range", [(0, 1), (3, 700), (-1, 2), (5, 5),
                                           (10**9, 10**9 + 2)]),
    "to_array": lambda ns, a, b: [a.to_array(), list(a)],
    "for_each": _collect("for_each"),
    "for_each_in_range": lambda ns, a, b: [
        _outcome(_collect("for_each_in_range", *r), ns, a, b)
        for r in ((0, 70000), (0x7FFFFFF0, 0x80000010))],
    "for_all_in_range": lambda ns, a, b: [
        _outcome(_collect("for_all_in_range", *r), ns, a, b)
        for r in ((0, 70), (65530, 65546))],
    "int_iterator": _walk_peekable,
    "reverse_iterator": lambda ns, a, b: list(a.get_reverse_int_iterator()),
    "signed_iterator": lambda ns, a, b: list(a.get_signed_int_iterator()),
    "rank_iterator": _walk_rank,
    "batch_iterator": _walk_batches,
    "batch_iterator_sizes": lambda ns, a, b: [
        list(a.batch_iterator(n)) for n in (1, 999, 65536)],
    "container_pointer": _pointer,
    "algebra": lambda ns, a, b: [a & b, a | b, a ^ b, a - b,
                                 ns.bm.and_(a, b), ns.bm.or_(a, b),
                                 ns.bm.xor(a, b), ns.bm.andnot(a, b)],
    "algebra_rhs": lambda ns, a, b: [b & a, b | a, b ^ a, b - a],
    "cardinalities": lambda ns, a, b: [
        a.and_cardinality(b), ns.bm.or_cardinality(a, b),
        ns.bm.xor_cardinality(a, b), ns.bm.andnot_cardinality(a, b)],
    "relations": lambda ns, a, b: [
        a.intersects(b), a.intersects(a), a.is_subset_of(b),
        a.is_subset_of(a), [a.is_hamming_similar(b, t)
                            for t in (0, 10, 10_000, 1 << 20)]],
    "equality": lambda ns, a, b: [a == a.to_bitmap(), a == b, a.to_bitmap() == a,
                                  hash(a) == hash(a.to_bitmap())],
    "conversions": lambda ns, a, b: [
        a.to_bitmap(), a.to_roaring_bitmap(), a.to_mutable(),
        a.to_mutable_roaring_bitmap(),
        a.to_mutable().to_immutable(),
        a.to_mutable().to_immutable_roaring_bitmap(),
        ns.MUT.from_immutable(a)],
    "static_builders": lambda ns, a, b: [
        ns.IM.bitmap_of(1, 5, 70000), ns.MUT.bitmap_of(3, 9),
        ns.IM.remove(a, 0, 1 << 32), ns.IM.remove(a, 65536, 0x80000001),
        ns.IM.remove(a.to_bitmap(), 0, 70)],
    "pickle": lambda ns, a, b: (lambda c: [type(c).__name__, c])(
        pickle.loads(pickle.dumps(a))),
}


@pytest.mark.parametrize("partner", ["heap", "imm"])
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_immutable_matches_jax(case, shape, partner):
    fn = CASES[case]

    def run(ns):
        b = (_heap if partner == "heap" else _imm)(ns, PARTNER[shape])
        return _outcome(fn, ns, _imm(ns, shape), b)

    assert run(PORT) == run(JAX)


def test_immutable_covers_the_jax_class():
    for jcls, tcls in ((jim.ImmutableRoaringBitmap, tim.ImmutableRoaringBitmap),
                       (jim.MutableRoaringBitmap, tim.MutableRoaringBitmap),
                       (jim._LazyContainerSeq, tim._LazyContainerSeq)):
        missing = [n for n in dir(jcls) if n not in dir(tcls)]
        assert missing == [], (jcls.__name__, missing)


@pytest.mark.parametrize("shape", SHAPES)
def test_bytes_map_both_ways(shape):
    """The JAX package's bytes map in the port and the port's in the JAX
    package: the same members, cardinality and bytes."""
    jbytes, tbytes = _heap(JAX, shape).serialize(), _heap(PORT, shape).serialize()
    assert jbytes == tbytes
    for blob in (jbytes, tbytes):
        t, j = PORT.IM(blob), JAX.IM(blob)
        assert t.cardinality == j.cardinality
        assert t.to_array().tolist() == j.to_array().tolist()
        assert t.serialize() == j.serialize() == blob
    # an immutable from one package serializes into the other's
    assert JAX.IM(PORT.IM(jbytes).serialize()).to_bitmap().serialize() == jbytes
    assert PORT.IM(JAX.IM(tbytes).serialize()).to_bitmap().serialize() == tbytes


@pytest.mark.parametrize("shape", SHAPES)
def test_to_mutable_roaring_bitmap_matches_jax(shape):
    """``RoaringBitmap.to_mutable_roaring_bitmap``: a MutableRoaringBitmap
    copy that does not alias the source."""
    out = []
    for ns in (JAX, PORT):
        rb = _heap(ns, shape)
        m = rb.to_mutable_roaring_bitmap()
        before = rb.serialize()
        m.add(0xFEEDBEEF)
        assert rb.serialize() == before
        out.append((type(m).__name__, m.serialize(),
                    m.to_immutable().serialize()))
    assert out[0] == out[1]


def _corruptions() -> list:
    """(label, bytes) of hostile buffers: truncations of an array, a
    bitmap and a run bitmap's bytes, a bad cookie, keys out of order, a
    lying cardinality, overlapping runs, unsorted array values."""
    rb = jb.RoaringBitmap.from_values(np.concatenate([
        np.arange(0, 200, 3), (1 << 16) + np.arange(5000) * 2,
        (2 << 16) + np.arange(100, 900)]).astype(np.uint32))
    plain = rb.serialize()
    rb.run_optimize()
    runs = rb.serialize()
    out = [(f"plain[:{c}]", plain[:c]) for c in (0, 3, 7, 9, 15, 20, 24, 40,
                                                 len(plain) - 1)]
    out += [(f"runs[:{c}]", runs[:c]) for c in (4, 5, 9, 13, 30, 50,
                                                len(runs) - 1)]
    bad = bytearray(plain)
    bad[0] ^= 0xFF
    out.append(("cookie", bytes(bad)))
    bad = bytearray(plain)
    bad[8:10], bad[12:14] = plain[12:14], plain[8:10]
    out.append(("key order", bytes(bad)))
    bad = bytearray(plain)
    bad[10] ^= 0x01
    out.append(("cardinality lie", bytes(bad)))
    small = jb.RoaringBitmap.from_values(np.arange(10, 20, dtype=np.uint32))
    small.run_optimize()
    bad = bytearray(small.serialize())
    bad[-4:] = (5).to_bytes(2, "little") + (20).to_bytes(2, "little")
    out.append(("run past cardinality", bytes(bad)))
    arr = bytearray(jb.RoaringBitmap.from_values(
        np.array([1, 5, 9], np.uint32)).serialize())
    arr[-2:] = (2).to_bytes(2, "little")
    out.append(("unsorted array", bytes(arr)))
    return out


@pytest.mark.parametrize("label,blob", _corruptions(),
                         ids=[c[0] for c in _corruptions()])
def test_corrupt_buffers_raise_like_jax(label, blob):
    """The same error class at wrap or at the first full decode (the lazy
    sequence propagates the decoder's typed error)."""
    def wrap_and_decode(ns):
        im = ns.IM(blob)
        return [list(c.values()) for c in im.containers] + [im.cardinality]

    want, got = _outcome(wrap_and_decode, JAX), _outcome(wrap_and_decode, PORT)
    assert got == want
    assert got[0] == "raised" or label.startswith(("plain[:", "runs[:"))


def test_view_into_larger_frame_and_mmap(tmp_path):
    rb = _heap(PORT, "mixed")
    blob = b"\xAA" * 37 + rb.serialize() + b"\xBB" * 11
    for ns in (JAX, PORT):
        im = ns.IM(memoryview(blob)[37:])
        assert im.serialize() == rb.serialize()
        assert im.to_array().tolist() == rb.to_array().tolist()
    path = os.path.join(tmp_path, "bitmap.bin")
    with open(path, "wb") as f:
        f.write(rb.serialize())
    ims = [ns.IM.mapped(path) for ns in (JAX, PORT)]
    assert ims[0].serialize() == ims[1].serialize() == rb.serialize()
    assert (ims[1] & rb) == rb and ims[1].first() == rb.first()


def _wide_imm(n_keys: int):
    parts = [np.arange(0, 5000, 1 + (k % 3), dtype=np.uint32) + (k << 16)
             for k in range(n_keys)]
    rb = tb.RoaringBitmap.from_values(np.concatenate(parts))
    return rb, tim.ImmutableRoaringBitmap(rb.serialize())


def test_lazy_decoding():
    """An AND against a 10^4-container immutable decodes one container; the
    iterator seek and range walks decode only what they visit; the header
    answers cardinality and rank skips without a decode."""
    rb, im = _wide_imm(10_000)
    assert im.cardinality == rb.cardinality and len(im._cache) == 0
    probe = tb.RoaringBitmap.from_values(
        (7 << 16) + np.arange(0, 5000, 7, dtype=np.uint32))
    assert (im & probe) == (rb & probe) and len(im._cache) == 1
    _, im = _wide_imm(100)
    it = im.get_int_iterator()
    it.advance_if_needed(90 << 16)
    assert it.next() == (90 << 16) and len(im._cache) <= 3
    _, im = _wide_imm(100)
    seen = []
    im.for_each_in_range(50 << 16, (50 << 16) + 10, seen.append)
    assert len(seen) > 0 and len(im._cache) <= 4
    _, im = _wide_imm(50)
    rit = ti.PeekableIntRankIterator(im)
    rit.advance_if_needed(40 << 16)
    assert rit.peek_next_rank() == im.rank(40 << 16) and len(im._cache) <= 4


def test_zero_copy_views():
    if sys.byteorder != "little":
        pytest.skip("zero-copy only on little-endian hosts")
    rb = tb.RoaringBitmap.from_values(np.concatenate([
        np.arange(100, dtype=np.uint32),
        (1 << 16) + np.arange(5000, dtype=np.uint32)]).astype(np.uint32))
    rb.run_optimize()
    blob = rb.serialize()
    im = tim.ImmutableRoaringBitmap(blob)
    src = np.frombuffer(blob, dtype=np.uint8)
    for c in im.containers:
        payload = (c.runs if hasattr(c, "runs") else
                   c.words() if c.is_bitmap() else c.values())
        assert np.shares_memory(payload, src)
        assert not payload.flags.writeable
    out = im.to_bitmap()
    out.add(12345)
    assert 12345 in out and 12345 not in im


@pytest.mark.parametrize("elements,begin,end,expected", [
    ([1, 3, 5, 7, 9], 3, 8, 3),
    ([1, 3, 5, 7, 9], 2, 8, 3),
    ([1, 3, 5, 7, 9], 3, 7, 2),
    ([1, 3, 5, 7, 9], 0, 7, 3),
    ([1, 3, 5, 7, 9], 0, 6, 3),
    ([1, 3, 5, 7, 9, 0x7FFF], 0, 0x8000, 6),
    ([1, 10000, 25000, 0x7FFE], 0, 0x7FFF, 4),
    ([1 << 3, 1 << 8, 511, 512, 513, 1 << 12, 1 << 14], 0, 0x7FFF, 7),
])
def test_range_cardinality_word_boundaries(elements, begin, end, expected):
    """The JAX suite's word-boundary range counts (the reference's
    TestBufferRangeCardinality) on both packages' immutables."""
    for ns in (JAX, PORT):
        rb = ns.RB.from_values(np.array(elements, np.uint32))
        assert ns.IM(rb.serialize()).range_cardinality(begin, end) == expected


@pytest.mark.parametrize("offset", [20, 1 << 16, -20, 65516, 5950])
def test_mutable_twin_add_offset_matches_jax(offset):
    """The mutable twin's offset through the immutable pairing, on an
    array, a run and a bitmap container in adjacent chunks."""
    def run(ns):
        rng = np.random.default_rng(9)
        rb = ns.RB()
        rb.add_many(rng.choice(1 << 16, size=100, replace=False)
                    .astype(np.uint32))
        rb.add_range((1 << 16) + 1000, (1 << 16) + 9000)
        rb.add_many(((2 << 16) + rng.choice(1 << 16, size=9000,
                                            replace=False)).astype(np.uint32))
        rb.run_optimize()
        mut = ns.IM(rb.serialize()).to_mutable()
        shifted = mut.add_offset(offset)
        return [type(mut).__name__, shifted, shifted.cardinality,
                mut.add_offset(offset).add_offset(-offset) == rb]

    assert _outcome(run, PORT) == _outcome(run, JAX)
