"""The port's host RoaringBitmap API (``core.bitmap``, ``core.iterators``,
the container helpers and ``format.spec``) held against the JAX package.

Every case feeds both packages the same numpy-seeded values and compares
the outcome exactly: members, cardinalities, serialized bytes, iterator
walks, and the class name of a raised error.  Shapes cover array, bitmap
and run containers, the chunk and sign boundaries (0, 65535, 65536, 2^31,
2^32 - 1) and the empty bitmap; each case runs on every shape.
"""

import pickle
import types

import numpy as np
import pytest

from roaringbitmap_tpu.core import bitmap as jb
from roaringbitmap_tpu.core import containers as jc
from roaringbitmap_tpu.core import iterators as ji
from roaringbitmap_tpu.format import spec as js
from roaringbitmap_tpu_torch.core import bitmap as tb
from roaringbitmap_tpu_torch.core import containers as tc
from roaringbitmap_tpu_torch.core import iterators as ti
from roaringbitmap_tpu_torch.format import spec as ts

JAX = types.SimpleNamespace(bm=jb, C=jc, it=ji, spec=js, RB=jb.RoaringBitmap)
PORT = types.SimpleNamespace(bm=tb, C=tc, it=ti, spec=ts, RB=tb.RoaringBitmap)


def _values(shape: str) -> tuple[np.ndarray, bool]:
    """(u32 values, run_optimize?) of a named shape, from a fixed seed."""
    rng = np.random.default_rng(sum(map(ord, shape)))
    if shape == "empty":
        return np.empty(0, np.uint32), False
    if shape == "sparse":
        return rng.choice(1 << 22, 700, replace=False).astype(np.uint32), False
    if shape == "dense":
        base = rng.choice(1 << 16, 9000, replace=False)
        return np.concatenate([base, (3 << 16) + base[:5000]]).astype(np.uint32), False
    if shape == "runs":
        parts = [np.arange(s, s + n) for s, n in
                 ((10, 300), (65530, 20), (5 << 16, 1 << 16), (0x7FFFFF00, 0x200))]
        return np.concatenate(parts).astype(np.uint32), True
    if shape == "edges":
        return np.array([0, 1, 63, 64, 65535, 65536, 0x7FFFFFFF, 0x80000000,
                         0xFFFFFFFE, 0xFFFFFFFF], np.uint32), False
    # mixed: an array, a bitmap and a run container, and a top chunk
    arr = rng.choice(1 << 16, 100, replace=False)
    bmp = (1 << 16) + rng.choice(1 << 16, 6000, replace=False)
    run = (2 << 16) + np.arange(1000, 9000)
    top = 0xFFFF0000 + rng.choice(1 << 16, 50, replace=False)
    return np.concatenate([arr, bmp, run, top]).astype(np.uint32), True


SHAPES = ["empty", "sparse", "dense", "runs", "edges", "mixed"]
PARTNER = dict(zip(SHAPES, SHAPES[1:] + SHAPES[:1]))


def _build(ns, shape: str):
    vals, runs = _values(shape)
    rb = ns.RB.from_values(vals)
    if runs:
        rb.run_optimize()
    return rb


def _norm(x):
    """A package-neutral form of a result, for exact comparison."""
    if isinstance(x, (jb.RoaringBitmap, tb.RoaringBitmap)):
        return ("rb", x.serialize())
    if isinstance(x, (jc.Container, tc.Container)):
        return ("c", type(x).__name__, x.values().tolist())
    if isinstance(x, np.ndarray):
        return ("arr", str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    return x


def _outcome(fn, ns, *args):
    try:
        return _norm(fn(ns, *args))
    except Exception as e:  # the class name is part of the contract
        return ("raised", type(e).__name__)


def _mutated(method, *args):
    """A case that mutates a clone and returns (return value, clone)."""
    def run(ns, a, b):
        c = a.clone()
        ret = getattr(c, method)(*[b if x is _B else x for x in args])
        return [ret, c]
    return run


_B = object()  # stands for the partner bitmap in _mutated's arguments

PROBES = [0, 1, 64, 65535, 65536, 70000, 0x7FFFFFFF, 0x80000000,
          0xFFFFFFFF]
RANGES = [(0, 1), (5, 5), (10, 3), (65530, 65546), (0, 1 << 20),
          (0x7FFFFFF0, 0x80000010), ((1 << 32) - 5, 1 << 32), (-1, 5),
          (0, (1 << 32) + 1)]
OFFSETS = [0, 1, 63, 65536, -65536, 12345, -1, 1 << 31, -(1 << 31),
           (1 << 32) - 1]


def _walk_peekable(ns, a, b):
    it = a.get_int_iterator()
    out = []
    for target in (0, 70, 65536, 0x80000000, 0xFFFFFFFF):
        it.advance_if_needed(target)
        out.append(it.peek_next() if it.has_next() else None)
        if it.has_next():
            out.append(it.next())
    clone = it.clone()
    return [out, list(it), list(clone)]


def _walk_rank(ns, a, b):
    it = ns.it.PeekableIntRankIterator(a)
    out = []
    for target in (3, 65536, 5 << 16, 0x7FFFFF80):
        it.advance_if_needed(target)
        if it.has_next():
            out.append((it.peek_next(), it.peek_next_rank()))
    return out


def _walk_batches(ns, a, b):
    it = a.get_batch_iterator(1000)
    out = []
    if it.has_next():
        out.append(it.next_batch())
    it.advance_if_needed(65536)
    twin = it.clone()
    out.append(it.next_batch())
    it.advance_if_needed(0x80000000)
    out.append(list(it))
    out.append(twin.next_batch())
    return out


def _container_pointer(ns, a, b):
    p = a.get_container_pointer()
    out = []
    while p.has_container():
        out.append((p.key(), p.get_cardinality(), p.is_bitmap_container(),
                    p.is_run_container(), p.get_container()))
        q = p.clone()
        p.advance()
        out.append(q.key())
    out.append(p.get_container())
    return out


def _collect(method, *args):
    def run(ns, a, b):
        got = []
        getattr(a, method)(*args, lambda *v: got.append(v))
        return got
    return run


CASES = {
    "rank": lambda ns, a, b: [a.rank(x) for x in PROBES],
    "rank_long": lambda ns, a, b: [a.rank_long(x) for x in PROBES],
    "select": lambda ns, a, b: [_outcome(lambda n, j: a.select(j), ns, j)
                                for j in (0, len(a) // 2, len(a) - 1, len(a))],
    "first": lambda ns, a, b: a.first(),
    "last": lambda ns, a, b: a.last(),
    "first_signed": lambda ns, a, b: a.first_signed(),
    "last_signed": lambda ns, a, b: a.last_signed(),
    "next_value": lambda ns, a, b: [a.next_value(x) for x in PROBES],
    "previous_value": lambda ns, a, b: [a.previous_value(x) for x in PROBES],
    "next_absent_value": lambda ns, a, b: [a.next_absent_value(x) for x in PROBES],
    "previous_absent_value": lambda ns, a, b: [
        a.previous_absent_value(x) for x in PROBES],
    "contains_range": lambda ns, a, b: [
        _outcome(lambda n, r: a.contains_range(*r), ns, r) for r in RANGES],
    "intersects_range": lambda ns, a, b: [
        _outcome(lambda n, r: a.intersects_range(*r), ns, r) for r in RANGES],
    "range_cardinality": lambda ns, a, b: [
        a.range_cardinality(*r) for r in RANGES[:-2]],
    "add_range": lambda ns, a, b: [
        _outcome(_mutated("add_range", *r), ns, a, b) for r in RANGES],
    "remove_range": lambda ns, a, b: [
        _outcome(_mutated("remove_range", *r), ns, a, b) for r in RANGES],
    "flip_range": lambda ns, a, b: [
        _outcome(_mutated("flip_range", *r), ns, a, b) for r in RANGES],
    "flip_static": lambda ns, a, b: [
        _outcome(lambda n, r: n.bm.flip(a, *r), ns, r) for r in RANGES],
    "add_offset": lambda ns, a, b: [a.add_offset(o) for o in OFFSETS],
    "add_many": _mutated("add_many", np.array([7, 65535, 1 << 20, 0xFFFFFFF0],
                                              np.uint32)),
    "add_n": lambda ns, a, b: [
        _outcome(_mutated("add_n", np.arange(10, 20, dtype=np.uint32), o, n),
                 ns, a, b) for o, n in ((0, 3), (2, 0), (-1, 2), (5, 100))],
    "checked_add": lambda ns, a, b: [
        _outcome(_mutated("checked_add", x), ns, a, b) for x in PROBES],
    "checked_remove": lambda ns, a, b: [
        _outcome(_mutated("checked_remove", x), ns, a, b) for x in PROBES],
    "add_remove": lambda ns, a, b: [
        _outcome(_mutated(m, x), ns, a, b) for m in ("add", "remove")
        for x in PROBES],
    "clear": _mutated("clear"),
    "trim": _mutated("trim"),
    "iand": _mutated("iand", _B),
    "ior": _mutated("ior", _B),
    "ixor": _mutated("ixor", _B),
    "iandnot": _mutated("iandnot", _B),
    "and_not": _mutated("and_not", _B),
    "is_subset_of": lambda ns, a, b: [a.is_subset_of(b), b.is_subset_of(a),
                                      a.is_subset_of(a & b), (a & b).is_subset_of(a)],
    "intersects": lambda ns, a, b: [a.intersects(b), a.intersects(a),
                                    b.intersects(a)],
    "is_hamming_similar": lambda ns, a, b: [
        a.is_hamming_similar(b, t) for t in (0, 10, 10_000, 1 << 20)],
    "pairwise_cardinality": lambda ns, a, b: [
        f(a, b) for f in (ns.bm.and_cardinality, ns.bm.or_cardinality,
                          ns.bm.xor_cardinality, ns.bm.andnot_cardinality)],
    "or_not": lambda ns, a, b: [ns.bm.or_not(a, b, e) for e in
                                (0, 70000, 1 << 20, 0x80000001)],
    "cardinality_exceeds": lambda ns, a, b: [
        a.cardinality_exceeds(t) for t in (-1, 0, 5, len(a) - 1, len(a))],
    "limit": lambda ns, a, b: [a.limit(n) for n in (0, 1, 301, 10 ** 9)],
    "select_range": lambda ns, a, b: [
        _outcome(lambda n, r: a.select_range(*r), ns, r)
        for r in ((0, 1), (3, 700), (-1, 2), (5, 5), (len(a), len(a) + 2))],
    "for_each": _collect("for_each"),
    "for_each_in_range": lambda ns, a, b: [
        _outcome(_collect("for_each_in_range", *r), ns, a, b)
        for r in ((0, 70000), (0x7FFFFFF0, 0x80000010), (-1, 3))],
    "for_all_in_range": lambda ns, a, b: [
        _outcome(_collect("for_all_in_range", *r), ns, a, b)
        for r in ((0, 70), (65530, 65546), ((1 << 32) - 4, 1 << 32))],
    "iter": lambda ns, a, b: [list(a), list(a.get_signed_int_iterator())],
    "int_iterator": _walk_peekable,
    "rank_iterator": _walk_rank,
    "reverse_iterator": lambda ns, a, b: (
        lambda it: [list(it.clone()), list(it)])(a.get_reverse_int_iterator()),
    "batch_iterator": _walk_batches,
    "batch_iterator_sizes": lambda ns, a, b: [
        list(a.batch_iterator(n)) for n in (1, 999, 65536)],
    "container_pointer": _container_pointer,
    "sizes": lambda ns, a, b: [a.get_size_in_bytes(), a.get_long_size_in_bytes(),
                               a.serialized_size_in_bytes(),
                               ns.RB.maximum_serialized_size(len(a), 1 << 32),
                               len(a), a.long_cardinality],
    "run_compression": lambda ns, a, b: (
        lambda c: [c.has_run_compression(), c.remove_run_compression(),
                   c.has_run_compression(), c, c.run_optimize(), c])(a.clone()),
    "dunders": lambda ns, a, b: [bool(a), 65536 in a, 0xFFFFFFFF in a, repr(a)],
    "pickle": lambda ns, a, b: (lambda c: [type(c) is ns.RB, c])(
        pickle.loads(pickle.dumps(a))),
    "constructors": lambda ns, a, b: [
        ns.RB.bitmap_of_unordered(a.to_array()[::-1]),
        ns.RB.bitmap_of_range(65530, 65546)],
    "append": lambda ns, a, b: [
        _outcome(lambda n, k: a.clone().append(k, n.C.range_container(0, 5)) or 0,
                 ns, k) for k in (0, 0xFFFF, -1, 1 << 16)],
}


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_bitmap_method_matches_jax(case, shape):
    fn = CASES[case]
    want = _outcome(fn, JAX, _build(JAX, shape), _build(JAX, PARTNER[shape]))
    got = _outcome(fn, PORT, _build(PORT, shape), _build(PORT, PARTNER[shape]))
    assert got == want


def test_iterators_cover_the_jax_module():
    public = {n for n in dir(ji) if not n.startswith("__")}
    assert public <= set(dir(ti))
    missing = [n for n in dir(jb.RoaringBitmap) if not n.startswith("__")
               and n not in dir(tb.RoaringBitmap)]
    assert missing == []


def test_mutating_iteration_does_not_desync():
    for ns in (JAX, PORT):
        rb = _build(ns, "mixed")
        it = rb.get_int_iterator()
        rb.clear()
        ns.walked = list(it)
    assert PORT.walked == JAX.walked and len(PORT.walked) > 0


def test_contains_outside_universe_is_false():
    """A value outside [0, 2^32) is no member in the port (``in``,
    ``contains``, ``remove``, ``range_cardinality``), as in the reference
    Java library; the JAX package raises numpy's OverflowError there
    (ROADMAP C4, pinned in ``test_torch_packing.py``)."""
    rb = _build(PORT, "edges")
    assert [-1 in rb, (1 << 32) in rb, rb.range_cardinality(-5, 1 << 33)] == \
        [False, False, len(rb)]
    with pytest.raises(OverflowError):
        _build(JAX, "edges").contains(-1)


def test_batch_iterator_rejects_zero_batch():
    for ns in (JAX, PORT):
        with pytest.raises(ValueError):
            ns.it.RoaringBatchIterator(ns.RB.bitmap_of(1), 0)


# ----------------------------------------------------------- container helpers

def _container(ns, kind: str, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "array":
        return ns.C.from_values(np.sort(rng.choice(1 << 16, 300, replace=False))
                                .astype(np.uint16))
    if kind == "bitmap":
        return ns.C.from_values(np.sort(rng.choice(1 << 16, 9000, replace=False))
                                .astype(np.uint16))
    lo = int(rng.integers(0, 1 << 15))
    c = ns.C.range_container(lo, lo + 20000)
    return c


KINDS = ["array", "bitmap", "run"]
HELPERS = {
    "and_cardinality": lambda ns, a, b: ns.C.container_and_cardinality(a, b),
    "intersects": lambda ns, a, b: [ns.C.container_intersects(a, b),
                                    ns.C.container_intersects(a, a)],
    "is_subset": lambda ns, a, b: [ns.C.container_is_subset(a, b),
                                   ns.C.container_is_subset(a, a),
                                   ns.C.container_is_subset(
                                       ns.C.container_and(a, b), b)],
    "join_disjoint": lambda ns, a, b: ns.C.container_join_disjoint(
        ns.C.from_values(a.values()[a.values() < 30000]),
        ns.C.from_values(b.values()[b.values() >= 30000])),
    "shift": lambda ns, a, b: [ns.C.container_shift(a, s)
                               for s in (0, 1, 64, 100, 40000, 65535)],
}


@pytest.mark.parametrize("helper", sorted(HELPERS))
@pytest.mark.parametrize("kinds", [(x, y) for x in KINDS for y in KINDS])
def test_container_helper_matches_jax(helper, kinds):
    def run(ns):
        a, b = _container(ns, kinds[0], 1), _container(ns, kinds[1], 2)
        return HELPERS[helper](ns, a, b)
    assert _outcome(lambda ns: run(ns), PORT) == _outcome(lambda ns: run(ns), JAX)


def test_join_disjoint_fuses_touching_runs():
    for ns in (JAX, PORT):
        got = ns.C.container_join_disjoint(ns.C.range_container(0, 10),
                                           ns.C.range_container(10, 20))
        ns.fused = (type(got).__name__, got.runs.tolist())
    assert PORT.fused == JAX.fused == ("RunContainer", [0, 19])


# ------------------------------------------------------------------------ spec

@pytest.mark.parametrize("card,universe", [
    (0, 0), (1, 1), (10, 1 << 16), (5000, 1 << 16), (1 << 20, 1 << 32),
    (1 << 32, 1 << 32), (70000, 70000)])
def test_maximum_serialized_size_matches_jax(card, universe):
    assert ts.maximum_serialized_size(card, universe) == \
        js.maximum_serialized_size(card, universe)


@pytest.mark.parametrize("shape", SHAPES)
def test_deserialize_meta_matches_jax(shape):
    buf = _build(JAX, shape).serialize()
    assert _build(PORT, shape).serialize() == buf
    jv, tv = js.deserialize_meta(buf), ts.deserialize_meta(buf)
    for name in ("keys", "cardinalities", "is_run", "is_bitmap",
                 "payload_offsets", "payload_sizes"):
        assert np.array_equal(getattr(tv, name), getattr(jv, name)), name
    assert tv.size == jv.size and tv.serialized_end() == jv.serialized_end()
    assert len(buf) <= ts.maximum_serialized_size(len(_build(PORT, shape)), 1 << 32) \
        or shape == "runs"


@pytest.mark.parametrize("cut", [0, 3, 7, 9, 12, 40])
def test_deserialize_meta_truncation_raises_like_jax(cut):
    buf = _build(JAX, "mixed").serialize()[:cut]

    def err(spec):
        try:
            spec.deserialize_meta(buf)
        except Exception as e:
            return type(e).__name__
        return None
    assert err(ts) == err(js) == "InvalidRoaringFormat"
