"""The rest of the port's host tier held against the JAX package: the
writer, the bitset interop, the fast-rank bitmap, ``Roaring64NavigableMap``,
``RangeBitmap``'s serialized form, the insights classes, the dataset loaders
and the top-level exports.

Inputs are numpy-seeded and small.  Each case runs the same calls in both
packages and compares members, cardinalities and serialized bytes exactly,
and the class name of any raised error; serialized bytes are read in the
other package both ways.
"""

import dataclasses
import os
import pickle
import types
import zipfile

import numpy as np
import pytest

import roaringbitmap_tpu as jpkg
import roaringbitmap_tpu_torch as tpkg
from roaringbitmap_tpu.buffer import immutable as jim
from roaringbitmap_tpu.core import bitmap as jb
from roaringbitmap_tpu.core import bitmap64 as j64
from roaringbitmap_tpu.core import bitset as jbs
from roaringbitmap_tpu.core import fastrank as jfr
from roaringbitmap_tpu.core import rangebitmap as jrg
from roaringbitmap_tpu.core import writer as jw
from roaringbitmap_tpu.insights import analysis as jins
from roaringbitmap_tpu.utils import datasets as jds
from roaringbitmap_tpu_torch.buffer import immutable as tim
from roaringbitmap_tpu_torch.core import bitmap as tb
from roaringbitmap_tpu_torch.core import bitmap64 as t64
from roaringbitmap_tpu_torch.core import bitset as tbs
from roaringbitmap_tpu_torch.core import fastrank as tfr
from roaringbitmap_tpu_torch.core import rangebitmap as trg
from roaringbitmap_tpu_torch.core import writer as tw
from roaringbitmap_tpu_torch.insights import analysis as tins
from roaringbitmap_tpu_torch.utils import datasets as tds

JAX = types.SimpleNamespace(RB=jb.RoaringBitmap, b64=j64, bs=jbs,
                            FR=jfr.FastRankRoaringBitmap, rg=jrg, w=jw,
                            ins=jins, MUT=jim.MutableRoaringBitmap, ds=jds)
PORT = types.SimpleNamespace(RB=tb.RoaringBitmap, b64=t64, bs=tbs,
                             FR=tfr.FastRankRoaringBitmap, rg=trg, w=tw,
                             ins=tins, MUT=tim.MutableRoaringBitmap, ds=tds)

U64 = (1 << 64) - 1


def _norm(x):
    """A package-neutral form of a result, for exact comparison."""
    if isinstance(x, (jb.RoaringBitmap, tb.RoaringBitmap)):
        return ("rb", type(x).__name__, x.serialize())
    if isinstance(x, (j64.Roaring64NavigableMap, t64.Roaring64NavigableMap)):
        return ("nm", x.signed_longs, x.serialize_legacy())
    if isinstance(x, (j64.Roaring64Bitmap, t64.Roaring64Bitmap)):
        return ("r64", x.serialize())
    if isinstance(x, (jbs.RoaringBitSet, tbs.RoaringBitSet)):
        return ("bitset", x.to_bitmap().serialize())
    if isinstance(x, (jim.ImmutableRoaringBitmap,
                      tim.ImmutableRoaringBitmap)):
        return ("imm", x.serialize())
    if isinstance(x, (jrg.RangeBitmap, trg.RangeBitmap)):
        return ("range", x.row_count, x.max_value, x.serialize())
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return ("dc", type(x).__name__, dataclasses.asdict(x))
    if isinstance(x, np.ndarray):
        return ("arr", str(x.dtype), x.tolist())
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (np.integer, np.bool_)):
        return x.item()
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def _outcome(fn, *args):
    try:
        return _norm(fn(*args))
    except Exception as e:  # the class name is part of the contract
        return ("raised", type(e).__name__)


def _same(fn, *args):
    got, want = _outcome(fn, PORT, *args), _outcome(fn, JAX, *args)
    assert got == want
    return got


# ------------------------------------------------------------------ writer

def _stream(seed: int) -> list:
    """A seeded mix of point adds, bulk adds out of order and ranges."""
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(12):
        kind = rng.integers(3)
        if kind == 0:
            ops.append(("add", int(rng.integers(0, 1 << 22))))
        elif kind == 1:
            ops.append(("add_many", rng.integers(0, 1 << 22, 500)
                        .astype(np.uint32)))
        else:
            lo = int(rng.integers(0, 1 << 22))
            ops.append(("add_range", lo, lo + int(rng.integers(1, 70000))))
    ops.append(("add_many", np.arange(5 << 16, (5 << 16) + 3000,
                                      dtype=np.uint32)[::-1].copy()))
    return ops


WIZARDS = {
    "default": lambda wz: wz,
    "arrays": lambda wz: wz.optimise_for_arrays(),
    "runs": lambda wz: wz.optimise_for_runs(),
    "constant_memory": lambda wz: wz.constant_memory(),
    "no_run_compress": lambda wz: wz.run_compress(False),
    "fast_rank": lambda wz: wz.fast_rank(),
    "sorted": lambda wz: wz.partially_sort_values().do_partial_radix_sort(),
    "sized": lambda wz: wz.initial_capacity(64).expected_container_size(9)
    .expected_range(0, 1 << 22).expected_density(0.25),
    "constant_fast_rank": lambda wz: wz.constant_memory().fast_rank()
    .run_compress(False),
}


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("wizard", sorted(WIZARDS))
def test_writer_matches_jax(wizard, seed):
    def run(ns):
        w = WIZARDS[wizard](ns.w.RoaringBitmapWriter.wizard()).get()
        seen = []
        for op in _stream(seed):
            getattr(w, op[0])(*op[1:])
            seen.append(w.get_underlying().cardinality)
        out = w.get()
        knobs = [w.constant_memory, w.optimize_for_runs, w.partially_sort,
                 w.run_compress, w.expected_container_size,
                 w.initial_capacity, w.expected_range]
        w.reset()
        w.add(7)
        return [seen, out, knobs, w.get(), ns.w.RoaringBitmapWriter.writer()
                .get().get()]

    _same(run)


def test_writer_constant_memory_key_revisit():
    def run(ns):
        w = ns.w.RoaringBitmapWriter.wizard().constant_memory().get()
        for v in (5, 70000, 6, 1 << 20, 70001, 4):
            w.add(v)
        return w.get()

    got = _same(run)
    assert got[0] == "rb"


# ------------------------------------------------------------------ bitset

def _words(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    w = rng.integers(0, 1 << 63, 2100, dtype=np.uint64)
    w[rng.random(2100) < 0.6] = 0
    w[-1] = np.uint64(1) << np.uint64(63)
    return w


@pytest.mark.parametrize("seed", [3, 4])
def test_bitset_util_matches_jax(seed):
    words = _words(seed)
    mask = np.random.default_rng(seed).random(150_000) < 0.1

    def run(ns):
        rb = ns.bs.bitmap_of_words(words)
        return [rb, ns.bs.bitmap_of_words(np.zeros(0, np.uint64)),
                ns.bs.bitmap_of_bool_array(mask), ns.bs.bitset_of(rb),
                ns.bs.bitset_of(rb, 3000),
                _outcome(lambda: ns.bs.bitset_of(rb, 10)),
                ns.bs.bitset_of(ns.RB(), 4), ns.bs.bool_array_of(rb),
                ns.bs.bool_array_of(rb, 1000), ns.bs.BLOCK_LENGTH]

    _same(run)


@pytest.mark.parametrize("seed", [5, 6, 7])
def test_roaring_bitset_matches_jax(seed):
    """A seeded sequence of every RoaringBitSet call, each call's outcome
    compared (the randomized model test of the JAX suite, held between
    the packages)."""
    rng = np.random.default_rng(seed)
    calls = []
    for _ in range(120):
        a = int(rng.integers(0, 200_000))
        b = a + int(rng.integers(0, 70_000))
        calls.append((int(rng.integers(12)), a, b))

    def run(ns):
        s = ns.bs.RoaringBitSet()
        o = ns.bs.RoaringBitSet.value_of(_words(seed)[:40])
        out = []
        for kind, a, b in calls:
            if kind == 0:
                s.set(a)
            elif kind == 1:
                s.set(a, b)
            elif kind == 2:
                s.set(a, bool(b & 1))
            elif kind == 3:
                s.clear(a) if b & 1 else s.clear(a, b)
            elif kind == 4:
                s.flip(a) if b & 1 else s.flip(a, b)
            elif kind == 5:
                getattr(s, ("and_", "or_", "xor", "and_not")[b % 4])(o)
            elif kind == 6:
                out.append([s.next_set_bit(a), s.next_clear_bit(a),
                            s.previous_set_bit(a), s.previous_clear_bit(a),
                            s.previous_set_bit(-1), s[a], s.get(b)])
            elif kind == 7:
                out.append([s.cardinality(), s.is_empty(), s.length(),
                            s.size(), s.intersects(o), s == o, repr(s)])
            elif kind == 8:
                out.append([s.stream(), s.to_word_array(), s.to_bitmap()])
            elif kind == 9:
                s.set(a, b, False)
            elif kind == 10:
                out.append(hash(s) == hash(ns.bs.RoaringBitSet(
                    s.to_bitmap().clone())))
            else:
                s.clear() if b % 7 == 0 else None
        return [out, s]

    _same(run)


# -------------------------------------------------------------- fast rank

@pytest.mark.parametrize("seed", [8, 9])
def test_fast_rank_matches_jax(seed):
    rng = np.random.default_rng(seed)
    vals = np.unique(rng.integers(0, 1 << 24, 20_000)).astype(np.uint32)
    probes = [0, 1, 65535, 65536, 1 << 23, (1 << 24) + 5] + \
        [int(v) for v in vals[::997]]

    def run(ns):
        fr = ns.FR.from_values(vals)
        out = [isinstance(fr, ns.RB), fr.cache_valid]
        out.append([fr.rank(x) for x in probes])
        out.append([_outcome(fr.select, j) for j in (0, 5, vals.size - 1,
                                                     vals.size)])
        out.append(fr.cache_valid)
        for mut, args in (("add", (7,)), ("remove", (int(vals[3]),)),
                          ("add_many", (np.arange(10, 90, dtype=np.uint32),)),
                          ("add_range", (1 << 25, (1 << 25) + 70000)),
                          ("remove_range", (0, 5000)),
                          ("flip_range", (65530, 65550)),
                          ("ior", (ns.RB.bitmap_of(1, 2, 3),)),
                          ("iand", (ns.RB.from_range(0, 1 << 26),)),
                          ("ixor", (ns.RB.bitmap_of(1, 9),)),
                          ("iandnot", (ns.RB.bitmap_of(2),)),
                          ("run_optimize", ())):
            getattr(fr, mut)(*args)
            out.append([mut, fr.cache_valid, fr.rank(1 << 24), fr.select(3)])
        fr.append(1 << 15, ns.RB.bitmap_of(5).containers[0])
        out.append([fr.cache_valid, fr.rank(1 << 31), fr])
        fr.clear()
        out.append([fr.cache_valid, fr.rank(5), pickle.loads(
            pickle.dumps(fr))])
        return out

    _same(run)


# ------------------------------------------------- Roaring64NavigableMap

def _u64(seed: int, n: int = 3000) -> np.ndarray:
    rng = np.random.default_rng(seed)
    highs = np.array([0, 1, 7, 1 << 31, (1 << 32) - 1], np.uint64)
    v = (highs[rng.integers(0, highs.size, n)] << np.uint64(32)) | \
        rng.integers(0, 1 << 32, n, dtype=np.uint64)
    v[:200] = (np.uint64(1) << np.uint64(40)) + np.arange(200, dtype=np.uint64)
    return np.unique(v)


NM_CASES = {
    "accessors": lambda ns, a, b, v: [
        a.cardinality, len(a), a.is_empty(), a.to_array(), list(a)[:50],
        [int(x) in a for x in v[::211]], [a.contains(x) for x in
                                         (0, 5, U64, 1 << 63)],
        _outcome(a.first), _outcome(a.last), a.long_cardinality,
        _outcome(lambda: a.int_cardinality), a.get_size_in_bytes(),
        a.get_long_size_in_bytes(), repr(a)],
    "rank_select": lambda ns, a, b, v: [
        [a.rank(int(x)) for x in v[::97]] + [a.rank(0), a.rank(U64)],
        [_outcome(a.select, j) for j in (0, 3, len(v) // 2, len(v) - 1,
                                         len(v))]],
    "algebra": lambda ns, a, b, v: [
        (lambda c: (getattr(c, m)(b), c)[1])(
            ns.b64.Roaring64NavigableMap.deserialize_legacy(
                a.serialize_legacy()))
        for m in ("ior", "iand", "ixor", "iandnot", "and_not",
                  "naive_lazy_or")],
    "mutation": lambda ns, a, b, v: (lambda c: [
        c.add(5), c.add_long(1 << 63), c.add_int(-1 & 0xFFFFFFFF),
        c.remove(int(v[0])), c.remove(123), c.flip(9), c.flip(9),
        c.add_range((1 << 33) - 100, (1 << 33) + 200), c.add_range(5, 5),
        c.run_optimize(), c.trim(), c.repair_after_lazy(), c])(
        ns.b64.Roaring64NavigableMap.from_values(v, a.signed_longs)),
    "iteration": lambda ns, a, b, v: [
        list(a.get_long_iterator())[-40:],
        list(a.get_reverse_long_iterator())[:40],
        (lambda seen: (a.for_each(seen.append), seen[:40])[1])([]),
        a.limit(0), a.limit(301), a.limit(1 << 40)],
    "serialize": lambda ns, a, b, v: [
        a.serialize_legacy(), a.serialize_portable(),
        a.serialize(), a.serialize(ns.b64.SERIALIZATION_MODE_PORTABLE),
        a.serialized_size_in_bytes(),
        a.serialized_size_in_bytes(ns.b64.SERIALIZATION_MODE_LEGACY),
        a.serialized_size_in_bytes(ns.b64.SERIALIZATION_MODE_PORTABLE)],
    "roaring64": lambda ns, a, b, v: [
        a.to_roaring64(), ns.b64.Roaring64NavigableMap.from_roaring64(
            a.to_roaring64(), True),
        ns.b64.Roaring64NavigableMap.deserialize_portable(
            a.to_roaring64().serialize())],
    "equality": lambda ns, a, b, v: [a == b, a == a, hash(a) == hash(
        ns.b64.Roaring64NavigableMap.from_values(v, a.signed_longs))],
    "pickle": lambda ns, a, b, v: pickle.loads(pickle.dumps(a)),
    "bitmap_of": lambda ns, a, b, v: ns.b64.Roaring64NavigableMap.bitmap_of(
        5, 1 << 40, U64, 5),
}


@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("case", sorted(NM_CASES))
def test_navigable_map_matches_jax(case, signed):
    va, vb = _u64(10), _u64(11)

    def run(ns):
        a = ns.b64.Roaring64NavigableMap.from_values(va, signed)
        b = ns.b64.Roaring64NavigableMap.from_values(vb, signed)
        return NM_CASES[case](ns, a, b, va)

    _same(run)


@pytest.mark.parametrize("signed", [False, True])
def test_navigable_map_bytes_both_ways(signed):
    """Legacy and portable bytes of each package deserialize in the other,
    byte-equal on the way back; the module-wide mode picks the default
    form in both."""
    v = _u64(12)
    for src, dst in ((JAX, PORT), (PORT, JAX)):
        nm = src.b64.Roaring64NavigableMap.from_values(v, signed)
        for ser, de in (("serialize_legacy", "deserialize_legacy"),
                        ("serialize_portable", "deserialize_portable")):
            blob = getattr(nm, ser)()
            back = getattr(dst.b64.Roaring64NavigableMap, de)(blob)
            assert getattr(back, ser)() == blob
            assert sorted(back.to_array().tolist()) == v.tolist()
        mode = dst.b64.SERIALIZATION_MODE_PORTABLE
        assert dst.b64.Roaring64NavigableMap.deserialize(
            nm.serialize_portable(), mode).serialize(mode) == \
            nm.serialize_portable()
    for ns in (JAX, PORT):
        nm = ns.b64.Roaring64NavigableMap.from_values(v)
        old = ns.b64.SERIALIZATION_MODE
        try:
            ns.b64.SERIALIZATION_MODE = ns.b64.SERIALIZATION_MODE_PORTABLE
            assert nm.serialize() == nm.serialize_portable()
            assert nm.serialized_size_in_bytes() == len(nm.serialize())
        finally:
            ns.b64.SERIALIZATION_MODE = old
        assert nm.serialize() == nm.serialize_legacy()


def _nm_corruptions() -> list:
    nm = j64.Roaring64NavigableMap.from_values(_u64(13, 400))
    leg, port = nm.serialize_legacy(), nm.serialize_portable()
    out = [("legacy", leg[:c]) for c in (0, 4, 5, 8, 30, len(leg) - 1)]
    out += [("portable", port[:c]) for c in (0, 7, 8, 11, 40, len(port) - 1)]
    out.append(("legacy", b"\x00\xff\xff\xff\xff"))   # a negative count
    return out


@pytest.mark.parametrize("fmt,blob", _nm_corruptions())
def test_navigable_map_corrupt_bytes_raise_like_jax(fmt, blob):
    _same(lambda ns: getattr(ns.b64.Roaring64NavigableMap,
                             f"deserialize_{fmt}")(blob))


@pytest.mark.parametrize("supplier", ["fast_rank", "mutable"])
def test_navigable_map_supplier_matches_jax(supplier):
    v = _u64(14, 2000)

    def run(ns):
        cls = ns.FR if supplier == "fast_rank" else ns.MUT
        nm = ns.b64.Roaring64NavigableMap.from_values(v, supplier=cls)
        nm.add((1 << 52) + 5)
        nm.add_range(1 << 50, (1 << 50) + 10)
        back = pickle.loads(pickle.dumps(nm))
        return [sorted(type(b).__name__ for b in nm._map.values()),
                nm.select(17), nm.rank(int(v[0])), nm.serialize_portable(),
                sorted(type(b).__name__ for b in back._map.values()),
                back, nm.limit(50)]

    _same(run)


# ------------------------------------------------ RangeBitmap serialization

RANGE_VALUES = {
    "zero": lambda rng: np.zeros(100, np.uint64),
    "small": lambda rng: rng.integers(0, 1000, 5000).astype(np.uint64),
    "contiguous": lambda rng: np.arange(70_000, dtype=np.uint64),
    "wide": lambda rng: rng.integers(0, 1 << 40, 140_000).astype(np.uint64),
    "constant": lambda rng: np.full(66_000, 12345, np.uint64),
    "runs": lambda rng: np.repeat(rng.integers(0, 1 << 20, 40), 3000)
    .astype(np.uint64),
}


@pytest.mark.parametrize("name", sorted(RANGE_VALUES))
def test_rangebitmap_serialization_matches_jax(name):
    values = RANGE_VALUES[name](np.random.default_rng(len(name)))
    probes = sorted({0, 1, int(values.max()), int(values.max()) // 3,
                     int(values[len(values) // 2]), int(values.max()) + 1})

    def queries(rb):
        out = []
        for p in probes:
            out.append([rb.lte(p), rb.lt(p), rb.gte(p), rb.gt(p), rb.eq(p),
                        rb.neq(p), rb.lte_cardinality(p)])
        out.append(rb.between(probes[1], probes[-2]))
        return out

    def run(ns):
        app = ns.rg.RangeBitmap.appender(int(values.max()))
        app.add_many(values)
        size = app.serialized_size_in_bytes()
        blob = app.serialize()
        rb = app.build()
        mapped = ns.rg.RangeBitmap.map(blob)
        return [size, blob, rb.serialize(), rb.serialized_size_in_bytes(),
                mapped.row_count, mapped.max_value, mapped.serialize() == blob,
                queries(mapped)]

    got = _same(run)
    # the port's vectorized build serializes as the appender's
    assert PORT.rg.RangeBitmap.from_values(values).serialize() == got[1]
    # a mapped RangeBitmap answers as the built one, in both directions
    jblob, tblob = [ns.rg.RangeBitmap.from_values(values).serialize()
                    if ns is PORT else _jax_range(values).serialize()
                    for ns in (JAX, PORT)]
    assert jblob == tblob == got[1]
    tm, jm = PORT.rg.RangeBitmap.map(jblob), JAX.rg.RangeBitmap.map(tblob)
    assert _norm(queries(tm)) == _norm(queries(jm)) == got[7]


def _jax_range(values):
    app = jrg.RangeBitmap.appender(int(values.max()))
    app.add_many(values)
    return app.build()


def test_rangebitmap_appender_cache_and_clear():
    def run(ns):
        app = ns.rg.RangeBitmap.appender(1 << 20)
        app.add(5)
        a = app.serialize()
        app.add_many(np.arange(1000, dtype=np.uint64))
        b = app.serialize()
        app.clear()
        app.add(7)
        return [a, b, app.serialize(), app.serialized_size_in_bytes()]

    _same(run)


def _range_corruptions() -> list:
    blob = _jax_range(np.random.default_rng(3).integers(
        0, 5000, 70_000).astype(np.uint64)).serialize()
    out = [(f"cut{c}", blob[:c]) for c in (0, 9, 10, 13, 20, 40, 3000,
                                           len(blob) - 1)]
    bad = bytearray(blob)
    bad[0] ^= 0xFF
    out.append(("cookie", bytes(bad)))
    bad = bytearray(blob)
    bad[2] = 10
    out.append(("base", bytes(bad)))
    bad = bytearray(blob)
    bad[14] = 9
    out.append(("record type", bytes(bad)))
    return out


@pytest.mark.parametrize("label,blob", _range_corruptions(),
                         ids=[c[0] for c in _range_corruptions()])
def test_rangebitmap_map_rejects_like_jax(label, blob):
    _same(lambda ns: (lambda rb: [rb.row_count, rb.lte(100)])(
        ns.rg.RangeBitmap.map(blob)))


# ---------------------------------------------------------------- insights

def _insight_inputs(ns):
    rng = np.random.default_rng(21)
    arr = ns.RB.from_values(rng.integers(0, 1 << 20, 300).astype(np.uint32))
    dense = ns.RB.from_values(rng.integers(0, 1 << 17, 60_000)
                              .astype(np.uint32))
    runs = ns.RB.from_range(0, 1 << 18)
    runs.run_optimize()
    mixed = arr | dense | ns.RB.from_range(1 << 21, (1 << 21) + 9000)
    mixed.run_optimize()
    return [ns.RB(), arr, dense, runs, mixed]


def test_insights_match_jax():
    def run(ns):
        A, NW = ns.ins.BitmapAnalyser, ns.ins.NaiveWriterRecommender
        bms = _insight_inputs(ns)
        stats = [A.analyse(b) for b in bms]
        total = A.analyse_all(bms)
        return [stats, total, ns.ins.analyse(bms[1]),
                [s.container_count() for s in stats],
                [s.container_fraction(s.bitmap_containers_count)
                 for s in stats],
                [s.array_stats.average_cardinality() for s in stats],
                [NW.recommend(s) for s in stats], NW.recommend(total),
                [NW.recommend_for(b) for b in bms],
                stats[1].merge(stats[2])]

    _same(run)


# ---------------------------------------------------------------- datasets

def test_dataset_loaders_match_jax(tmp_path, monkeypatch):
    """The loaders over a seeded zip written in the reference's layout, read
    by both packages (the real zips are not in the repository)."""
    rng = np.random.default_rng(22)
    real = tmp_path / "real-roaring-dataset"
    real.mkdir()
    arrays = [np.unique(rng.integers(0, 1 << 24, 400)) for _ in range(5)]
    with zipfile.ZipFile(real / "census1881.zip", "w") as z:
        for i, a in enumerate(arrays):
            z.writestr(f"b{i}.txt", ",".join(map(str, a)) + "\n")
    ranges = tmp_path / "random-generated-data"
    ranges.mkdir()
    with zipfile.ZipFile(ranges / "random_range.zip", "w") as z:
        z.writestr("r.txt", "1:5,10:20\n\n7:9\n")
    for ns in (JAX, PORT):
        monkeypatch.setattr(ns.ds, "REFERENCE_DATASET_DIR", str(real))
        monkeypatch.setattr(ns.ds, "RANGE_DATASET_ZIP",
                            str(ranges / "random_range.zip"))

    def run(ns):
        return [ns.ds.has_dataset("census1881"), ns.ds.has_dataset("none"),
                os.path.basename(ns.ds.dataset_path("census1881")),
                ns.ds.load_value_arrays("census1881"),
                ns.ds.load_bitmaps("census1881"),
                ns.ds.fetch_bit_positions("census1881"),
                ns.ds.has_range_dataset(), ns.ds.load_range_arrays(),
                list(ns.ds.AVAILABLE)]

    got = _same(run)
    assert got[0] is True and len(got[3]) == 5


@pytest.mark.skipif(not tds.has_dataset("census1881"),
                    reason="the real-roaring-dataset zips are not in the "
                           "repository")
def test_real_census1881_matches_jax():
    bms = tds.load_bitmaps("census1881")
    assert [b.serialize() for b in bms] == [
        b.serialize() for b in jds.load_bitmaps("census1881")]


# ----------------------------------------------------------------- exports

def test_top_level_exports_match_jax():
    """Every name the JAX package exports, the port exports too, as the
    same kind of object under the same class name."""
    missing = [n for n in jpkg.__all__ if n not in tpkg.__all__]
    assert missing == []
    for name in jpkg.__all__:
        j, t = getattr(jpkg, name), getattr(tpkg, name)
        assert type(j) is type(t) or (callable(j) and callable(t)), name
        if isinstance(j, type):
            assert j.__name__ == t.__name__
    assert tpkg.and_not is tpkg.andnot
    assert tpkg.and_not_cardinality is tpkg.andnot_cardinality


def test_host_modules_cover_the_jax_modules():
    for jmod, tmod in ((jw, tw), (jbs, tbs), (jfr, tfr)):
        public = [n for n in dir(jmod) if not n.startswith("_")
                  and n not in ("annotations",)]
        assert [n for n in public if not hasattr(tmod, n)] == [], jmod
    for jcls, tcls in ((jw.RoaringBitmapWriter, tw.RoaringBitmapWriter),
                       (jw.Wizard, tw.Wizard),
                       (jbs.RoaringBitSet, tbs.RoaringBitSet),
                       (jfr.FastRankRoaringBitmap, tfr.FastRankRoaringBitmap),
                       (j64.Roaring64NavigableMap, t64.Roaring64NavigableMap),
                       (jrg.RangeBitmap, trg.RangeBitmap),
                       (jrg.Appender, trg.Appender)):
        assert [n for n in dir(jcls) if n not in dir(tcls)] == [], jcls
    for name in ("BitmapAnalyser", "BitmapStatistics", "ArrayContainersStats",
                 "NaiveWriterRecommender", "analyse"):
        assert hasattr(tins, name)
    for name in ("dataset_path", "has_dataset", "load_value_arrays",
                 "load_bitmaps", "load_range_arrays", "has_range_dataset",
                 "fetch_bit_positions", "synthetic_bitmaps"):
        assert hasattr(tds, name)


@pytest.mark.parametrize("size", [0xFFFF, 0x10001, 100_000])
def test_rangebitmap_contiguous_values_multi_chunk(size):
    """Contiguous column values across the 2^16-row chunk boundary (the
    reference's testInsertContiguousValues), serialized and mapped in both
    packages, every threshold form at decade points."""
    def run(ns):
        app = ns.rg.RangeBitmap.appender(size)
        app.add_many(np.arange(size, dtype=np.uint64))
        blob = app.serialize()
        out = [blob]
        for rb in (app.build(), ns.rg.RangeBitmap.map(blob)):
            p = 1
            while p < size:
                out.append([rb.lte(p), rb.lt_cardinality(p), rb.gte(p),
                            rb.gt(p), rb.eq(p)])
                p *= 10
        return out

    _same(run)


def test_rangebitmap_edges_match_jax():
    """An empty appender, a column of zeros over two chunks (every
    complement full: run records), and the JAX suite's reference-layout
    mix (uniform, a constant tail, small values)."""
    rng = np.random.default_rng(42)
    mix = np.concatenate([rng.integers(0, 1 << 20, 70000, dtype=np.uint64),
                          np.full(5000, 12345, dtype=np.uint64),
                          rng.integers(0, 64, 8000, dtype=np.uint64)])

    def run(ns):
        out = []
        for values, mx in ((np.zeros(0, np.uint64), 10),
                           (np.zeros(70000, np.uint64), 100),
                           (mix, int(mix.max()))):
            app = ns.rg.RangeBitmap.appender(mx)
            app.add_many(values)
            blob = app.serialize()
            m = ns.rg.RangeBitmap.map(blob)
            out.append([blob, m.row_count, m.lte(0), m.gt(0),
                        m.lt_cardinality(mx), m.between(100, 12345)])
        return out

    _same(run)


def test_pickle_round_trips_every_class_like_jax():
    """Every serializable host class round-trips through pickle to the same
    class and bytes in both packages."""
    rng = np.random.default_rng(6)
    v32 = np.unique(rng.integers(0, 1 << 22, 5000)).astype(np.uint32)
    v64 = rng.integers(0, 1 << 44, 3000, dtype=np.uint64)

    def run(ns, jim_or_tim):
        rb = ns.RB.from_values(v32)
        rb.run_optimize()
        objs = [rb, ns.FR(rb.keys, rb.containers), ns.MUT(rb.keys,
                                                          rb.containers),
                jim_or_tim.ImmutableRoaringBitmap(rb.serialize()),
                ns.b64.Roaring64Bitmap.from_values(v64),
                ns.b64.Roaring64NavigableMap.from_values(v64, True)]
        return [[type(b).__name__, b] for b in
                (pickle.loads(pickle.dumps(o)) for o in objs)]

    got = _outcome(run, PORT, tim)
    assert got == _outcome(run, JAX, jim)
    assert got[5][1][1] is True      # the signed order survives


def test_navigable_map_with_itself_matches_jax():
    """Self-ops on one navigable map (the reference's testWithYourself)."""
    def run(ns):
        out = []
        for m in ("ior", "ixor", "iand", "iandnot"):
            b = ns.b64.Roaring64NavigableMap.bitmap_of(*range(1, 11),
                                                       1 << 40)
            b.run_optimize()
            getattr(b, m)(b)
            out.append(b)
        return out

    _same(run)
