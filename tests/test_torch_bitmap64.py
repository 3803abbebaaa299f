"""The port's ``Roaring64Bitmap`` (core/bitmap64) against
roaringbitmap_tpu.core.bitmap64.

The same numpy-seeded u64 values, spread over the four high-32 buckets
0, 1, 2^31 and 2^32 - 1 (so keys cross 2^32 and 2^63), build a bitmap in
each package; build, point mutation, rank/select, range ops and algebra
must agree member for member, and both serialized forms (portable and the
reference's ART stream) byte for byte.  Hostile blobs from
``utils.fuzz.mutate_serialized`` get the same verdict from both decoders:
the same bitmap, or ``InvalidRoaringFormat`` from both.  Tolerance: zero.
"""

import numpy as np
import pytest

from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
from roaringbitmap_tpu.format.spec import InvalidRoaringFormat as JBad
from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64
from roaringbitmap_tpu_torch.format.spec import InvalidRoaringFormat as TBad
from roaringbitmap_tpu_torch.utils import fuzz

BUCKETS = (0, 1, 2**31, 2**32 - 1)
EDGES = np.array([0, 2**32 - 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1],
                 np.uint64)


def _values(seed: int, n: int = 3000) -> np.ndarray:
    """Sparse, dense and run-shaped low words under each bucket, plus the
    edge values."""
    rng = np.random.default_rng(seed)
    parts = [EDGES]
    for b in BUCKETS:
        base = np.uint64(b) << np.uint64(32)
        parts.append(base | rng.integers(0, 1 << 22, n).astype(np.uint64))
        parts.append(base | (np.uint64(3 << 16) + rng.choice(
            1 << 16, 6000, replace=False).astype(np.uint64)))
        parts.append(base | np.arange(9 << 16, (9 << 16) + 70000,
                                      dtype=np.uint64))
    return np.concatenate(parts)


def _pair(seed: int):
    v = _values(seed)
    return T64.from_values(v), J64.from_values(v)


def _same(t: T64, j: J64) -> None:
    assert t.keys.dtype == np.uint64
    assert np.array_equal(t.keys, j.keys)
    assert np.array_equal(t.to_array(), j.to_array())
    assert t.serialize() == j.serialize()


def test_build_and_accessors():
    t, j = _pair(1)
    _same(t, j)
    assert t.cardinality == j.cardinality
    assert (t.first(), t.last()) == (j.first(), j.last()) == (0, 2**64 - 1)
    for x in [0, 1, 2**32, 2**63 - 1, 2**63, 2**64 - 1, (2**31 << 32) + 5,
              (1 << 32) | (9 << 16) | 100]:
        assert t.contains(x) == j.contains(x)
        assert t.rank(x) == j.rank(x)
    for r in (0, 1, 17, t.cardinality // 2, t.cardinality - 1):
        assert t.select(r) == j.select(r)
    for x in (5, 2**63 + 3, 2**64 - 2):
        assert t.next_value(x) == j.next_value(x)
        assert t.previous_value(x) == j.previous_value(x)
    assert T64.bitmap_of(*EDGES.tolist()).serialize() == \
        J64.bitmap_of(*EDGES.tolist()).serialize()
    with pytest.raises(ValueError):
        T64().first()


@pytest.mark.parametrize("start,stop", [
    (5, 70000), (2**32 - 7, 2**32 + 9), (2**63 - 3, 2**63 + 65540),
    (2**64 - 100, 2**64), (9, 3)])
def test_range_ops(start, stop):
    t, j = _pair(2)
    assert T64.from_range(start, stop).serialize() == \
        J64.from_range(start, stop).serialize()
    for name in ("add_range", "remove_range", "flip_range"):
        tt, jj = t.clone(), j.clone()
        getattr(tt, name)(start, stop)
        getattr(jj, name)(start, stop)
        _same(tt, jj)
    with pytest.raises(ValueError, match="64-bit universe"):
        T64.from_range(-1, 5)
    with pytest.raises(ValueError, match="64-bit universe"):
        T64.from_range(0, 2**64 + 1)


def test_point_mutation():
    t, j = _pair(3)
    rng = np.random.default_rng(30)
    xs = np.concatenate([EDGES, rng.integers(0, 2**64, 40, dtype=np.uint64),
                         t.to_array()[::997]])
    for i, x in enumerate(xs.tolist()):
        op = ("add", "remove", "flip")[i % 3]
        getattr(t, op)(x)
        getattr(j, op)(x)
    _same(t, j)
    assert t.run_optimize() == j.run_optimize()
    _same(t, j)
    assert t.has_run_compression() == j.has_run_compression()


def test_algebra():
    (ta, ja), (tb, jb) = _pair(4), _pair(5)
    for op in ("__and__", "__or__", "__xor__", "__sub__"):
        got, want = getattr(ta, op)(tb), getattr(ja, op)(jb)
        assert isinstance(got, T64)
        _same(got, want)
    for op in ("iand", "ior", "ixor", "iandnot"):
        tt, jj = ta.clone(), ja.clone()
        getattr(tt, op)(tb)
        getattr(jj, op)(jb)
        _same(tt, jj)
    assert (ta & tb) == T64.deserialize((ja & jb).serialize())


def test_serialized_forms_roundtrip():
    t, j = _pair(6)
    t.run_optimize()
    j.run_optimize()
    assert t.serialize_art() == j.serialize_art()
    assert t.serialized_size_in_bytes() == j.serialized_size_in_bytes() \
        == len(t.serialize())
    for blob in (t.serialize(), t.serialize_art(), J64().serialize(),
                 J64().serialize_art()):
        _same(T64.deserialize(blob), J64.deserialize(blob))
    assert T64.deserialize_art(j.serialize_art()) == t


def _verdict(cls, bad, blob):
    try:
        return cls.deserialize(blob).serialize()
    except bad:
        return "invalid"


@pytest.mark.parametrize("form", ["portable", "art"])
def test_hostile_blobs_same_verdict(form):
    """Mutations of the inner 32-bit buckets (the fuzz corpus's structured
    kinds) and of the whole stream: the same verdict from both decoders,
    and never an error other than InvalidRoaringFormat."""
    rng = np.random.default_rng(7 if form == "portable" else 8)
    t = T64.from_values(_values(9, n=400))
    t.run_optimize()
    blob = t.serialize() if form == "portable" else t.serialize_art()
    rejected = 0
    for i in range(120):
        kind = fuzz.MUTATION_KINDS[i % len(fuzz.MUTATION_KINDS)]
        if form == "portable" and i % 2 == 0:
            # the first bucket: u64 count + u32 high word, then the 32-bit
            # format, the structured kinds' target
            mutated = blob[:12] + fuzz.mutate_serialized(rng, blob[12:], kind)
        else:
            mutated = fuzz.mutate_serialized(
                rng, blob, ("truncate", "bitflip", "grow")[i % 3])
        got, want = _verdict(T64, TBad, mutated), _verdict(J64, JBad, mutated)
        assert got == want, (i, kind)
        rejected += got == "invalid"
    assert rejected > 20


def test_fuzz_decoder_hardening_matches_jax():
    """The port's fuzz corpus is the JAX package's: the same seeds reject
    the same number of mutated 32-bit blobs."""
    from roaringbitmap_tpu.utils import fuzz as jfuzz

    assert fuzz.verify_decoder_hardening(64) == \
        jfuzz.verify_decoder_hardening(64) > 0
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    blob = fuzz.random_bitmap(np.random.default_rng(4)).serialize()
    for kind in fuzz.MUTATION_KINDS:
        assert fuzz.mutate_serialized(rng_t, blob, kind) == \
            jfuzz.mutate_serialized(rng_j, blob, kind)
