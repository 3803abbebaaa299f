"""Host-side container model (NumPy): the oracle and the point-op data plane.

The 32-bit universe is cut into 2^16 chunks of 2^16 values, and each chunk
is stored as one of three container kinds (the reference's
ArrayContainer / BitmapContainer / RunContainer):

- ArrayContainer: sorted u16 values, cardinality <= 4096
- BitmapContainer: 1024 x u64 words
- RunContainer: interleaved (start, length-1) u16 pairs

Containers are thin wrappers over NumPy arrays, and the pairwise ops the host
fold needs are vectorized word algebra (densify -> bitwise -> normalize).
This is the port's own copy of ``roaringbitmap_tpu.core.containers`` (point
ops, rank/select, run optimization, range containers, the pairwise algebra
and the subset, intersection and shift helpers of ``core.bitmap``), so that
the port never imports the JAX package.
"""

from __future__ import annotations

import numpy as np

#: Promotion boundary: a non-run container with cardinality <= this is an
#: array of u16, above it a 1024-word bitmap.
ARRAY_MAX_SIZE = 4096

#: Words per dense container: 2^16 bits / 64.
WORDS_PER_CONTAINER = 1024

_BIT_COUNT_TABLE = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def popcount_words(words: np.ndarray) -> int:
    """Total set-bit count of a u64 word array."""
    return int(_BIT_COUNT_TABLE[words.view(np.uint8)].sum())


def values_to_words(values: np.ndarray) -> np.ndarray:
    """Sorted u16 values -> dense u64[1024] chunk bitmap (LSB-first)."""
    bits = np.zeros(1 << 16, dtype=np.uint8)
    bits[values.astype(np.int64)] = 1
    return np.packbits(bits, bitorder="little").view(np.uint64)


def words_to_values(words: np.ndarray) -> np.ndarray:
    """Dense u64[1024] chunk bitmap -> sorted u16 values.  Only the nonzero
    words are unpacked: an array container's at most 4,096 values touch at
    most that many of the 1,024 words."""
    nz = np.flatnonzero(words)
    bits = np.unpackbits(words[nz].view(np.uint8),
                         bitorder="little").reshape(-1, 64)
    word, bit = np.nonzero(bits)
    return (nz[word] * 64 + bit).astype(np.uint16)


def runs_to_values(runs: np.ndarray) -> np.ndarray:
    """Interleaved (start, length-1) u16 pairs -> sorted u16 values.

    A run (s, l) covers [s, s+l] inclusive.
    """
    if runs.size == 0:
        return np.empty(0, dtype=np.uint16)
    starts = runs[0::2].astype(np.int64)
    lens = runs[1::2].astype(np.int64) + 1
    out = np.empty(int(lens.sum()), dtype=np.int64)
    # vectorized multi-arange: offsets within each run
    ends = np.cumsum(lens)
    out[:] = 1
    out[0] = starts[0]
    out[ends[:-1]] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    return np.cumsum(out).astype(np.uint16)


def values_to_runs(values: np.ndarray) -> np.ndarray:
    """Sorted u16 values -> interleaved (start, length-1) u16 run pairs."""
    if values.size == 0:
        return np.empty(0, dtype=np.uint16)
    v = values.astype(np.int64)
    breaks = np.flatnonzero(np.diff(v) != 1)
    starts = np.concatenate(([0], breaks + 1))
    stops = np.concatenate((breaks, [v.size - 1]))
    runs = np.empty(2 * starts.size, dtype=np.uint16)
    runs[0::2] = v[starts].astype(np.uint16)
    runs[1::2] = (v[stops] - v[starts]).astype(np.uint16)
    return runs


def number_of_runs(values: np.ndarray) -> int:
    """Run count of a sorted value list (RunContainer sizing heuristic input)."""
    if values.size == 0:
        return 0
    return int(np.count_nonzero(np.diff(values.astype(np.int64)) != 1)) + 1


class Container:
    """Abstract chunk of up to 2^16 values. Subclasses wrap one NumPy array."""

    __slots__ = ()

    @property
    def cardinality(self) -> int:
        raise NotImplementedError

    def values(self) -> np.ndarray:
        """Sorted u16 member values."""
        raise NotImplementedError

    def words(self) -> np.ndarray:
        """Dense u64[1024] word image."""
        raise NotImplementedError

    def is_run(self) -> bool:
        return isinstance(self, RunContainer)

    def serialized_size_in_bytes(self) -> int:
        """Payload byte size in the portable format."""
        raise NotImplementedError

    def write_payload(self, out: bytearray) -> None:
        raise NotImplementedError

    def contains(self, x: int) -> bool:
        raise NotImplementedError

    def add(self, x: int) -> "Container":
        v = self.values()
        i = int(np.searchsorted(v, np.uint16(x)))
        if i < v.size and v[i] == x:
            return self
        return from_values(np.insert(v, i, np.uint16(x)))

    def remove(self, x: int) -> "Container":
        v = self.values()
        i = int(np.searchsorted(v, np.uint16(x)))
        if i >= v.size or v[i] != x:
            return self
        return from_values(np.delete(v, i))

    def rank(self, x: int) -> int:
        """Number of members <= x (Container.rank)."""
        return int(np.searchsorted(self.values(), np.uint16(x), side="right"))

    def select(self, j: int) -> int:
        """j-th smallest member (0-based)."""
        return int(self.values()[j])

    def first(self) -> int:
        return int(self.values()[0])

    def last(self) -> int:
        return int(self.values()[-1])

    def run_optimize(self) -> "Container":
        """Pick the smallest of run/array/bitmap encodings.

        Reference: Container.runOptimize via RunContainer sizing
        (RunContainer.java toEfficientContainer / serializedSizeInBytes).
        """
        vals = self.values()
        card = vals.size
        n_runs = number_of_runs(vals)
        size_as_run = 2 + 4 * n_runs  # RunContainer payload (:78-80): u16 count + u16 pairs
        if card <= ARRAY_MAX_SIZE:
            size_now = 2 * card
        else:
            size_now = 8 * WORDS_PER_CONTAINER
        if size_as_run < size_now:
            return RunContainer(values_to_runs(vals))
        if isinstance(self, RunContainer):
            return from_values(vals)
        return self


class ArrayContainer(Container):
    __slots__ = ("_values",)

    def __init__(self, values: np.ndarray):
        self._values = np.ascontiguousarray(values, dtype=np.uint16)

    @property
    def cardinality(self) -> int:
        return int(self._values.size)

    def values(self) -> np.ndarray:
        return self._values

    def words(self) -> np.ndarray:
        return values_to_words(self._values)

    def serialized_size_in_bytes(self) -> int:
        return 2 * self.cardinality

    def write_payload(self, out: bytearray) -> None:
        out += self._values.astype("<u2").tobytes()

    def contains(self, x: int) -> bool:
        i = np.searchsorted(self._values, np.uint16(x))
        return i < self._values.size and self._values[i] == x


class BitmapContainer(Container):
    __slots__ = ("_words", "_card")

    def __init__(self, words: np.ndarray, cardinality: int | None = None):
        self._words = np.ascontiguousarray(words, dtype=np.uint64)
        self._card = popcount_words(self._words) if cardinality is None else int(cardinality)

    @property
    def cardinality(self) -> int:
        return self._card

    def values(self) -> np.ndarray:
        return words_to_values(self._words)

    def words(self) -> np.ndarray:
        return self._words

    def serialized_size_in_bytes(self) -> int:
        return 8 * WORDS_PER_CONTAINER

    def write_payload(self, out: bytearray) -> None:
        out += self._words.astype("<u8").tobytes()

    def contains(self, x: int) -> bool:
        return bool((int(self._words[x >> 6]) >> (x & 63)) & 1)

    def add(self, x: int) -> "Container":
        w = int(self._words[x >> 6])
        bit = 1 << (x & 63)
        if w & bit:
            return self
        words = self._words.copy()
        words[x >> 6] = np.uint64(w | bit)
        return BitmapContainer(words, self._card + 1)

    def remove(self, x: int) -> "Container":
        w = int(self._words[x >> 6])
        bit = 1 << (x & 63)
        if not (w & bit):
            return self
        words = self._words.copy()
        words[x >> 6] = np.uint64(w & ~bit)
        if self._card - 1 <= ARRAY_MAX_SIZE:  # demote (BitmapContainer.remove)
            return ArrayContainer(words_to_values(words))
        return BitmapContainer(words, self._card - 1)


class RunContainer(Container):
    __slots__ = ("_runs",)

    def __init__(self, runs: np.ndarray):
        self._runs = np.ascontiguousarray(runs, dtype=np.uint16)

    @property
    def n_runs(self) -> int:
        return self._runs.size // 2

    @property
    def runs(self) -> np.ndarray:
        return self._runs

    @property
    def cardinality(self) -> int:
        return int(self._runs[1::2].astype(np.int64).sum()) + self.n_runs

    def values(self) -> np.ndarray:
        return runs_to_values(self._runs)

    def words(self) -> np.ndarray:
        return values_to_words(self.values())

    def serialized_size_in_bytes(self) -> int:
        # u16 run count + (start, len) u16 pairs
        return 2 + 4 * self.n_runs

    def write_payload(self, out: bytearray) -> None:
        out += np.uint16(self.n_runs).astype("<u2").tobytes()
        out += self._runs.astype("<u2").tobytes()

    def contains(self, x: int) -> bool:
        starts = self._runs[0::2]
        i = int(np.searchsorted(starts, np.uint16(x), side="right")) - 1
        if i < 0:
            return False
        return x <= int(starts[i]) + int(self._runs[2 * i + 1])


def from_values(values: np.ndarray) -> Container:
    """Build the canonical (array-or-bitmap) container for a sorted value set."""
    if values.size > ARRAY_MAX_SIZE:
        return BitmapContainer(values_to_words(values), int(values.size))
    return ArrayContainer(values)


def from_words(words: np.ndarray, cardinality: int | None = None) -> Container:
    card = popcount_words(words) if cardinality is None else cardinality
    if card > ARRAY_MAX_SIZE:
        return BitmapContainer(words, card)
    return ArrayContainer(words_to_values(words))


def full_container() -> Container:
    """Container holding all of [0, 65536) — RunContainer.full analog."""
    return RunContainer(np.array([0, 0xFFFF], dtype=np.uint16))


def range_container(start: int, stop: int) -> Container:
    """Container holding [start, stop) within one chunk (Container.rangeOfOnes:29)."""
    if stop - start > 2:  # run encoding is 10 bytes; array beats it below 5 values
        return RunContainer(np.array([start, stop - 1 - start], dtype=np.uint16))
    return ArrayContainer(np.arange(start, stop, dtype=np.uint16))


# ---------------------------------------------------------------------------
# Pairwise container algebra: the dense word image is the universal path
# (densify, one 1024-word bitwise op, normalize by cardinality); array x array
# stays in the sorted-set domain where NumPy's set ops are cheaper.
# ---------------------------------------------------------------------------

def container_and(a: Container, b: Container) -> Container:
    if isinstance(a, ArrayContainer) and isinstance(b, ArrayContainer):
        return ArrayContainer(np.intersect1d(a.values(), b.values(), assume_unique=True))
    if isinstance(a, ArrayContainer):
        return ArrayContainer(a.values()[_member_mask(b, a.values())])
    if isinstance(b, ArrayContainer):
        return ArrayContainer(b.values()[_member_mask(a, b.values())])
    return from_words(a.words() & b.words())


def container_or(a: Container, b: Container) -> Container:
    if isinstance(a, ArrayContainer) and isinstance(b, ArrayContainer) and \
            a.cardinality + b.cardinality <= ARRAY_MAX_SIZE:
        return ArrayContainer(np.union1d(a.values(), b.values()))
    return from_words(a.words() | b.words())


def container_xor(a: Container, b: Container) -> Container:
    if isinstance(a, ArrayContainer) and isinstance(b, ArrayContainer):
        return from_values(np.setxor1d(a.values(), b.values(), assume_unique=True))
    return from_words(a.words() ^ b.words())


def container_andnot(a: Container, b: Container) -> Container:
    if isinstance(a, ArrayContainer):
        if isinstance(b, ArrayContainer):
            return ArrayContainer(np.setdiff1d(a.values(), b.values(), assume_unique=True))
        return ArrayContainer(a.values()[~_member_mask(b, a.values())])
    return from_words(a.words() & ~b.words())


def _member_mask(c: Container, queries: np.ndarray) -> np.ndarray:
    """Boolean membership of sorted u16 queries in container c."""
    if isinstance(c, ArrayContainer):
        if c.values().size == 0:
            return np.zeros(queries.size, dtype=bool)
        idx = np.minimum(np.searchsorted(c.values(), queries), c.values().size - 1)
        return c.values()[idx] == queries
    words = c.words()
    q = queries.astype(np.int64)
    return ((words[q >> 6] >> (q & np.int64(63)).astype(np.uint64)) & np.uint64(1)).astype(bool)


def container_is_subset(a: Container, b: Container) -> bool:
    if a.cardinality > b.cardinality:
        return False
    return bool(_member_mask(b, a.values()).all())


def container_intersects(a: Container, b: Container) -> bool:
    if isinstance(a, ArrayContainer) and not isinstance(b, ArrayContainer):
        return bool(_member_mask(b, a.values()).any())
    if isinstance(b, ArrayContainer) and not isinstance(a, ArrayContainer):
        return bool(_member_mask(a, b.values()).any())
    if isinstance(a, ArrayContainer):
        return np.intersect1d(a.values(), b.values(), assume_unique=True).size > 0
    return bool(np.any(a.words() & b.words()))


def container_and_cardinality(a: Container, b: Container) -> int:
    return container_and(a, b).cardinality


def container_equals(a: Container, b: Container) -> bool:
    """Set equality: same-kind bitmaps compare words, runs compare their
    pairs, anything else compares member values."""
    if a.cardinality != b.cardinality:
        return False
    if isinstance(a, BitmapContainer) or isinstance(b, BitmapContainer):
        return bool(np.array_equal(a.words(), b.words()))
    if isinstance(a, RunContainer) and isinstance(b, RunContainer) \
            and np.array_equal(a.runs, b.runs):
        return True
    return bool(np.array_equal(a.values(), b.values()))


def container_join_disjoint(a: Container, b: Container) -> Container:
    """OR two containers where every member of a lies below every member of
    b (the carry merge of ``RoaringBitmap.add_offset``).  Run/run and
    array/array pairs concatenate without building a dense word image."""
    if isinstance(a, RunContainer) and isinstance(b, RunContainer):
        ra, rb = a.runs, b.runs
        if int(ra[-2]) + int(ra[-1]) + 1 == int(rb[0]):  # touching: fuse
            end = int(rb[0]) + int(rb[1])
            fused = np.array([end - int(ra[-2])], dtype=np.uint16)
            return RunContainer(np.concatenate([ra[:-1], fused, rb[2:]]))
        return RunContainer(np.concatenate([ra, rb]))
    if isinstance(a, ArrayContainer) and isinstance(b, ArrayContainer):
        return from_values(np.concatenate([a.values(), b.values()]))
    return container_or(a, b)


def container_shift(c: Container, inoff: int) -> tuple[Container | None,
                                                       Container | None]:
    """Shift a container's values up by ``inoff`` in [0, 65536), split at the
    chunk boundary: ``(low, high)``, low the values still below 2^16, high
    the overflow less 2^16; either is None when empty.  Bitmap and run
    containers shift as words and runs, never as value arrays."""
    if inoff == 0:
        return (c if c.cardinality else None), None
    if isinstance(c, BitmapContainer):
        words = c.words()
        w, s = inoff >> 6, inoff & 63
        out = np.zeros(2 * WORDS_PER_CONTAINER, dtype=np.uint64)
        if s == 0:
            out[w:w + WORDS_PER_CONTAINER] = words
        else:
            out[w:w + WORDS_PER_CONTAINER] = words << np.uint64(s)
            out[w + 1:w + 1 + WORDS_PER_CONTAINER] |= words >> np.uint64(64 - s)
        lo_w, hi_w = out[:WORDS_PER_CONTAINER], out[WORDS_PER_CONTAINER:]
        lo = from_words(lo_w) if np.any(lo_w) else None
        hi = from_words(hi_w) if np.any(hi_w) else None
        return lo, hi
    if isinstance(c, RunContainer):
        starts = c.runs[0::2].astype(np.int64) + inoff
        ends = starts + c.runs[1::2].astype(np.int64)  # inclusive

        def build(s, e):
            if s.size == 0:
                return None
            runs = np.empty(2 * s.size, dtype=np.uint16)
            runs[0::2] = s.astype(np.uint16)
            runs[1::2] = (e - s).astype(np.uint16)
            return RunContainer(runs)
        lo_m, hi_m = starts < (1 << 16), ends >= (1 << 16)
        lo = build(starts[lo_m], np.minimum(ends[lo_m], 0xFFFF))
        hi = build(np.maximum(starts[hi_m], 1 << 16) - (1 << 16),
                   ends[hi_m] - (1 << 16))
        return lo, hi
    vals = c.values().astype(np.int64) + inoff
    split = int(np.searchsorted(vals, 1 << 16))
    lo = ArrayContainer(vals[:split].astype(np.uint16)) if split else None
    hi = (ArrayContainer((vals[split:] - (1 << 16)).astype(np.uint16))
          if split < vals.size else None)
    return lo, hi
