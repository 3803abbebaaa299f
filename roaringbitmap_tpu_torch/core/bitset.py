"""BitSet interop: the BitSetUtil conversions and RoaringBitSet.

The port's own copy of ``roaringbitmap_tpu.core.bitset``.  The BitSetUtil
functions convert between flat bitsets (NumPy u64 word arrays or bool
arrays, the analog of java.util.BitSet's long[]) and RoaringBitmaps, all
vectorized.  ``RoaringBitSet`` is a java.util.BitSet-shaped surface
(set/get/clear/flip, the logical ops, next/previous set and clear bits,
length/size) backed by a RoaringBitmap instead of a dense word array.
"""

from __future__ import annotations

import numpy as np

from .bitmap import RoaringBitmap, and_ as rb_and, andnot as rb_andnot, \
    or_ as rb_or, xor as rb_xor

BLOCK_LENGTH = 1024  # words per container block


# ------------------------------------------------------------- BitSetUtil
def bitmap_of_words(words: np.ndarray) -> RoaringBitmap:
    """u64 word array -> RoaringBitmap (BitSetUtil.bitmapOf)."""
    w = np.asarray(words, dtype=np.uint64)
    if w.size == 0:
        return RoaringBitmap()
    bits = np.unpackbits(w.view(np.uint8), bitorder="little")
    return RoaringBitmap.from_values(np.flatnonzero(bits).astype(np.uint32))


def bitmap_of_bool_array(mask: np.ndarray) -> RoaringBitmap:
    """bool[N] -> RoaringBitmap of set positions."""
    return RoaringBitmap.from_values(
        np.flatnonzero(np.asarray(mask, dtype=bool)).astype(np.uint32))


def bitset_of(rb: RoaringBitmap, n_words: int | None = None) -> np.ndarray:
    """RoaringBitmap -> u64 word array (BitSetUtil.bitsetOf)."""
    if rb.is_empty():
        return np.zeros(n_words or 0, dtype=np.uint64)
    last = rb.last()
    need = (last >> 6) + 1
    n = n_words if n_words is not None else need
    if need > n:
        raise ValueError("bitmap exceeds requested bitset length")
    vals = rb.to_array().astype(np.int64)
    out = np.zeros(n, dtype=np.uint64)
    np.bitwise_or.at(out, vals >> 6,
                     np.uint64(1) << (vals & 63).astype(np.uint64))
    return out


def bool_array_of(rb: RoaringBitmap, n: int | None = None) -> np.ndarray:
    """RoaringBitmap -> bool[N]."""
    size = n if n is not None else (rb.last() + 1 if not rb.is_empty() else 0)
    out = np.zeros(size, dtype=bool)
    vals = rb.to_array()
    out[vals[vals < size]] = True
    return out


# ------------------------------------------------------------ RoaringBitSet
class RoaringBitSet:
    """Drop-in BitSet facade over a RoaringBitmap (RoaringBitSet)."""

    def __init__(self, rb: RoaringBitmap | None = None):
        self._rb = rb if rb is not None else RoaringBitmap()

    @staticmethod
    def value_of(words: np.ndarray) -> "RoaringBitSet":
        return RoaringBitSet(bitmap_of_words(words))

    # ------------------------------------------------------------- mutation
    def set(self, from_idx: int, to_idx: int | None = None,
            value: bool = True) -> None:
        """set(i) / set(i, value) / set(from, to) (RoaringBitSet.set)."""
        if isinstance(to_idx, bool):  # Java's set(int, boolean) overload
            value, to_idx = to_idx, None
        if to_idx is None:
            if value:
                self._rb.add(from_idx)
            else:
                self._rb.remove(from_idx)
        elif value:
            self._rb.add_range(from_idx, to_idx)
        else:
            self._rb.remove_range(from_idx, to_idx)

    def clear(self, from_idx: int | None = None,
              to_idx: int | None = None) -> None:
        if from_idx is None:
            self._rb.clear()
        elif to_idx is None:
            self._rb.remove(from_idx)
        else:
            self._rb.remove_range(from_idx, to_idx)

    def flip(self, from_idx: int, to_idx: int | None = None) -> None:
        if to_idx is None:
            to_idx = from_idx + 1
        self._rb.flip_range(from_idx, to_idx)

    def get(self, i: int) -> bool:
        return self._rb.contains(i)

    def __getitem__(self, i: int) -> bool:
        return self.get(i)

    # ---------------------------------------------------------- logical ops
    def and_(self, o: "RoaringBitSet") -> None:
        self._rb = rb_and(self._rb, o._rb)

    def or_(self, o: "RoaringBitSet") -> None:
        self._rb = rb_or(self._rb, o._rb)

    def xor(self, o: "RoaringBitSet") -> None:
        self._rb = rb_xor(self._rb, o._rb)

    def and_not(self, o: "RoaringBitSet") -> None:
        self._rb = rb_andnot(self._rb, o._rb)

    def intersects(self, o: "RoaringBitSet") -> bool:
        return self._rb.intersects(o._rb)

    # ------------------------------------------------------------ navigation
    def next_set_bit(self, i: int) -> int:
        return self._rb.next_value(i)

    def next_clear_bit(self, i: int) -> int:
        return self._rb.next_absent_value(i)

    def previous_set_bit(self, i: int) -> int:
        return self._rb.previous_value(i) if i >= 0 else -1

    def previous_clear_bit(self, i: int) -> int:
        return self._rb.previous_absent_value(i) if i >= 0 else -1

    # ------------------------------------------------------------- accessors
    def cardinality(self) -> int:
        return self._rb.cardinality

    def is_empty(self) -> bool:
        return self._rb.is_empty()

    def length(self) -> int:
        """Highest set bit + 1 (BitSet.length)."""
        return 0 if self._rb.is_empty() else self._rb.last() + 1

    def size(self) -> int:
        """Allocated size illusion: words rounded up, in bits."""
        return ((self.length() + 63) >> 6) << 6

    def stream(self) -> np.ndarray:
        return self._rb.to_array()

    def to_word_array(self) -> np.ndarray:
        return bitset_of(self._rb)

    def to_bitmap(self) -> RoaringBitmap:
        return self._rb

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, RoaringBitSet):
            return NotImplemented
        return self._rb == o._rb

    def __hash__(self) -> int:
        return hash(self._rb)

    def __repr__(self) -> str:
        head = ", ".join(str(v) for _, v in zip(range(8), self._rb))
        more = "..." if self.cardinality() > 8 else ""
        return f"{{{head}{more}}}"
