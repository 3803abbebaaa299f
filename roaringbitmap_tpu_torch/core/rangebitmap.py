"""RangeBitmap: a range index over appended values, the host oracle of the
port's ``RangeColumn`` and ``DeviceRangeBitmap``
(``roaringbitmap_tpu.core.rangebitmap``, queries and builder).

An append-only index maps dense row ids 0..n-1 to unsigned 64-bit values and
answers lt/lte/gt/gte/eq/neq/between, each a RoaringBitmap of row ids, plus
the ``*_cardinality`` forms and ``context`` (row-filter) overloads.  Values
are held as base-2 bit slices over row ids (slice i holds the rows whose
value has bit i set); queries run the O'Neil descending slice scan.

Two builders give the same slices: :class:`Appender` (the reference's
``RangeBitmap.Appender``, one mask and bitmap build per bit at flush) and
:meth:`RangeBitmap.from_values`, which packs each bit plane of a dense value
vector straight into container words.  The serialized form (cookie 0xF00D,
``serialize`` / ``map``) is not ported.
"""

from __future__ import annotations

import numpy as np

from . import containers as C
from .bitmap import RoaringBitmap, and_ as rb_and, andnot as rb_andnot, \
    or_ as rb_or

_CHUNK = 1 << 16


def _range_mask_bits(max_value: int) -> int:
    """Slice count for a max value."""
    if max_value < 0:
        raise ValueError("maxValue must be unsigned (0 <= v < 2^64)")
    return max(max_value.bit_length(), 1)


def _plane_bitmap(bits: np.ndarray) -> RoaringBitmap:
    """Rows 0..n-1 whose entry of the bool vector ``bits`` is set, built
    from packed words per 2^16-row key; keys with no row are left out."""
    n_keys = -(-bits.size // _CHUNK)
    padded = np.zeros(n_keys * _CHUNK, np.uint8)
    padded[:bits.size] = bits
    words = np.packbits(padded, bitorder="little").view(np.uint64).reshape(
        n_keys, C.WORDS_PER_CONTAINER)
    cards = np.add.reduceat(bits.astype(np.int64),
                            np.arange(0, bits.size, _CHUNK)) \
        if bits.size else np.zeros(0, np.int64)
    keys, conts = [], []
    for k in np.flatnonzero(cards):
        keys.append(k)
        conts.append(C.from_words(words[k], int(cards[k])))
    return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)


class RangeBitmap:
    """Immutable range index; build with :meth:`appender` or
    :meth:`from_values`."""

    def __init__(self, slices: list[RoaringBitmap], row_count: int,
                 max_value: int):
        self._slices = slices
        self._rows = row_count
        self._max = max_value

    # ----------------------------------------------------------------- build
    @staticmethod
    def appender(max_value: int) -> "Appender":
        return Appender(max_value)

    @staticmethod
    def from_values(values, max_value: int | None = None) -> "RangeBitmap":
        """Vectorized build over rows 0..n-1: per bit, the value vector's bit
        plane packed into words key by key.  Equal, slice for slice, to
        appending ``values`` in order."""
        v = np.asarray(values, dtype=np.uint64)
        mx = int(v.max()) if max_value is None and v.size else (
            0 if max_value is None else int(max_value))
        if v.size and int(v.max()) > mx:
            raise ValueError("value exceeds appender maxValue")
        if v.size > 0xFFFFFFFF:
            raise ValueError("RangeBitmap supports at most 2^32-1 rows")
        slices = [_plane_bitmap(((v >> np.uint64(i)) & np.uint64(1))
                                .astype(bool))
                  for i in range(_range_mask_bits(mx))]
        return RangeBitmap(slices, int(v.size), mx)

    @property
    def row_count(self) -> int:
        return self._rows

    @property
    def max_value(self) -> int:
        return self._max

    @property
    def slices(self) -> list[RoaringBitmap]:
        return self._slices

    def _all_rows(self) -> RoaringBitmap:
        return RoaringBitmap.from_range(0, self._rows)

    # --------------------------------------------------------------- queries
    def _scan(self, threshold: int):
        """O'Neil descending slice scan -> (gt, lt, eq) over all rows."""
        gt = RoaringBitmap()
        lt = RoaringBitmap()
        eq = self._all_rows()
        for i in range(len(self._slices) - 1, -1, -1):
            if (threshold >> i) & 1:
                lt = rb_or(lt, rb_andnot(eq, self._slices[i]))
                eq = rb_and(eq, self._slices[i])
            else:
                gt = rb_or(gt, rb_and(eq, self._slices[i]))
                eq = rb_andnot(eq, self._slices[i])
        return gt, lt, eq

    def _apply_context(self, rb: RoaringBitmap,
                       context: RoaringBitmap | None) -> RoaringBitmap:
        return rb if context is None else rb_and(rb, context)

    def lte(self, threshold: int,
            context: RoaringBitmap | None = None) -> RoaringBitmap:
        """Rows with value <= threshold."""
        if threshold < 0:
            return RoaringBitmap()
        if threshold >= (1 << len(self._slices)) - 1 or threshold >= self._max:
            return self._apply_context(self._all_rows(), context)
        _gt, lt, eq = self._scan(threshold)
        return self._apply_context(rb_or(lt, eq), context)

    def lt(self, threshold: int,
           context: RoaringBitmap | None = None) -> RoaringBitmap:
        if threshold <= 0:
            return RoaringBitmap()
        return self.lte(threshold - 1, context)

    def gte(self, threshold: int,
            context: RoaringBitmap | None = None) -> RoaringBitmap:
        if threshold <= 0:
            return self._apply_context(self._all_rows(), context)
        if threshold > self._max:
            return RoaringBitmap()
        gt, _lt, eq = self._scan(threshold)
        return self._apply_context(rb_or(gt, eq), context)

    def gt(self, threshold: int,
           context: RoaringBitmap | None = None) -> RoaringBitmap:
        return self.gte(threshold + 1, context)

    def eq(self, value: int,
           context: RoaringBitmap | None = None) -> RoaringBitmap:
        if value < 0 or value > self._max:
            return RoaringBitmap()
        _gt, _lt, eq = self._scan(value)
        return self._apply_context(eq, context)

    def neq(self, value: int,
            context: RoaringBitmap | None = None) -> RoaringBitmap:
        base = self._apply_context(self._all_rows(), context)
        return rb_andnot(base, self.eq(value))

    def _scan2(self, lo: int, hi: int):
        """One descending pass carrying both bounds (the reference's
        DoubleEvaluation): (gt1, eq1) of the lower, (lt2, eq2) of the upper."""
        gt1 = RoaringBitmap()
        eq1 = self._all_rows()
        lt2 = RoaringBitmap()
        eq2 = self._all_rows()
        for i in range(len(self._slices) - 1, -1, -1):
            s = self._slices[i]
            if (lo >> i) & 1:
                eq1 = rb_and(eq1, s)
            else:
                gt1 = rb_or(gt1, rb_and(eq1, s))
                eq1 = rb_andnot(eq1, s)
            if (hi >> i) & 1:
                lt2 = rb_or(lt2, rb_andnot(eq2, s))
                eq2 = rb_and(eq2, s)
            else:
                eq2 = rb_andnot(eq2, s)
        return gt1, eq1, lt2, eq2

    def between(self, min_value: int, max_value: int,
                context: RoaringBitmap | None = None) -> RoaringBitmap:
        """Rows with min <= value <= max, in one double-bound pass."""
        lo, hi = max(min_value, 0), min(max_value, self._max)
        if lo > hi:
            return RoaringBitmap()
        if lo <= 0 and hi >= self._max:
            return self._apply_context(self._all_rows(), context)
        if lo <= 0:
            return self.lte(hi, context)
        if hi >= self._max:
            return self.gte(lo, context)
        gt1, eq1, lt2, eq2 = self._scan2(lo, hi)
        res = rb_and(rb_or(gt1, eq1), rb_or(lt2, eq2))
        return self._apply_context(res, context)

    # cardinality forms
    def lte_cardinality(self, threshold: int, context=None) -> int:
        return self.lte(threshold, context).cardinality

    def lt_cardinality(self, threshold: int, context=None) -> int:
        return self.lt(threshold, context).cardinality

    def gte_cardinality(self, threshold: int, context=None) -> int:
        return self.gte(threshold, context).cardinality

    def gt_cardinality(self, threshold: int, context=None) -> int:
        return self.gt(threshold, context).cardinality

    def eq_cardinality(self, value: int, context=None) -> int:
        return self.eq(value, context).cardinality

    def neq_cardinality(self, value: int, context=None) -> int:
        return self.neq(value, context).cardinality

    def between_cardinality(self, min_value: int, max_value: int,
                            context=None) -> int:
        return self.between(min_value, max_value, context).cardinality


class Appender:
    """Append-only builder: ``add`` assigns the next dense row id; ``build``
    freezes into a RangeBitmap.  Adds are buffered and the slices are built
    per flush, one mask and bitmap build per bit."""

    def __init__(self, max_value: int):
        self.max_value = max_value
        self.depth = _range_mask_bits(max_value)
        self._pending: list[np.ndarray] = []
        self._slices = [RoaringBitmap() for _ in range(self.depth)]
        self._rows = 0

    def add(self, value: int) -> None:
        """Append one value at the next row id."""
        if value < 0 or value > self.max_value:
            raise ValueError(f"value {value} out of range [0, {self.max_value}]")
        self.add_many(np.array([value], dtype=np.uint64))

    def add_many(self, values: np.ndarray) -> None:
        """Bulk append; row ids are assigned in order."""
        v = np.asarray(values, dtype=np.uint64)
        if v.size == 0:
            return
        if int(v.max()) > self.max_value:
            raise ValueError("value exceeds appender maxValue")
        self._pending.append(v)

    def _flush(self) -> None:
        if not self._pending:
            return
        vals = np.concatenate(self._pending)
        if self._rows + vals.size > 0xFFFFFFFF:
            raise ValueError("RangeBitmap supports at most 2^32-1 rows")
        rows = (self._rows + np.arange(vals.size)).astype(np.uint32)
        for i in range(self.depth):
            hit = rows[(vals >> np.uint64(i)) & np.uint64(1) == 1]
            if hit.size:
                self._slices[i] = rb_or(self._slices[i],
                                        RoaringBitmap.from_values(hit))
        self._rows += vals.size
        self._pending = []

    def build(self) -> RangeBitmap:
        self._flush()
        return RangeBitmap([s.clone() for s in self._slices], self._rows,
                           self.max_value)

    def clear(self) -> None:
        self._pending = []
        self._slices = [RoaringBitmap() for _ in range(self.depth)]
        self._rows = 0
