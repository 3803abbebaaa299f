"""32-bit RoaringBitmap: the host API over the container model.

The port's own copy of the JAX package's ``core.bitmap``: point mutation,
pairwise algebra, ranges, rank/select, navigation, iterators and
serialization, with the same names, results and typed errors.  Point ops
run on the host (O(log K) plus one small container op); wide and batched
ops go to the card through ``roaringbitmap_tpu_torch.parallel``.

Structure of arrays: ``keys`` is a sorted u16 NumPy array, ``containers``
the matching list.  Bulk construction is vectorized (sort + unique on the
high-16 axis).  The pairwise functions build ``type(a)`` with a's key
dtype, so the same functions serve the 64-bit tier (``core.bitmap64``:
u64 high-48 keys).
"""

from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from . import containers as C
from .containers import Container
from ..format import spec


def _highbits(x: np.ndarray) -> np.ndarray:
    return (x >> np.uint32(16)).astype(np.uint16)


class RoaringBitmap:
    """Compressed bitmap over the unsigned 32-bit universe."""

    __slots__ = ("keys", "containers")

    def __init__(self, keys: np.ndarray | None = None,
                 containers: list[Container] | None = None):
        self.keys = keys if keys is not None else np.empty(0, dtype=np.uint16)
        self.containers = containers if containers is not None else []

    # ------------------------------------------------------------------ build
    @staticmethod
    def bitmap_of(*values: int) -> "RoaringBitmap":
        """RoaringBitmap.bitmapOf analog."""
        return RoaringBitmap.from_values(np.array(values, dtype=np.uint32))

    @staticmethod
    def from_values(values: np.ndarray) -> "RoaringBitmap":
        """Vectorized bulk construction from an unsorted u32 array: one sort
        and one unique-split instead of per-value binary searches."""
        v = np.asarray(values, dtype=np.uint32)
        if v.size == 0:
            return RoaringBitmap()
        return RoaringBitmap.from_sorted(np.unique(v))

    @staticmethod
    def from_sorted(v: np.ndarray) -> "RoaringBitmap":
        """Bulk construction from ascending, duplicate-free u32 values."""
        if v.size == 0:
            return RoaringBitmap()
        keys, starts = np.unique(_highbits(v), return_index=True)
        bounds = np.append(starts, v.size)
        conts: list[Container] = [
            C.from_values((v[bounds[i]:bounds[i + 1]] & np.uint32(0xFFFF)).astype(np.uint16))
            for i in range(keys.size)
        ]
        return RoaringBitmap(keys.astype(np.uint16), conts)

    @staticmethod
    def from_range(start: int, stop: int) -> "RoaringBitmap":
        """All values in [start, stop) — RoaringBitmap.add(long,long) on
        empty, built O(#chunks) (one run container per chunk, no per-chunk
        array reallocation).  Bounds are enforced by _chunk_ranges."""
        keys, conts = [], []
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            keys.append(hb)
            conts.append(C.range_container(lo, hi_excl))
        return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)

    def clone(self) -> "RoaringBitmap":
        return RoaringBitmap(self.keys.copy(), list(self.containers))

    # -------------------------------------------------------------- accessors
    @property
    def cardinality(self) -> int:
        """getLongCardinality."""
        return sum(c.cardinality for c in self.containers)

    def __len__(self) -> int:
        return self.cardinality

    def is_empty(self) -> bool:
        return not self.containers

    def __bool__(self) -> bool:
        return not self.is_empty()

    def _index(self, hb: int) -> int:
        """Index of key hb, or -(insertion point)-1 (RoaringArray.getIndex)."""
        i = int(np.searchsorted(self.keys, np.uint16(hb)))
        if i < self.keys.size and self.keys[i] == hb:
            return i
        return -i - 1

    def contains(self, x: int) -> bool:
        """Membership; a value outside [0, 2^32) is never a member."""
        if not 0 <= x < (1 << 32):
            return False
        i = self._index(x >> 16)
        return i >= 0 and self.containers[i].contains(x & 0xFFFF)

    def __contains__(self, x: int) -> bool:
        return self.contains(x)

    def contains_range(self, start: int, stop: int) -> bool:
        """True iff every value in [start, stop) is present (RoaringBitmap.contains(long,long))."""
        if start >= stop:
            return True
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            if i < 0:
                return False
            c = self.containers[i]
            lo_rank = c.rank(lo) - (1 if c.contains(lo) else 0)
            if c.rank(hi_excl - 1) - lo_rank != hi_excl - lo:
                return False
        return True

    def intersects_range(self, start: int, stop: int) -> bool:
        """True iff any value in [start, stop) is present (RoaringBitmap.intersects(long,long))."""
        if start >= stop:
            return False
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            if i >= 0:
                c = self.containers[i]
                before = c.rank(lo) - (1 if c.contains(lo) else 0)
                if c.rank(hi_excl - 1) > before:
                    return True
        return False

    def rank(self, x: int) -> int:
        """Number of members <= x (RoaringBitmap.rank)."""
        hb = x >> 16
        i = int(np.searchsorted(self.keys, np.uint16(hb), side="left"))
        total = sum(c.cardinality for c in self.containers[:i])
        if i < self.keys.size and self.keys[i] == hb:
            total += self.containers[i].rank(x & 0xFFFF)
        return total

    def range_cardinality(self, start: int, stop: int) -> int:
        """Number of members in [start, stop), the bounds clamped to the
        32-bit universe (RoaringBitmap.rangeCardinality)."""
        lo, hi = (min(max(v, 0), 1 << 32) for v in (start, stop))
        if hi <= lo:
            return 0
        return self.rank(hi - 1) - (self.rank(lo - 1) if lo > 0 else 0)

    def select(self, j: int) -> int:
        """j-th smallest member, 0-based (RoaringBitmap.select)."""
        for k, c in zip(self.keys, self.containers):
            if j < c.cardinality:
                return (int(k) << 16) | c.select(j)
            j -= c.cardinality
        raise ValueError("select: rank out of bounds")

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return (int(self.keys[0]) << 16) | self.containers[0].first()

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return (int(self.keys[-1]) << 16) | self.containers[-1].last()

    def next_value(self, x: int) -> int:
        """Smallest member >= x, or -1 (RoaringBitmap.nextValue)."""
        r = self.rank(x - 1) if x > 0 else 0
        if r >= self.cardinality:
            return -1
        return self.select(r)

    def previous_value(self, x: int) -> int:
        """Largest member <= x, or -1 (RoaringBitmap.previousValue)."""
        r = self.rank(x)
        return self.select(r - 1) if r > 0 else -1

    def next_absent_value(self, x: int) -> int:
        """Smallest non-member >= x (RoaringBitmap.nextAbsentValue)."""
        y = x
        while y <= 0xFFFFFFFF:
            i = self._index(y >> 16)
            if i < 0:
                return y
            c = self.containers[i]
            lo = y & 0xFFFF
            if not c.contains(lo):
                return y
            vals = c.values().astype(np.int64)
            tail = vals[int(np.searchsorted(vals, lo)):]
            expect = lo + np.arange(tail.size)
            mism = np.flatnonzero(tail != expect)
            if mism.size:
                return (y & ~0xFFFF) + int(expect[mism[0]])
            nxt = lo + tail.size  # contiguous through end of container
            if nxt <= 0xFFFF:
                return (y & ~0xFFFF) + nxt
            y = ((y >> 16) + 1) << 16
        return y

    def previous_absent_value(self, x: int) -> int:
        """Largest non-member <= x (RoaringBitmap.previousAbsentValue)."""
        y = x
        while y >= 0:
            i = self._index(y >> 16)
            if i < 0:
                return y
            c = self.containers[i]
            lo = y & 0xFFFF
            if not c.contains(lo):
                return y
            vals = c.values().astype(np.int64)
            head = vals[:int(np.searchsorted(vals, lo)) + 1][::-1]  # descending from lo
            expect = lo - np.arange(head.size)
            mism = np.flatnonzero(head != expect)
            if mism.size:
                return (y & ~0xFFFF) + int(expect[mism[0]])
            prv = lo - head.size  # contiguous down to container start
            if prv >= 0:
                return (y & ~0xFFFF) + prv
            y = ((y >> 16) << 16) - 1
        return y

    # ------------------------------------------------------------- iteration
    def to_array(self) -> np.ndarray:
        """All members, ascending, as u32 (RoaringBitmap.toArray)."""
        if not self.containers:
            return np.empty(0, dtype=np.uint32)
        parts = [
            (np.uint32(int(k) << 16) | c.values().astype(np.uint32))
            for k, c in zip(self.keys, self.containers)
        ]
        return np.concatenate(parts)

    def __iter__(self) -> Iterator[int]:
        for k, c in zip(self.keys, self.containers):
            base = int(k) << 16
            for v in c.values():
                yield base | int(v)

    def batch_iterator(self, batch_size: int = 65536) -> Iterator[np.ndarray]:
        """Container-at-a-time buffer fills."""
        buf: list[np.ndarray] = []
        n = 0
        for k, c in zip(self.keys, self.containers):
            part = np.uint32(int(k) << 16) | c.values().astype(np.uint32)
            buf.append(part)
            n += part.size
            while n >= batch_size:
                whole = np.concatenate(buf)
                yield whole[:batch_size]
                rest = whole[batch_size:]
                buf = [rest] if rest.size else []
                n = rest.size
        if n:
            yield np.concatenate(buf)

    def for_each(self, fn) -> None:
        """Visit every member ascending (RoaringBitmap.forEach)."""
        for v in self:
            fn(v)

    def for_each_in_range(self, start: int, stop: int, fn) -> None:
        """Visit members in [start, stop) ascending (forEachInRange) —
        touches only the containers the range spans (a byte-backed bitmap
        decodes nothing else)."""
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            if i < 0:
                continue
            vals = self.containers[i].values()
            a, b = np.searchsorted(vals, [lo, hi_excl])
            base = hb << 16
            for v in vals[int(a):int(b)]:
                fn(base | int(v))

    def for_all_in_range(self, start: int, stop: int, fn) -> None:
        """Visit EVERY position in [start, stop) with its membership bit
        (forAllInRange's RelativeRangeConsumer contract) — same per-chunk
        walk as for_each_in_range."""
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            base = hb << 16
            if i < 0:
                for off in range(lo, hi_excl):
                    fn(base + off - start, False)
                continue
            vals = self.containers[i].values()
            a, b = np.searchsorted(vals, [lo, hi_excl])
            members = set(vals[int(a):int(b)].tolist())
            for off in range(lo, hi_excl):
                fn(base + off - start, off in members)

    def get_batch_iterator(self, batch_size: int = 65536):
        """RoaringBatchIterator with seek — advance_if_needed skips whole
        containers without expanding them."""
        from .iterators import RoaringBatchIterator

        return RoaringBatchIterator(self, batch_size)

    def get_int_iterator(self):
        """PeekableIntIterator flyweight (getIntIterator)."""
        from .iterators import PeekableIntIterator

        return PeekableIntIterator(self)

    def get_reverse_int_iterator(self):
        """Descending flyweight (getReverseIntIterator)."""
        from .iterators import ReverseIntIterator

        return ReverseIntIterator(self)

    def get_signed_int_iterator(self):
        """Ascending in SIGNED 32-bit order: negatives (values >= 2^31)
        come first (getSignedIntIterator)."""
        arr = self.to_array()
        for v in arr[arr >= (1 << 31)]:
            yield int(v) - (1 << 32)
        for v in arr[arr < (1 << 31)]:
            yield int(v)

    def first_signed(self) -> int:
        """Smallest member in signed-int order (firstSigned)."""
        if self.is_empty():
            raise ValueError("empty bitmap")
        arr = self.to_array()
        neg = arr[arr >= (1 << 31)]
        return int(neg[0]) - (1 << 32) if neg.size else int(arr[0])

    def last_signed(self) -> int:
        """Largest member in signed-int order (lastSigned)."""
        if self.is_empty():
            raise ValueError("empty bitmap")
        arr = self.to_array()
        pos = arr[arr < (1 << 31)]
        return int(pos[-1]) if pos.size else int(arr[-1]) - (1 << 32)

    def cardinality_exceeds(self, threshold: int) -> bool:
        """True iff cardinality > threshold, short-circuiting per container
        (cardinalityExceeds)."""
        total = 0
        for c in self.containers:
            total += c.cardinality
            if total > threshold:
                return True
        return False

    def select_range(self, start: int, end: int) -> "RoaringBitmap":
        """Members with rank in [start, end), as a bitmap (selectRange).

        Container-granular like the reference's selectRangeWithoutCopy:
        wholly-included containers are shared (persistent), only the two
        rank-boundary containers materialize values — never the whole
        bitmap.
        """
        if start < 0 or end <= start:
            raise ValueError("invalid rank range")
        keys: list[int] = []
        conts: list[Container] = []
        pos = 0
        for k, c in zip(self.keys, self.containers):
            card = c.cardinality
            if pos + card > start:
                lo, hi = max(start - pos, 0), min(end - pos, card)
                conts.append(c if (lo, hi) == (0, card)
                             else C.from_values(c.values()[lo:hi]))
                keys.append(int(k))
            pos += card
            if pos >= end:
                break
        if pos <= start:
            raise ValueError("select_range: start beyond cardinality")
        return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)

    def rank_long(self, x: int) -> int:
        """rankLong: Python ints never overflow; alias of rank."""
        return self.rank(x)

    @property
    def long_cardinality(self) -> int:
        """getLongCardinality alias (Python ints are unbounded)."""
        return self.cardinality

    def get_long_size_in_bytes(self) -> int:
        return self.get_size_in_bytes()

    def trim(self) -> None:
        """trim(): NumPy container arrays are exact-sized already; kept for
        API parity (the reference shrinks overallocated arrays)."""

    @staticmethod
    def bitmap_of_unordered(values) -> "RoaringBitmap":
        """bitmapOfUnordered: from_values sorts internally."""
        return RoaringBitmap.from_values(
            np.asarray(values, dtype=np.uint32))

    @staticmethod
    def bitmap_of_range(start: int, stop: int) -> "RoaringBitmap":
        """bitmapOfRange(long, long): alias of from_range."""
        return RoaringBitmap.from_range(start, stop)

    def append(self, key: int, container: Container) -> None:
        """Expert API: append a container at a key strictly above the last
        (RoaringBitmap.append / RoaringArray.append); raises on
        out-of-order keys instead of corrupting the index."""
        if not (0 <= key <= 0xFFFF):
            raise ValueError(f"key {key} outside the u16 key space")
        if self.keys.size and key <= int(self.keys[-1]):
            raise ValueError(
                f"append key {key} not above last key {int(self.keys[-1])}")
        if container.cardinality == 0:
            raise ValueError(
                "append of an empty container (the wire format has no "
                "empty-slot encoding)")
        self._insert(int(self.keys.size), np.uint16(key), container)

    def get_container_pointer(self) -> "ContainerPointer":
        """Expert container cursor (getContainerPointer)."""
        return ContainerPointer(self)

    def to_mutable_roaring_bitmap(self):
        """Copy into the buffer tier's mutable class
        (toMutableRoaringBitmap)."""
        from ..buffer import MutableRoaringBitmap

        return MutableRoaringBitmap(self.keys.copy(), list(self.containers))

    @staticmethod
    def maximum_serialized_size(cardinality: int, universe_size: int) -> int:
        """Upper bound on the serialized bytes of any bitmap with
        ``cardinality`` members below ``universe_size``."""
        return spec.maximum_serialized_size(cardinality, universe_size)

    # -------------------------------------------------------------- mutation
    def add(self, x: int) -> None:
        """Point insert (RoaringBitmap.add)."""
        i = self._index(x >> 16)
        if i >= 0:
            self.containers[i] = self.containers[i].add(x & 0xFFFF)
        else:
            self._insert(-i - 1, np.uint16(x >> 16),
                         C.ArrayContainer(np.array([x & 0xFFFF], dtype=np.uint16)))

    def checked_add(self, x: int) -> bool:
        if self.contains(x):
            return False
        self.add(x)
        return True

    def add_n(self, values: np.ndarray, offset: int, n: int) -> None:
        """Add n values starting at index offset (RoaringBitmap.addN
        — the partial-array form of addMany)."""
        if n < 0 or offset < 0:
            raise IndexError(f"addN window [{offset}, {offset + n}) invalid")
        if n == 0:
            return  # before the bounds check, matching addN's ordering
        if offset + n > len(values):
            raise IndexError(
                f"addN window [{offset}, {offset + n}) out of bounds "
                f"for {len(values)} values")
        self.add_many(np.asarray(values)[offset:offset + n])

    def add_many(self, values: np.ndarray) -> None:
        """Bulk insert (RoaringBitmap.add(int...) / addMany) — cost scales
        with the batch's key count, not the bitmap's."""
        self.ior(RoaringBitmap.from_values(values))

    def remove(self, x: int) -> None:
        """Point removal; a value outside [0, 2^32) is no member, so no-op."""
        if not 0 <= x < (1 << 32):
            return
        i = self._index(x >> 16)
        if i < 0:
            return
        c = self.containers[i].remove(x & 0xFFFF)
        if c.cardinality == 0:
            self._delete(i)
        else:
            self.containers[i] = c

    def checked_remove(self, x: int) -> bool:
        if not self.contains(x):
            return False
        self.remove(x)
        return True

    def add_range(self, start: int, stop: int) -> None:
        """Set all of [start, stop) (RoaringBitmap.add(long,long))."""
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            full_chunk = lo == 0 and hi_excl == 0x10000
            if i >= 0:
                if full_chunk:
                    self.containers[i] = C.full_container()
                else:
                    self.containers[i] = C.container_or(
                        self.containers[i], C.range_container(lo, hi_excl))
            else:
                self._insert(-i - 1, np.uint16(hb), C.range_container(lo, hi_excl))

    def remove_range(self, start: int, stop: int) -> None:
        """Clear all of [start, stop) (RoaringBitmap.remove(long,long))."""
        kill: list[int] = []
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            if i < 0:
                continue
            if lo == 0 and hi_excl == 0x10000:
                kill.append(i)
                continue
            c = C.container_andnot(self.containers[i], C.range_container(lo, hi_excl))
            if c.cardinality == 0:
                kill.append(i)
            else:
                self.containers[i] = c
        for i in reversed(kill):
            self._delete(i)

    def flip_range(self, start: int, stop: int) -> None:
        """In-place complement of [start, stop) (RoaringBitmap.flip(long,long))."""
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            i = self._index(hb)
            rc = C.range_container(lo, hi_excl) if not (lo == 0 and hi_excl == 0x10000) \
                else C.full_container()
            if i >= 0:
                c = C.container_xor(self.containers[i], rc)
                if c.cardinality == 0:
                    self._delete(i)
                else:
                    self.containers[i] = c
            else:
                self._insert(-i - 1, np.uint16(hb), rc)

    def _insert(self, pos: int, key: np.uint16, cont: Container) -> None:
        self.keys = np.insert(self.keys, pos, key)
        self.containers.insert(pos, cont)

    def _delete(self, pos: int) -> None:
        self.keys = np.delete(self.keys, pos)
        del self.containers[pos]

    def clear(self) -> None:
        self.keys = np.empty(0, dtype=np.uint16)
        self.containers = []

    # ------------------------------------------------------- transformations
    def run_optimize(self) -> bool:
        """Recompress containers to run encoding where smaller (RoaringBitmap.runOptimize)."""
        changed = False
        for i, c in enumerate(self.containers):
            o = c.run_optimize()
            if o is not c:
                self.containers[i] = o
                changed = changed or o.is_run()
        return changed

    def has_run_compression(self) -> bool:
        return any(c.is_run() for c in self.containers)

    def remove_run_compression(self) -> bool:
        changed = False
        for i, c in enumerate(self.containers):
            if c.is_run():
                self.containers[i] = C.from_values(c.values())
                changed = True
        return changed

    def limit(self, max_cardinality: int) -> "RoaringBitmap":
        """First max_cardinality members (RoaringBitmap.limit)."""
        keys, conts = [], []
        left = max_cardinality
        for k, c in zip(self.keys, self.containers):
            if left <= 0:
                break
            if c.cardinality <= left:
                keys.append(k)
                conts.append(c)
                left -= c.cardinality
            else:
                keys.append(k)
                conts.append(C.from_values(c.values()[:left]))
                left = 0
        return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)

    def add_offset(self, offset: int) -> "RoaringBitmap":
        """Value-shifted copy (RoaringBitmap.addOffset); drops
        out-of-range bits.

        Container-granular, never O(cardinality): a 65536-aligned offset is
        pure key surgery (containers shared, not copied); otherwise each
        container splits into at most two destination containers via
        word/run/value shifts (containers.container_shift), mirroring the
        reference's two-way split.
        """
        off = int(offset)
        if off == 0:
            return self.clone()
        kshift, inoff = off >> 16, off & 0xFFFF  # floor div: inoff in [0, 2^16)
        if inoff == 0:
            keep = ((self.keys.astype(np.int64) + kshift >= 0)
                    & (self.keys.astype(np.int64) + kshift <= 0xFFFF))
            keys = (self.keys[keep].astype(np.int64) + kshift).astype(np.uint16)
            conts = [c for c, k in zip(self.containers, keep) if k]
            return RoaringBitmap(keys, conts)
        keys: list[int] = []
        conts: list[Container] = []
        pending: tuple[int, Container] | None = None  # carry from previous split
        for k, c in zip(self.keys, self.containers):
            k1 = int(k) + kshift
            lo, hi = C.container_shift(c, inoff)
            if pending is not None:
                pk, pc = pending
                if pk == k1 and lo is not None:
                    # high half of the previous chunk shares this key; the
                    # halves occupy disjoint bit ranges ([0, inoff) vs
                    # [inoff, 2^16)) so the merge is an ordered concat
                    lo = C.container_join_disjoint(pc, lo)
                elif 0 <= pk <= 0xFFFF:
                    keys.append(pk)
                    conts.append(pc)
            if lo is not None and 0 <= k1 <= 0xFFFF:
                keys.append(k1)
                conts.append(lo)
            pending = (k1 + 1, hi) if hi is not None else None
        if pending is not None and 0 <= pending[0] <= 0xFFFF:
            keys.append(pending[0])
            conts.append(pending[1])
        return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)

    # ----------------------------------------------------------- set algebra
    def __and__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return and_(self, o)

    def __or__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return or_(self, o)

    def __xor__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return xor(self, o)

    def __sub__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return andnot(self, o)

    def iand(self, o: "RoaringBitmap") -> None:
        # inherently O(self): every key absent from o leaves the result
        r = and_(self, o)
        self.keys, self.containers = r.keys, r.containers

    def _delta_positions(self, o: "RoaringBitmap"):
        """For each of o's keys: its position in self.keys and whether it
        matches an existing key.  The O(|o| log |self|) probe shared by the
        in-place delta merges (the addN-style contract: touch only
        containers the delta names)."""
        pos = np.searchsorted(self.keys, o.keys)
        match = np.zeros(o.keys.size, dtype=bool)
        inb = pos < self.keys.size
        match[inb] = self.keys[pos[inb]] == o.keys[inb]
        return pos, match

    def _insert_missing(self, o: "RoaringBitmap", miss) -> None:
        """Splice o's containers (indices `miss`) in at their key positions:
        one keys-array rebuild (memcpy) + list inserts, no container
        algebra.  Positions are probed against the CURRENT keys array, so
        callers may delete keys first."""
        if miss.size == 0:
            return
        pos = np.searchsorted(self.keys, o.keys[miss])
        self.keys = np.insert(self.keys, pos, o.keys[miss])
        for n_done, (j, p) in enumerate(zip(miss, pos)):
            self.containers.insert(int(p) + n_done, o.containers[j])

    def ior(self, o: "RoaringBitmap") -> None:
        if o.is_empty():
            return
        pos, match = self._delta_positions(o)
        for j in np.flatnonzero(match):
            i = int(pos[j])
            self.containers[i] = C.container_or(
                self.containers[i], o.containers[j])
        self._insert_missing(o, np.flatnonzero(~match))

    def ixor(self, o: "RoaringBitmap") -> None:
        if o.is_empty():
            return
        pos, match = self._delta_positions(o)
        kill: list[int] = []
        for j in np.flatnonzero(match):
            i = int(pos[j])
            c = C.container_xor(self.containers[i], o.containers[j])
            if c.cardinality == 0:
                kill.append(i)
            else:
                self.containers[i] = c
        for i in reversed(kill):
            del self.containers[i]
        self.keys = np.delete(self.keys, kill)
        self._insert_missing(o, np.flatnonzero(~match))

    def and_not(self, o: "RoaringBitmap") -> None:
        """In-place difference, Java's andNot(other) naming
        (MutableRoaringBitmap.andNot; covers every subclass)."""
        self.iandnot(o)

    def iandnot(self, o: "RoaringBitmap") -> None:
        if o.is_empty() or self.is_empty():
            return
        pos, match = self._delta_positions(o)
        kill: list[int] = []
        for j in np.flatnonzero(match):
            i = int(pos[j])
            c = C.container_andnot(self.containers[i], o.containers[j])
            if c.cardinality == 0:
                kill.append(i)
            else:
                self.containers[i] = c
        for i in reversed(kill):
            del self.containers[i]
        self.keys = np.delete(self.keys, kill)

    def intersects(self, o: "RoaringBitmap") -> bool:
        common, ia, ib = np.intersect1d(self.keys, o.keys,
                                        assume_unique=True, return_indices=True)
        return any(
            C.container_intersects(self.containers[i], o.containers[j])
            for i, j in zip(ia, ib))

    def is_subset_of(self, o: "RoaringBitmap") -> bool:
        """RoaringBitmap.contains(RoaringBitmap) analog."""
        common, ia, ib = np.intersect1d(self.keys, o.keys,
                                        assume_unique=True, return_indices=True)
        if common.size != self.keys.size:
            return False
        return all(
            C.container_is_subset(self.containers[i], o.containers[j])
            for i, j in zip(ia, ib))

    def is_hamming_similar(self, o: "RoaringBitmap", tolerance: int) -> bool:
        """Symmetric-difference cardinality <= tolerance (RoaringBitmap.isHammingSimilar)."""
        return xor_cardinality(self, o) <= tolerance

    # ---------------------------------------------------------- equality/repr
    def __eq__(self, o: object) -> bool:
        if not isinstance(o, RoaringBitmap):
            return NotImplemented
        if self.keys.size != o.keys.size or not np.array_equal(self.keys, o.keys):
            return False
        return all(
            C.container_equals(a, b)
            for a, b in zip(self.containers, o.containers))

    def __hash__(self) -> int:
        return hash(self.to_array().tobytes())

    def __repr__(self) -> str:
        card = self.cardinality
        head = ",".join(str(v) for _, v in zip(range(8), self))
        tail = "..." if card > 8 else ""
        return f"RoaringBitmap(card={card}, keys={self.keys.size}, {{{head}{tail}}})"

    # ------------------------------------------------------------------- I/O
    def serialize(self) -> bytes:
        return spec.serialize(self.keys, self.containers)

    @classmethod
    def _from_serialized(cls, data: bytes):
        keys, conts = spec.deserialize(data)
        return cls(keys, conts)

    def __reduce__(self):
        """Pickle via the portable format (the Externalizable analog).
        Subclasses (FastRank, MutableRoaringBitmap) round-trip to their own
        class."""
        return (type(self)._from_serialized, (self.serialize(),))

    @staticmethod
    def deserialize(buf: bytes | memoryview) -> "RoaringBitmap":
        keys, conts = spec.deserialize(buf)
        return RoaringBitmap(keys, conts)

    def serialized_size_in_bytes(self) -> int:
        return spec.serialized_size_in_bytes(self.keys, self.containers)

    def get_size_in_bytes(self) -> int:
        """Rough in-memory footprint (getLongSizeInBytes analog)."""
        total = 8 + 2 * self.keys.size
        for c in self.containers:
            total += c.serialized_size_in_bytes()
        return total

    # ------------------------------------------------------------- statistics
    def container_count(self) -> int:
        return len(self.containers)


class ContainerPointer:
    """Expert cursor over (key, container) slots.

    The reference exposes this for container-granular walks (insights'
    analyser, merge machinery); here it is a thin index cursor over the
    SoA pair."""

    def __init__(self, rb: RoaringBitmap, pos: int = 0):
        self._rb = rb
        self._pos = pos

    def advance(self) -> None:
        self._pos += 1

    def clone(self) -> "ContainerPointer":
        return ContainerPointer(self._rb, self._pos)

    def has_container(self) -> bool:
        return self._pos < len(self._rb.containers)

    def key(self) -> int:
        return int(self._rb.keys[self._pos])

    def get_container(self) -> Container | None:
        if not self.has_container():
            return None
        return self._rb.containers[self._pos]

    def get_cardinality(self) -> int:
        return self._rb.containers[self._pos].cardinality

    def is_bitmap_container(self) -> bool:
        return isinstance(self._rb.containers[self._pos], C.BitmapContainer)

    def is_run_container(self) -> bool:
        return self._rb.containers[self._pos].is_run()


def _chunk_ranges(start: int, stop: int):
    """Split [start, stop) into per-chunk (lo, hi_excl, highbits) pieces."""
    if start >= stop:
        return
    if start < 0 or stop > (1 << 32):
        raise ValueError("range outside the 32-bit universe")
    hb_first, hb_last = start >> 16, (stop - 1) >> 16
    for hb in range(hb_first, hb_last + 1):
        lo = start & 0xFFFF if hb == hb_first else 0
        hi_excl = ((stop - 1) & 0xFFFF) + 1 if hb == hb_last else 0x10000
        yield lo, hi_excl, hb


# ---------------------------------------------------------------------------
# Pairwise static algebra: two-pointer key merge (RoaringBitmap.or
# skeleton), vectorized over the key axis with intersect1d/union1d.
# ---------------------------------------------------------------------------


def _result_cls(a):
    """Class of an op's result: type(a), unless the class routes results
    elsewhere (``RESULT_CLS``: ops on a byte-backed ImmutableRoaringBitmap
    return in-RAM RoaringBitmaps, as the reference's immutable ops return
    mutable ones)."""
    return getattr(type(a), "RESULT_CLS", None) or type(a)


def and_(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    common, ia, ib = np.intersect1d(a.keys, b.keys, assume_unique=True,
                                    return_indices=True)
    keys, conts = [], []
    for k, i, j in zip(common, ia, ib):
        c = C.container_and(a.containers[i], b.containers[j])
        if c.cardinality:
            keys.append(k)
            conts.append(c)
    return _result_cls(a)(np.array(keys, dtype=a.keys.dtype), conts)


def or_(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    return _merge_union(a, b, C.container_or)


def xor(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    return _merge_union(a, b, C.container_xor, drop_empty=True)


def andnot(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    keys, conts = [], []
    b_idx = {int(k): j for j, k in enumerate(b.keys)}
    for k, ca in zip(a.keys, a.containers):
        j = b_idx.get(int(k))
        c = ca if j is None else C.container_andnot(ca, b.containers[j])
        if c.cardinality:
            keys.append(k)
            conts.append(c)
    return _result_cls(a)(np.array(keys, dtype=a.keys.dtype), conts)


def or_not(a: RoaringBitmap, b: RoaringBitmap, range_end: int) -> RoaringBitmap:
    """a | (~b over [0, range_end)) (RoaringBitmap.orNot).

    b's members at/above range_end do not contribute (the reference's key
    loop stops at maxKey and copies only a's remaining containers); a's
    members above range_end are kept.

    Single bounded merge pass, like the reference: one container per key in
    [0, maxKey] (the result is dense there — a missing b container
    complements to all-ones), then a's tail containers appended untouched.
    Nothing of b beyond range_end is cloned or flipped.
    """
    if range_end <= 0:
        return a.clone()
    range_end = min(range_end, 1 << 32)
    max_key = (range_end - 1) >> 16
    a_idx = {int(k): i for i, k in enumerate(a.keys) if int(k) <= max_key}
    b_idx = {int(k): i for i, k in enumerate(b.keys) if int(k) <= max_key}
    # Keys untouched by either input complement to all-ones; they all share
    # ONE immutable full-range container (containers are persistent, so
    # sharing is safe — same as _merge_union's lone-side rows).  Container
    # algebra therefore runs only over keys present in a or b: O(|a|+|b|)
    # container ops instead of 65,536 at range_end=2^32 (the output is
    # inherently dense, but its constant factor is now list fills).
    full = C.full_container()
    conts: list = [full] * (max_key + 1)
    last_span = range_end - (max_key << 16)
    if last_span < (1 << 16):
        conts[max_key] = C.range_container(0, last_span)
    for k in sorted(set(a_idx) | set(b_idx)):
        # bits [0, span) of this key's chunk are in range
        span = min(range_end - (k << 16), 1 << 16)
        prefix = C.range_container(0, span)
        j = b_idx.get(k)
        comp = prefix if j is None else C.container_andnot(prefix, b.containers[j])
        i = a_idx.get(k)
        c = comp if i is None else C.container_or(a.containers[i], comp)
        conts[k] = c if c.cardinality else None  # None = empty result, drop
    keys = [k for k in range(max_key + 1) if conts[k] is not None]
    conts = [c for c in conts if c is not None]
    for k, ca in zip(a.keys, a.containers):
        if int(k) > max_key:
            keys.append(int(k))
            conts.append(ca)  # shared, same as _merge_union's lone-side rows
    return _result_cls(a)(np.array(keys, dtype=a.keys.dtype), conts)


def _merge_union(a: RoaringBitmap, b: RoaringBitmap, op, drop_empty: bool = False):
    all_keys = np.union1d(a.keys, b.keys)
    a_idx = {int(k): i for i, k in enumerate(a.keys)}
    b_idx = {int(k): i for i, k in enumerate(b.keys)}
    keys, conts = [], []
    for k in all_keys:
        i, j = a_idx.get(int(k)), b_idx.get(int(k))
        if i is not None and j is not None:
            c = op(a.containers[i], b.containers[j])
        elif i is not None:
            c = a.containers[i]
        else:
            c = b.containers[j]
        if drop_empty and c.cardinality == 0:
            continue
        keys.append(k)
        conts.append(c)
    return _result_cls(a)(np.array(keys, dtype=a.keys.dtype), conts)


def and_cardinality(a: RoaringBitmap, b: RoaringBitmap) -> int:
    common, ia, ib = np.intersect1d(a.keys, b.keys, assume_unique=True,
                                    return_indices=True)
    return sum(
        C.container_and_cardinality(a.containers[i], b.containers[j])
        for i, j in zip(ia, ib))


def or_cardinality(a: RoaringBitmap, b: RoaringBitmap) -> int:
    """Inclusion-exclusion (FastAggregation.or_cardinality analog)."""
    return a.cardinality + b.cardinality - and_cardinality(a, b)


def xor_cardinality(a: RoaringBitmap, b: RoaringBitmap) -> int:
    return a.cardinality + b.cardinality - 2 * and_cardinality(a, b)


def andnot_cardinality(a: RoaringBitmap, b: RoaringBitmap) -> int:
    return a.cardinality - and_cardinality(a, b)


def flip(a: RoaringBitmap, start: int, stop: int) -> RoaringBitmap:
    out = a.clone()
    out.containers = list(out.containers)
    out.flip_range(start, stop)
    return out
