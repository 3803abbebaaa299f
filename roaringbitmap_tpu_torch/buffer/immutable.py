"""ImmutableRoaringBitmap: a read-only bitmap over serialized bytes.

The port's own copy of ``roaringbitmap_tpu.buffer.immutable`` (the
reference's ``buffer/ImmutableRoaringBitmap``).  It is built over any
bytes-like buffer holding the portable format: a ``bytes`` object, a
``memoryview`` slice of a larger frame, or an mmap'd file.  The descriptive
header is decoded eagerly into NumPy arrays (``format.spec.SerializedView``);
container payloads stay in the buffer and are wrapped on demand, cached
after the first touch.  Binary ops return in-RAM ``RoaringBitmap``s, as the
reference's ops on immutable inputs return mutable results.

``MutableRoaringBitmap`` is the heap-mutable class: the core
``RoaringBitmap`` with the immutable pairing conversions.

The device engines read an immutable's bytes directly: ``ops.packing`` finds
its ``SerializedView`` (``_view``) and streams the payloads off the buffer,
and the wide AND decodes only the containers its key intersection keeps
(``_container``).
"""

from __future__ import annotations

import mmap as mmap_mod

import numpy as np

from ..core import containers as C
from ..core.bitmap import (
    RoaringBitmap,
    and_ as rb_and,
    and_cardinality,
    andnot as rb_andnot,
    or_ as rb_or,
    xor as rb_xor,
)
from ..format import spec


class _LazyContainerSeq:
    """Sequence view over an immutable's containers, decoding on touch.

    The pairwise algebra and the iterator flyweights index containers one by
    one, so handing them this sequence instead of a list makes every op
    decode only the containers it touches.  Decoded containers are cached on
    the owning bitmap.
    """

    __slots__ = ("_im",)

    #: structural mutation is impossible on the byte-backed class, so the
    #: iterator flyweights may hold this sequence instead of a list copy
    #: (which would decode every container)
    immutable = True

    def __init__(self, im: "ImmutableRoaringBitmap"):
        self._im = im

    def __len__(self) -> int:
        return self._im._view.size

    def __bool__(self) -> bool:
        return self._im._view.size > 0

    def __iter__(self):
        for i in range(len(self)):
            yield self._im._container(i)

    def __getitem__(self, i):
        n = len(self)
        if isinstance(i, slice):
            return [self._im._container(j) for j in range(*i.indices(n))]
        i = int(i)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError("container index out of range")
        return self._im._container(i)

    def cardinality_at(self, i: int) -> int:
        """Cardinality from the header alone: rank walks skip containers
        without decoding them."""
        return int(self._im._view.cardinalities[i])


class ImmutableRoaringBitmap:
    """Read-only view over a serialized 32-bit roaring bitmap."""

    RESULT_CLS = RoaringBitmap  # binary ops produce in-RAM results

    def __init__(self, buf: bytes | memoryview):
        self._view = spec.SerializedView(buf)
        self._cache: dict[int, C.Container] = {}
        self._seq = _LazyContainerSeq(self)

    # ----------------------------------------------------------- constructors
    @staticmethod
    def mapped(path: str) -> "ImmutableRoaringBitmap":
        """Memory-map a serialized bitmap file: the payloads stay on disk
        until a walk touches them."""
        with open(path, "rb") as f:
            mm = mmap_mod.mmap(f.fileno(), 0, access=mmap_mod.ACCESS_READ)
        return ImmutableRoaringBitmap(memoryview(mm))

    @staticmethod
    def from_bitmap(rb: RoaringBitmap) -> "ImmutableRoaringBitmap":
        return ImmutableRoaringBitmap(rb.serialize())

    # ------------------------------------------------------------- internals
    @property
    def keys(self) -> np.ndarray:
        return self._view.keys

    @property
    def containers(self) -> _LazyContainerSeq:
        """The lazy container sequence: indexing decodes (and caches) one
        container, so an AND against a large mapped file decodes the
        containers of the result, not all of them."""
        return self._seq

    def _container(self, i: int) -> C.Container:
        c = self._cache.get(i)
        if c is None:
            c = self._view.container(i)
            self._cache[i] = c
        return c

    def _index(self, hb: int) -> int:
        keys = self._view.keys
        i = int(np.searchsorted(keys, np.uint16(hb)))
        if i < keys.size and keys[i] == hb:
            return i
        return -i - 1

    # -------------------------------------------------------------- accessors
    @property
    def cardinality(self) -> int:
        """From the descriptive header alone: no payload touched."""
        return int(self._view.cardinalities.sum())

    def __len__(self) -> int:
        return self.cardinality

    def is_empty(self) -> bool:
        return self._view.size == 0

    def __bool__(self) -> bool:
        return not self.is_empty()

    def contains(self, x: int) -> bool:
        """Membership; a value outside [0, 2^32) is never a member."""
        if not 0 <= x < (1 << 32):
            return False
        i = self._index(x >> 16)
        return i >= 0 and self._container(i).contains(x & 0xFFFF)

    def __contains__(self, x: int) -> bool:
        return self.contains(x)

    def rank(self, x: int) -> int:
        hb = x >> 16
        keys = self._view.keys
        i = int(np.searchsorted(keys, np.uint16(hb), side="left"))
        total = int(self._view.cardinalities[:i].sum())
        if i < keys.size and keys[i] == hb:
            total += self._container(i).rank(x & 0xFFFF)
        return total

    def select(self, j: int) -> int:
        cum = np.cumsum(self._view.cardinalities)
        i = int(np.searchsorted(cum, j, side="right"))
        if i >= self._view.size:
            raise ValueError("select: rank out of bounds")
        prev = int(cum[i - 1]) if i else 0
        return (int(self._view.keys[i]) << 16) | \
            self._container(i).select(j - prev)

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return (int(self._view.keys[0]) << 16) | self._container(0).first()

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        n = self._view.size - 1
        return (int(self._view.keys[n]) << 16) | self._container(n).last()

    def has_run_compression(self) -> bool:
        return bool(self._view.is_run.any())

    def container_count(self) -> int:
        return self._view.size

    # ------------------------------------------------------------- iteration
    # RoaringBitmap's walks reused as plain functions: they touch only
    # .keys / .containers / ._index, and the lazy sequence makes each decode
    # the containers it visits, one at a time.
    to_array = RoaringBitmap.to_array
    __iter__ = RoaringBitmap.__iter__
    batch_iterator = RoaringBitmap.batch_iterator
    get_batch_iterator = RoaringBitmap.get_batch_iterator

    # ------------------------------------------------------------ conversion
    def to_bitmap(self) -> RoaringBitmap:
        """An in-RAM heap copy (toMutableRoaringBitmap).  The container list
        is copied: containers are persistent, but a shared list would let
        the copy's point mutations rebind this view's entries."""
        return RoaringBitmap(self._view.keys.copy(), list(self.containers))

    def to_mutable(self) -> "MutableRoaringBitmap":
        return MutableRoaringBitmap(self._view.keys.copy(),
                                    list(self.containers))

    def to_roaring_bitmap(self) -> RoaringBitmap:
        """toRoaringBitmap: alias of to_bitmap."""
        return self.to_bitmap()

    def clone(self) -> RoaringBitmap:
        """A heap copy, as the ops on this tier return in-RAM results: the
        host folds, ad-hoc expression leaves and single-source wide calls
        that copy their input take an immutable as they take a heap
        bitmap."""
        return self.to_bitmap()

    @staticmethod
    def bitmap_of(*values: int) -> "MutableRoaringBitmap":
        """ImmutableRoaringBitmap.bitmapOf returns the mutable class, as the
        reference does (an immutable needs backing bytes)."""
        rb = RoaringBitmap.bitmap_of(*values)
        return MutableRoaringBitmap(rb.keys, rb.containers)

    @staticmethod
    def remove(rb, range_start: int, range_end: int) -> "MutableRoaringBitmap":
        """Static range removal into a new bitmap
        (ImmutableRoaringBitmap.remove(rb, long, long))."""
        out = (rb.to_mutable() if isinstance(rb, ImmutableRoaringBitmap)
               else MutableRoaringBitmap(rb.keys.copy(),
                                         list(rb.containers)))
        out.remove_range(range_start, range_end)
        return out

    def to_mutable_roaring_bitmap(self) -> "MutableRoaringBitmap":
        """toMutableRoaringBitmap: alias of to_mutable."""
        return self.to_mutable()

    # both touch only .keys / .containers / .cardinality
    get_container_pointer = RoaringBitmap.get_container_pointer
    is_hamming_similar = RoaringBitmap.is_hamming_similar

    # ------------------------------------------------- read-only long tail
    # RoaringBitmap's implementations over the lazy sequence: the range
    # walks decode only the chunk span, the flyweights one container at a
    # time.
    for_each = RoaringBitmap.for_each
    for_each_in_range = RoaringBitmap.for_each_in_range
    for_all_in_range = RoaringBitmap.for_all_in_range
    get_int_iterator = RoaringBitmap.get_int_iterator
    get_reverse_int_iterator = RoaringBitmap.get_reverse_int_iterator
    get_signed_int_iterator = RoaringBitmap.get_signed_int_iterator
    first_signed = RoaringBitmap.first_signed
    last_signed = RoaringBitmap.last_signed

    def cardinality_exceeds(self, threshold: int) -> bool:
        # header only: no payload touched
        total = 0
        for c in self._view.cardinalities:
            total += int(c)
            if total > threshold:
                return True
        return False

    def range_cardinality(self, start: int, stop: int) -> int:
        """Members in [start, stop), the bounds clamped to the 32-bit
        universe as ``RoaringBitmap.range_cardinality`` clamps them."""
        lo, hi = (min(max(v, 0), 1 << 32) for v in (start, stop))
        if hi <= lo:
            return 0
        return self.rank(hi - 1) - (self.rank(lo - 1) if lo > 0 else 0)

    def rank_long(self, x: int) -> int:
        return self.rank(x)

    @property
    def long_cardinality(self) -> int:
        return self.cardinality

    def select_range(self, start: int, end: int) -> RoaringBitmap:
        """Members with rank in [start, end): the header's cumulative
        cardinalities locate the container span, and only those containers
        decode."""
        if start < 0 or end <= start:
            raise ValueError("invalid rank range")
        cum = np.concatenate(([0], np.cumsum(self._view.cardinalities)))
        if start >= cum[-1]:
            raise ValueError("select_range: start beyond cardinality")
        end = min(end, int(cum[-1]))
        first = int(np.searchsorted(cum, start, side="right")) - 1
        last = int(np.searchsorted(cum, end, side="left"))
        parts = []
        for i in range(first, last):
            vals = (np.uint32(int(self._view.keys[i]) << 16)
                    | self._container(i).values().astype(np.uint32))
            parts.append(vals[max(start - int(cum[i]), 0):end - int(cum[i])])
        return RoaringBitmap.from_values(np.concatenate(parts))

    def next_value(self, x: int) -> int:
        """Smallest member >= x, -1 if none: rank and select over the
        header, touching at most one container."""
        r = self.rank(x - 1) if x > 0 else 0
        if r >= self.cardinality:
            return -1
        return self.select(r)

    def previous_value(self, x: int) -> int:
        """Largest member <= x, -1 if none."""
        r = self.rank(x)
        return -1 if r == 0 else self.select(r - 1)

    # the absent-value walks touch one container per chunk step
    next_absent_value = RoaringBitmap.next_absent_value
    previous_absent_value = RoaringBitmap.previous_absent_value

    def limit(self, max_cardinality: int) -> RoaringBitmap:
        """The first max_cardinality members, by the same span walk."""
        if max_cardinality <= 0 or self.is_empty():
            return RoaringBitmap()
        return self.select_range(0, max_cardinality)

    # ----------------------------------------------------------- set algebra
    def __and__(self, o) -> RoaringBitmap:
        return rb_and(self, o)

    def __or__(self, o) -> RoaringBitmap:
        return rb_or(self, o)

    def __xor__(self, o) -> RoaringBitmap:
        return rb_xor(self, o)

    def __sub__(self, o) -> RoaringBitmap:
        return rb_andnot(self, o)

    def and_cardinality(self, o) -> int:
        return and_cardinality(self, o)

    def intersects(self, o) -> bool:
        return RoaringBitmap.intersects(self, o)

    def is_subset_of(self, o) -> bool:
        return RoaringBitmap.is_subset_of(self, o)

    # ---------------------------------------------------------- equality/repr
    def __eq__(self, o: object) -> bool:
        if isinstance(o, (ImmutableRoaringBitmap, RoaringBitmap)):
            return self.to_bitmap() == (
                o.to_bitmap() if isinstance(o, ImmutableRoaringBitmap) else o)
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.to_bitmap())

    def __repr__(self) -> str:
        return (f"ImmutableRoaringBitmap(card={self.cardinality}, "
                f"keys={self._view.size})")

    def __reduce__(self):
        return (ImmutableRoaringBitmap, (self.serialize(),))

    # ------------------------------------------------------------------- I/O
    def serialize(self) -> bytes:
        """The backing bytes, verbatim (already the portable format)."""
        return bytes(self._view.buf[:self._view.serialized_end()])

    def serialized_size_in_bytes(self) -> int:
        return self._view.serialized_end()

    def get_size_in_bytes(self) -> int:
        return self.serialized_size_in_bytes()


class MutableRoaringBitmap(RoaringBitmap):
    """The heap-mutable twin (buffer/MutableRoaringBitmap): the core
    RoaringBitmap plus the immutable pairing conversions."""

    def to_immutable(self) -> ImmutableRoaringBitmap:
        """toImmutableRoaringBitmap (a constant-time upcast in the
        reference; one serialization pass here)."""
        return ImmutableRoaringBitmap(self.serialize())

    def to_immutable_roaring_bitmap(self) -> ImmutableRoaringBitmap:
        """toImmutableRoaringBitmap: alias of to_immutable."""
        return self.to_immutable()

    def get_mappeable_roaring_array(self):
        """The expert backing-array accessor (getMappeableRoaringArray):
        the object itself exposes .keys / .containers."""
        return self

    # the static range removal lives only on ImmutableRoaringBitmap: here
    # ``remove`` stays the inherited point removal
    bitmap_of = staticmethod(ImmutableRoaringBitmap.bitmap_of)

    @staticmethod
    def from_immutable(im: ImmutableRoaringBitmap) -> "MutableRoaringBitmap":
        return im.to_mutable()
