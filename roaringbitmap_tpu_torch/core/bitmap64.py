"""64-bit tier: ``Roaring64Bitmap`` (the reference's longlong package).

Values split into a high 48-bit key and a low 16-bit container.  The key
index is a sorted ``u64`` NumPy array searched with ``np.searchsorted`` (the
reference indexes it with an adaptive radix tree), so bulk builds and key
merges are single vectorized passes, and the key axis packs straight into
the device rows of the wide engines: the kernels see only segment ids, so
the u48 key takes the place of the u16 key there.

``serialize`` writes the portable 64-bit spec (u64-LE bucket count, then per
high-32 bucket a u32-LE high word and the 32-bit format).  The reference's
native serialization, its ART node graph, is a codec here
(``serialize_art`` / ``deserialize_art``); ``deserialize`` reads both.
Hostile blobs raise ``InvalidRoaringFormat``.

``Roaring64NavigableMap`` is the reference's other 64-bit class: a map of
high-32-bit words to 32-bit RoaringBitmaps, signed or unsigned long order,
with both of its serialized forms (the legacy Java one and the portable
one, chosen by ``SERIALIZATION_MODE``).

This is the port's own copy of ``roaringbitmap_tpu.core.bitmap64``, byte for
byte in every serialized form.
"""

from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

from . import containers as C
from .bitmap import RoaringBitmap, and_, andnot, or_, xor
from .containers import Container
from ..format import spec

U64_MAX = (1 << 64) - 1

#: Roaring64NavigableMap's serialization mode: a module-wide default, like
#: the reference's static field
SERIALIZATION_MODE_LEGACY = 0
SERIALIZATION_MODE_PORTABLE = 1
SERIALIZATION_MODE = SERIALIZATION_MODE_LEGACY

# ART wire-format node kinds (art/NodeType.java ordinals)
_ART_NODE4, _ART_NODE16, _ART_NODE48, _ART_NODE256, _ART_LEAF = range(5)


def _art_container_payload_size(mv, ckind: int, card: int, pos: int,
                                bad) -> int:
    """Payload byte length of one serialized container in the ART container
    table (Containers.instanceContainer:352-377), bounds-checked."""
    if ckind == 0:  # run: u16 count + (value, length) u16 pairs
        if pos + 2 > len(mv):
            raise bad("truncated ART run container")
        (nbrruns,) = struct.unpack_from("<H", mv, pos)
        size = 2 + 4 * nbrruns
    elif ckind == 1:  # bitmap: 1024 u64 words
        size = 8 * C.WORDS_PER_CONTAINER
    elif ckind == 2:  # array: cardinality u16 values
        if not (0 <= card <= (1 << 16)):
            raise bad(f"implausible ART array cardinality {card}")
        size = 2 * card
    else:
        raise bad(f"unknown ART container type {ckind}")
    if pos + size > len(mv):
        raise bad("truncated ART container payload")
    return size


def _read_art_container(mv, ckind: int, card: int, pos: int, bad) -> Container:
    size = _art_container_payload_size(mv, ckind, card, pos, bad)
    raw = np.frombuffer(mv, dtype="<u2", count=size // 2, offset=pos)
    if ckind == 0:
        runs = raw[1:].astype(np.uint16)
        if runs.size >= 2:
            starts = runs[0::2].astype(np.int64)
            ends = starts + runs[1::2]  # inclusive
            if np.any(starts[1:] <= ends[:-1]) or np.any(ends > 0xFFFF):
                raise bad("ART run container overlapping / out of range")
        return C.RunContainer(runs)
    if ckind == 1:
        words = np.frombuffer(mv, dtype="<u8",
                              count=C.WORDS_PER_CONTAINER,
                              offset=pos).astype(np.uint64)
        return C.BitmapContainer(words)  # recount; header card is untrusted
    vals = raw.astype(np.uint16)
    if vals.size > 1 and np.any(vals[1:] <= vals[:-1]):
        raise bad("ART array container not sorted")
    return C.ArrayContainer(vals)


# ---------------------------------------------------------------- LongUtils
def high48(x: int) -> int:
    """LongUtils.highPart analog (LongUtils.java:13) as an int key."""
    return (x >> 16) & 0xFFFFFFFFFFFF


def low16(x: int) -> int:
    """LongUtils.lowPart (LongUtils.java:30)."""
    return x & 0xFFFF


def to_long(high: int, low: int) -> int:
    """LongUtils.toLong (LongUtils.java:60)."""
    return (high << 16) | low


class Roaring64Bitmap:
    """Compressed bitmap over the unsigned 64-bit universe.

    Same structure-of-arrays shape as the 32-bit class — ``keys`` is the
    sorted u64 array of high-48 prefixes, ``containers`` the matching low-16
    containers — so the whole pairwise algebra in core.bitmap and the
    group-by-key device packing in ops.packing apply unchanged.
    """

    __slots__ = ("keys", "containers")

    def __init__(self, keys: np.ndarray | None = None,
                 containers: list[Container] | None = None):
        self.keys = keys if keys is not None else np.empty(0, dtype=np.uint64)
        self.containers = containers if containers is not None else []

    # ------------------------------------------------------------------ build
    @staticmethod
    def bitmap_of(*values: int) -> "Roaring64Bitmap":
        return Roaring64Bitmap.from_values(np.array(values, dtype=np.uint64))

    @staticmethod
    def from_values(values: np.ndarray) -> "Roaring64Bitmap":
        """Vectorized bulk build (the addLong loop :50-62, batched)."""
        v = np.asarray(values, dtype=np.uint64)
        if v.size == 0:
            return Roaring64Bitmap()
        v = np.unique(v)
        hi = v >> np.uint64(16)
        keys, starts = np.unique(hi, return_index=True)
        bounds = np.append(starts, v.size)
        conts = [
            C.from_values((v[bounds[i]:bounds[i + 1]] & np.uint64(0xFFFF)).astype(np.uint16))
            for i in range(keys.size)
        ]
        return Roaring64Bitmap(keys, conts)

    @staticmethod
    def from_range(start: int, stop: int) -> "Roaring64Bitmap":
        rb = Roaring64Bitmap()
        rb.add_range(start, stop)
        return rb

    def clone(self) -> "Roaring64Bitmap":
        return Roaring64Bitmap(self.keys.copy(), list(self.containers))

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
        i = int(np.searchsorted(self.keys, np.uint64(hb)))
        if i < self.keys.size and self.keys[i] == hb:
            return i
        return -i - 1

    def contains(self, x: int) -> bool:
        i = self._index(high48(x))
        return i >= 0 and self.containers[i].contains(low16(x))

    def __contains__(self, x: int) -> bool:
        return self.contains(x)

    def rank(self, x: int) -> int:
        """Members <= x (Roaring64Bitmap.rankLong)."""
        hb = high48(x)
        i = int(np.searchsorted(self.keys, np.uint64(hb), side="left"))
        total = sum(c.cardinality for c in self.containers[:i])
        if i < self.keys.size and self.keys[i] == hb:
            total += self.containers[i].rank(low16(x))
        return total

    def select(self, j: int) -> int:
        """j-th smallest member, 0-based (Roaring64Bitmap.select)."""
        for k, c in zip(self.keys, self.containers):
            if j < c.cardinality:
                return to_long(int(k), c.select(j))
            j -= c.cardinality
        raise ValueError("select: rank out of bounds")

    def first(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return to_long(int(self.keys[0]), self.containers[0].first())

    def last(self) -> int:
        if self.is_empty():
            raise ValueError("empty bitmap")
        return to_long(int(self.keys[-1]), self.containers[-1].last())

    def next_value(self, x: int) -> int:
        """Smallest member >= x, or -1."""
        r = self.rank(x - 1) if x > 0 else 0
        if r >= self.cardinality:
            return -1
        return self.select(r)

    def previous_value(self, x: int) -> int:
        """Largest member <= x, or -1."""
        r = self.rank(x)
        return self.select(r - 1) if r > 0 else -1

    def rank_long(self, x: int) -> int:
        """rankLong alias (Python ints are unbounded)."""
        return self.rank(x)

    @property
    def int_cardinality(self) -> int:
        """getIntCardinality: clamps to int range in the reference; Python
        ints don't overflow, so this equals cardinality."""
        return self.cardinality

    @property
    def long_cardinality(self) -> int:
        """getLongCardinality alias."""
        return self.cardinality

    def and_not(self, o: "Roaring64Bitmap") -> None:
        """In-place difference, Java's andNot(other) naming."""
        self.iandnot(o)

    def get_long_size_in_bytes(self) -> int:
        return self.get_size_in_bytes()

    def trim(self) -> None:
        """trim(): NumPy-backed containers are exact-sized; API parity."""

    def limit(self, max_cardinality: int) -> "Roaring64Bitmap":
        """First max_cardinality members (limit) — walks containers only
        until the budget is spent (never materializes the whole set)."""
        if max_cardinality <= 0 or self.is_empty():
            return Roaring64Bitmap()
        parts: list[np.ndarray] = []
        left = max_cardinality
        for k, c in zip(self.keys, self.containers):
            vals = c.values()[:left].astype(np.uint64)
            parts.append(np.uint64(int(k) << 16) | vals)
            left -= vals.size
            if left == 0:
                break
        return Roaring64Bitmap.from_values(np.concatenate(parts))

    def for_each(self, fn) -> None:
        """Visit every member ascending (forEach)."""
        for v in self:
            fn(v)

    def for_each_in_range(self, start: int, stop: int, fn) -> None:
        """Visit members in [start, stop) ascending (forEachInRange).
        stop=2^64 covers the top of the universe (same exclusive-stop
        convention as add_range)."""
        for v in self.long_iterator_from(start):
            if v >= stop:
                return
            fn(v)

    def for_all_in_range(self, start: int, stop: int, fn) -> None:
        """Visit every position in [start, stop) with its membership bit
        (forAllInRange)."""
        members = set()
        for v in self.long_iterator_from(start):
            if v >= stop:
                break
            members.add(v)
        for v in range(start, stop):
            fn(v - start, v in members)

    def long_iterator(self):
        """Ascending iterator (getLongIterator)."""
        return iter(self)

    def long_iterator_from(self, minimum: int):
        """Ascending from the first member >= minimum (getLongIteratorFrom)
        — lazy per container, like __iter__."""
        hb = high48(minimum)
        i = int(np.searchsorted(self.keys, np.uint64(hb)))
        for j in range(i, self.keys.size):
            k = int(self.keys[j])
            vals = self.containers[j].values()
            if k == hb:
                vals = vals[np.searchsorted(vals, low16(minimum)):]
            base = k << 16
            for v in vals:
                yield base | int(v)

    def reverse_long_iterator(self):
        """Descending iterator (getReverseLongIterator) — lazy per
        container."""
        for j in range(self.keys.size - 1, -1, -1):
            base = int(self.keys[j]) << 16
            for v in self.containers[j].values()[::-1]:
                yield base | int(v)

    def reverse_long_iterator_from(self, maximum: int):
        """Descending from the last member <= maximum
        (getReverseLongIteratorFrom) — lazy per container."""
        hb = high48(maximum)
        i = int(np.searchsorted(self.keys, np.uint64(hb), side="right")) - 1
        for j in range(i, -1, -1):
            k = int(self.keys[j])
            vals = self.containers[j].values()
            if k == hb:
                vals = vals[:np.searchsorted(vals, low16(maximum),
                                             side="right")]
            base = k << 16
            for v in vals[::-1]:
                yield base | int(v)

    # ------------------------------------------------------------- iteration
    def to_array(self) -> np.ndarray:
        if not self.containers:
            return np.empty(0, dtype=np.uint64)
        parts = [
            (np.uint64(int(k) << 16) | c.values().astype(np.uint64))
            for k, c in zip(self.keys, self.containers)
        ]
        return np.concatenate(parts)

    def __iter__(self) -> Iterator[int]:
        for k, c in zip(self.keys, self.containers):
            base = int(k) << 16
            for v in c.values():
                yield base | int(v)

    def batch_iterator(self, batch_size: int = 65536) -> Iterator[np.ndarray]:
        buf: list[np.ndarray] = []
        n = 0
        for k, c in zip(self.keys, self.containers):
            part = np.uint64(int(k) << 16) | c.values().astype(np.uint64)
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

    # -------------------------------------------------------------- mutation
    def add(self, x: int) -> None:
        """Point insert (Roaring64Bitmap.addLong :50-62)."""
        i = self._index(high48(x))
        if i >= 0:
            self.containers[i] = self.containers[i].add(low16(x))
        else:
            self._insert(-i - 1, high48(x),
                         C.ArrayContainer(np.array([low16(x)], dtype=np.uint16)))

    def add_many(self, values: np.ndarray) -> None:
        other = Roaring64Bitmap.from_values(values)
        res = or_(self, other)
        self.keys, self.containers = res.keys, res.containers

    def remove(self, x: int) -> None:
        i = self._index(high48(x))
        if i < 0:
            return
        c = self.containers[i].remove(low16(x))
        if c.cardinality == 0:
            self._delete(i)
        else:
            self.containers[i] = c

    def add_range(self, start: int, stop: int) -> None:
        """Set all of [start, stop) (Roaring64Bitmap.addRange :211-248)."""
        for lo, hi_excl, hb in _chunk_ranges64(start, stop):
            i = self._index(hb)
            full_chunk = lo == 0 and hi_excl == 0x10000
            if i >= 0:
                if full_chunk:
                    self.containers[i] = C.full_container()
                else:
                    self.containers[i] = C.container_or(
                        self.containers[i], C.range_container(lo, hi_excl))
            else:
                self._insert(-i - 1, hb, C.range_container(lo, hi_excl))

    def remove_range(self, start: int, stop: int) -> None:
        kill: list[int] = []
        for lo, hi_excl, hb in _chunk_ranges64(start, stop):
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
        for lo, hi_excl, hb in _chunk_ranges64(start, stop):
            i = self._index(hb)
            rc = C.range_container(lo, hi_excl)
            if i >= 0:
                c = C.container_xor(self.containers[i], rc)
                if c.cardinality == 0:
                    self._delete(i)
                else:
                    self.containers[i] = c
            else:
                self._insert(-i - 1, hb, rc)

    def flip(self, x: int) -> None:
        """Single-value flip (Roaring64Bitmap.flip(long))."""
        if self.contains(x):
            self.remove(x)
        else:
            self.add(x)

    def _insert(self, pos: int, key: int, cont: Container) -> None:
        self.keys = np.insert(self.keys, pos, np.uint64(key))
        self.containers.insert(pos, cont)

    def _delete(self, pos: int) -> None:
        self.keys = np.delete(self.keys, pos)
        del self.containers[pos]

    def clear(self) -> None:
        self.keys = np.empty(0, dtype=np.uint64)
        self.containers = []

    def run_optimize(self) -> bool:
        changed = False
        for i, c in enumerate(self.containers):
            o = c.run_optimize()
            if o is not c:
                self.containers[i] = o
                changed = changed or o.is_run()
        return changed

    def has_run_compression(self) -> bool:
        return any(c.is_run() for c in self.containers)

    # ----------------------------------------------------------- set algebra
    # The pairwise merges are the generic key-merge functions from
    # core.bitmap — they construct type(a)(keys-with-a's-dtype, conts), so
    # they work unchanged over the u64 key axis.
    def __and__(self, o: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return and_(self, o)

    def __or__(self, o: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return or_(self, o)

    def __xor__(self, o: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return xor(self, o)

    def __sub__(self, o: "Roaring64Bitmap") -> "Roaring64Bitmap":
        return andnot(self, o)

    def iand(self, o: "Roaring64Bitmap") -> None:
        r = and_(self, o)
        self.keys, self.containers = r.keys, r.containers

    def ior(self, o: "Roaring64Bitmap") -> None:
        r = or_(self, o)
        self.keys, self.containers = r.keys, r.containers

    def ixor(self, o: "Roaring64Bitmap") -> None:
        r = xor(self, o)
        self.keys, self.containers = r.keys, r.containers

    def iandnot(self, o: "Roaring64Bitmap") -> None:
        r = andnot(self, o)
        self.keys, self.containers = r.keys, r.containers

    # ---------------------------------------------------------- equality/repr
    def __eq__(self, o: object) -> bool:
        if not isinstance(o, Roaring64Bitmap):
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
        return f"Roaring64Bitmap(card={card}, keys={self.keys.size}, {{{head}{tail}}})"

    # ------------------------------------------------------------------- I/O
    def _buckets32(self) -> list[tuple[int, RoaringBitmap]]:
        """Group high-48 keys by their upper 32 bits into 32-bit bitmaps.

        The container objects are shared, not copied: a bucket's 32-bit
        bitmap has keys = middle 16 bits of the 48-bit prefix.
        """
        if not self.containers:
            return []
        hi32 = (self.keys >> np.uint64(16)).astype(np.uint32)
        highs, starts = np.unique(hi32, return_index=True)
        bounds = np.append(starts, self.keys.size)
        out = []
        for i, h in enumerate(highs):
            lo, hi = int(bounds[i]), int(bounds[i + 1])
            keys16 = (self.keys[lo:hi] & np.uint64(0xFFFF)).astype(np.uint16)
            out.append((int(h), RoaringBitmap(keys16, self.containers[lo:hi])))
        return out

    def serialize(self) -> bytes:
        """Portable 64-bit spec (Roaring64NavigableMap.serializePortable
        :1254-1260 / RoaringFormatSpec 64-bit extension): u64-LE bucket
        count, then per bucket u32-LE high bits + the 32-bit format."""
        buckets = self._buckets32()
        out = bytearray(struct.pack("<Q", len(buckets)))
        for high, rb32 in buckets:
            out += struct.pack("<I", high)
            out += rb32.serialize()
        return bytes(out)

    @staticmethod
    def deserialize(buf: bytes | memoryview) -> "Roaring64Bitmap":
        """Portable 64-bit spec, with auto-detection of the reference's
        native ART stream: a portable parse failure
        falls back to deserialize_art, so bytes from either implementation
        round-trip; streams valid in neither format raise a typed error
        naming both."""
        mv = memoryview(buf)
        try:
            return Roaring64Bitmap._deserialize_portable(mv)
        except spec.InvalidRoaringFormat as portable_err:
            try:
                return Roaring64Bitmap.deserialize_art(mv)
            except spec.InvalidRoaringFormat as art_err:
                raise spec.InvalidRoaringFormat(
                    "stream is neither portable 64-bit "
                    f"({portable_err}) nor reference-ART ({art_err})"
                ) from None

    @staticmethod
    def _deserialize_portable(buf: bytes | memoryview) -> "Roaring64Bitmap":
        mv = memoryview(buf)
        if len(mv) < 8:
            raise spec.InvalidRoaringFormat("truncated 64-bit header")
        (n,) = struct.unpack_from("<Q", mv, 0)
        pos = 8
        keys_parts: list[np.ndarray] = []
        conts: list[Container] = []
        prev_high = -1
        for _ in range(n):
            if pos + 4 > len(mv):
                raise spec.InvalidRoaringFormat("truncated 64-bit bucket header")
            (high,) = struct.unpack_from("<I", mv, pos)
            if high <= prev_high:
                raise spec.InvalidRoaringFormat("64-bit bucket keys not ascending")
            prev_high = high
            pos += 4
            view = spec.SerializedView(mv[pos:])
            k16 = view.keys.copy()
            bucket_conts = [view.container(i) for i in range(view.size)]
            pos += view.serialized_end()
            keys_parts.append((np.uint64(high) << np.uint64(16))
                              | k16.astype(np.uint64))
            conts.extend(bucket_conts)
        keys = (np.concatenate(keys_parts) if keys_parts
                else np.empty(0, dtype=np.uint64))
        return Roaring64Bitmap(keys, conts)

    # ------------------------------------------------- ART wire-format codec
    # The reference Roaring64Bitmap's native serialization
    # (HighLowContainer.serialize:155-185): u8 empty tag; Art.serializeArt
    # (i64-LE key count + a preorder node stream, children ascending); then
    # Containers.serialize (two-level container table) and a 16-byte
    # allocator trailer.  All integers little-endian (the ByteBuffer path).

    def serialize_art(self) -> bytes:
        """Emit the reference's native ART format (readable by
        Roaring64Bitmap.deserialize on the JVM side).

        The node stream is the canonical prefix-compressed radix tree over
        the 6-byte big-endian high-48 keys: node kind by child count
        (Node4/16/48/256, art/Node*.java packings), leaves carry the full
        key + container index into a single first-level container array.
        """
        if self.keys.size == 0:
            return b"\x00"
        out = bytearray(b"\x01")
        out += struct.pack("<q", self.keys.size)
        kb = [int(k).to_bytes(6, "big") for k in self.keys]

        def emit(lo: int, hi: int, depth: int) -> None:
            if hi - lo == 1:
                out.extend(struct.pack("<BhB", _ART_LEAF, 0, 0))
                out.extend(kb[lo])
                out.extend(struct.pack("<q", lo))  # containerIdx: level (0, lo)
                return
            d = depth  # longest common prefix below the current depth
            while all(kb[i][d] == kb[lo][d] for i in range(lo + 1, hi)):
                d += 1
            # child groups by the byte at d (keys are sorted, groups contiguous)
            bounds = [lo] + [i for i in range(lo + 1, hi)
                             if kb[i][d] != kb[i - 1][d]] + [hi]
            child_keys = bytes(kb[b][d] for b in bounds[:-1])
            n = len(child_keys)
            kind = (_ART_NODE4 if n <= 4 else _ART_NODE16 if n <= 16
                    else _ART_NODE48 if n <= 48 else _ART_NODE256)
            prefix = kb[lo][depth:d]
            out.extend(struct.pack("<BhB", kind, n, len(prefix)))
            out.extend(prefix)
            if kind == _ART_NODE4:       # int of the 4 BE key bytes, LE wire
                out.extend((child_keys + b"\x00" * 4)[:4][::-1])
            elif kind == _ART_NODE16:    # two BE-packed longs, LE wire
                padded = (child_keys + b"\x00" * 16)[:16]
                out.extend(padded[:8][::-1])
                out.extend(padded[8:][::-1])
            elif kind == _ART_NODE48:    # 256 child-pos byte slots in 32 longs
                slots = bytearray(b"\xff" * 256)
                for pos, key_byte in enumerate(child_keys):
                    slots[8 * (key_byte >> 3) + (7 - (key_byte & 7))] = pos
                out.extend(slots)
            else:                        # 4-long presence bitmap
                mask = np.zeros(4, dtype=np.uint64)
                for key_byte in child_keys:
                    mask[key_byte >> 6] |= np.uint64(1) << np.uint64(key_byte & 63)
                out.extend(mask.astype("<u8").tobytes())
            for a, b in zip(bounds[:-1], bounds[1:]):
                emit(a, b, d + 1)

        emit(0, self.keys.size, 0)
        # Containers: one first-level array with every container in key order
        out += struct.pack("<i", 1)
        out += struct.pack("<bi", -2, len(self.containers))  # NOT_TRIMMED
        for c in self.containers:
            kind = 0 if c.is_run() else (
                1 if isinstance(c, C.BitmapContainer) else 2)
            out += struct.pack("<BBi", 1, kind, c.cardinality)
            c.write_payload(out)
        # allocator cursor trailer: (firstLevelIdx, secondLevelIdx) are the
        # LAST-USED indices (Containers.addContainer increments before
        # writing), so a JVM-side addContainer after deserialize appends
        # without leaving a hole
        out += struct.pack("<qii", len(self.containers), 0,
                           len(self.containers) - 1)
        return bytes(out)

    @staticmethod
    def deserialize_art(buf: bytes | memoryview) -> "Roaring64Bitmap":
        """Read the reference's native ART serialization.

        Internal-node key bytes are structural only — every leaf is
        self-describing — so the walk just needs each node's size and child
        count; hostile streams raise InvalidRoaringFormat, never crash.
        """
        mv = memoryview(buf)
        bad = spec.InvalidRoaringFormat
        if len(mv) < 1:
            raise bad("truncated ART 64-bit stream (missing empty tag)")
        tag = mv[0]
        if tag == 0:
            return Roaring64Bitmap()
        if tag != 1:
            raise bad(f"bad ART empty tag {tag}")
        if len(mv) < 9:
            raise bad("truncated ART key count")
        (key_count,) = struct.unpack_from("<q", mv, 1)
        if not (0 < key_count <= (len(mv) // 14)):  # a leaf needs >= 18 bytes
            raise bad(f"implausible ART key count {key_count}")
        pos = 9
        leaves: list[tuple[bytes, int]] = []
        _BODY = {_ART_NODE4: 4, _ART_NODE16: 16, _ART_NODE48: 256,
                 _ART_NODE256: 32}

        def parse_node(depth: int = 0) -> None:
            nonlocal pos
            if depth > 8:  # 6 key bytes bound a valid ART's height
                raise bad("ART node stream nests deeper than a 48-bit key")
            if len(leaves) > key_count:
                raise bad("ART node stream has more leaves than keySize")
            if pos + 4 > len(mv):
                raise bad("truncated ART node header")
            kind, count, plen = struct.unpack_from("<BhB", mv, pos)
            pos += 4 + plen
            if pos > len(mv):
                raise bad("truncated ART node prefix")
            if kind == _ART_LEAF:
                if pos + 14 > len(mv):
                    raise bad("truncated ART leaf body")
                leaves.append((bytes(mv[pos:pos + 6]),
                               struct.unpack_from("<q", mv, pos + 6)[0]))
                pos += 14
                return
            body = _BODY.get(kind)
            if body is None:
                raise bad(f"unknown ART node type {kind}")
            if count <= 0 or count > 256:
                raise bad(f"bad ART child count {count}")
            pos += body
            for _ in range(count):
                parse_node(depth + 1)

        parse_node()
        if len(leaves) != key_count:
            raise bad(f"ART leaf count {len(leaves)} != keySize {key_count}")
        # Containers table
        if pos + 4 > len(mv):
            raise bad("truncated ART containers header")
        (first_level,) = struct.unpack_from("<i", mv, pos)
        pos += 4
        if first_level < 0:
            raise bad("negative ART container table size")
        arrays: list[list[Container | None]] = []
        for _ in range(first_level):
            if pos + 5 > len(mv):
                raise bad("truncated ART container array header")
            _trim, second = struct.unpack_from("<bi", mv, pos)
            pos += 5
            if not (0 <= second <= len(mv)):
                raise bad("implausible ART container array size")
            row: list[Container | None] = []
            for _ in range(second):
                if pos + 1 > len(mv):
                    raise bad("truncated ART container slot")
                null_tag = mv[pos]
                pos += 1
                if null_tag == 0:
                    row.append(None)
                    continue
                if null_tag != 1:
                    raise bad(f"bad ART container null tag {null_tag}")
                if pos + 5 > len(mv):
                    raise bad("truncated ART container header")
                ckind, card = struct.unpack_from("<Bi", mv, pos)
                pos += 5
                row.append(_read_art_container(mv, ckind, card, pos, bad))
                pos += _art_container_payload_size(mv, ckind, card, pos, bad)
            arrays.append(row)
        if pos + 16 > len(mv):
            raise bad("truncated ART allocator trailer")
        keys = np.empty(len(leaves), dtype=np.uint64)
        conts: list[Container] = []
        for i, (key6, cidx) in enumerate(leaves):
            keys[i] = int.from_bytes(key6, "big")
            fl, sl = cidx >> 32, cidx & 0xFFFFFFFF
            if not (0 <= fl < len(arrays) and 0 <= sl < len(arrays[fl])):
                raise bad(f"ART leaf container index {cidx} out of range")
            cont = arrays[fl][sl]
            if cont is None:
                raise bad(f"ART leaf points at a null container slot {cidx}")
            conts.append(cont)
        order = np.argsort(keys, kind="stable")
        if not np.array_equal(order, np.arange(keys.size)):
            keys = keys[order]
            conts = [conts[i] for i in order]
        if np.unique(keys).size != keys.size:
            raise bad("duplicate ART leaf keys")
        return Roaring64Bitmap(keys, conts)

    def __reduce__(self):
        """Pickle via the portable 64-bit spec (Externalizable analog)."""
        return (Roaring64Bitmap.deserialize, (self.serialize(),))

    def serialized_size_in_bytes(self) -> int:
        return 8 + sum(4 + rb.serialized_size_in_bytes()
                       for _, rb in self._buckets32())

    def get_size_in_bytes(self) -> int:
        total = 8 + 8 * self.keys.size
        for c in self.containers:
            total += c.serialized_size_in_bytes()
        return total

    def container_count(self) -> int:
        return len(self.containers)


def _chunk_ranges64(start: int, stop: int):
    """Split [start, stop) into per-chunk (lo, hi_excl, high48) pieces."""
    if start >= stop:
        return
    if start < 0 or stop > (1 << 64):
        raise ValueError("range outside the 64-bit universe")
    hb_first, hb_last = start >> 16, (stop - 1) >> 16
    for hb in range(hb_first, hb_last + 1):
        lo = start & 0xFFFF if hb == hb_first else 0
        hi_excl = ((stop - 1) & 0xFFFF) + 1 if hb == hb_last else 0x10000
        yield lo, hi_excl, hb


# ---------------------------------------------------------------------------
# Roaring64NavigableMap: the high-32 / low-32 NavigableMap variant.
# ---------------------------------------------------------------------------

class Roaring64NavigableMap:
    """Map of high-32-bit key -> 32-bit RoaringBitmap (the reference's
    ``Roaring64NavigableMap``), with signed or unsigned long ordering and
    both serialization formats.

    ``supplier`` is the BitmapDataProviderSupplier analog: a zero-argument
    callable making each bucket's 32-bit bitmap, so the backend is
    pluggable (``FastRankRoaringBitmap`` for rank-heavy work,
    ``MutableRoaringBitmap`` for the buffer tier).  The wide 64-bit entry
    points (``aggregation.or64`` / ``xor64`` / ``and64``) and the resident
    sets take a navigable map through :meth:`to_roaring64`, which shares the
    containers.
    """

    def __init__(self, signed_longs: bool = False, supplier=None):
        self.signed_longs = signed_longs
        self._supplier = supplier or RoaringBitmap
        self._map: dict[int, RoaringBitmap] = {}  # unsigned u32 high -> bitmap
        self._sorted_highs: list[int] | None = None
        self._cum_cards: np.ndarray | None = None

    # ----------------------------------------------------------------- build
    @staticmethod
    def bitmap_of(*values: int) -> "Roaring64NavigableMap":
        rb = Roaring64NavigableMap()
        for v in values:
            rb.add(v)
        return rb

    @staticmethod
    def from_values(values: np.ndarray, signed_longs: bool = False,
                    supplier=None) -> "Roaring64NavigableMap":
        rb = Roaring64NavigableMap(signed_longs, supplier)
        v = np.unique(np.asarray(values, dtype=np.uint64))
        if v.size == 0:
            return rb
        hi = (v >> np.uint64(32)).astype(np.uint32)
        highs, starts = np.unique(hi, return_index=True)
        bounds = np.append(starts, v.size)
        for i, h in enumerate(highs):
            lows = (v[bounds[i]:bounds[i + 1]] & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            if rb._supplier is RoaringBitmap:
                rb._map[int(h)] = RoaringBitmap.from_values(lows)
            else:  # pluggable backend: bulk-ingest into a supplied bucket
                b = rb._supplier()
                b.add_many(lows)
                rb._map[int(h)] = b
        rb._invalidate()
        return rb

    # ------------------------------------------------------------- key order
    def _key_order(self, high: int) -> int:
        """Sort key for a stored (unsigned) high word under the active order."""
        if self.signed_longs and high >= 1 << 31:
            return high - (1 << 32)
        return high

    def _highs(self) -> list[int]:
        if self._sorted_highs is None:
            self._sorted_highs = sorted(self._map, key=self._key_order)
        return self._sorted_highs

    def _cum(self) -> np.ndarray:
        """Cached cumulative cardinalities (the reference's perf helpers)."""
        if self._cum_cards is None:
            cards = [self._map[h].cardinality for h in self._highs()]
            self._cum_cards = np.cumsum([0] + cards)
        return self._cum_cards

    def _invalidate(self) -> None:
        self._sorted_highs = None
        self._cum_cards = None

    # -------------------------------------------------------------- accessors
    @property
    def cardinality(self) -> int:
        return sum(b.cardinality for b in self._map.values())

    def __len__(self) -> int:
        return self.cardinality

    def is_empty(self) -> bool:
        return all(b.is_empty() for b in self._map.values())

    def contains(self, x: int) -> bool:
        x &= U64_MAX
        b = self._map.get(x >> 32)
        return b is not None and b.contains(x & 0xFFFFFFFF)

    def __contains__(self, x: int) -> bool:
        return self.contains(x)

    def rank(self, x: int) -> int:
        """Members <= x in the active long order (rankLong)."""
        x &= U64_MAX
        highs = self._highs()
        cum = self._cum()
        hx = self._key_order(x >> 32)
        total = 0
        for i, h in enumerate(highs):
            kh = self._key_order(h)
            if kh < hx:
                total = int(cum[i + 1])
            elif kh == hx:
                total = int(cum[i]) + self._map[h].rank(x & 0xFFFFFFFF)
        return total

    def select(self, j: int) -> int:
        """j-th member in the active long order (select), 0-based."""
        highs = self._highs()
        cum = self._cum()
        i = int(np.searchsorted(cum, j, side="right")) - 1
        if i < 0 or i >= len(highs) or j >= cum[-1]:
            raise ValueError("select: rank out of bounds")
        h = highs[i]
        low = self._map[h].select(j - int(cum[i]))
        return ((h << 32) | low) & U64_MAX

    def first(self) -> int:
        highs = self._highs()
        if not highs:
            raise ValueError("empty bitmap")
        h = highs[0]
        return ((h << 32) | self._map[h].first()) & U64_MAX

    def last(self) -> int:
        highs = self._highs()
        if not highs:
            raise ValueError("empty bitmap")
        h = highs[-1]
        return ((h << 32) | self._map[h].last()) & U64_MAX

    # -------------------------------------------------------------- mutation
    def add(self, x: int) -> None:
        x &= U64_MAX
        h = x >> 32
        b = self._map.get(h)
        if b is None:
            b = self._supplier()
            self._map[h] = b
            self._sorted_highs = None
        b.add(x & 0xFFFFFFFF)
        self._cum_cards = None

    def add_long(self, x: int) -> None:
        self.add(x)

    def add_int(self, x: int) -> None:
        """addInt: zero-extends a 32-bit int (Roaring64NavigableMap.addInt)."""
        self.add(x & 0xFFFFFFFF)

    def remove(self, x: int) -> None:
        x &= U64_MAX
        h = x >> 32
        b = self._map.get(h)
        if b is None:
            return
        b.remove(x & 0xFFFFFFFF)
        if b.is_empty():
            del self._map[h]
            self._sorted_highs = None
        self._cum_cards = None

    def add_range(self, start: int, stop: int) -> None:
        """addRange over [start, stop) split at 2^32 bucket boundaries."""
        if start >= stop:
            return
        h_first, h_last = start >> 32, (stop - 1) >> 32
        for h in range(h_first, h_last + 1):
            lo = start & 0xFFFFFFFF if h == h_first else 0
            hi = ((stop - 1) & 0xFFFFFFFF) + 1 if h == h_last else 1 << 32
            b = self._map.get(h)
            if b is None:
                b = self._supplier()
                self._map[h] = b
            b.add_range(lo, hi)
        self._invalidate()

    # ----------------------------------------------------------- set algebra
    def _binary_inplace(self, o: "Roaring64NavigableMap", op: str) -> None:
        ops = {"and": and_, "or": or_, "xor": xor, "andnot": andnot}
        f = ops[op]
        if op == "and":
            keep = {}
            for h, b in self._map.items():
                ob = o._map.get(h)
                if ob is not None:
                    r = f(b, ob)
                    if not r.is_empty():
                        keep[h] = r
            self._map = keep
        else:
            for h, ob in (o._map.items() if op != "andnot" else ()):
                b = self._map.get(h)
                r = f(b, ob) if b is not None else ob.clone()
                if r.is_empty():
                    self._map.pop(h, None)
                else:
                    self._map[h] = r
            if op == "andnot":
                for h in list(self._map):
                    ob = o._map.get(h)
                    if ob is not None:
                        r = f(self._map[h], ob)
                        if r.is_empty():
                            del self._map[h]
                        else:
                            self._map[h] = r
        self._invalidate()

    def iand(self, o: "Roaring64NavigableMap") -> None:
        self._binary_inplace(o, "and")

    def ior(self, o: "Roaring64NavigableMap") -> None:
        self._binary_inplace(o, "or")

    def ixor(self, o: "Roaring64NavigableMap") -> None:
        self._binary_inplace(o, "xor")

    def iandnot(self, o: "Roaring64NavigableMap") -> None:
        self._binary_inplace(o, "andnot")

    # ------------------------------------------------------------- iteration
    def __iter__(self) -> Iterator[int]:
        for h in self._highs():
            base = (h << 32) & U64_MAX
            for v in self._map[h]:
                yield base | v

    def to_array(self) -> np.ndarray:
        parts = [((np.uint64(h) << np.uint64(32)) | self._map[h].to_array().astype(np.uint64))
                 for h in self._highs()]
        return np.concatenate(parts) if parts else np.empty(0, dtype=np.uint64)

    def run_optimize(self) -> bool:
        return any([b.run_optimize() for b in self._map.values()])

    # ------------------------------------------------- long-tail API parity
    def clear(self) -> None:
        """Empty the map (Roaring64NavigableMap.clear)."""
        self._map = {}
        self._invalidate()

    def flip(self, x: int) -> None:
        """Single-bit flip (flip(long))."""
        if x in self:
            self.remove(x)
        else:
            self.add(x)

    def for_each(self, fn) -> None:
        """Visit every member in the active key order (forEach/accept)."""
        for v in self:
            fn(v)

    def get_long_iterator(self) -> Iterator[int]:
        """Ascending (in the active order) value iterator (getLongIterator)."""
        return iter(self)

    def get_reverse_long_iterator(self) -> Iterator[int]:
        """Descending value iterator (getReverseLongIterator) — the
        per-bucket reverse flyweight keeps memory O(one container)."""
        for h in reversed(self._highs()):
            base = (h << 32) & U64_MAX
            for v in self._map[h].get_reverse_int_iterator():
                yield base | v

    def limit(self, max_cardinality: int) -> "Roaring64NavigableMap":
        """First max_cardinality members in the active order (limit)."""
        out = Roaring64NavigableMap(self.signed_longs, self._supplier)
        left = max_cardinality
        for h in self._highs():
            if left <= 0:
                break
            b = self._map[h]
            take = b if b.cardinality <= left else b.limit(left)
            bucket = self._supplier()  # keep the pluggable backend
            bucket.ior(take)  # splices shared (persistent) containers
            out._map[h] = bucket
            left -= take.cardinality
        out._invalidate()
        return out

    def trim(self) -> None:
        """trim(): exact-sized NumPy arrays already; API parity."""

    def get_size_in_bytes(self) -> int:
        """Rough in-memory footprint (getSizeInBytes analog)."""
        return 8 + sum(8 + b.get_size_in_bytes() for b in self._map.values())

    def get_long_size_in_bytes(self) -> int:
        return self.get_size_in_bytes()

    @property
    def long_cardinality(self) -> int:
        """getLongCardinality: alias of cardinality."""
        return self.cardinality

    @property
    def int_cardinality(self) -> int:
        """getIntCardinality: raises when the count exceeds a signed
        32-bit int, like the reference's UnsupportedOperationException."""
        card = self.cardinality
        if card > 0x7FFFFFFF:
            raise OverflowError("cardinality exceeds a 32-bit int")
        return card

    def naive_lazy_or(self, o: "Roaring64NavigableMap") -> None:
        """naivelazyor: the reference defers per-container cardinality
        during OR chains and repairs at the end; here there is no deferred
        state, so this is the plain in-place union."""
        self.ior(o)

    def repair_after_lazy(self) -> None:
        """repairAfterLazy: no deferred state to repair (see
        naive_lazy_or)."""

    def and_not(self, o: "Roaring64NavigableMap") -> None:
        """In-place difference, Java's andNot(other) naming."""
        self.iandnot(o)

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, Roaring64NavigableMap):
            return NotImplemented
        return ({h: None for h in self._map} == {h: None for h in o._map}
                and all(self._map[h] == o._map[h] for h in self._map))

    def __hash__(self) -> int:
        return hash(self.to_array().tobytes())

    def __repr__(self) -> str:
        return (f"Roaring64NavigableMap(card={self.cardinality}, "
                f"buckets={len(self._map)}, signed={self.signed_longs})")

    # ------------------------------------------------------------------- I/O
    def serialize(self, mode: int | None = None) -> bytes:
        mode = SERIALIZATION_MODE if mode is None else mode
        if mode == SERIALIZATION_MODE_PORTABLE:
            return self.serialize_portable()
        return self.serialize_legacy()

    def serialize_legacy(self) -> bytes:
        """The legacy Java format (serializeLegacy): a 1-byte boolean
        signedLongs, an i32-BE bucket count, then per bucket an i32-BE high
        word and the 32-bit portable payload."""
        out = bytearray()
        out += struct.pack(">?i", self.signed_longs, len(self._map))
        for h in self._highs():
            out += struct.pack(">i", h - (1 << 32) if h >= 1 << 31 else h)
            out += self._map[h].serialize()
        return bytes(out)

    def serialize_portable(self) -> bytes:
        """The portable spec (serializePortable): a u64-LE bucket count, then
        per bucket a u32-LE high word and the 32-bit payload, in unsigned
        key order."""
        out = bytearray(struct.pack("<Q", len(self._map)))
        for h in sorted(self._map):
            out += struct.pack("<I", h)
            out += self._map[h].serialize()
        return bytes(out)

    @staticmethod
    def deserialize(buf: bytes | memoryview,
                    mode: int | None = None) -> "Roaring64NavigableMap":
        mode = SERIALIZATION_MODE if mode is None else mode
        if mode == SERIALIZATION_MODE_PORTABLE:
            return Roaring64NavigableMap.deserialize_portable(buf)
        return Roaring64NavigableMap.deserialize_legacy(buf)

    @staticmethod
    def deserialize_legacy(buf: bytes | memoryview) -> "Roaring64NavigableMap":
        mv = memoryview(buf)
        if len(mv) < 5:
            raise spec.InvalidRoaringFormat("truncated legacy 64-bit header")
        signed, n = struct.unpack_from(">?i", mv, 0)
        if n < 0:
            raise spec.InvalidRoaringFormat("negative bucket count")
        rb = Roaring64NavigableMap(signed_longs=bool(signed))
        pos = 5
        for _ in range(n):
            if pos + 4 > len(mv):
                raise spec.InvalidRoaringFormat("truncated legacy bucket")
            (h,) = struct.unpack_from(">i", mv, pos)
            pos += 4
            view = spec.SerializedView(mv[pos:])
            conts = [view.container(i) for i in range(view.size)]
            pos += view.serialized_end()
            rb._map[h & 0xFFFFFFFF] = RoaringBitmap(view.keys.copy(), conts)
        return rb

    @staticmethod
    def deserialize_portable(buf: bytes | memoryview) -> "Roaring64NavigableMap":
        mv = memoryview(buf)
        if len(mv) < 8:
            raise spec.InvalidRoaringFormat("truncated portable 64-bit header")
        (n,) = struct.unpack_from("<Q", mv, 0)
        rb = Roaring64NavigableMap(signed_longs=False)
        pos = 8
        for _ in range(n):
            if pos + 4 > len(mv):
                raise spec.InvalidRoaringFormat("truncated portable bucket")
            (h,) = struct.unpack_from("<I", mv, pos)
            pos += 4
            view = spec.SerializedView(mv[pos:])
            conts = [view.container(i) for i in range(view.size)]
            pos += view.serialized_end()
            rb._map[h] = RoaringBitmap(view.keys.copy(), conts)
        return rb

    def serialized_size_in_bytes(self, mode: int | None = None) -> int:
        mode = SERIALIZATION_MODE if mode is None else mode
        header = 8 if mode == SERIALIZATION_MODE_PORTABLE else 5
        return header + sum(4 + b.serialized_size_in_bytes()
                            for b in self._map.values())

    def __reduce__(self):
        """Pickle in the legacy format (which carries signedLongs); the
        supplier rides alongside, so a pluggable backend survives the round
        trip (the wire format has no supplier field)."""
        return (_restore_navigable_map,
                (self.serialize_legacy(), self._supplier))

    # ------------------------------------------------------------- interop
    def to_roaring64(self) -> Roaring64Bitmap:
        """Lossless in-memory conversion to the array-keyed implementation:
        high48 = (high32 << 16) | key16, containers shared."""
        keys_parts: list[np.ndarray] = []
        conts: list[Container] = []
        for h in sorted(self._map):
            rb32 = self._map[h]
            keys_parts.append((np.uint64(h) << np.uint64(16))
                              | rb32.keys.astype(np.uint64))
            conts.extend(rb32.containers)
        keys = (np.concatenate(keys_parts) if keys_parts
                else np.empty(0, dtype=np.uint64))
        return Roaring64Bitmap(keys, conts)

    @staticmethod
    def from_roaring64(rb: Roaring64Bitmap,
                       signed_longs: bool = False) -> "Roaring64NavigableMap":
        out = Roaring64NavigableMap(signed_longs)
        for high, rb32 in rb._buckets32():
            out._map[high] = RoaringBitmap(rb32.keys.copy(),
                                           list(rb32.containers))
        return out


def _restore_navigable_map(blob: bytes, supplier) -> Roaring64NavigableMap:
    """Pickle restore: the legacy-format payload, re-bucketed under the
    original supplier (module level, so pickle can name it)."""
    nm = Roaring64NavigableMap.deserialize_legacy(blob)
    nm._supplier = supplier or RoaringBitmap
    if nm._supplier is not RoaringBitmap:
        for h, b in list(nm._map.items()):
            fresh = nm._supplier()
            fresh.ior(b)
            nm._map[h] = fresh
    return nm
