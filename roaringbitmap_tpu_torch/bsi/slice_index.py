"""Host bit-sliced index: the RoaringBitmapSliceIndex oracle
(``roaringbitmap_tpu.bsi.slice_index``, the port's own copy).

An existence bitmap ``ebm`` plus base-2 slice bitmaps (row r is in slice i
iff bit i of value(r) is set), for values in [0, 2^31 - 1].  The reference
bsi module's surface: the O'Neil comparator with min/max pruning, the Kaser
top-K, the sum, value lookups, addition with carry, merge, and both
serialized forms (the Hadoop-vint stream and the fixed-width big-endian
buffer).  ``from_pairs`` builds every slice with one NumPy mask per bit.
The device tier (``bsi.device``) and the analytics columns are held against
this class.  ``run_optimize`` re-encodes the ebm and every slice in run
containers where smaller and sets the run flag both serialized forms write.
"""

from __future__ import annotations

import enum
import struct
from typing import Iterable

import numpy as np

from ..core.bitmap import (
    RoaringBitmap,
    and_ as rb_and,
    and_cardinality,
    andnot as rb_andnot,
    or_ as rb_or,
    xor as rb_xor,
)
from ..format import spec


class Operation(enum.Enum):
    """BitmapSliceIndex.Operation."""

    EQ = "EQ"
    NEQ = "NEQ"
    LE = "LE"
    LT = "LT"
    GE = "GE"
    GT = "GT"
    RANGE = "RANGE"


def minmax_decision(op: Operation, start: int, end: int,
                    mn: int, mx: int) -> str | None:
    """[minValue, maxValue] range pruning: "all" (every stored row
    matches), "empty" (none can), or None (the O'Neil scan must run).
    Shared by the host comparator, ``DeviceBSI`` and ``BsiColumn`` so all
    three prune, and answer out-of-range predicates, identically."""
    if op is Operation.LT:
        if start > mx:
            return "all"
        if start <= mn:
            return "empty"
    elif op is Operation.LE:
        if start >= mx:
            return "all"
        if start < mn:
            return "empty"
    elif op is Operation.GT:
        if start < mn:
            return "all"
        if start >= mx:
            return "empty"
    elif op is Operation.GE:
        if start <= mn:
            return "all"
        if start > mx:
            return "empty"
    elif op is Operation.EQ:
        if mn == mx and mn == start:
            return "all"
        if start < mn or start > mx:
            return "empty"
    elif op is Operation.NEQ:
        if mn == mx:
            return "empty" if mn == start else "all"
        if start < mn or start > mx:
            # no stored value equals an out-of-band predicate; without this
            # rung the scan would truncate it to bit_count bits
            return "all"
    elif op is Operation.RANGE:
        if start <= mn and end >= mx:
            return "all"
        if start > mx or end < mn:
            return "empty"
    return None


def clamp_range_bounds(op: Operation, start: int, end: int,
                       mn: int, mx: int) -> tuple[int, int]:
    """RANGE bounds clamped to the stored domain [mn, mx]: the O'Neil scan
    reads only ``bit_count`` bits, which would truncate an out-of-band
    bound."""
    if op is Operation.RANGE:
        return max(start, mn), min(end, mx)
    return start, end


# ------------------------------------------------------------- Hadoop vints
def write_vlong(out: bytearray, v: int) -> None:
    """Hadoop WritableUtils.writeVLong: one byte for -112..127, else a
    length prefix byte and big-endian magnitude bytes."""
    if -112 <= v <= 127:
        out.append(v & 0xFF)
        return
    length = -112
    if v < 0:
        v ^= -1
        length = -120
    tmp = v
    while tmp != 0:
        tmp >>= 8
        length -= 1
    out.append(length & 0xFF)
    nbytes = -(length + 120) if length < -120 else -(length + 112)
    for i in range(nbytes - 1, -1, -1):
        out.append((v >> (8 * i)) & 0xFF)


def read_vlong(buf: memoryview, pos: int) -> tuple[int, int]:
    """Inverse of write_vlong; returns (value, new_pos)."""
    first = buf[pos]
    if first >= 128:
        first -= 256
    pos += 1
    if first >= -112:
        return first, pos
    negative = first <= -121
    nbytes = -(first + 120) if negative else -(first + 112)
    if pos + nbytes > len(buf):
        raise spec.InvalidRoaringFormat("truncated vint")
    v = 0
    for _ in range(nbytes):
        v = (v << 8) | buf[pos]
        pos += 1
    return (v ^ -1) if negative else v, pos


def trim_smallest(bm: RoaringBitmap, k: int) -> RoaringBitmap:
    """Drop the smallest row ids until ``bm`` holds k rows: the Kaser tie
    rule, shared by the host scan and the device readbacks."""
    excess = bm.cardinality - k
    if excess > 0:
        return RoaringBitmap.from_values(bm.to_array()[excess:])
    return bm


def kaser_top_k(slices, found: RoaringBitmap, k: int) -> RoaringBitmap:
    """Kaser top-K over any slice-bitmap stack: the rows holding the k
    largest values within ``found``, ties trimmed smallest-id-first."""
    g = RoaringBitmap()
    e = found
    for i in range(len(slices) - 1, -1, -1):
        x = rb_or(g, rb_and(e, slices[i]))
        n = x.cardinality
        if n > k:
            e = rb_and(e, slices[i])
        elif n < k:
            g = x
            e = rb_andnot(e, slices[i])
        else:
            e = rb_and(e, slices[i])
            break
    return trim_smallest(rb_or(g, e), k)


def _read_bitmap(mv: memoryview, pos: int) -> tuple[RoaringBitmap, int]:
    view = spec.SerializedView(mv[pos:])
    conts = [view.container(i) for i in range(view.size)]
    return RoaringBitmap(view.keys.copy(), conts), pos + view.serialized_end()


class RoaringBitmapSliceIndex:
    """32-bit-value bit-sliced index over RoaringBitmap row-id sets."""

    def __init__(self, min_value: int = 0, max_value: int = 0):
        if min_value < 0:
            raise ValueError("values should be in the range [0, 2^31-1]")
        self.min_value = min_value
        self.max_value = max_value
        self.ebm = RoaringBitmap()
        self.slices: list[RoaringBitmap] = [
            RoaringBitmap()
            for _ in range(max(max_value.bit_length(), 1) if max_value else 0)]
        self.run_optimized = False

    # ----------------------------------------------------------------- build
    @staticmethod
    def from_pairs(column_ids: np.ndarray, values: np.ndarray
                   ) -> "RoaringBitmapSliceIndex":
        """Vectorized setValues: one bitmap build per bit; the last write
        wins per column id, like repeated setValue calls."""
        cols = np.asarray(column_ids, dtype=np.uint32)
        vals = np.asarray(values, dtype=np.int64)
        if cols.shape != vals.shape:
            raise ValueError("column_ids and values must align")
        if vals.size and (int(vals.min()) < 0 or int(vals.max()) > 0x7FFFFFFF):
            raise ValueError("values should be in the range [0, 2^31-1]")
        bsi = RoaringBitmapSliceIndex()
        if cols.size == 0:
            return bsi
        order = np.argsort(cols, kind="stable")
        cols, vals = cols[order], vals[order]
        last = np.r_[cols[1:] != cols[:-1], True]
        cols, vals = cols[last], vals[last]
        bsi.min_value = int(vals.min())
        bsi.max_value = int(vals.max())
        # cols now ascend without duplicates, and so does each subset
        bsi.ebm = RoaringBitmap.from_sorted(cols)
        depth = max(bsi.max_value.bit_length(), 1)
        bsi.slices = [RoaringBitmap.from_sorted(cols[(vals >> i) & 1 == 1])
                      for i in range(depth)]
        return bsi

    def set_value(self, column_id: int, value: int) -> None:
        if value < 0 or value > 0x7FFFFFFF:
            raise ValueError("values should be in the range [0, 2^31-1]")
        self._ensure_depth(max(value.bit_length(), 1))
        for i, s in enumerate(self.slices):
            if (value >> i) & 1:
                s.add(column_id)
            else:
                s.remove(column_id)
        self.ebm.add(column_id)
        if self.ebm.cardinality == 1:
            self.min_value = self.max_value = value
        else:
            self.min_value = min(self.min_value, value)
            self.max_value = max(self.max_value, value)

    def set_values(self, pairs: Iterable[tuple[int, int]]) -> None:
        """Bulk upsert."""
        pairs = list(pairs)
        if not pairs:
            return
        cols = np.array([p[0] for p in pairs], dtype=np.uint32)
        vals = np.array([p[1] for p in pairs], dtype=np.int64)
        self.merge_overwrite(RoaringBitmapSliceIndex.from_pairs(cols, vals))

    def _ensure_depth(self, depth: int) -> None:
        while len(self.slices) < depth:
            self.slices.append(RoaringBitmap())

    # ------------------------------------------------------------- accessors
    def bit_count(self) -> int:
        return len(self.slices)

    @property
    def cardinality(self) -> int:
        return self.ebm.cardinality

    @property
    def long_cardinality(self) -> int:
        return self.cardinality

    def get_existence_bitmap(self) -> RoaringBitmap:
        return self.ebm

    def value_exists(self, column_id: int) -> bool:
        return self.ebm.contains(column_id)

    def value_exist(self, column_id: int) -> bool:
        """valueExist, the reference's spelling."""
        return self.value_exists(column_id)

    def get_value(self, column_id: int) -> tuple[int, bool]:
        """(value, exists)."""
        if not self.ebm.contains(column_id):
            return 0, False
        v = 0
        for i, s in enumerate(self.slices):
            if s.contains(column_id):
                v |= 1 << i
        return v, True

    def get_values(self, column_ids: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized getValue: (values i64[N], exists bool[N])."""
        cols = np.asarray(column_ids, dtype=np.uint32)
        vals = np.zeros(cols.size, dtype=np.int64)
        for i, s in enumerate(self.slices):
            if s.is_empty():
                continue
            vals[np.isin(cols, s.to_array())] |= np.int64(1 << i)
        exists = np.isin(cols, self.ebm.to_array())
        vals[~exists] = 0
        return vals, exists

    def run_optimize(self) -> None:
        """Re-encode the ebm and every slice in their smallest container
        kinds (run containers where smaller); the serialized forms then
        carry the run flag."""
        self.ebm.run_optimize()
        for s in self.slices:
            s.run_optimize()
        self.run_optimized = True

    def has_run_compression(self) -> bool:
        return self.run_optimized

    def clone(self) -> "RoaringBitmapSliceIndex":
        out = RoaringBitmapSliceIndex()
        out.min_value, out.max_value = self.min_value, self.max_value
        out.ebm = self.ebm.clone()
        out.slices = [s.clone() for s in self.slices]
        out.run_optimized = self.run_optimized
        return out

    # ------------------------------------------------------------ combining
    def _recompute_min_max(self) -> None:
        """minValue()/maxValue(): greedy descending slice scans."""
        if self.ebm.is_empty():
            self.min_value = self.max_value = 0
            return
        cand, mx = self.ebm, 0
        for i in range(len(self.slices) - 1, -1, -1):
            t = rb_and(cand, self.slices[i])
            if not t.is_empty():
                cand = t
                mx |= 1 << i
        cand, mn = self.ebm, 0
        for i in range(len(self.slices) - 1, -1, -1):
            t = rb_andnot(cand, self.slices[i])
            if t.is_empty():
                mn |= 1 << i
                cand = rb_and(cand, self.slices[i])
            else:
                cand = t
        self.min_value, self.max_value = mn, mx

    def add(self, other: "RoaringBitmapSliceIndex") -> None:
        """BSI addition with carry: overlapping ids get the sum."""
        if other.ebm.is_empty():
            return
        self.ebm = rb_or(self.ebm, other.ebm)
        for i in range(other.bit_count()):
            self._add_digit(other.slices[i], i)
        self._recompute_min_max()

    def add_digit(self, digit: RoaringBitmap, i: int) -> None:
        """Add the column set ``digit`` into slice i, rippling carries."""
        self._add_digit(digit, i)
        self._recompute_min_max()

    def _add_digit(self, digit: RoaringBitmap, i: int) -> None:
        self._ensure_depth(i + 1)
        carry = rb_and(self.slices[i], digit)
        self.slices[i] = rb_xor(self.slices[i], digit)
        if not carry.is_empty():
            self._add_digit(carry, i + 1)

    def merge(self, other: "RoaringBitmapSliceIndex") -> None:
        """Union of disjoint column-id sets."""
        if not rb_and(self.ebm, other.ebm).is_empty():
            raise ValueError("merge can only be used between two bsi but "
                             "the existence bitmap is different")
        if other.ebm.is_empty():
            return
        if self.ebm.is_empty():
            self.min_value, self.max_value = other.min_value, other.max_value
        else:
            self.min_value = min(self.min_value, other.min_value)
            self.max_value = max(self.max_value, other.max_value)
        self.ebm = rb_or(self.ebm, other.ebm)
        self._ensure_depth(other.bit_count())
        for i in range(other.bit_count()):
            self.slices[i] = rb_or(self.slices[i], other.slices[i])

    def merge_overwrite(self, other: "RoaringBitmapSliceIndex") -> None:
        """Upsert: other's columns overwrite ours, then a disjoint merge."""
        overlap = rb_and(self.ebm, other.ebm)
        if not overlap.is_empty():
            self.slices = [rb_andnot(s, overlap) for s in self.slices]
            self.ebm = rb_andnot(self.ebm, overlap)
            if not self.ebm.is_empty():
                self._recompute_min_max()
            else:
                self.min_value = self.max_value = 0
        if self.ebm.is_empty():
            self.min_value, self.max_value = other.min_value, other.max_value
            self.ebm = other.ebm.clone()
            self.slices = [s.clone() for s in other.slices]
            return
        self.merge(other)

    # --------------------------------------------------------------- queries
    def o_neil_compare(self, op: Operation, predicate: int,
                       found_set: RoaringBitmap | None = None
                       ) -> RoaringBitmap:
        """The O'Neil comparator: one descending pass accumulating
        GT/LT/EQ."""
        fixed = self.ebm if found_set is None else found_set
        gt = RoaringBitmap()
        lt = RoaringBitmap()
        eq = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            if (predicate >> i) & 1:
                lt = rb_or(lt, rb_andnot(eq, self.slices[i]))
                eq = rb_and(eq, self.slices[i])
            else:
                gt = rb_or(gt, rb_and(eq, self.slices[i]))
                eq = rb_andnot(eq, self.slices[i])
        eq = rb_and(fixed, eq)
        if op is Operation.EQ:
            return eq
        if op is Operation.NEQ:
            return rb_andnot(fixed, eq)
        if op is Operation.GT:
            return rb_and(gt, fixed)
        if op is Operation.LT:
            return rb_and(lt, fixed)
        if op is Operation.LE:
            return rb_or(rb_and(lt, fixed), eq)
        if op is Operation.GE:
            return rb_or(rb_and(gt, fixed), eq)
        raise ValueError(f"unsupported operation {op}")

    def _compare_using_min_max(self, op: Operation, start: int, end: int,
                               found_set: RoaringBitmap | None
                               ) -> RoaringBitmap | None:
        decision = minmax_decision(op, start, end, self.min_value,
                                   self.max_value)
        if decision == "all":
            return (self.ebm.clone() if found_set is None
                    else rb_and(self.ebm, found_set))
        if decision == "empty":
            return RoaringBitmap()
        return None

    def _o_neil_range(self, lo: int, hi: int,
                      found_set: RoaringBitmap | None) -> RoaringBitmap:
        """RANGE in one descending pass carrying both bounds."""
        fixed = self.ebm if found_set is None else found_set
        gt1 = RoaringBitmap()
        eq1 = self.ebm
        lt2 = RoaringBitmap()
        eq2 = self.ebm
        for i in range(self.bit_count() - 1, -1, -1):
            s = self.slices[i]
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
        left = rb_or(rb_and(gt1, fixed), rb_and(fixed, eq1))
        right = rb_or(rb_and(lt2, fixed), rb_and(fixed, eq2))
        return rb_and(left, right)

    def compare(self, op: Operation, start_or_value: int, end: int = 0,
                found_set: RoaringBitmap | None = None) -> RoaringBitmap:
        """Min/max pruning, then the O'Neil scan (RANGE: the single-pass
        double evaluation)."""
        pruned = self._compare_using_min_max(op, start_or_value, end,
                                             found_set)
        if pruned is not None:
            return pruned
        if op is Operation.RANGE:
            start_or_value, end = clamp_range_bounds(
                op, start_or_value, end, self.min_value, self.max_value)
            return self._o_neil_range(start_or_value, end, found_set)
        return self.o_neil_compare(op, start_or_value, found_set)

    def sum(self, found_set: RoaringBitmap | None = None) -> tuple[int, int]:
        """(sum of values, member count) over the found set."""
        fs = self.ebm if found_set is None else found_set
        if fs.is_empty():
            return 0, 0
        total = sum((1 << i) * and_cardinality(s, fs)
                    for i, s in enumerate(self.slices))
        return total, fs.cardinality

    def top_k(self, k: int, found_set: RoaringBitmap | None = None
              ) -> RoaringBitmap:
        """Kaser top-K: rows holding the k largest values; ties broken by
        dropping the smallest row ids."""
        fixed = self.ebm if found_set is None else found_set
        if k < 0 or k > fixed.cardinality:
            raise ValueError(
                f"TopK param error,cardinality:{fixed.cardinality} k:{k}")
        f = kaser_top_k(self.slices, fixed, k)
        assert f.cardinality == k, "bugs found when compute topK"
        return f

    def transpose_with_count(self, found_set: RoaringBitmap | None = None
                             ) -> "RoaringBitmapSliceIndex":
        """A BSI keyed by value whose entries count occurrences."""
        fixed = self.ebm if found_set is None else rb_and(self.ebm, found_set)
        vals, exists = self.get_values(fixed.to_array())
        uniq, counts = np.unique(vals[exists], return_counts=True)
        return RoaringBitmapSliceIndex.from_pairs(uniq.astype(np.uint32),
                                                  counts.astype(np.int64))

    def in_values(self, values: set[int],
                  found_set: RoaringBitmap | None = None) -> RoaringBitmap:
        """Value-set membership, vectorized per column."""
        fixed = self.ebm if found_set is None else rb_and(self.ebm, found_set)
        cols = fixed.to_array()
        vals, exists = self.get_values(cols)
        keep = exists & np.isin(vals, np.array(sorted(values), dtype=np.int64))
        return RoaringBitmap.from_values(cols[keep])

    def to_pair_list(self, found_set: RoaringBitmap | None = None
                     ) -> list[tuple[int, int]]:
        fixed = self.ebm if found_set is None else rb_and(self.ebm, found_set)
        cols = fixed.to_array()
        vals, _ = self.get_values(cols)
        return [(int(c), int(v)) for c, v in zip(cols, vals)]

    # ---------------------------------------------------------- equality/repr
    def __eq__(self, o: object) -> bool:
        if not isinstance(o, RoaringBitmapSliceIndex):
            return NotImplemented
        if (self.min_value, self.max_value) != (o.min_value, o.max_value):
            return False
        if self.ebm != o.ebm or len(self.slices) != len(o.slices):
            return False
        return all(a == b for a, b in zip(self.slices, o.slices))

    def __repr__(self) -> str:
        return (f"RoaringBitmapSliceIndex(card={self.cardinality}, "
                f"bits={self.bit_count()}, "
                f"range=[{self.min_value},{self.max_value}])")

    # ------------------------------------------------------------------- I/O
    def serialize(self) -> bytes:
        """The canonical wire form: the fixed-width buffer format, the one
        ``serialized_size_in_bytes`` measures."""
        return self.serialize_buffer()

    @staticmethod
    def deserialize(buf: bytes | memoryview) -> "RoaringBitmapSliceIndex":
        return RoaringBitmapSliceIndex.deserialize_buffer(buf)

    def serialize_stream(self) -> bytes:
        """Hadoop-vint stream: vint min, vint max, bool runOptimized, ebm,
        vint bitDepth, slices."""
        out = bytearray()
        write_vlong(out, self.min_value)
        write_vlong(out, self.max_value)
        out.append(1 if self.run_optimized else 0)
        out += self.ebm.serialize()
        write_vlong(out, len(self.slices))
        for s in self.slices:
            out += s.serialize()
        return bytes(out)

    @staticmethod
    def deserialize_stream(buf: bytes | memoryview
                           ) -> "RoaringBitmapSliceIndex":
        mv = memoryview(buf)
        bsi = RoaringBitmapSliceIndex()
        mn, pos = read_vlong(mv, 0)
        mx, pos = read_vlong(mv, pos)
        bsi.min_value, bsi.max_value = int(mn), int(mx)
        bsi.run_optimized = mv[pos] == 1
        pos += 1
        bsi.ebm, pos = _read_bitmap(mv, pos)
        depth, pos = read_vlong(mv, pos)
        bsi.slices = []
        for _ in range(int(depth)):
            s, pos = _read_bitmap(mv, pos)
            bsi.slices.append(s)
        return bsi

    def serialize_buffer(self) -> bytes:
        """Fixed-width buffer: i32-BE min/max, u8 runOptimized, ebm, i32-BE
        bitDepth, slices."""
        out = bytearray(struct.pack(">ii", self.min_value, self.max_value))
        out.append(1 if self.run_optimized else 0)
        out += self.ebm.serialize()
        out += struct.pack(">i", len(self.slices))
        for s in self.slices:
            out += s.serialize()
        return bytes(out)

    @staticmethod
    def deserialize_buffer(buf: bytes | memoryview
                           ) -> "RoaringBitmapSliceIndex":
        mv = memoryview(buf)
        if len(mv) < 9:
            raise spec.InvalidRoaringFormat("truncated BSI header")
        mn, mx = struct.unpack_from(">ii", mv, 0)
        bsi = RoaringBitmapSliceIndex()
        bsi.min_value, bsi.max_value = mn, mx
        bsi.run_optimized = mv[8] == 1
        bsi.ebm, pos = _read_bitmap(mv, 9)
        if pos + 4 > len(mv):
            raise spec.InvalidRoaringFormat("truncated BSI bit depth")
        (depth,) = struct.unpack_from(">i", mv, pos)
        pos += 4
        if depth < 0 or depth > 64:
            raise spec.InvalidRoaringFormat(
                f"BSI bit depth {depth} out of [0, 64]")
        bsi.slices = []
        for _ in range(depth):
            s, pos = _read_bitmap(mv, pos)
            bsi.slices.append(s)
        return bsi

    def serialized_size_in_bytes(self) -> int:
        """The buffer-format size."""
        return (4 + 4 + 1 + 4 + self.ebm.serialized_size_in_bytes()
                + sum(s.serialized_size_in_bytes() for s in self.slices))
