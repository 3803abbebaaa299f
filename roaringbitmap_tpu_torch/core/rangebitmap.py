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
``serialize`` / ``map``) is the reference's byte for byte:

  u16 cookie 0xF00D | u8 base=2 | u8 sliceCount | u16 maxKey | u32 maxRid
  maxKey * ceil(sliceCount/8) bytes of per-chunk slice-presence masks (LE)
  container records, per chunk in key order, per present slice ascending:
    u8 type (0=BITMAP,1=RUN,2=ARRAY)
    BITMAP: u16 cardinality (mod 2^16) + 1024 u64 words
    RUN:    u16 nbrRuns + (start u16, length-1 u16) pairs
    ARRAY:  u16 cardinality + cardinality u16 values

The reference's appender stores the complement (slice i's container holds
the rows whose value has bit i clear); the slices here are direct, so
``serialize`` and ``map`` complement within each 2^16-row chunk on the way
through.  A mapped RangeBitmap answers every query as the built one does
(its ``max_value`` is the slice count's mask, as in the reference).
"""

from __future__ import annotations

import struct

import numpy as np

from . import containers as C
from .bitmap import RoaringBitmap, and_ as rb_and, andnot as rb_andnot, \
    or_ as rb_or
from ..format import spec

_CHUNK = 1 << 16
COOKIE = 0xF00D
_T_BITMAP, _T_RUN, _T_ARRAY = 0, 1, 2


def _record_kind(slice_i: int, card: int, n_runs: int) -> int:
    """The container type the reference's appender emits.

    Slices < 5 live as bitmap containers in that appender, whose run
    optimize converts to a run only when the run form beats 8192 bytes and
    never downgrades to an array.  Slices >= 5 live as run containers, whose
    efficient form picks the run on ties, else array or bitmap by
    cardinality.
    """
    run_sz = 2 + 4 * n_runs
    if slice_i < 5:
        return _T_RUN if run_sz < 8192 else _T_BITMAP
    if run_sz <= min(8192, 2 * card + 2):
        return _T_RUN
    return _T_ARRAY if card <= C.ARRAY_MAX_SIZE else _T_BITMAP


def _emit_record(out: bytearray, c: C.Container, slice_i: int) -> None:
    """One typed container record of the serialized form."""
    if isinstance(c, C.RunContainer):
        card, n_runs = c.cardinality, c.n_runs
    else:
        card, n_runs = c.cardinality, C.number_of_runs(c.values())
    kind = _record_kind(slice_i, card, n_runs)
    if kind == _T_RUN:
        runs = c.runs if isinstance(c, C.RunContainer) \
            else C.values_to_runs(c.values())
        out.append(_T_RUN)
        out += struct.pack("<H", runs.size // 2)
        out += runs.astype("<u2").tobytes()
    elif kind == _T_BITMAP:
        out.append(_T_BITMAP)
        out += struct.pack("<H", card & 0xFFFF)  # a Java char: mod 2^16
        out += c.words().astype("<u8").tobytes()
    else:
        out.append(_T_ARRAY)
        out += struct.pack("<H", card)
        out += c.values().astype("<u2").tobytes()


def _rows_container(chunk_rows: int) -> C.Container:
    """All appended rows of a chunk as one run: the constant the full and
    empty fast paths need, without an 8 KiB word round trip."""
    if chunk_rows == 1 << 16:
        return C.full_container()
    return C.RunContainer(np.array([0, chunk_rows - 1], dtype=np.uint16))


def _read_record(mv: memoryview, pos: int) -> tuple[C.Container, int]:
    ctype = mv[pos]
    pos += 1
    if ctype == _T_BITMAP:
        if len(mv) < pos + 2 + 8192:
            raise spec.InvalidRoaringFormat("truncated bitmap record")
        words = np.frombuffer(mv[pos + 2:pos + 2 + 8192],
                              dtype="<u8").astype(np.uint64)
        return C.BitmapContainer(words), pos + 2 + 8192
    if ctype == _T_RUN:
        (n_runs,) = struct.unpack_from("<H", mv, pos)
        end = pos + 2 + 4 * n_runs
        if len(mv) < end:
            raise spec.InvalidRoaringFormat("truncated run record")
        runs = np.frombuffer(mv[pos + 2:end], dtype="<u2").astype(np.uint16)
        return C.RunContainer(runs), end
    if ctype == _T_ARRAY:
        (card,) = struct.unpack_from("<H", mv, pos)
        end = pos + 2 + 2 * card
        if len(mv) < end:
            raise spec.InvalidRoaringFormat("truncated array record")
        vals = np.frombuffer(mv[pos + 2:end], dtype="<u2").astype(np.uint16)
        return C.ArrayContainer(vals), end
    raise spec.InvalidRoaringFormat(f"unknown container type {ctype}")


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
        self._serialized_cache: bytes | None = None

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

    # ------------------------------------------------------------------- I/O
    def _chunk_container(self, slice_i: int, key: int) -> C.Container | None:
        """Direct-encoding container of slice i at chunk `key`, or None."""
        s = self._slices[slice_i]
        idx = int(np.searchsorted(s.keys, np.uint16(key)))
        if idx < s.keys.size and s.keys[idx] == key:
            return s.containers[idx]
        return None

    def serialize(self) -> bytes:
        """The reference's serialized stream.  Cached: the index is
        immutable, and the size-then-serialize calling pattern must not pay
        the encoding pass twice."""
        if self._serialized_cache is None:
            self._serialized_cache = self._serialize_impl()
        return self._serialized_cache

    def _serialize_impl(self) -> bytes:
        depth = len(self._slices)
        bytes_per_mask = (depth + 7) >> 3
        n_keys = -(-self._rows // (1 << 16))
        if self._rows >= 1 << 32 or n_keys > 0xFFFF:
            raise ValueError("RangeBitmap supports at most 2^32-1 rows")
        out = bytearray(struct.pack("<HBBHI", COOKIE, 2, depth, n_keys,
                                    self._rows))
        masks = bytearray()
        records = bytearray()
        for key in range(n_keys):
            chunk_rows = min(self._rows - (key << 16), 1 << 16)
            keep = (C.values_to_words(np.arange(chunk_rows, dtype=np.uint16))
                    if chunk_rows < 1 << 16 else None)
            mask_bits = 0
            for i in range(depth):
                direct = self._chunk_container(i, key)
                # complement within the appended rows of this chunk (the
                # reference stores the ~value bits)
                if direct is None:
                    comp = _rows_container(chunk_rows)  # all rows, one run
                else:
                    comp_words = ~direct.words()
                    if keep is not None:
                        comp_words = comp_words & keep
                    comp = C.from_words(comp_words)
                    if comp.cardinality == 0:
                        continue
                mask_bits |= 1 << i
                _emit_record(records, comp, i)
            masks += mask_bits.to_bytes(bytes_per_mask, "little")
        return bytes(out + masks + records)

    def serialized_size_in_bytes(self) -> int:
        if self._serialized_cache is None:
            self._serialized_cache = self.serialize()
        return len(self._serialized_cache)

    @staticmethod
    def map(buf: bytes | memoryview) -> "RangeBitmap":
        """Attach to a serialized RangeBitmap (RangeBitmap.map).  Takes any
        stream the reference's appender produces and answers queries
        bit-exactly; the complement containers are decoded back into direct
        slices."""
        mv = memoryview(buf)
        if len(mv) < 10:
            raise spec.InvalidRoaringFormat("truncated RangeBitmap header")
        cookie, base, depth, n_keys, rows = struct.unpack_from("<HBBHI", mv, 0)
        if cookie != COOKIE:
            raise spec.InvalidRoaringFormat(
                f"invalid RangeBitmap cookie {cookie:#x}")
        if base != 2:
            raise spec.InvalidRoaringFormat(
                f"unsupported RangeBitmap base {base}")
        bytes_per_mask = (depth + 7) >> 3
        pos = 10
        if len(mv) < pos + n_keys * bytes_per_mask:
            raise spec.InvalidRoaringFormat("truncated RangeBitmap masks")
        chunk_masks = [
            int.from_bytes(mv[pos + k * bytes_per_mask:
                              pos + (k + 1) * bytes_per_mask], "little")
            for k in range(n_keys)]
        pos += n_keys * bytes_per_mask
        slice_keys: list[list[int]] = [[] for _ in range(depth)]
        slice_conts: list[list[C.Container]] = [[] for _ in range(depth)]
        for key in range(n_keys):
            chunk_rows = min(rows - (key << 16), 1 << 16)
            keep = None
            if chunk_rows < 1 << 16:
                keep = C.values_to_words(np.arange(chunk_rows, dtype=np.uint16))
            for i in range(depth):
                if (chunk_masks[key] >> i) & 1:
                    comp, pos = _read_record(mv, pos)
                    direct_words = ~comp.words()
                    if keep is not None:
                        direct_words = direct_words & keep
                    direct = C.from_words(direct_words)
                    if direct.cardinality == 0:
                        continue
                else:
                    # empty complement: every appended row has bit i set
                    direct = _rows_container(chunk_rows)
                slice_keys[i].append(key)
                slice_conts[i].append(direct)
        slices = [
            RoaringBitmap(np.array(slice_keys[i], dtype=np.uint16),
                          slice_conts[i])
            for i in range(depth)]
        return RangeBitmap(slices, rows, (1 << depth) - 1)


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
        self._ser_cache: bytes | None = None

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
        self._ser_cache = None

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
        self._ser_cache = None

    def _serialized(self) -> bytes:
        """The encoded bytes, cached so the size-then-serialize calling
        pattern runs the encoding pass once; ``add`` and ``clear``
        invalidate them."""
        if self._ser_cache is None:
            self._flush()
            self._ser_cache = RangeBitmap(
                self._slices, self._rows, self.max_value).serialize()
        return self._ser_cache

    def serialized_size_in_bytes(self) -> int:
        return len(self._serialized())

    def serialize(self) -> bytes:
        """Serialize without building a RangeBitmap first."""
        return self._serialized()
