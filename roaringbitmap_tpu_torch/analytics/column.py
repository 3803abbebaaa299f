"""Value columns a resident set can attach (``roaringbitmap_tpu.analytics.
column``): the resident artifacts of the analytics lane.

A column binds a value domain to a set's row-id universe twice:

- a **host oracle**: ``bsi.slice_index.RoaringBitmapSliceIndex`` for a
  sparse column (:class:`BsiColumn`), ``core.rangebitmap.RangeBitmap`` for a
  dense row-indexed one (:class:`RangeColumn`), the reference every engine
  rung is held against.  Either may be the mapped, read-only form over
  serialized bytes (``BsiColumn.from_bsi`` of a
  ``bsi.ImmutableBitSliceIndex``, ``RangeColumn.from_range_bitmap`` of a
  ``RangeBitmap.map``): the planes pack straight off the views, and the
  first delta copies the oracle to the heap;
- a **device artifact**: the slice planes densified once over the column's
  container keys and padded to a power-of-two depth (``int32[S_pad, K,
  2048]``) with the existence plane (``int32[K, 2048]``), uploaded once to
  the column's device (:meth:`_ColumnBase.device_operands`).

Padding is exact: a padded zero plane under a zero predicate bit leaves
every O'Neil and Kaser state update at the identity.  A column's ``uid``
comes from the resident sets' counter, so the two never collide; engines
key their plans on each attached column's ``(uid, version,
structure_version)``.  A column delta (``BsiColumn.apply_delta`` /
``RangeColumn.apply_delta``) updates the host oracle, re-packs the device
planes, bumps ``version`` (and ``structure_version`` when the planes' shape
moves) and drops the result-cache entries that read the column.
"""

from __future__ import annotations

import numpy as np

from ..bsi.device import _densify, _slice_cards_res, _unpack, \
    _weighted_total
from ..bsi.immutable import ImmutableBitSliceIndex
from ..bsi.slice_index import (Operation, RoaringBitmapSliceIndex,
                               clamp_range_bounds, kaser_top_k,
                               minmax_decision, trim_smallest)
from ..core.bitmap import RoaringBitmap, and_ as rb_and, andnot as rb_andnot
from ..core.rangebitmap import RangeBitmap
from ..ops import packing
from ..ops.words import WORDS32, as_i32, resolve_device
from ..obs import memory as obs_memory
from ..obs import trace as obs_trace
from . import plane

_BSI_OP = {"eq": Operation.EQ, "neq": Operation.NEQ, "lt": Operation.LT,
           "le": Operation.LE, "gt": Operation.GT, "ge": Operation.GE,
           "range": Operation.RANGE}


def _exact_sum(values: np.ndarray) -> int:
    """Exact sum of int64 values >= 0 (fewer than 2^31 of them): the high
    and low 32-bit halves summed apart, each well inside int64."""
    v = values.astype(np.uint64)
    lo = int((v & np.uint64(0xFFFFFFFF)).sum(dtype=np.uint64))
    return lo + (int((v >> np.uint64(32)).sum(dtype=np.uint64)) << 32)


def _next_uid() -> int:
    from ..parallel.aggregation import _SET_UIDS

    return next(_SET_UIDS)


class _ColumnBase:
    """Packing, identity and the two-phase aggregate of both kinds."""

    kind = "column"

    def _init_identity(self, name: str, device) -> None:
        self.name = str(name)
        self.device = resolve_device(device)
        self.uid = _next_uid()
        self.version = 0
        self.structure_version = 0
        self._dev = None
        obs_memory.LEDGER.register(
            self.kind, "dense", lambda c: c.hbm_bytes(), owner=self,
            stamp=lambda c: (c.version, c.structure_version,
                             getattr(c, "depth_pad", None)))

    def _pack(self, ebm_bitmap: RoaringBitmap, slice_bitmaps) -> None:
        """Densify the existence plane and the slices over the ebm's keys,
        pad the slice axis to a power of two."""
        keys = np.asarray(ebm_bitmap.keys, np.uint16).copy()
        depth = len(slice_bitmaps)
        depth_pad = packing.next_pow2(max(1, depth))
        ebm_np = (_densify(ebm_bitmap, keys) if keys.size
                  else np.zeros((0, WORDS32), np.uint32))
        slices_np = np.zeros((depth_pad,) + ebm_np.shape, np.uint32)
        if keys.size:
            for i, s in enumerate(slice_bitmaps):
                slices_np[i] = _densify(s, keys)
        old_shape = (getattr(self, "depth_pad", None),
                     getattr(self, "keys", np.zeros(0)).size)
        if old_shape != (None, 0) and old_shape != (depth_pad, keys.size):
            self.structure_version += 1
        self.keys = keys
        self.depth = depth
        self.depth_pad = depth_pad
        self.ebm_np = ebm_np
        self.slices_np = slices_np
        self._dev = None

    def hbm_bytes(self) -> int:
        return int(self.slices_np.nbytes + self.ebm_np.nbytes)

    def device_operands(self):
        """(slices int32[S_pad, K, 2048], ebm int32[K, 2048]) on the
        column's device, uploaded once."""
        if self._dev is None:
            self._dev = (as_i32(self.slices_np, self.device),
                         as_i32(self.ebm_np, self.device))
        return self._dev

    def _bits(self, value: int) -> np.ndarray:
        return plane.predicate_bits(value, self.depth_pad)

    def _trace_build(self) -> None:
        """The ``analytics.column`` span of a built column."""
        with obs_trace.span("analytics.column", col=self.name,
                            kind=self.kind, uid=self.uid, depth=self.depth,
                            depth_pad=self.depth_pad,
                            keys=int(self.keys.size),
                            hbm_bytes=self.hbm_bytes()):
            pass

    def _note_delta(self, mode: str = "patch") -> None:
        """After a delta: bump the version, drop every result-cache entry
        that reads this column, and attach the ``analytics.delta`` event
        to the current span."""
        from ..mutation import result_cache

        self.version += 1
        dropped = result_cache.notify_version_bump(self.uid)
        obs_trace.current().event(
            "analytics.delta", col=self.name, uid=self.uid, kind=self.kind,
            mode=mode, version=self.version,
            structure_version=self.structure_version,
            cache_dropped=dropped, hbm_bytes=self.hbm_bytes())

    # ----------------------------------------------------- two-phase lane
    def device_agg(self, kind: str, found: RoaringBitmap, k: int = 0):
        """The two-phase baseline's second dispatch: a read-back found
        bitmap is densified again over the column's keys and the aggregate
        runs on its own."""
        slices, ebm = self.device_operands()
        fw = (as_i32(_densify(found, self.keys), self.device)
              if self.keys.size else ebm)
        if kind == "sum":
            cards = _slice_cards_res(slices[:self.depth], fw).cpu().numpy()
            return _weighted_total(cards), found.cardinality
        res = plane.topk_words(slices, fw & ebm, k)
        return trim_smallest(_unpack(self.keys, res), k)


class BsiColumn(_ColumnBase):
    """Sparse value column over arbitrary 32-bit row ids, values in
    [0, 2^31 - 1], backed by the host RoaringBitmapSliceIndex."""

    kind = "bsi_column"

    def __init__(self, name: str, column_ids, values, device=None):
        self._init_identity(name, device)
        self.host = RoaringBitmapSliceIndex.from_pairs(
            np.asarray(column_ids, np.uint32), np.asarray(values, np.int64))
        self._repack()
        self._trace_build()

    @classmethod
    def from_bsi(cls, name: str, bsi: RoaringBitmapSliceIndex,
                 device=None) -> "BsiColumn":
        """A column over a host BSI: a copy of a heap one, or a read-only
        ``ImmutableBitSliceIndex`` as it is (its planes pack off the
        serialized bytes; the first delta copies it to the heap)."""
        out = cls.__new__(cls)
        out._init_identity(name, device)
        out.host = (bsi if isinstance(bsi, ImmutableBitSliceIndex)
                    else bsi.clone())
        out._repack()
        return out

    def _repack(self) -> None:
        self.min_value = self.host.min_value
        self.max_value = self.host.max_value
        self._pack(self.host.ebm, self.host.slices)

    def scan_plan(self, op: str, lo: int, hi: int = 0):
        """Plan-time lowering of one predicate: ``("empty",)`` / ``("all",)``
        (min/max pruning, shared with the host comparator) or ``("scan",
        tag, bits, bits2)`` with the clamped bounds as padded-depth bits."""
        bop = _BSI_OP[op]
        if self.host.ebm.is_empty() or self.keys.size == 0:
            # predicates evaluate over the existence plane, so an empty
            # column answers empty for every op, NEQ included
            return ("empty",)
        decision = minmax_decision(bop, lo, hi, self.min_value,
                                   self.max_value)
        if decision is not None:
            return (decision,)
        lo, hi = clamp_range_bounds(bop, lo, hi, self.min_value,
                                    self.max_value)
        return ("scan", f"bsi:{bop.value}", self._bits(lo), self._bits(hi))

    def host_filter(self, op: str, lo: int, hi: int = 0) -> RoaringBitmap:
        return self.host.compare(_BSI_OP[op], lo, hi)

    def host_sum(self, found: RoaringBitmap | None):
        return self.host.sum(found)

    def host_top_k(self, k: int, found: RoaringBitmap | None
                   ) -> RoaringBitmap:
        fs = self.host.ebm if found is None else rb_and(self.host.ebm, found)
        return self.host.top_k(min(int(k), fs.cardinality), fs)

    def apply_delta(self, set_values=None, removes=()) -> dict:
        """Mutate the column: ``removes`` drop rows from every plane, then
        ``set_values`` ({row_id: value} or (ids, values)) upsert.  The
        device planes re-pack, the version bumps, and the dependent
        result-cache entries drop."""
        if isinstance(self.host, ImmutableBitSliceIndex):
            self.host = self.host.to_mutable()
        removes = list(removes)
        if removes:
            rm = RoaringBitmap.from_values(np.asarray(removes, np.uint32))
            self.host.ebm = rb_andnot(self.host.ebm, rm)
            self.host.slices = [rb_andnot(s, rm) for s in self.host.slices]
            if self.host.ebm.is_empty():
                self.host.min_value = self.host.max_value = 0
            else:
                self.host._recompute_min_max()
        n_set = 0
        if set_values:
            if isinstance(set_values, dict):
                pairs = sorted(set_values.items())
            else:
                ids, vals = set_values
                pairs = list(zip(np.asarray(ids).tolist(),
                                 np.asarray(vals).tolist()))
            self.host.set_values(pairs)
            n_set = len(pairs)
        self._repack()
        self._note_delta()
        return {"set": n_set, "removed": len(removes),
                "version": self.version,
                "structure_version": self.structure_version}


class RangeColumn(_ColumnBase):
    """Dense row-indexed value column (rows 0..N-1, int64 values >= 0),
    backed by the host RangeBitmap (the threshold oracle) and the
    stored values (the aggregate oracle)."""

    kind = "range_column"

    def __init__(self, name: str, values, device=None):
        self._init_identity(name, device)
        self.values = np.asarray(values, np.int64).copy()
        if self.values.size and int(self.values.min()) < 0:
            raise ValueError("range column values must be >= 0")
        self._rebuild()
        self._trace_build()

    @classmethod
    def from_range_bitmap(cls, name: str, rb: RangeBitmap,
                          device=None) -> "RangeColumn":
        """A column over a RangeBitmap (a built one or one attached to its
        serialized bytes with ``RangeBitmap.map``), kept as the threshold
        oracle.  The row values, the aggregate oracle, are read back off
        its slices; the planes and the min/max pruning are the same as
        ``RangeColumn(name, values)`` builds, so are the plans."""
        if len(rb.slices) > 63 and not rb.slices[63].is_empty():
            raise ValueError("range column values must be below 2^63")
        values = np.zeros(rb.row_count, np.int64)
        for i, s in enumerate(rb.slices):
            values[s.to_array()] |= np.int64(1) << np.int64(i)
        out = cls.__new__(cls)
        out._init_identity(name, device)
        out.values = values
        out.host = rb
        out.rows = int(values.size)
        out.min_value = int(values.min()) if out.rows else 0
        out.max_value = int(values.max()) if out.rows else 0
        out._pack(RoaringBitmap.from_range(0, out.rows), rb.slices)
        out._trace_build()
        return out

    def _rebuild(self) -> None:
        self.host = RangeBitmap.from_values(self.values)
        self.rows = int(self.values.size)
        self.min_value = int(self.values.min()) if self.rows else 0
        self.max_value = self.host.max_value
        self._pack(RoaringBitmap.from_range(0, self.rows), self.host.slices)

    def apply_delta(self, updates: dict) -> dict:
        """Set row values ({row: value}); the host oracle and the device
        planes rebuild, the version bumps, and the dependent result-cache
        entries drop."""
        for row, value in updates.items():
            row = int(row)
            if row < 0 or row >= self.rows:
                raise IndexError(f"row {row} out of range 0..{self.rows - 1}")
            if int(value) < 0:
                raise ValueError("range column values must be >= 0")
            self.values[row] = int(value)
        self._rebuild()
        self._note_delta()
        return {"set": len(updates), "version": self.version,
                "structure_version": self.structure_version}

    def scan_plan(self, op: str, lo: int, hi: int = 0):
        """RangeBitmap guard semantics: thresholds outside the stored domain
        short-circuit as on the host, the rest lowers to the
        lte/gte/eq/neq/between scans."""
        if self.rows == 0 or self.keys.size == 0:
            return ("empty",)
        mx = self.max_value
        if op == "lt":
            if lo <= 0:
                return ("empty",)
            op, lo = "le", lo - 1
        elif op == "gt":
            op, lo = "ge", lo + 1
        if op == "le":
            if lo < 0:
                return ("empty",)
            if lo >= mx:
                return ("all",)
            return ("scan", "range:lte", self._bits(lo), self._bits(0))
        if op == "ge":
            if lo <= 0:
                return ("all",)
            if lo > mx:
                return ("empty",)
            return ("scan", "range:gte", self._bits(lo), self._bits(0))
        if op == "eq":
            if lo < 0 or lo > mx:
                return ("empty",)
            return ("scan", "range:eq", self._bits(lo), self._bits(0))
        if op == "neq":
            if lo < 0 or lo > mx:
                return ("all",)
            return ("scan", "range:neq", self._bits(lo), self._bits(0))
        if op == "range":
            a, b = max(lo, 0), min(hi, mx)
            if a > mx or hi < 0 or a > b:
                return ("empty",)
            if a <= 0 and b >= mx:
                return ("all",)
            return ("scan", "range:between", self._bits(a), self._bits(b))
        raise ValueError(f"unknown predicate op {op!r}")

    def host_filter(self, op: str, lo: int, hi: int = 0) -> RoaringBitmap:
        rb = self.host
        fns = {"le": rb.lte, "lt": rb.lt, "ge": rb.gte, "gt": rb.gt,
               "eq": rb.eq, "neq": rb.neq}
        if op == "range":
            return rb.between(lo, hi)
        if op not in fns:
            raise ValueError(f"unknown predicate op {op!r}")
        return fns[op](lo)

    def host_sum(self, found: RoaringBitmap | None):
        """(exact total, found count): the values are summed as 32-bit
        halves, so the total is exact past 2^63."""
        if found is None:
            return _exact_sum(self.values), self.rows
        rows = found.to_array()
        return (_exact_sum(self.values[rows[rows < self.rows]]),
                found.cardinality)

    def host_top_k(self, k: int, found: RoaringBitmap | None
                   ) -> RoaringBitmap:
        universe = RoaringBitmap.from_range(0, self.rows)
        fs = universe if found is None else rb_and(universe, found)
        return kaser_top_k(self.host.slices, fs,
                           min(int(k), fs.cardinality))


__all__ = ["BsiColumn", "RangeColumn"]
