"""Device BSI tier: the O'Neil comparator, the sum and the Kaser top-K over
a resident bit-sliced index (``roaringbitmap_tpu.bsi.device``).

The index is densified once onto the device as int32 views of u32 words:

  slices  int32[S, K, 2048]   slice s, container key k, dense 2^16-bit image
  ebm     int32[K, 2048]

and each query is a loop over the slice axis, descending, of elementwise
word algebra, with a popcount on the way out.  The JAX package ran these
scans as ``lax.scan`` in XLA, outside any Pallas kernel, so here they are
plain PyTorch, as the port's other XLA parts are.  Predicates are
decomposed into their bits on the host (Python ints, so 64-bit thresholds
and out-of-band values keep their exact bit pattern), and each bit selects
which of the two state updates a slice step runs.  The Kaser scan's take
decision (``popcount(x) < k``) stays on the device, a 0-d tensor feeding
``torch.where``: no step of it waits for the host.  Popcounts go through
``ops.words.popcount`` (int64 inside); sums weight the per-slice counts by
2^i in Python ints.

Entry points run on the card: ``device=None`` means ``"cuda"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitmap import RoaringBitmap, and_ as rb_and, \
    and_cardinality, or_ as rb_or
from ..obs import memory as obs_memory
from ..ops import packing
from ..ops.words import as_i32, popcount, resolve_device, to_u32
from .slice_index import (Operation, RoaringBitmapSliceIndex,
                          clamp_range_bounds, minmax_decision,
                          trim_smallest)


def _densify(rb: RoaringBitmap, keys: np.ndarray) -> np.ndarray:
    """Dense u32[K, 2048] image of ``rb`` over the index's key set.
    Containers under keys outside the set are dropped."""
    idx = np.searchsorted(keys, rb.keys)
    hit = idx < keys.size
    hit[hit] = keys[idx[hit]] == rb.keys[hit]
    conts = [c for c, h in zip(rb.containers, hit) if h]
    return packing.densify_containers(conts, idx[hit], keys.size)


def predicate_bits(predicate: int, depth: int) -> np.ndarray:
    """Predicate -> top-bit-first bit array int32[depth], decomposed with
    Python int shifts so negative and >= 2^31 predicates keep the host
    comparator's bit pattern (sign extension included)."""
    return np.asarray([(predicate >> i) & 1
                       for i in range(depth - 1, -1, -1)], dtype=np.int32)


def _descending(slices):
    """Slice planes from the top bit down."""
    return (slices[i] for i in range(slices.shape[0] - 1, -1, -1))


def _masks(bits) -> torch.Tensor:
    """Device predicate bits int32[depth] -> per-slice word masks (0 or -1)."""
    return -bits


def oneil_scan(slices, ebm, bits):
    """One descending pass over base-2 slices -> (gt, lt, eq) words.
    ``bits`` is the predicate's top-bit-first bit array: a host array
    (the scan branches on each bit), or an int32 tensor on the slices'
    device, for which the scan is branch-free (each bit becomes a word
    mask), so that the predicate stays data in a captured program."""
    if isinstance(bits, torch.Tensor):
        m = _masks(bits)
        gt = torch.zeros_like(ebm)
        lt = torch.zeros_like(ebm)
        eq = ebm
        for i, w in enumerate(_descending(slices)):
            lt = lt | (eq & ~w & m[i])
            gt = gt | (eq & w & ~m[i])
            eq = eq & ~(w ^ m[i])
        return gt, lt, eq
    gt = torch.zeros_like(ebm)
    lt = torch.zeros_like(ebm)
    eq = ebm
    for w, bit in zip(_descending(slices), bits):
        if int(bit):
            lt = lt | (eq & ~w)
            eq = eq & w
        else:
            gt = gt | (eq & w)
            eq = eq & ~w
    return gt, lt, eq


def oneil_scan2(slices, ebm, bits_lo, bits_hi):
    """One descending pass carrying both bounds (the reference's
    DoubleEvaluation): each slice is read once and updates the lower
    bound's (gt, eq) and the upper bound's (lt, eq)."""
    gt1 = torch.zeros_like(ebm)
    lt2 = torch.zeros_like(ebm)
    eq1 = eq2 = ebm
    if isinstance(bits_lo, torch.Tensor):
        # branch-free over device bits, as in ``oneil_scan``
        m1, m2 = _masks(bits_lo), _masks(bits_hi)
        for i, w in enumerate(_descending(slices)):
            gt1 = gt1 | (eq1 & w & ~m1[i])
            eq1 = eq1 & ~(w ^ m1[i])
            lt2 = lt2 | (eq2 & ~w & m2[i])
            eq2 = eq2 & ~(w ^ m2[i])
        return gt1, eq1, lt2, eq2
    for w, b1, b2 in zip(_descending(slices), bits_lo, bits_hi):
        if int(b1):
            eq1 = eq1 & w
        else:
            gt1 = gt1 | (eq1 & w)
            eq1 = eq1 & ~w
        if int(b2):
            lt2 = lt2 | (eq2 & ~w)
            eq2 = eq2 & w
        else:
            eq2 = eq2 & ~w
    return gt1, eq1, lt2, eq2


def _compare_res(op: str, slices, ebm, bits, bits2, found):
    """One O'Neil scan and the op's word combine (the BSI comparator)."""
    if op == "RANGE":
        gt, eq, lt2, eq2 = oneil_scan2(slices, ebm, bits, bits2)
        return ((gt & found) | (found & eq)) & ((lt2 & found) | (found & eq2))
    gt, lt, eq = oneil_scan(slices, ebm, bits)
    eq = found & eq
    if op == "EQ":
        return eq
    if op == "NEQ":
        return found & ~eq
    if op == "GT":
        return gt & found
    if op == "LT":
        return lt & found
    if op == "LE":
        return (lt & found) | eq
    if op == "GE":
        return (gt & found) | eq
    raise ValueError(f"unsupported operation {op}")


def _range_res(op: str, slices, ebm, bits, bits2, found):
    """The RangeBitmap threshold family lte/gte/eq/neq/between."""
    if op == "between":
        gt, eq, lt2, eq2 = oneil_scan2(slices, ebm, bits, bits2)
        return (gt | eq) & (lt2 | eq2) & found
    gt, lt, eq = oneil_scan(slices, ebm, bits)
    if op == "lte":
        return (lt | eq) & found
    if op == "gte":
        return (gt | eq) & found
    if op == "eq":
        return eq & found
    if op == "neq":
        return found & ~eq
    raise ValueError(f"unsupported op {op}")


def _topk_res(slices, found, k):
    """The Kaser top-K scan, branch-free: per slice, candidates
    ``x = g | (e & w)``; when popcount(x) < k take them (g = x, e &= ~w),
    else restrict e to the slice.  Returns g | e, before the tie trim.
    ``k`` is an int or a 0-d tensor; the decision never leaves the
    device."""
    g = torch.zeros_like(found)
    e = found
    for w in _descending(slices):
        x = g | (e & w)
        take = popcount(x).sum(dtype=torch.int64) < k
        g = torch.where(take, x, g)
        e = torch.where(take, e & ~w, e & w)
    return g | e


def _slice_cards_res(slices, found):
    """Per-slice popcount of slices ∩ found -> int64[S]."""
    return popcount(slices & found[None]).sum(dim=-1, dtype=torch.int64)


def _weighted_total(cards) -> int:
    """sum_i 2^i * cards[i], in Python ints."""
    return sum((1 << i) * int(c) for i, c in enumerate(cards))


def _unpack(keys: np.ndarray, words) -> RoaringBitmap:
    return packing.unpack_result(keys, to_u32(words),
                                 popcount(words).cpu().numpy())


def _pack_index(ebm_bitmap: RoaringBitmap, slice_bitmaps, device):
    """Densify an existence bitmap and its slices over the ebm's key set
    and upload both.  Returns (keys, ebm, slices)."""
    keys = ebm_bitmap.keys.copy()
    ebm = _densify(ebm_bitmap, keys)
    slices = (np.stack([_densify(s, keys) for s in slice_bitmaps])
              if slice_bitmaps else np.zeros((0,) + ebm.shape, np.uint32))
    return keys, as_i32(ebm, device), as_i32(slices, device)


def _total_mod32(device):
    return torch.zeros((), dtype=torch.int64, device=device)


class DeviceBSI:
    """A RoaringBitmapSliceIndex packed once and kept resident on the
    card.  Bit-exact with the host comparator, min/max pruning included.

    The chained probes return a callable that runs ``reps`` dependent
    queries and returns a 0-d device tensor: the summed result mod 2^32
    (int64 accumulation, no host synchronization in the loop).  PyTorch
    runs eagerly and never hoists or elides a repeated call, so every
    iteration runs the whole scan."""

    def __init__(self, bsi: RoaringBitmapSliceIndex, device=None):
        self.device = resolve_device(device)
        self.min_value = bsi.min_value
        self.max_value = bsi.max_value
        self.depth = bsi.bit_count()
        self._ebm_host = bsi.ebm.clone()
        self.keys, self.ebm, self.slices = _pack_index(
            bsi.ebm, bsi.slices, self.device)
        # resident planes in the HBM ledger, released when collected
        obs_memory.LEDGER.register("bsi", "dense", self.hbm_bytes(),
                                   owner=self)

    def hbm_bytes(self) -> int:
        """Device bytes of the resident planes."""
        return sum(t.numel() * t.element_size()
                   for t in (self.ebm, self.slices))

    def _bits(self, predicate: int) -> np.ndarray:
        return predicate_bits(predicate, self.depth)

    def _found_words(self, found_set: RoaringBitmap | None):
        if found_set is None:
            return self.ebm
        return as_i32(_densify(found_set, self.keys), self.device)

    def _compare_words(self, op: Operation, start: int, end: int, found):
        start, end = clamp_range_bounds(op, start, end, self.min_value,
                                        self.max_value)
        return _compare_res(op.value, self.slices, self.ebm,
                            self._bits(start), self._bits(end), found)

    def _pruned(self, decision: str,
                found_set: RoaringBitmap | None) -> RoaringBitmap:
        """A min/max-pruned answer, on the host: "all" = ebm ∩ foundSet."""
        if decision == "empty":
            return RoaringBitmap()
        return (self._ebm_host.clone() if found_set is None
                else rb_and(self._ebm_host, found_set))

    def compare(self, op: Operation, start_or_value: int, end: int = 0,
                found_set: RoaringBitmap | None = None) -> RoaringBitmap:
        decision = minmax_decision(op, start_or_value, end,
                                   self.min_value, self.max_value)
        if decision is not None:
            return self._pruned(decision, found_set)
        res = _unpack(self.keys, self._compare_words(
            op, start_or_value, end, self._found_words(found_set)))
        if op is Operation.NEQ and found_set is not None:
            # NEQ = foundSet \ EQ keeps foundSet rows under keys the index
            # never stored, which the densify dropped: re-attach them
            extra = ~np.isin(found_set.keys, self.keys)
            if extra.any():
                res = rb_or(res, RoaringBitmap(
                    found_set.keys[extra],
                    [c for c, x in zip(found_set.containers, extra) if x]))
        return res

    def compare_cardinality(self, op: Operation, start_or_value: int,
                            end: int = 0,
                            found_set: RoaringBitmap | None = None) -> int:
        decision = minmax_decision(op, start_or_value, end,
                                   self.min_value, self.max_value)
        if decision is not None:
            if decision == "empty":
                return 0
            if found_set is None:
                return self._ebm_host.cardinality
            return and_cardinality(self._ebm_host, found_set)
        if op is Operation.NEQ and found_set is not None:
            return self.compare(op, start_or_value, end,
                                found_set).cardinality
        words = self._compare_words(op, start_or_value, end,
                                    self._found_words(found_set))
        return int(popcount(words).sum(dtype=torch.int64))

    def sum(self, found_set: RoaringBitmap | None = None) -> tuple[int, int]:
        """(sum of values, member count): per-slice popcounts on the device,
        the 2^i weighting in Python ints.  The count is the found set's
        cardinality, as on the host, rows under keys the index never stored
        included."""
        found = self._found_words(found_set)
        cards = _slice_cards_res(self.slices, found).cpu().numpy()
        count = (found_set.cardinality if found_set is not None
                 else int(popcount(found).sum(dtype=torch.int64)))
        return _weighted_total(cards), count

    def top_k(self, k: int, found_set: RoaringBitmap | None = None
              ) -> RoaringBitmap:
        found = self._found_words(found_set)
        if k < 0 or k > int(popcount(found).sum(dtype=torch.int64)):
            raise ValueError("TopK param error")
        f = trim_smallest(_unpack(self.keys,
                                  _topk_res(self.slices, found, k)), k)
        assert f.cardinality == k, "bugs found when compute topK"
        return f

    # ------------------------------------------------------------- probes
    def chained_compare_cardinality(self, op: Operation, value: int,
                                    reps: int, end: int = 0):
        """``reps`` compares over the whole index -> fn() = summed
        cardinality mod 2^32 (no pruning or clamping: the scan runs every
        time, as in the JAX probe)."""
        bits, bits2 = self._bits(value), self._bits(end)

        def run():
            total = _total_mod32(self.device)
            for _ in range(reps):
                words = _compare_res(op.value, self.slices, self.ebm, bits,
                                     bits2, self.ebm)
                total += popcount(words).sum(dtype=torch.int64)
            return total % (1 << 32)

        return run

    def chained_sum_cardinality(self, reps: int):
        """``reps`` sums over the whole index -> fn() = summed total mod
        2^32 (per-slice weights mod 2^32, as the JAX probe)."""
        weights = torch.tensor([(1 << i) & 0xFFFFFFFF
                                for i in range(self.depth)],
                               dtype=torch.int64, device=self.device)

        def run():
            total = _total_mod32(self.device)
            for _ in range(reps):
                cards = _slice_cards_res(self.slices, self.ebm)
                total += (cards * weights).sum() % (1 << 32)
            return total % (1 << 32)

        return run

    def chained_topk_cardinality(self, k: int, reps: int):
        """``reps`` Kaser scans -> fn() = summed pre-trim cardinality mod
        2^32 (>= k with ties)."""
        def run():
            total = _total_mod32(self.device)
            for _ in range(reps):
                f = _topk_res(self.slices, self.ebm, k)
                total += popcount(f).sum(dtype=torch.int64)
            return total % (1 << 32)

        return run


class DeviceRangeBitmap:
    """A ``core.rangebitmap.RangeBitmap`` packed resident on the card, with
    the host tier's query surface and out-of-range guards.  Thresholds are
    decomposed into bits on the host, so the scan is exact over the full
    unsigned 64-bit value range."""

    def __init__(self, rb, device=None):
        from ..core.rangebitmap import RangeBitmap

        if not isinstance(rb, RangeBitmap):
            raise TypeError("DeviceRangeBitmap takes a RangeBitmap")
        self.device = resolve_device(device)
        self.rows = rb.row_count
        self.max_value = rb.max_value
        self.depth = len(rb.slices)
        self.keys, self.ebm, self.slices = _pack_index(
            RoaringBitmap.from_range(0, self.rows), rb.slices, self.device)
        obs_memory.LEDGER.register("rangebitmap", "dense", self.hbm_bytes(),
                                   owner=self)

    def hbm_bytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.ebm, self.slices))

    def _bits(self, threshold: int) -> np.ndarray:
        return predicate_bits(threshold, self.depth)

    def _found_words(self, context: RoaringBitmap | None):
        if context is None:
            return self.ebm
        # clipped to the row universe, as the host computes all_rows ∩ context
        return as_i32(_densify(context, self.keys), self.device) & self.ebm

    def _query_words(self, op: str, a: int, b: int, context):
        return _range_res(op, self.slices, self.ebm, self._bits(a),
                          self._bits(b), self._found_words(context))

    def chained_cardinality(self, op: str, a: int, b: int, reps: int):
        """``reps`` threshold queries over every row -> fn() = summed
        cardinality mod 2^32."""
        def run():
            total = _total_mod32(self.device)
            for _ in range(reps):
                words = self._query_words(op, a, b, None)
                total += popcount(words).sum(dtype=torch.int64)
            return total % (1 << 32)

        return run

    def _run(self, op: str, a: int, b: int, context) -> RoaringBitmap:
        return _unpack(self.keys, self._query_words(op, a, b, context))

    def _all(self, context) -> RoaringBitmap:
        return _unpack(self.keys, self._found_words(context))

    def lte(self, threshold, context=None):
        if threshold < 0:
            return RoaringBitmap()
        if threshold >= self.max_value:
            return self._all(context)
        return self._run("lte", threshold, 0, context)

    def lt(self, threshold, context=None):
        if threshold <= 0:
            return RoaringBitmap()
        return self.lte(threshold - 1, context)

    def gte(self, threshold, context=None):
        if threshold <= 0:
            return self._all(context)
        if threshold > self.max_value:
            return RoaringBitmap()
        return self._run("gte", threshold, 0, context)

    def gt(self, threshold, context=None):
        return self.gte(threshold + 1, context)

    def eq(self, value, context=None):
        if value < 0 or value > self.max_value:
            return RoaringBitmap()
        return self._run("eq", value, 0, context)

    def neq(self, value, context=None):
        if value < 0 or value > self.max_value:
            return self._all(context)
        return self._run("neq", value, 0, context)

    def between(self, min_value, max_value, context=None):
        lo, hi = max(min_value, 0), min(max_value, self.max_value)
        if lo > self.max_value or hi < 0 or lo > hi:
            return RoaringBitmap()
        return self._run("between", lo, hi, context)

    # cardinality forms: one scalar back to the host
    def _card(self, op: str, a: int, b: int, context) -> int:
        words = self._query_words(op, a, b, context)
        return int(popcount(words).sum(dtype=torch.int64))

    def _all_cardinality(self, context) -> int:
        return int(popcount(self._found_words(context))
                   .sum(dtype=torch.int64))

    def lte_cardinality(self, t, context=None):
        if t < 0:
            return 0
        if t >= self.max_value:
            return self._all_cardinality(context)
        return self._card("lte", t, 0, context)

    def lt_cardinality(self, t, context=None):
        return 0 if t <= 0 else self.lte_cardinality(t - 1, context)

    def gte_cardinality(self, t, context=None):
        if t <= 0:
            return self._all_cardinality(context)
        if t > self.max_value:
            return 0
        return self._card("gte", t, 0, context)

    def gt_cardinality(self, t, context=None):
        return self.gte_cardinality(t + 1, context)

    def eq_cardinality(self, v, context=None):
        if v < 0 or v > self.max_value:
            return 0
        return self._card("eq", v, 0, context)

    def neq_cardinality(self, v, context=None):
        if v < 0 or v > self.max_value:
            return self._all_cardinality(context)
        return self._card("neq", v, 0, context)

    def between_cardinality(self, a, b, context=None):
        lo, hi = max(a, 0), min(b, self.max_value)
        if lo > self.max_value or hi < 0 or lo > hi:
            return 0
        return self._card("between", lo, hi, context)


__all__ = ["DeviceBSI", "DeviceRangeBitmap", "predicate_bits", "oneil_scan",
           "oneil_scan2"]
