"""FastAggregation: the named wide-aggregation strategy set.

Every strategy name of the reference's FastAggregation is kept, over the
port's engine:

- naive_or/naive_xor/naive_and: host-side pairwise folds.
- priorityqueue_or/priorityqueue_xor: size-ordered host folds (smallest
  pair first).
- horizontal_or/horizontal_xor: the device engine: the group-by-key rotation
  is the container priority queue, the segmented reduce the lazy-OR chain,
  the fused popcount the repair.
- work_shy_and / work_and_memory_shy_and / and_: the device wide AND.
- or_/xor: the recommended strategy, the device engine.

Strategies accept bitmaps as varargs or as one iterable.  The device ones
take ``device=None`` (the card) like every entry point of the port.
"""

from __future__ import annotations

import heapq

from ..core.bitmap import (
    RoaringBitmap,
    and_ as rb_and,
    andnot as rb_andnot,
    or_ as rb_or,
    xor as rb_xor,
)
from . import aggregation


def _as_list(bitmaps) -> list:
    if len(bitmaps) == 1 and not hasattr(bitmaps[0], "keys"):
        return list(bitmaps[0])
    return list(bitmaps)


# ------------------------------------------------------------------- naive
def naive_or(*bitmaps) -> RoaringBitmap:
    """Left-to-right pairwise fold."""
    acc = RoaringBitmap()
    for b in _as_list(bitmaps):
        acc = rb_or(acc, b)
    return acc


def naive_xor(*bitmaps) -> RoaringBitmap:
    acc = RoaringBitmap()
    for b in _as_list(bitmaps):
        acc = rb_xor(acc, b)
    return acc


def naive_and(*bitmaps) -> RoaringBitmap:
    """Pairwise intersect with an empty short-circuit."""
    bs = _as_list(bitmaps)
    if not bs:
        return RoaringBitmap()
    acc = bs[0].clone()
    for b in bs[1:]:
        acc = rb_and(acc, b)
        if acc.is_empty():
            return acc
    return acc


def naive_andnot(first, *others, device=None) -> RoaringBitmap:
    """Difference chain: first \\ (or of the rest)."""
    rest = _as_list(others)
    if not rest:
        return first.clone()
    return rb_andnot(first, aggregation.or_(rest, device=device))


# ---------------------------------------------------------- priority queue
def _priorityqueue(fold, bitmaps) -> RoaringBitmap:
    bs = _as_list(bitmaps)
    if not bs:
        return RoaringBitmap()
    if len(bs) == 1:
        return bs[0].clone()
    heap = [(b.serialized_size_in_bytes(), i, b) for i, b in enumerate(bs)]
    heapq.heapify(heap)
    tick = len(bs)
    while len(heap) > 1:
        _, _, a = heapq.heappop(heap)
        _, _, b = heapq.heappop(heap)
        m = fold(a, b)
        heapq.heappush(heap, (m.serialized_size_in_bytes(), tick, m))
        tick += 1
    return heap[0][2]


def priorityqueue_or(*bitmaps) -> RoaringBitmap:
    """Smallest-two-first merge: keeps intermediates small, host-side."""
    return _priorityqueue(rb_or, bitmaps)


def priorityqueue_xor(*bitmaps) -> RoaringBitmap:
    return _priorityqueue(rb_xor, bitmaps)


# -------------------------------------------------------- horizontal (device)
def horizontal_or(*bitmaps, engine: str = "auto", device=None) -> RoaringBitmap:
    """Container-queue lazy OR with one repair, on the device."""
    return aggregation.or_(_as_list(bitmaps), engine=engine, device=device)


def horizontal_xor(*bitmaps, engine: str = "auto", device=None) -> RoaringBitmap:
    return aggregation.xor(_as_list(bitmaps), engine=engine, device=device)


# ------------------------------------------------------------ AND (device)
def work_shy_and(*bitmaps, device=None) -> RoaringBitmap:
    """workShyAnd: key-set intersection, then the dense AND-reduce."""
    return aggregation.and_(_as_list(bitmaps), device=device)


def work_and_memory_shy_and(*bitmaps, device=None) -> RoaringBitmap:
    """workAndMemoryShyAnd: the same key-shy plan; reusing one scratch
    buffer is the allocator's job on the device."""
    return aggregation.and_(_as_list(bitmaps), device=device)


# camelCase-parity aliases
workShyAnd = work_shy_and
workAndMemoryShyAnd = work_and_memory_shy_and


# ------------------------------------------------------------- recommended
def or_(*bitmaps, engine: str = "auto", device=None) -> RoaringBitmap:
    return aggregation.or_(_as_list(bitmaps), engine=engine, device=device)


def xor(*bitmaps, engine: str = "auto", device=None) -> RoaringBitmap:
    return aggregation.xor(_as_list(bitmaps), engine=engine, device=device)


def and_(*bitmaps, device=None) -> RoaringBitmap:
    return aggregation.and_(_as_list(bitmaps), device=device)


def or_cardinality(*bitmaps, device=None) -> int:
    return aggregation.or_cardinality(_as_list(bitmaps), device=device)


def and_cardinality(*bitmaps, device=None) -> int:
    return aggregation.and_cardinality(_as_list(bitmaps), device=device)


def xor_cardinality(*bitmaps, device=None) -> int:
    return aggregation.xor_cardinality(_as_list(bitmaps), device=device)
