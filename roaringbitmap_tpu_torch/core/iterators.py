"""Iterator flyweights over ``core.bitmap.RoaringBitmap``, the port's own
copy of the JAX package's ``core.iterators``.

The per-value family: ``PeekableIntIterator`` (peek_next and
advance_if_needed), ``PeekableIntRankIterator``, ``ReverseIntIterator`` and
the seeking ``RoaringBatchIterator``.  These are host conveniences; bulk
paths should prefer ``to_array()`` / ``batch_iterator`` or the device tier.

Flyweights: memory is O(one container).  Only the container being walked
is expanded to a value array; the rest of the bitmap is never
materialized, so a walk holds at most 2^16 values (256 KB) at a time.
"""

from __future__ import annotations

import copy
import numpy as np


def _snapshot_containers(rb):
    """Container access for a flyweight walk.  Mutable bitmaps are
    snapshotted (list copy) so structural mutation after iterator creation
    cannot desync the walk; byte-backed immutables (whose lazy sequence
    sets ``immutable = True``) are held directly — listifying one would
    decode every container up front, defeating the flyweight discipline."""
    conts = rb.containers
    return conts if getattr(conts, "immutable", False) else list(conts)


def _cardinality_at(conts, j: int) -> int:
    """Container j's cardinality without forcing a decode when the backing
    sequence can answer from its header."""
    header = getattr(conts, "cardinality_at", None)
    return header(j) if header is not None else conts[j].cardinality


class PeekableIntIterator:
    """Ascending iterator with peek_next and advance_if_needed.

    Expands one container at a time: _load(ci) materializes container ci's
    values; moving to the next container drops the previous array.
    """

    def __init__(self, rb):
        # snapshot the structure (keys array + container list) so structural
        # mutation of the bitmap after iterator creation cannot desync the
        # walk; container contents are shared (in-place container mutation
        # during iteration is undefined, as for the reference's flyweights)
        self._keys = rb.keys.copy()
        self._conts = _snapshot_containers(rb)
        self._ci = 0
        self._cur = np.empty(0, np.uint32)
        self._pos = 0
        self._load(0)

    def _load(self, ci: int) -> None:
        """Expand container ci (skipping empty ones) into _cur."""
        self._pos = 0
        while ci < len(self._conts):
            c = self._conts[ci]
            if c.cardinality:
                self._ci = ci
                base = np.uint32(int(self._keys[ci]) << 16)
                self._cur = base + c.values().astype(np.uint32)
                return
            ci += 1
        self._ci = ci
        self._cur = np.empty(0, np.uint32)

    def has_next(self) -> bool:
        return self._pos < self._cur.size

    def next(self) -> int:
        v = int(self._cur[self._pos])
        self._pos += 1
        if self._pos == self._cur.size:
            self._load(self._ci + 1)
        return v

    def peek_next(self) -> int:
        if not self.has_next():
            raise StopIteration
        return int(self._cur[self._pos])

    def advance_if_needed(self, min_val: int) -> None:
        """Skip values < min_val: O(log #keys) container hop + O(log card)
        within the landing container (advanceIfNeeded) — no other container
        is touched, let alone expanded."""
        if not self.has_next() or int(self._cur[self._pos]) >= min_val:
            return
        key = min_val >> 16
        if key != int(self._keys[self._ci]):
            ci = int(np.searchsorted(self._keys, key))
            self._load(ci)
            if not self.has_next():
                return
        if int(self._keys[self._ci]) == key:
            self._pos += int(np.searchsorted(
                self._cur[self._pos:], np.uint32(min_val)))
            if self._pos == self._cur.size:
                self._load(self._ci + 1)

    def clone(self) -> "PeekableIntIterator":
        return copy.copy(self)

    def __iter__(self):
        while self.has_next():
            yield self.next()


class PeekableIntRankIterator(PeekableIntIterator):
    """PeekableIntRankIterator: also reports the rank of the next value.

    Tracks the cardinality of containers already passed (_base); rank =
    base + position inside the current container.
    """

    def __init__(self, rb):
        self._base = 0
        self._base_ci = 0
        super().__init__(rb)

    def _load(self, ci: int) -> None:
        # accumulate cardinalities of containers being skipped over
        # (header-only on byte-backed bitmaps — skipping never decodes)
        for j in range(self._base_ci, min(ci, len(self._conts))):
            self._base += _cardinality_at(self._conts, j)
        self._base_ci = max(self._base_ci, min(ci, len(self._conts)))
        super()._load(ci)
        # _load may skip empty containers; account for them (cardinality 0)
        self._base_ci = max(self._base_ci, min(self._ci, len(self._conts)))

    def peek_next_rank(self) -> int:
        if not self.has_next():
            raise StopIteration
        return self._base + self._pos + 1  # rank is 1-based in the reference


class ReverseIntIterator:
    """Descending iterator (getReverseIntIterator) — same one-container
    flyweight discipline, walking containers from the last."""

    def __init__(self, rb):
        self._keys = rb.keys.copy()   # structural snapshot, as above
        self._conts = _snapshot_containers(rb)
        self._load(len(self._conts) - 1)

    def _load(self, ci: int) -> None:
        while ci >= 0:
            c = self._conts[ci]
            if c.cardinality:
                self._ci = ci
                base = np.uint32(int(self._keys[ci]) << 16)
                self._cur = base + c.values().astype(np.uint32)
                self._pos = self._cur.size - 1
                return
            ci -= 1
        self._ci = -1
        self._cur = np.empty(0, np.uint32)
        self._pos = -1

    def has_next(self) -> bool:
        return self._pos >= 0

    def next(self) -> int:
        v = int(self._cur[self._pos])
        self._pos -= 1
        if self._pos < 0:
            self._load(self._ci - 1)
        return v

    def clone(self) -> "ReverseIntIterator":
        """Independent cursor over the same snapshot
        (ReverseIntIteratorFlyweight.clone)."""
        return copy.copy(self)

    def __iter__(self):
        while self.has_next():
            yield self.next()


class RoaringBatchIterator:
    """Batch iterator with seek.

    next_batch() fills a u32 buffer of up to ``batch_size`` ascending
    values, spanning containers; advance_if_needed(min_val) implements the
    seek of RoaringBatchIterator.advanceIfNeeded: whole containers
    below min_val's chunk are skipped WITHOUT being expanded (a byte-backed
    bitmap does not even decode them), and within the landing container the
    position moves by binary search.  This is the natural host->device
    streaming seam: page through value space and ship each batch.
    """

    def __init__(self, rb, batch_size: int = 65536):
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self._keys = rb.keys.copy()
        self._conts = _snapshot_containers(rb)
        self._batch = batch_size
        self._ci = 0
        self._cur: np.ndarray | None = None  # expanded current container
        self._pos = 0

    def _skip_empty(self) -> None:
        while (self._cur is None and self._ci < len(self._conts)
               and _cardinality_at(self._conts, self._ci) == 0):
            self._ci += 1

    def has_next(self) -> bool:
        self._skip_empty()
        if self._cur is not None:
            return True
        return self._ci < len(self._conts)

    def _expand(self) -> None:
        base = np.uint32(int(self._keys[self._ci]) << 16)
        self._cur = base + self._conts[self._ci].values().astype(np.uint32)
        self._pos = 0

    def next_batch(self) -> np.ndarray:
        """Up to batch_size next values, ascending (empty when exhausted)."""
        parts: list[np.ndarray] = []
        n = 0
        while n < self._batch:
            self._skip_empty()
            if self._ci >= len(self._conts):
                break
            if self._cur is None:
                self._expand()
            take = self._cur[self._pos:self._pos + (self._batch - n)]
            parts.append(take)
            n += take.size
            self._pos += take.size
            if self._pos >= self._cur.size:
                self._cur = None
                self._ci += 1
        return np.concatenate(parts) if parts else np.empty(0, np.uint32)

    def advance_if_needed(self, min_val: int) -> None:
        """Skip values < min_val.  Containers in chunks below min_val's are
        hopped over without expansion (or decode); inside the landing
        container the cursor moves by one binary search."""
        key = min_val >> 16
        ci = int(np.searchsorted(self._keys, np.uint16(key)))
        if ci > self._ci:
            self._ci = ci
            self._cur = None
            self._pos = 0
        if (self._ci < len(self._conts)
                and int(self._keys[self._ci]) == key):
            if self._cur is None:
                self._skip_empty()
                if (self._ci >= len(self._conts)
                        or int(self._keys[self._ci]) != key):
                    return
                self._expand()
            self._pos = max(self._pos, int(np.searchsorted(
                self._cur, np.uint32(min_val))))
            if self._pos >= self._cur.size:
                self._cur = None
                self._ci += 1

    def clone(self) -> "RoaringBatchIterator":
        """Independent cursor over the same container snapshot
        (RoaringBatchIterator.clone / CloneBatchIteratorTest): clones
        advance separately; the shared containers are persistent."""
        return copy.copy(self)

    def __iter__(self):
        while self.has_next():
            yield self.next_batch()
