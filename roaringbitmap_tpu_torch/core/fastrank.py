"""FastRankRoaringBitmap: rank and select over cached prefix sums.

The port's own copy of ``roaringbitmap_tpu.core.fastrank``: a RoaringBitmap
subclass that memoizes the cumulative per-container cardinalities (one
``np.cumsum``), so rank is two binary searches and select one, instead of a
linear container walk.  Every mutation invalidates the cache.
"""

from __future__ import annotations

import numpy as np

from .bitmap import RoaringBitmap


class FastRankRoaringBitmap(RoaringBitmap):
    __slots__ = ("_cum",)

    def __init__(self, keys=None, containers=None):
        super().__init__(keys, containers)
        self._cum: np.ndarray | None = None

    @staticmethod
    def from_values(values: np.ndarray) -> "FastRankRoaringBitmap":
        rb = RoaringBitmap.from_values(values)
        return FastRankRoaringBitmap(rb.keys, rb.containers)

    # ------------------------------------------------------------- the cache
    def _cumulatives(self) -> np.ndarray:
        if self._cum is None:
            self._cum = np.cumsum(
                [c.cardinality for c in self.containers], dtype=np.int64) \
                if self.containers else np.empty(0, dtype=np.int64)
        return self._cum

    def _invalidate(self) -> None:
        self._cum = None

    # Mutations invalidate (FastRankRoaringBitmap overrides every mutator)
    def add(self, x: int) -> None:
        self._invalidate()
        super().add(x)

    def append(self, key: int, container) -> None:
        self._invalidate()
        super().append(key, container)

    def remove(self, x: int) -> None:
        self._invalidate()
        super().remove(x)

    def add_many(self, values) -> None:
        self._invalidate()
        super().add_many(values)

    def add_range(self, start: int, stop: int) -> None:
        self._invalidate()
        super().add_range(start, stop)

    def remove_range(self, start: int, stop: int) -> None:
        self._invalidate()
        super().remove_range(start, stop)

    def flip_range(self, start: int, stop: int) -> None:
        self._invalidate()
        super().flip_range(start, stop)

    def ior(self, o) -> None:
        self._invalidate()
        super().ior(o)

    def iand(self, o) -> None:
        self._invalidate()
        super().iand(o)

    def ixor(self, o) -> None:
        self._invalidate()
        super().ixor(o)

    def iandnot(self, o) -> None:
        self._invalidate()
        super().iandnot(o)

    def clear(self) -> None:
        self._invalidate()
        super().clear()

    def run_optimize(self) -> bool:
        # container types change but cardinalities don't; keep the cache
        return super().run_optimize()

    # ---------------------------------------------------------- fast queries
    def rank(self, x: int) -> int:
        """Two binary searches (getLongRank in the reference)."""
        cum = self._cumulatives()
        hb = x >> 16
        i = int(np.searchsorted(self.keys, np.uint16(hb), side="left"))
        total = int(cum[i - 1]) if i > 0 else 0
        if i < self.keys.size and self.keys[i] == hb:
            total += self.containers[i].rank(x & 0xFFFF)
        return total

    def select(self, j: int) -> int:
        cum = self._cumulatives()
        i = int(np.searchsorted(cum, j, side="right"))
        if i >= cum.size:
            raise ValueError("select: rank out of bounds")
        prev = int(cum[i - 1]) if i else 0
        return (int(self.keys[i]) << 16) | self.containers[i].select(j - prev)

    @property
    def cache_valid(self) -> bool:
        return self._cum is not None
