"""Bounded LRU cache with counters (``roaringbitmap_tpu.runtime.cache``).

The batch engine caches a prepared plan per query tuple.  An unbounded dict
would turn a stream of novel query shapes into a memory leak, so the cache is
size-capped and counts its hits, misses and evictions (``stats()``).  The
port has no metrics registry yet, so ``name`` only labels the cache.
"""

from __future__ import annotations

from collections import OrderedDict

_MISSING = object()


class LRUCache:
    """OrderedDict-backed LRU: ``get`` refreshes recency, ``put`` evicts the
    least-recently-used entry past ``maxsize``.  Not thread-safe (one
    dispatcher per engine)."""

    def __init__(self, maxsize: int, name: str | None = None):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.name = name
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, key, default=None):
        val = self._data.get(key, _MISSING)
        if val is _MISSING:
            self.misses += 1
            return default
        self.hits += 1
        self._data.move_to_end(key)
        return val

    def put(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1

    def clear(self) -> None:
        self._data.clear()

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def stats(self) -> dict:
        return {"size": len(self._data), "maxsize": self.maxsize,
                "hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}
