"""Bounded LRU cache with observable counters (the port's own copy of
``roaringbitmap_tpu.runtime.cache``).

A long-lived serving process replays the prepared-statement pattern: plans
and programs are cached per query/bucket signature.  Unbounded dicts turn
adversarial query shapes into a memory leak, so the engines' caches ride
this LRU: size-capped, eviction-counted, and introspectable via
``stats()`` so a server can alarm on churn.
"""

from __future__ import annotations

import weakref
from collections import OrderedDict

from ..obs import metrics as _metrics

_MISSING = object()

#: live named caches, summed per name by the rb_cache_size collector at
#: scrape time (a pull gauge cannot desync across obs.reset() or clobber
#: across instances the way pushed values can; a name whose caches have
#: all been collected keeps its last value until the next reset)
_named_caches: "weakref.WeakSet" = weakref.WeakSet()


def _collect_cache_sizes(registry) -> None:
    sizes: dict = {}
    for c in list(_named_caches):
        sizes[c.name] = sizes.get(c.name, 0) + len(c._data)
    for name, n in sizes.items():
        registry.gauge("rb_cache_size", cache=name).set(n)


_metrics.REGISTRY.register_collector(_collect_cache_sizes)


class LRUCache:
    """OrderedDict-backed LRU: ``get`` refreshes recency, ``put`` evicts the
    least-recently-used entry past ``maxsize``.  Not thread-safe (one
    dispatcher per engine).

    ``name`` opts the cache into the unified metrics registry as a
    first-class instrument: hits/misses/evictions bump
    ``rb_cache_events_total{cache=name,event=...}``, and the entry count
    is computed at scrape time by the ``rb_cache_size`` collector as the
    sum over live instances sharing the name (a server's per-engine view
    stays ``stats()``)."""

    def __init__(self, maxsize: int, name: str | None = None):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self.name = name
        self._data: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        if name is not None:
            _named_caches.add(self)

    def _count(self, event: str) -> None:
        if self.name is not None:
            _metrics.counter("rb_cache_events_total", cache=self.name,
                             event=event).inc()

    def get(self, key, default=None):
        val = self._data.get(key, _MISSING)
        if val is _MISSING:
            self.misses += 1
            self._count("miss")
            return default
        self.hits += 1
        self._count("hit")
        self._data.move_to_end(key)
        return val

    def put(self, key, value) -> None:
        if key in self._data:
            self._data.move_to_end(key)
        self._data[key] = value
        while len(self._data) > self.maxsize:
            self._data.popitem(last=False)
            self.evictions += 1
            self._count("eviction")

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
