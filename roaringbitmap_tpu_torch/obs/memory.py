"""Device-memory observability: the live HBM ledger + dispatch measurement
(the port's own copy of ``roaringbitmap_tpu.obs.memory``; gauge names,
labels and event fields are the JAX package's).

- **HBM ledger** (``LEDGER``): every resident device payload
  (``DeviceBitmapSet``, ``DevicePairSet``, a value column, a device BSI,
  a result cache, a captured-graph pool) registers its bytes and releases
  them when freed; a ``weakref.finalize`` fires the release when the owner
  is collected, so a leaked registration cannot outlive its tensors.  A
  registration holds a byte count (pushed; ``update`` resizes it) or a
  function of the owner (pulled at every read, through a weak reference,
  and recounted only when the owner's ``stamp`` moves): the port's sets
  change their bytes on a repack and its caches on every fill.  Live
  totals export as ``rb_hbm_resident_bytes{kind,layout}`` gauges through
  a registry collector — pull-model, like ``rb_cache_size``, so the truth
  is recomputed at every scrape and survives ``obs.reset()``.
- **Dispatch measurement** (``PeakWindow``): there is no compiler memory
  analysis to read; the measured peak of one launch is the rise of
  ``torch.cuda.max_memory_allocated()`` over the allocation at the
  launch's start, after ``reset_peak_memory_stats()``.  The statistics
  are device-global, so the engines take the measurement only while
  tracing is on and only on a synchronous dispatch (a pipelined launch or
  the pump thread would race it).  The prediction it is held against is
  ``insights.predict_*_dispatch_bytes`` (``rb_hbm_predicted_bytes`` vs
  ``rb_hbm_measured_peak_bytes``, and the ``batch.memory`` span event).
- **Allocator stats** (``backend_memory_stats`` / ``backend_free_bytes``):
  ``torch.cuda.memory_stats`` and ``torch.cuda.mem_get_info`` on a CUDA
  device; None on the CPU, which reports nothing — the source of the
  default ``ROARING_TPU_HBM_BUDGET``.

A byte count of the port differs from the JAX package's for the same
bitmaps: the port keeps other resident tensors beside the image (segment
ids and head indices as int32, the compact streams' device copies, B3's
chunk bounds), and the graph pools have no JAX counterpart.  A budget
compared with these bytes is stated in the port's own units.
"""

from __future__ import annotations

import itertools
import threading
import weakref

from . import metrics as _metrics

_UNSET = object()


class HbmLedger:
    """Resident device bytes per (kind, layout), keyed by registration.

    ``register`` returns an integer handle; ``release(handle)`` is
    idempotent (a manual release followed by the owner's GC finalizer
    must not double-subtract).  Passing ``owner`` arms a
    ``weakref.finalize`` so collection releases automatically.  ``nbytes``
    is an int, or a function of ``owner`` pulled at every read (cached
    while ``stamp(owner)`` stays the same; without ``stamp``, recounted
    at every read).
    """

    def __init__(self):
        # handle -> [kind, layout, bytes, owner ref, fn, stamp fn, stamp]
        self._entries: dict = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()

    def register(self, kind: str, layout: str, nbytes, owner=None,
                 stamp=None) -> int:
        handle = next(self._ids)
        if callable(nbytes):
            if owner is None:
                raise ValueError("a pulled byte count needs its owner")
            row = [str(kind), str(layout), 0, weakref.ref(owner), nbytes,
                   stamp, _UNSET]
        else:
            row = [str(kind), str(layout), int(nbytes), None, None, None,
                   None]
        with self._lock:
            self._entries[handle] = row
        if owner is not None:
            weakref.finalize(owner, self.release, handle)
        if row[3] is None:
            # a pulled count is read at the first scrape, not here: its
            # owner may still be under construction
            self._push_gauges(row[0], row[1])
        return handle

    def release(self, handle: int) -> None:
        with self._lock:
            row = self._entries.pop(handle, None)
        if row is not None:
            # push the shrunk total immediately — a scrape between a free
            # and the next collector run must not report freed bytes
            self._push_gauges(row[0], row[1])

    def update(self, handle: int, nbytes: int) -> None:
        """Re-size a live pushed registration in place (idempotent no-op
        on a released handle).  Gauges push immediately, like
        ``release``."""
        with self._lock:
            row = self._entries.get(handle)
            if row is None:
                return
            row[2] = int(nbytes)
        self._push_gauges(row[0], row[1])

    def _push_gauges(self, kind: str, layout: str) -> None:
        _metrics.gauge("rb_hbm_resident_bytes", kind=kind,
                       layout=layout).set(self.resident_bytes(kind, layout))

    def _rows(self) -> list:
        """[(kind, layout, bytes)] of every live registration, pulling
        the byte counts of function registrations whose stamp moved."""
        with self._lock:
            rows = list(self._entries.values())
        out = []
        for row in rows:
            ref = row[3]
            if ref is not None and row[4] is not None:
                owner = ref()
                if owner is None:
                    continue
                try:
                    st = row[5](owner) if row[5] is not None else _UNSET
                    if row[5] is None or st != row[6]:
                        row[2] = int(row[4](owner))
                        row[6] = st
                except AttributeError:
                    # an owner still being built on another thread:
                    # nothing of it counts yet, the next read counts it
                    row[2], row[6] = 0, _UNSET
            out.append((row[0], row[1], row[2]))
        return out

    def resident_bytes(self, kind: str | None = None,
                       layout: str | None = None) -> int:
        return sum(b for k, l, b in self._rows()
                   if (kind is None or k == kind)
                   and (layout is None or l == layout))

    def snapshot(self) -> dict:
        """{"total_bytes", "entries", "by_kind": {kind: {layout: bytes}}}
        — plain JSON, the ledger half of a health endpoint."""
        rows = self._rows()
        by_kind: dict = {}
        for k, l, b in rows:
            by_kind.setdefault(k, {})
            by_kind[k][l] = by_kind[k].get(l, 0) + b
        return {"total_bytes": sum(b for _, _, b in rows),
                "entries": len(rows), "by_kind": by_kind}

    def reset(self) -> None:
        """Drop every registration: ``snapshot()`` afterwards equals a
        fresh ledger's (pending finalizers release already-absent
        handles, a no-op).  The pushed gauges of the cleared (kind,
        layout) pairs are zeroed too."""
        with self._lock:
            cleared = {(r[0], r[1]) for r in self._entries.values()}
            self._entries.clear()
        for kind, layout in cleared:
            self._push_gauges(kind, layout)

    def _collect(self, registry) -> None:
        """Registry collector: recompute every live (kind, layout) gauge
        at scrape time (pull model — survives ``obs.reset()``)."""
        snap = self.snapshot()
        for kind, layouts in snap["by_kind"].items():
            for layout, b in layouts.items():
                registry.gauge("rb_hbm_resident_bytes", kind=kind,
                               layout=layout).set(b)


#: the process-wide ledger every resident device payload registers with
LEDGER = HbmLedger()

_metrics.REGISTRY.register_collector(LEDGER._collect)


# ----------------------------------------------------------- measurement

class PeakWindow:
    """Measured transient footprint of the launches inside the window on
    a CUDA ``device``: ``peak()`` is ``{"peak_bytes"}``, the rise of the
    allocator's peak over the allocation at entry.  On another device the
    window measures nothing and ``peak()`` is None.  The caller must have
    waited for the launch (the allocator's peak moves when the tensors
    are allocated, which is on the host, but the caller's outputs must
    exist)."""

    __slots__ = ("device", "_base")

    def __init__(self, device):
        import torch

        dev = torch.device(device)
        self.device = dev if dev.type == "cuda" else None
        self._base = None

    def __enter__(self):
        if self.device is not None:
            import torch

            self._base = int(torch.cuda.memory_allocated(self.device))
            torch.cuda.reset_peak_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        return False

    def peak(self) -> dict | None:
        if self.device is None or self._base is None:
            return None
        import torch

        top = int(torch.cuda.max_memory_allocated(self.device))
        return {"peak_bytes": max(0, top - self._base)}


def backend_memory_stats(device=None) -> dict | None:
    """The allocator's counters of a CUDA device (``torch.cuda
    .memory_stats`` plus ``bytes_limit`` / ``bytes_free`` from
    ``mem_get_info``), or None on the CPU, which reports nothing."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    stats = dict(torch.cuda.memory_stats(dev))
    free, total = torch.cuda.mem_get_info(dev)
    stats["bytes_limit"] = int(total)
    stats["bytes_free"] = int(free)
    stats["bytes_in_use"] = int(total) - int(free)
    return stats


def backend_free_bytes(device=None) -> int | None:
    """The card's free memory (``torch.cuda.mem_get_info``) — the default
    ``ROARING_TPU_HBM_BUDGET`` — or None on the CPU."""
    import torch

    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    return int(torch.cuda.mem_get_info(dev)[0])


def record_dispatch(site: str, predicted: int,
                    measured: dict | None) -> dict:
    """Per-dispatch predicted-vs-actual accounting: set the
    ``rb_hbm_predicted_bytes`` / ``rb_hbm_measured_peak_bytes`` gauges
    and return the ``batch.memory`` event payload (predicted, measured,
    residual_x = measured/predicted) the caller attaches to its dispatch
    span and keeps as ``last_dispatch_memory``."""
    _metrics.gauge("rb_hbm_predicted_bytes", site=site).set(predicted)
    doc: dict = {"predicted_bytes": int(predicted)}
    if measured is not None:
        peak = int(measured["peak_bytes"])
        _metrics.gauge("rb_hbm_measured_peak_bytes", site=site).set(peak)
        doc["measured_peak_bytes"] = peak
        if predicted > 0:
            doc["residual_x"] = round(peak / predicted, 4)
    return doc
