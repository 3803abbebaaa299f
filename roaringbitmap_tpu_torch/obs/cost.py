"""Cost & device-time observability: plan cost + roofline gauges (the port's
own copy of ``roaringbitmap_tpu.obs.cost``; metric names, the event fields
and ``estimate_seconds`` are the JAX package's).

The JAX package reads a compiled program's ``cost_analysis()``.  The port
has no compiler analysis: a dispatch's static cost is its plan's own
count, ``insights.predict_*_word_ops`` reported as ``flops`` (one u32
lane operation each) and ``insights.predict_*_dispatch_bytes`` as
``bytes_accessed`` (:func:`plan_cost`), so the same work gets the same
count whichever engine runs it.  Each dispatch combines that cost with
its measured device time (CUDA events bracketing the launch on the
engine's stream, read only while tracing is on) into achieved rates and
a roofline position:

- ``rb_achieved_flops_per_s{site,engine}`` — word ops / device seconds;
- ``rb_achieved_bytes_per_s{site,engine}`` — bytes / device seconds;
- ``rb_roofline_fraction{site,engine}`` — the roofline bound
  ``max(flops / peak_flops, bytes / peak_bw)`` over the measured time,
  clamped to (0, 1]; a raw value past 1 (the peak table underestimates
  the machine, or the plan's byte count overstates what the launch
  moved) is kept as ``roofline_fraction_raw``;
- ``rb_device_time_seconds_total{site,engine}`` — cumulative attributed
  launch time.

Peaks come from :data:`PEAKS`, resolved from ``torch.cuda
.get_device_name()``: the H100 row holds HBM3's 3.35e12 B/s and the INT32
rate of the kernels' word operations (64 lanes per SM x 132 SMs x 1.98
GHz), as ``chip_smoke.py`` bounds the kernels; the CPU proxy row is the
JAX package's, so the CPU tests exercise the whole pipeline.  The table
is a planning input — override via :func:`set_peaks`.

``TRACKER`` accumulates per-(site, engine) totals and the last dispatch's
gauges; ``obs.snapshot()["cost"]`` is its JSON view and ``obs.reset()``
clears it.  The serving loop's execute-time estimate
(``MultiSetBatchEngine.predict_dispatch_seconds``) reads it through
:func:`estimate_seconds`.
"""

from __future__ import annotations

import threading

from . import metrics as _metrics
from . import trace as _trace

#: peak table: ordered (device-name substring, lowercased) ->
#: (peak word ops per s, peak bytes per s).  First match wins
PEAKS = (
    ("h100", (132 * 64 * 1.98e9, 3.35e12)),
    ("cpu", (5.0e10, 2.0e10)),        # CPU proxy (the JAX package's row)
)

#: the fallback when nothing matches (no card, or another card): the CPU
#: proxy — conservative ceilings overestimate the fraction, which clamps
CPU_PROXY = ("cpu-proxy", 5.0e10, 2.0e10)

_peaks_override: tuple | None = None
_peaks_cache: tuple | None = None


def set_peaks(peak_flops_per_s: float | None,
              peak_bytes_per_s: float | None = None,
              label: str = "override") -> None:
    """Override the resolved peak table (both rates, ``None`` to clear) —
    the seam for operators with measured machine ceilings."""
    global _peaks_override, _peaks_cache
    _peaks_cache = None
    if peak_flops_per_s is None:
        _peaks_override = None
    else:
        _peaks_override = (label, float(peak_flops_per_s),
                           float(peak_bytes_per_s))


def device_peaks() -> dict:
    """Resolved ``{"kind", "peak_flops_per_s", "peak_bytes_per_s"}`` for
    the default device (cached; the CPU proxy without a card or for a
    card the table does not name)."""
    global _peaks_cache
    if _peaks_override is not None:
        label, pf, pb = _peaks_override
        return {"kind": label, "peak_flops_per_s": pf,
                "peak_bytes_per_s": pb}
    if _peaks_cache is None:
        label, pf, pb = CPU_PROXY
        import torch

        if torch.cuda.is_available():
            kind = torch.cuda.get_device_name(0)
            for frag, (f, b) in PEAKS:
                if frag in kind.lower():
                    label, pf, pb = kind, f, b
                    break
        _peaks_cache = (label, pf, pb)
    label, pf, pb = _peaks_cache
    return {"kind": label, "peak_flops_per_s": pf, "peak_bytes_per_s": pb}


def observe_compile(site: str, cache: str, seconds: float) -> None:
    """One ``rb_compile_seconds{site,cache}`` observation — the shared
    accounting of every program cache: ``cache="miss"`` records a real
    build wall (a CUDA-graph capture, the first eager run of a program
    key, a first-use ``nvcc`` build), ``cache="hit"`` the lookup."""
    _metrics.histogram("rb_compile_seconds", site=site,
                       cache=cache).observe(max(0.0, seconds))


def plan_cost(word_ops: int, nbytes: int) -> dict:
    """A dispatch's static cost from its plan: the word-op count as
    ``flops`` and the footprint model's bytes as ``bytes_accessed`` (the
    shape of the JAX package's ``compiled_cost``)."""
    return {"flops": float(word_ops), "bytes_accessed": float(nbytes),
            "transcendentals": 0.0}


def launch_timer(device):
    """A timing ``torch.cuda.Event`` recorded now on ``device``'s current
    stream, while tracing is on and ``device`` is a card; else None.  The
    engines record one before a launch and read :func:`launch_seconds`
    after the launch's own end event completed: no synchronization is
    added, and none is taken with tracing off."""
    if not _trace.enabled():
        return None
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def end_event(device, timed: bool):
    """The event a launch records after its work on ``device``'s current
    stream (None on the CPU): timing-enabled when its start was timed."""
    import torch

    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=timed)
    ev.record(torch.cuda.current_stream(dev))
    return ev


def launch_seconds(start, end, wall_s: float) -> float:
    """Device seconds between a :func:`launch_timer` event and a completed
    timing ``end`` event; ``wall_s`` (the launch's host wall, the JAX
    package's measure) when the launch was not timed."""
    if start is None or end is None:
        return wall_s
    return start.elapsed_time(end) / 1e3


class CostTracker:
    """Per-(site, engine) device-time and cost accumulation — the
    ``obs.snapshot()["cost"]`` source.  Cleared by ``obs.reset()``."""

    def __init__(self):
        self._rows: dict = {}      # (site, engine) -> accum dict
        self._lock = threading.Lock()

    def record(self, site: str, engine: str, doc: dict) -> None:
        key = (site, engine)
        with self._lock:
            row = self._rows.get(key)
            if row is None:
                row = self._rows[key] = {
                    "dispatches": 0, "device_seconds_total": 0.0,
                    "flops_total": 0.0, "bytes_total": 0.0, "last": None}
            row["dispatches"] += 1
            row["device_seconds_total"] += doc.get("device_ms", 0.0) / 1e3
            row["flops_total"] += doc.get("flops", 0.0)
            row["bytes_total"] += doc.get("bytes_accessed", 0.0)
            row["last"] = dict(doc)

    def observed_rates(self, site: str, engine: str) -> dict | None:
        """Cumulative achieved rates for (site, engine), or None before
        any recorded dispatch — the calibration input of
        :func:`estimate_seconds`."""
        with self._lock:
            row = self._rows.get((site, engine))
            if not row or row["device_seconds_total"] <= 0.0 \
                    or row["bytes_total"] <= 0.0:
                return None
            t = row["device_seconds_total"]
            return {"achieved_flops_per_s": row["flops_total"] / t,
                    "achieved_bytes_per_s": row["bytes_total"] / t,
                    "dispatches": row["dispatches"]}

    def snapshot(self) -> dict:
        """{"peaks": ..., "sites": {site: {engine: {...}}}} — plain JSON,
        deterministic ordering."""
        with self._lock:
            items = sorted(self._rows.items())
        sites: dict = {}
        for (site, engine), row in items:
            t = row["device_seconds_total"]
            out = {
                "dispatches": row["dispatches"],
                "device_seconds_total": round(t, 6),
                "flops_total": row["flops_total"],
                "bytes_total": row["bytes_total"],
            }
            if t > 0:
                out["achieved_flops_per_s"] = round(
                    row["flops_total"] / t, 3)
                out["achieved_bytes_per_s"] = round(
                    row["bytes_total"] / t, 3)
            if row["last"] is not None:
                out["last"] = row["last"]
                if "roofline_fraction" in row["last"]:
                    out["roofline_fraction"] = \
                        row["last"]["roofline_fraction"]
            sites.setdefault(site, {})[engine] = out
        return {"peaks": device_peaks(), "sites": sites}

    def reset(self) -> None:
        with self._lock:
            self._rows.clear()


#: the process-wide tracker every dispatch site reports into
TRACKER = CostTracker()


def record_dispatch(site: str, engine: str, cost: dict | None,
                    device_s: float, devices: int = 1,
                    est: dict | None = None, track: bool = True,
                    **extra) -> dict:
    """Per-dispatch cost accounting: combine the plan's static cost
    (:func:`plan_cost`) with the measured launch time into achieved rates
    + the roofline fraction, push the gauges, feed the tracker, and
    return the ``batch.cost`` / ``multiset.cost`` span-event payload.
    ``devices`` scales the roofline ceilings for a launch over several
    cards (the peak table is per card).

    ``est`` is a model estimate ``{"flops", "bytes_accessed"}`` that
    takes the place of a missing ``cost`` or one that reports no bytes;
    the event is then flagged ``estimated=True``.  ``track=False`` leaves
    the tracker (and so :func:`estimate_seconds`) untouched: the port's
    untimed launch wall can include one-time work (a capture, a first
    eager run, a kernel library load) that must not calibrate it."""
    doc: dict = {"device_ms": round(max(0.0, device_s) * 1e3, 4), **extra}
    if devices > 1:
        doc["devices"] = int(devices)
    if est is not None and (cost is None
                            or cost.get("bytes_accessed", 0.0) <= 0.0):
        cost = {"flops": float(est.get("flops") or 0.0),
                "bytes_accessed": float(est.get("bytes_accessed") or 0.0),
                "transcendentals": 0.0}
        doc["estimated"] = True
    _metrics.counter("rb_device_time_seconds_total", site=site,
                     engine=engine).inc(max(0.0, device_s))
    if cost is not None:
        doc["flops"] = cost["flops"]
        doc["bytes_accessed"] = cost["bytes_accessed"]
        if cost.get("transcendentals"):
            doc["transcendentals"] = cost["transcendentals"]
        if device_s > 0.0:
            peaks = device_peaks()
            d = max(1, int(devices))
            af = cost["flops"] / device_s
            ab = cost["bytes_accessed"] / device_s
            # roofline time bound: the launch cannot legally finish before
            # its flops at peak compute AND its bytes at peak bandwidth
            bound_s = max(
                cost["flops"] / (peaks["peak_flops_per_s"] * d),
                cost["bytes_accessed"] / (peaks["peak_bytes_per_s"] * d))
            raw = bound_s / device_s if bound_s > 0.0 else 0.0
            doc["achieved_flops_per_s"] = round(af, 3)
            doc["achieved_bytes_per_s"] = round(ab, 3)
            doc["roofline_fraction"] = round(min(1.0, raw), 6)
            doc["roofline_fraction_raw"] = round(raw, 6)
            _metrics.gauge("rb_achieved_flops_per_s", site=site,
                           engine=engine).set(af)
            _metrics.gauge("rb_achieved_bytes_per_s", site=site,
                           engine=engine).set(ab)
            _metrics.gauge("rb_roofline_fraction", site=site,
                           engine=engine).set(doc["roofline_fraction"])
    if track:
        TRACKER.record(site, engine, doc)
    return doc


def estimate_seconds(flops: float, bytes_accessed: float,
                     site: str | None = None,
                     engine: str | None = None) -> float:
    """Roofline device-time estimate for a (flops, bytes) workload:
    ``max(flops / rate_f, bytes / rate_b)`` — at the peak-table ceilings
    by default, or at the (site, engine)'s *observed* cumulative achieved
    rates when the tracker has seen dispatches there (the calibrated
    estimate ``BatchEngine.explain()`` reports)."""
    peaks = device_peaks()
    rate_f = peaks["peak_flops_per_s"]
    rate_b = peaks["peak_bytes_per_s"]
    if site is not None and engine is not None:
        obs = TRACKER.observed_rates(site, engine)
        if obs is not None:
            if obs["achieved_flops_per_s"] > 0:
                rate_f = obs["achieved_flops_per_s"]
            rate_b = obs["achieved_bytes_per_s"]
    return max(flops / rate_f if rate_f > 0 else 0.0,
               bytes_accessed / rate_b if rate_b > 0 else 0.0)
