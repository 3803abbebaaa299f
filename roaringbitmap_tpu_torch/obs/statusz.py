"""statusz: one health report over every subsystem (the port's own copy of
``roaringbitmap_tpu.obs.statusz``; the ``rb_statusz`` document and its
markdown page are the JAX package's).

``obs.snapshot()`` is per-process registry truth; the serving loop, the
durability layer and the lattice each keep their own health dicts.  This
module folds them into ONE document — per-host sections plus a monotone
counter merge — so "is the process healthy" is one call, one JSON doc,
one rendered-markdown page.

Document shapes (``"kind": "rb_statusz"``, validated by
``tools/check_trace.py``):

- ``local_doc(host=..., sections=...)`` — one host's view: the obs
  registry snapshot, flight-recorder state (recent triggers), journal
  health for every live ``DurableTenant`` (unflushed bytes, snapshot
  age), the active lattice's seal/escape state, plus caller-provided
  ``sections`` (the serving loop's ``snapshot()`` rides here: degrade
  level, queue backlog, resident-ring occupancy/wedges, result-cache
  stats).  The subsystems are read from the PORT's own modules
  (``roaringbitmap_tpu_torch.mutation.durability``,
  ``roaringbitmap_tpu_torch.runtime.lattice``), never the JAX package's,
  so a process that loaded both reports the port's state here.
- ``merge(docs, **sections)`` — per-host docs keyed under ``"hosts"``,
  counters merged **monotonically** (element-wise max per (name,
  labels)), so a stale copy can lag but never regress the view, and
  re-merging an already-merged doc is idempotent.

``statusz()`` (re-exported as ``obs.statusz``) is the entry point: it
builds the local doc, asks every registered provider (the pod front door
registers one per instance, weakly: ``register_provider``) for more
per-host docs, and merges.  On a 2-host simulated pod that yields both
hosts' journal, lattice, ring and degrade state in one report.

``render_markdown(doc)`` turns either doc shape into the human page.
"""

from __future__ import annotations

import os
import sys
import time
import types
import weakref

from . import flight as _flight

SCHEMA_KIND = "rb_statusz"
SCHEMA_VERSION = 1

#: name -> weak callable returning a list of extra statusz docs
_PROVIDERS: dict = {}


def register_provider(name: str, method) -> None:
    """Register a bound method returning ``list[dict]`` of statusz docs to
    fold into ``statusz()``.  Held weakly: when its owner dies the provider
    drops out, with no unregister needed."""
    _PROVIDERS[name] = weakref.WeakMethod(method)


def unregister_provider(name: str) -> None:
    _PROVIDERS.pop(name, None)


def local_doc(host: str | None = None, sections: dict | None = None) -> dict:
    """This process's (or one simulated host's) statusz document."""
    from . import snapshot as _obs_snapshot

    doc = {
        "kind": SCHEMA_KIND, "version": SCHEMA_VERSION, "merged": False,
        "host": str(host) if host is not None else str(os.getpid()),
        "pid": os.getpid(), "t": round(time.time(), 6),
        "obs": _obs_snapshot(),
        "flight": _flight.snapshot(),
    }
    # subsystem healths ride only when their module is already loaded —
    # statusz must not drag mutation/runtime packages in for obs-only
    # users (the obs.snapshot() lazy-import discipline)
    dur = sys.modules.get(
        "roaringbitmap_tpu_torch.mutation.durability")
    if dur is not None:
        tenants = dur.health()
        if tenants:
            doc["journal"] = tenants
    lat_mod = sys.modules.get("roaringbitmap_tpu_torch.runtime.lattice")
    if lat_mod is not None:
        lat = lat_mod.active()
        if lat is not None:
            doc["lattice"] = {
                "sealed": bool(getattr(lat, "sealed", False)),
                "escapes": int(getattr(lat, "escapes", 0)),
                "points": lat.n_points(pooled=True),
            }
    if sections:
        doc["sections"] = dict(sections)
    return doc


def merge_counters(counter_sections) -> dict:
    """Monotone element-wise-max merge of registry counter sections
    (each ``{name: [{"labels": ..., "value": ...}]}``).  Max — not sum —
    because the same host's counters can arrive at different ages and
    more than once: max is commutative, associative, and idempotent, so
    the merged value only moves forward.  Same-labeled counters from
    different hosts read as their maximum."""
    acc: dict = {}
    for sec in counter_sections:
        for name, entries in (sec or {}).items():
            for e in entries:
                labels = e.get("labels") or {}
                key = (name, tuple(sorted(labels.items())))
                v = e.get("value", 0)
                prev = acc.get(key)
                if prev is None or v > prev:
                    acc[key] = v
    out: dict = {}
    for (name, labels), v in sorted(acc.items()):
        out.setdefault(name, []).append(
            {"labels": dict(labels), "value": v})
    return out


def merge(docs, **pod_sections) -> dict:
    """Fold statusz docs (local or already-merged) into one doc.
    Idempotent: merging a merged doc with its own inputs changes
    nothing.  ``pod_sections`` land at the top level (the pod front
    door's placement map and stats)."""
    hosts: dict = {}
    counter_secs = []
    t = 0.0
    for doc in docs:
        if not isinstance(doc, dict):
            continue
        if doc.get("merged"):
            for h, sub in (doc.get("hosts") or {}).items():
                hosts.setdefault(str(h), sub)
                counter_secs.append(
                    (sub.get("obs") or {}).get("counters"))
            counter_secs.append(doc.get("counters"))
            t = max(t, doc.get("t") or 0.0)
        else:
            h = str(doc.get("host"))
            prev = hosts.get(h)
            # same host seen twice: newest wins
            if prev is None or (doc.get("t") or 0.0) >= (prev.get("t")
                                                         or 0.0):
                hosts[h] = doc
            counter_secs.append((doc.get("obs") or {}).get("counters"))
            t = max(t, doc.get("t") or 0.0)
    merged = {
        "kind": SCHEMA_KIND, "version": SCHEMA_VERSION, "merged": True,
        "t": round(t or time.time(), 6),
        "hosts": hosts,
        "counters": merge_counters(counter_secs),
    }
    for k, v in pod_sections.items():
        if v is not None:
            merged[k] = v
    return merged


def statusz() -> dict:
    """The report: the local doc and every provider's docs, merged."""
    docs = [local_doc()]
    for name in list(_PROVIDERS):
        fn = _PROVIDERS[name]()
        if fn is None:
            _PROVIDERS.pop(name, None)
            continue
        try:
            docs.extend(fn() or [])
        except Exception:  # health must not raise out of a dying subsystem
            continue
    return merge(docs)


# ------------------------------------------------------------- rendering

def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.3f}"
    return str(v)


def _host_lines(h: str, doc: dict) -> list:
    lines = [f"## host {h}", ""]
    serving = (doc.get("sections") or {}).get("serving")
    if serving:
        lines.append(
            f"- serving: level={serving.get('level')} "
            f"(peak={serving.get('level_peak')}) "
            f"backlog={serving.get('backlog')} "
            f"pending_bytes={serving.get('pending_bytes')}")
        res = serving.get("resident")
        if res:
            ring = res.get("ring") or {}
            lines.append(
                f"- resident ring: active={res.get('active')} "
                f"occupancy={ring.get('occupancy', ring.get('depth'))} "
                f"wedges={ring.get('wedges', ring.get('wedged'))}")
        rc = serving.get("result_cache")
        if rc:
            lines.append(f"- result cache: {_fmt_kv(rc)}")
        lat = serving.get("lattice")
        if lat:
            lines.append(f"- lattice: {_fmt_kv(lat)}")
    lat = doc.get("lattice")
    if lat and not (serving and serving.get("lattice")):
        lines.append(f"- lattice: {_fmt_kv(lat)}")
    for tenant in doc.get("journal") or ():
        lines.append(f"- journal[{tenant.get('tenant')}]: "
                     f"seq={tenant.get('seq')} "
                     f"unflushed_bytes={tenant.get('unflushed_bytes')} "
                     f"snapshot_age_s={_fmt(tenant.get('snapshot_age_s'))}")
    fl = doc.get("flight")
    if fl:
        recent = fl.get("recent_triggers") or []
        reasons = ", ".join(r.get("reason", "?") for r in recent[-4:])
        lines.append(f"- flight: ring {fl.get('occupancy')}/"
                     f"{fl.get('capacity')}"
                     + (f", recent triggers: {reasons}" if reasons
                        else ""))
    tr = (doc.get("obs") or {}).get("trace")
    if tr:
        lines.append(f"- trace: enabled={tr.get('enabled')} "
                     f"path={tr.get('path')}")
    lines.append("")
    return lines


def _fmt_kv(d: dict) -> str:
    return " ".join(f"{k}={_fmt(v)}" for k, v in d.items()
                    if not isinstance(v, (dict, list)))


def render_markdown(doc: dict) -> str:
    """Either statusz doc shape as a markdown page."""
    lines = ["# roaring-tpu statusz", ""]
    if doc.get("merged"):
        lines.append(f"merged over {len(doc.get('hosts') or {})} host(s) "
                     f"at t={_fmt(doc.get('t'))}")
        lines.append("")
        placement = doc.get("placement")
        if placement:
            lines.append(f"- placement: {len(placement)} tenant(s)")
        stats = doc.get("stats")
        if stats:
            lines.append(f"- front door: {_fmt_kv(stats)}")
        if placement or stats:
            lines.append("")
        for h in sorted(doc.get("hosts") or {}):
            lines.extend(_host_lines(h, doc["hosts"][h]))
        counters = doc.get("counters") or {}
        if counters:
            lines.append("## counters (monotone merge)")
            lines.append("")
            for name in sorted(counters):
                for e in counters[name]:
                    label = ",".join(f"{k}={v}" for k, v in
                                     sorted((e.get("labels")
                                             or {}).items()))
                    suffix = f"{{{label}}}" if label else ""
                    lines.append(f"- `{name}{suffix}` = "
                                 f"{_fmt(e.get('value'))}")
            lines.append("")
    else:
        lines.extend(_host_lines(doc.get("host", "?"), doc))
    return "\n".join(lines)


class _CallableModule(types.ModuleType):
    """``obs.statusz`` is both the module (``obs.statusz.merge``,
    ``render_markdown``, ...) and the entry point: calling it runs
    :func:`statusz`, so ``obs.statusz()`` needs no extra import."""

    def __call__(self):
        return statusz()


sys.modules[__name__].__class__ = _CallableModule
