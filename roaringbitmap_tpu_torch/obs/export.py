"""Prometheus text-format renderer for the unified metrics registry (the
port's own copy of ``roaringbitmap_tpu.obs.export``).

``render_prometheus()`` emits the exposition format (text/plain version
0.0.4) from a ``metrics.Registry``: ``# TYPE`` headers, one sample line
per (name, labels), histogram ``_bucket``/``_sum``/``_count`` expansion
with cumulative ``le`` labels.  No HTTP server is bundled — a serving
process exposes this however it already exposes health; the renderer
is pure string assembly so it is also usable as a debug dump.
"""

from __future__ import annotations

from . import metrics


def _escape(v) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _labels(labels: dict, extra: dict | None = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    body = ",".join(f'{k}="{_escape(v)}"'
                    for k, v in sorted(merged.items()))
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return repr(int(f)) if f == int(f) else repr(f)


def render_prometheus(registry: "metrics.Registry | None" = None) -> str:
    registry = registry if registry is not None else metrics.REGISTRY
    lines: list[str] = []
    typed: set = set()
    for name, labels, inst in registry.instruments():
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {inst.kind}")
        if inst.kind == "histogram":
            # Histogram.cumulative() is the shared le-semantics source;
            # repr keeps le values identical to snapshot() bucket keys
            rows, total = inst.cumulative()
            for bound, cum in rows:
                lines.append(f"{name}_bucket"
                             f"{_labels(labels, {'le': repr(bound)})} {cum}")
            lines.append(f"{name}_bucket{_labels(labels, {'le': '+Inf'})} "
                         f"{total}")
            lines.append(f"{name}_sum{_labels(labels)} {_fmt(inst.sum)}")
            lines.append(f"{name}_count{_labels(labels)} {inst.count}")
        else:
            lines.append(f"{name}{_labels(labels)} {_fmt(inst.value)}")
    return "\n".join(lines) + ("\n" if lines else "")
