"""What a ``torch.profiler`` trace of the measured window says: the seconds
in which a kernel, copy or memset ran on the card, the device operations
that took most time, and the longest idle gaps by what the host was doing.

The window is the host range named ``WINDOW`` (a ``record_function`` the
harness opens around its measured loop); device work is clipped to it.
An idle gap is charged to the innermost host range (a span of the harness
or of the program, or a PyTorch op) that covers its midpoint.
"""

from __future__ import annotations

import dataclasses

WINDOW = "cardbench.window"
_DEVICE_KINDS = ("kernel", "memcpy", "memset")
TOP = 10


@dataclasses.dataclass
class DeviceTrace:
    window_s: float
    busy_s: float
    device_ops: list      # [[name, seconds]], most time first
    idle_gaps: list       # [[host range, seconds]], most time first


def _union(intervals: list) -> list:
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _kind(ev) -> str | None:
    """The event's activity kind, where this PyTorch reports it."""
    kind = getattr(ev, "activity_type", None)
    return str(kind()).lower() if callable(kind) else None


def _is_device(ev, host_names: set) -> bool:
    """A kernel, copy or memset on the card.  The card's timeline also
    holds projections of host annotations; where the kind is not
    reported, they are told apart by their names, which a host range
    carries too."""
    if ev.device_type().name != "CUDA":
        return False
    kind = _kind(ev)
    if kind is not None:
        return any(k in kind for k in _DEVICE_KINDS)
    return ev.name() not in host_names


def reduce(events) -> DeviceTrace | None:
    """Reduce kineto events (``prof.profiler.kineto_results.events()``);
    None when the window range is missing."""
    win = [e for e in events if e.name() == WINDOW
           and e.device_type().name == "CPU"]
    if not win:
        return None
    w0 = min(e.start_ns() for e in win)
    w1 = max(e.end_ns() for e in win)
    dev, host = [], []
    by_name: dict = {}
    host_names = {e.name() for e in events if e.device_type().name == "CPU"}
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t <= w0 or s >= w1:
            continue
        if _is_device(e, host_names):
            s, t = max(s, w0), min(t, w1)
            dev.append((s, t))
            by_name[e.name()] = by_name.get(e.name(), 0) + (t - s)
        elif e.device_type().name == "CPU" and e.name() != WINDOW:
            host.append((s, t, e.name()))
    busy = _union(dev)
    busy_ns = sum(t - s for s, t in busy)
    gaps, prev = [], w0
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if w1 > prev:
        gaps.append((prev, w1))
    gap_names: dict = {}
    host.sort()
    stack: list = []     # open host ranges, outermost first
    hi = 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while hi < len(host) and host[hi][0] <= mid:
            while stack and stack[-1][1] < host[hi][0]:
                stack.pop()
            stack.append(host[hi])
            hi += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "no host range"
        gap_names[name] = gap_names.get(name, 0) + (g1 - g0)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    gtop = sorted(gap_names.items(), key=lambda kv: -kv[1])[:TOP]
    return DeviceTrace(
        window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        device_ops=[[n[:96], v / 1e9] for n, v in top],
        idle_gaps=[[n[:96], v / 1e9] for n, v in gtop])
