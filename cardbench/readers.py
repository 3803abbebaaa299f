"""What a traced run hands the per-layer metrics' readers.

Each reader under ``cardbench/metrics/`` takes one ``Readings`` and returns
a number, or None where the run holds nothing for it to read (no device
trace, no span of the name it reads); the harness then leaves the metric
out of the result line.  The program's spans (``obs/trace.py``) recorded in
the window are handed on too, so that a metric read from a span the
program adds later is a new reader file alone.
"""

from __future__ import annotations

import dataclasses

from . import work


@dataclasses.dataclass
class Readings:
    device: object             # devtrace.DeviceTrace, or None
    work_bytes: int            # the frozen count of the traced window's ops
    units: int                 # ops run in the window
    host_ms: list              # the harness's span around each call
    spans: list                # the program's span records in the window


def roofline(r: Readings):
    if r.device is None or not r.units:
        return None
    return work.roofline_pct(r.work_bytes, r.device.busy_s)


def idle_pct(r: Readings):
    if r.device is None or r.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.device.busy_s / r.device.window_s)


def host_ms(r: Readings):
    if not r.host_ms:
        return None
    return sum(r.host_ms) / len(r.host_ms)
