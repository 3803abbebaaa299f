"""The readers of the program's own spans, events and registry: their
values on a synthetic traced window, and None where what they read is
missing (as on a program that does not record it)."""

import pytest

from roaringbitmap_tpu_torch.obs.metrics import Registry

from cardbench import devtrace, readers, spec, work

import minibench

BUSY_S = 0.002


def _span(dur_ms: float, launches: list) -> dict:
    return {"name": "set.aggregate", "dur_ms": dur_ms, "tags": {},
            "events": [{"name": "kernel.launch", "t_offset_ms": 0.01,
                        "kernel": "B2", "variant": 2048, "bytes": b}
                       for b in launches]
                      + [{"name": "other", "t_offset_ms": 0.02, "bytes": 7}]}


def _readings(spans=None, device=True) -> readers.Readings:
    dt = (devtrace.DeviceTrace(window_s=0.003, busy_s=BUSY_S, device_ops=[],
                               idle_gaps=[]) if device else None)
    return readers.Readings(device=dt, work_bytes=1000, units=2,
                            host_ms=[0.5, 0.7],
                            spans=spans if spans is not None else [
                                _span(0.25, [3_000_000_000]),
                                _span(0.35, [2_000_000_000, 500]),
                                {"name": "caller", "dur_ms": 9.0,
                                 "tags": {}, "events": []}])


def _registry(phases: dict) -> Registry:
    reg = Registry()
    for phase, secs in phases.items():
        reg.histogram("rb_ingest_phase_seconds", layout="dense",
                      phase=phase).observe(secs)
    return reg


def _read(name):
    return spec.reader(name, minibench.REPO)


def test_aggregate_ms_is_the_mean_span():
    assert _read("aggregate_ms.wide")(_readings()) == pytest.approx(0.3)
    assert _read("aggregate_ms.wide")(_readings(spans=[])) is None


def test_kernel_hbm_counts_the_launch_events():
    got = _read("kernel_hbm.wide")(_readings())
    assert got == pytest.approx(work.roofline_pct(5_000_000_500, BUSY_S))
    assert _read("kernel_hbm.wide")(_readings(spans=[])) is None
    assert _read("kernel_hbm.wide")(_readings(device=False)) is None
    no_events = [dict(_span(0.3, []), events=[])]
    assert _read("kernel_hbm.wide")(_readings(spans=no_events)) is None


def test_build_and_pack_seconds_read_the_phase_histogram():
    reg = _registry({"choose_layout": 0.25, "pack": 1.5, "upload": 0.5,
                     "device": 0.125})
    assert _read("build_s.setup")(_readings(), reg) == pytest.approx(2.375)
    assert _read("pack_s.setup")(_readings(), reg) == pytest.approx(1.5)
    one = _registry({"upload": 0.5})
    assert _read("build_s.setup")(_readings(), one) == pytest.approx(0.5)
    assert _read("pack_s.setup")(_readings(), one) is None
    assert _read("build_s.setup")(_readings(), Registry()) is None
    assert _read("pack_s.setup")(_readings(), Registry()) is None
