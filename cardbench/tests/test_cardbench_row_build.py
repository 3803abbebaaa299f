"""``row_build_roofline.setup``: the share of the HBM bound in the dense
image's build in set-up, from the program's registry; None where the
program records none of it, as the parent of the program that adds B8."""

import pytest

from roaringbitmap_tpu_torch.obs.metrics import Registry

from cardbench import spec, work

import minibench

ROWS, VALUES, RUNS, BITMAPS = 470_016, 14_517_767, 8_329_979, 12
SECONDS = 1.46e-3


def _registry(counters: bool = True, seconds=(SECONDS,),
              layout: str = "dense") -> Registry:
    reg = Registry()
    if counters:
        reg.counter("rb_ingest_rows_total", layout=layout).inc(ROWS)
        reg.counter("rb_ingest_values_total", layout=layout).inc(VALUES)
        reg.counter("rb_ingest_run_pairs_total", layout=layout).inc(RUNS)
        for kind, n in (("array", 5), ("bitmap", BITMAPS), ("run", 7)):
            reg.counter("rb_ingest_containers_total", layout=layout,
                        kind=kind).inc(n)
    for s in seconds:
        reg.histogram("rb_kernel_seconds", kernel="b8").observe(s)
    return reg


def _read(registry):
    return spec.reader("row_build_roofline.setup", minibench.REPO)(
        None, registry=registry)


def test_the_share_of_a_synthetic_build():
    want = (8192 * (ROWS + BITMAPS) + 2 * VALUES + 4 * RUNS)
    assert _read(_registry()) == pytest.approx(
        work.roofline_pct(want, SECONDS))
    # two builds' times add up
    assert _read(_registry(seconds=(SECONDS, SECONDS))) == pytest.approx(
        work.roofline_pct(want, 2 * SECONDS))


@pytest.mark.parametrize("reg", [
    Registry(), _registry(counters=False), _registry(seconds=()),
    _registry(layout="counts")], ids=["empty", "no counters", "no time",
                                      "no dense build"])
def test_none_without_the_records(reg):
    assert _read(reg) is None
