"""Share of the HBM bound in the device time of the dense image's build in
set-up (B8), from the program's registry.

The work is the benchmark's own count, the same whatever builds the image:
8,192 bytes for each image row written, plus the serialized payload the
rows come from (2 bytes a value, 4 a run, 8,192 a bitmap container), read
from the dense layout's ``rb_ingest_rows_total``,
``rb_ingest_values_total``, ``rb_ingest_run_pairs_total`` and
``rb_ingest_containers_total{kind="bitmap"}``.  The time is the sum of
``rb_kernel_seconds{kernel="b8"}``, which the program takes with CUDA
events around the launch, since the build runs outside the traced window.
None where the program records either not.
"""

from cardbench import work

ROW_BYTES = 8192
LAYOUT = "dense"


def _counter(snap: dict, name: str, **labels):
    rows = [row["value"] for row in snap["counters"].get(name, [])
            if all(row["labels"].get(k) == v for k, v in labels.items())]
    return sum(rows) if rows else None


def read(r, registry=None):
    if registry is None:
        from roaringbitmap_tpu_torch.obs.metrics import REGISTRY as registry
    snap = registry.snapshot()
    secs = [row["sum"] for row in snap["histograms"].get(
        "rb_kernel_seconds", []) if row["labels"].get("kernel") == "b8"]
    rows = _counter(snap, "rb_ingest_rows_total", layout=LAYOUT)
    if not secs or rows is None:
        return None
    values = _counter(snap, "rb_ingest_values_total", layout=LAYOUT) or 0
    runs = _counter(snap, "rb_ingest_run_pairs_total", layout=LAYOUT) or 0
    bitmaps = _counter(snap, "rb_ingest_containers_total", layout=LAYOUT,
                       kind="bitmap") or 0
    work_bytes = ROW_BYTES * (rows + bitmaps) + 2 * values + 4 * runs
    return work.roofline_pct(work_bytes, sum(secs))
