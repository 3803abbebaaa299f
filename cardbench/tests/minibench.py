"""A benchmark root at a size a test run can hold: the repository's
BENCHMARK.json, traffic mixes and metrics, with every configuration cut to
3 segments of 20 attributes."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 11


def make_root(tmp: Path) -> Path:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    (tmp / "cardbench" / "configs").mkdir(parents=True)
    for sub in ("traffic", "metrics"):
        shutil.copytree(REPO / "cardbench" / sub, tmp / "cardbench" / sub)
    for c in spec["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        cfg["segments"], cfg["attributes"] = 3, 20
        (tmp / c["file"]).write_text(json.dumps(cfg))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


def workloads() -> list[str]:
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    return [w["name"] for w in spec["workloads"]]


#: a small configuration with run containers: a share of the containers
#: drawn as runs, some too many runs to pay (written as arrays or bitmaps),
#: bitmaps of 1 to 8 containers
RUN_CONFIG = {
    "segments": 3, "attributes": 24, "segment_span_keys": 16,
    "universe_keys": 8, "layout": "dense", "key_placement": "window",
    "containers_per_bitmap": {"dist": "loguniform", "lo": 1, "hi": 8},
    "array_card": {"dist": "loguniform", "lo": 1, "hi": 4096},
    "bitmap_share": 0.05, "bitmap_density": [0.5], "shape_seed": 77,
    "run_share": 0.6,
    "run_card": {"dist": "loguniform", "lo": 1, "hi": 65536},
    "run_count": {"dist": "loguniform", "lo": 1, "hi": 3000},
}
