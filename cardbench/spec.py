"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root names each cell's configuration and traffic
mix; the configuration's entry gives its file, the mix is
``cardbench/traffic/<traffic>.json`` and a per-layer metric's reader is
``cardbench/metrics/<metric>.py``.  A new configuration, mix or metric is
new files and entries: nothing here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list      # the spec's metric entries this cell reports
    per_layer: list


def load_spec(root: Path = ROOT) -> dict:
    with open(Path(root) / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def resolve(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``, with its configuration, mix and the
    metrics it reports; ``KeyError`` for a name the spec lacks."""
    root = Path(root)
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    configs = {c["name"]: c for c in spec["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    with open(root / "cardbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(
        name=workload, config=config, traffic=traffic, chips=int(w["chips"]),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, workload)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, workload)])


def reader(metric: str, root: Path = ROOT):
    """The ``read(readings)`` function of a per-layer metric, loaded from
    ``cardbench/metrics/<metric>.py``."""
    path = Path(root) / "cardbench" / "metrics" / f"{metric}.py"
    mod_name = "cardbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
