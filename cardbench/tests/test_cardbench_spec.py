"""The harness finds a configuration, a traffic mix and a per-layer metric
added as new files and entries, with no edit to the harness."""

import json
import time

import torch

from cardbench import run, spec

import minibench


def _add_cell(root):
    """A new configuration file, a new mix file and a new metric file,
    with their entries in BENCHMARK.json."""
    cfg = json.loads((root / "cardbench/configs/census1881_like.json")
                     .read_text())
    cfg.update(segments=2, attributes=8, shape_seed=7)
    (root / "cardbench/configs/tiny_new.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "cardbench/traffic/wide_resident.json")
                     .read_text())
    mix.update(ops={"xor": 1}, in_flight=2)
    (root / "cardbench/traffic/xor_only.json").write_text(json.dumps(mix))
    (root / "cardbench/metrics/units_seen.new.py").write_text(
        "def read(r):\n    return float(r.units) if r.units else None\n")
    s = json.loads((root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "tiny_new", "source": "a test",
                         "file": "cardbench/configs/tiny_new.json",
                         "reduced": [], "why": "a test"})
    s["workloads"].append({"name": "tiny_new.xor_only", "config": "tiny_new",
                           "traffic": "xor_only", "chips": 1, "why": "test"})
    s["per_layer"].append({"name": "units_seen.new", "unit": "ops",
                           "better": "higher", "source": "program_counter",
                           "layer": "entry points",
                           "moves": "wide_ops_per_s",
                           "workloads": ["tiny_new.xor_only"]})
    s["end_to_end"][1]["workloads"].append("tiny_new.xor_only")
    (root / "BENCHMARK.json").write_text(json.dumps(s))


def test_new_files_are_found_without_an_edit(tmp_path):
    root = minibench.make_root(tmp_path)
    _add_cell(root)
    cell = spec.resolve("tiny_new.xor_only", root)
    assert cell.config["attributes"] == 8
    assert cell.traffic["ops"] == {"xor": 1}
    assert [m["name"] for m in cell.per_layer] == ["units_seen.new"]
    assert {m["name"] for m in cell.end_to_end} == {"setup_s",
                                                   "wide_ops_per_s"}
    assert spec.reader("units_seen.new", root)(
        type("R", (), {"units": 3})()) == 3.0
    res, _ = run.run(cell, minibench.SEED, 0.3, True, torch,
                     torch.device("cpu"), root, t_start=time.perf_counter())
    assert res["correct"]
    assert res["metrics"]["units_seen.new"]["value"] > 0


def test_each_cell_reports_what_its_metrics_say():
    s = spec.load_spec()
    for w in s["workloads"]:
        cell = spec.resolve(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
            assert (spec.ROOT / "cardbench" / "metrics"
                    / f"{m['name']}.py").exists()
