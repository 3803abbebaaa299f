"""The result line holds the keys a run must print, and a run without a
card prints none."""

import json
import subprocess
import sys
import time

import pytest
import torch

from cardbench import run, spec

import minibench


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", minibench.workloads())
def test_result_keys(tmp_path, workload, trace):
    root = minibench.make_root(tmp_path)
    cell = spec.resolve(workload, root)
    res, lines = run.run(cell, minibench.SEED, 0.3, bool(trace), torch,
                         torch.device("cpu"), root,
                         t_start=time.perf_counter())
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(res["metrics"]) <= want
    if not trace:
        assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        for k in ("device_ops", "idle_gaps"):
            assert len(res["breakdown"][k]) <= 10
    assert all("limit" in ln for ln in lines)
    json.dumps(res)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "cardbench.run", "--workload",
                        minibench.workloads()[0], "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       cwd=minibench.REPO, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA device" in p.stderr

