"""The check fails what it should: the control (the reference in the
program's place, one guarantee broken), and a run with the timed path
broken underneath, once for each fault these cells can have.  The
harness's look for a chip is skipped: the runs drive the program's plain
path on the CPU at a small size."""

import time

import pytest
import torch

from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet

from cardbench import check, control, run, spec

import minibench


def _run(root, workload):
    cell = spec.resolve(workload, root)
    res, _ = run.run(cell, minibench.SEED, 0.3, False, torch,
                     torch.device("cpu"), root, t_start=time.perf_counter())
    return res


@pytest.mark.parametrize("workload", minibench.workloads())
def test_control_is_not_correct(tmp_path, workload):
    root = minibench.make_root(tmp_path)
    cell = spec.resolve(workload, root)
    for seed in (3, 4, 5):
        nums = control.readings(cell, seed)
        assert not check.verdict(nums), nums
        assert nums["card_mismatch"] >= 1


def _unwritten(orig):
    """A wide op that returns its output buffers as they were allocated,
    the reduce never having written them."""
    def agg(self, op, engine="auto"):
        words, cards = orig(self, op, engine)
        return words.new_zeros(words.shape), cards.new_zeros(cards.shape)
    return agg


def _altered(orig):
    """A wide op whose first key's cardinality and first head word are
    altered where they are produced."""
    def agg(self, op, engine="auto"):
        words, cards = orig(self, op, engine)
        words, cards = words.clone(), cards.clone()
        words[0, 0] ^= 1
        cards[0] += 1
        return words, cards
    return agg


@pytest.mark.parametrize("fault", [_unwritten, _altered])
@pytest.mark.parametrize("workload", minibench.workloads())
def test_wide_faults_are_caught(tmp_path, monkeypatch, workload, fault):
    root = minibench.make_root(tmp_path)
    assert _run(root, workload)["correct"]
    monkeypatch.setattr(DeviceBitmapSet, "aggregate_device",
                        fault(DeviceBitmapSet.aggregate_device))
    res = _run(root, workload)
    assert res["correct"] is False
    assert res["checks"]["word_mismatch"]["value"] > 0 or \
        res["checks"]["card_mismatch"]["value"] > 0
