"""The dense layout's run stream and B8, the dense image built once, on the
CPU.

- The run stream (``packing.pack_blocked_compact(..., runs=True)``): every
  run container's (start, length - 1) pairs as serialized, off the buffer
  or off ``RunContainer.runs``, to its row; ``validate_runs``' guards
  checked over the whole stream at once, each failure naming its container.
- The dense layout's build expands no run and densifies no run container on
  the host (``runs_to_values`` and ``values_to_words`` raise).
- B8's plain version (``dense.densify_streams`` on the CPU), its kernel
  walked on the host (``kernels.row_build_emulated`` under
  ``row_build_plan``) and the reference by definition
  (``ops/plain_rows.py``), equal on streams with runs of one bit, across a
  word edge, over many words and over a whole row.
- ``DeviceBitmapSet`` over a small census1881_srt_like draw of the
  benchmark's generator, in every layout, against the benchmark's NumPy
  reference (``cardbench/reference.py``): words and cardinalities.
- The mutation layer's value floor and ``from_numpy_state``'s states are as
  they were.

All bit-exact (tolerance 0).
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from cardbench import gen, reference
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import native
from roaringbitmap_tpu_torch.core import containers as C
from roaringbitmap_tpu_torch.format import spec
from roaringbitmap_tpu_torch.ops import dense, kernels, packing, plain_rows
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.utils.datasets import ROW_CASES, row_stream_case

torch.set_num_threads(2)

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _run_bitmaps(n: int = 14, seed: int = 3) -> list:
    """Run-optimized bitmaps over 8 keys: short and long runs (some past
    4,096 values, one a whole container), arrays and bitmap containers."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        parts = [np.unique(rng.integers(0, 8 << 16, 200))]
        for _ in range(int(rng.integers(1, 6))):
            a = int(rng.integers(0, 8 << 16))
            parts.append(np.arange(a, min(a + int(rng.integers(1, 9000)),
                                          8 << 16)))
        if i % 4 == 0:
            parts.append(np.arange(3 << 16, 4 << 16))      # a whole key
        if i % 5 == 1:
            parts.append((5 << 16) + rng.choice(1 << 16, 9000,
                                                replace=False))
        rb = TRB.from_values(np.unique(np.concatenate(parts)).astype(
            np.uint32))
        rb.run_optimize()
        out.append(rb)
    return out


def _host_fold(op: str, bitmaps: list):
    acc = bitmaps[0]
    for b in bitmaps[1:]:
        acc = (acc | b) if op == "or" else (acc ^ b)
    return acc


# ---------------------------------------------------------- the run stream

@pytest.mark.parametrize("form", ["bytes view", "heap"])
def test_run_stream_holds_each_run_container_as_serialized(form):
    bms = _run_bitmaps()
    srcs = ([memoryview(b.serialize()) for b in bms] if form == "bytes view"
            else bms)
    p = packing.pack_blocked_compact(srcs, runs=True)
    s = p.streams
    conts = [c for b in bms for c in b.containers]
    is_run = [isinstance(c, C.RunContainer) for c in conts]
    assert s.kinds == {"array": sum(isinstance(c, C.ArrayContainer)
                                    for c in conts),
                       "bitmap": sum(isinstance(c, C.BitmapContainer)
                                     for c in conts),
                       "run": sum(is_run)}
    assert s.run_counts.size == sum(is_run) > 0
    # rows in segment order: each row's run container, as serialized
    keys = np.concatenate([b.keys for b in bms])
    order = np.argsort(keys, kind="stable")
    want = [conts[i].runs for i in order if is_run[i]]
    assert np.array_equal(s.runs, np.concatenate(want))
    assert s.run_counts.tolist() == [r.size // 2 for r in want]
    assert np.all(np.diff(s.run_dest) > 0)
    assert s.dense_words.shape[0] == s.kinds["bitmap"]
    assert s.total_runs == s.runs.size // 2
    # the other streams are the runs=False pack's, less the run containers
    old = packing.pack_blocked_compact(srcs).streams
    assert old.runs is None and old.run_counts is None
    assert s.values.size < old.values.size
    assert s.transfer_bytes() < old.transfer_bytes()


def _blob(containers: list) -> bytes:
    """A serialized bitmap of run containers, one a key from 0: each a list
    of (start, length - 1) pairs; ``(pairs, card)`` declares ``card``."""
    out = bytearray()
    n = len(containers)
    out += (spec.SERIAL_COOKIE | ((n - 1) << 16)).to_bytes(4, "little")
    out += bytes([(1 << n) - 1])                     # all run containers
    for key, c in enumerate(containers):
        runs, card = c if isinstance(c, tuple) else (c, sum(
            ln + 1 for _, ln in c))
        out += key.to_bytes(2, "little") + (card - 1).to_bytes(2, "little")
    for c in containers:
        runs = c[0] if isinstance(c, tuple) else c
        out += len(runs).to_bytes(2, "little")
        for s, ln in runs:
            out += s.to_bytes(2, "little") + ln.to_bytes(2, "little")
    return bytes(out)


GOOD = [(10, 9), (100, 9)]


@pytest.mark.parametrize("bad,match", [
    ([(10, 99), (50, 99)], "container 1: overlapping/unsorted runs"),
    ([(500, 9), (100, 9)], "container 1: overlapping/unsorted runs"),
    ([(65000, 999)], "container 1: run extends past 65535"),
    (([(10, 9)], 11), "container 1: run cardinality mismatch"),
])
def test_each_run_guard_raises_naming_its_container(bad, match):
    blob = _blob([GOOD, bad, GOOD])
    with pytest.raises(spec.InvalidRoaringFormat, match=match):
        packing.pack_blocked_compact([memoryview(blob)], runs=True)
    # the expanding path raises the same
    with pytest.raises(spec.InvalidRoaringFormat, match=match):
        packing.pack_blocked_compact([memoryview(blob)])
    good = packing.pack_blocked_compact([memoryview(_blob([GOOD] * 3))],
                                        runs=True)
    assert good.streams.run_counts.tolist() == [2, 2, 2]


def test_a_truncated_run_payload_raises():
    blob = _blob([GOOD, GOOD])
    with pytest.raises(spec.InvalidRoaringFormat):
        packing.pack_blocked_compact([memoryview(blob[:-3])], runs=True)


def test_the_first_guard_of_a_container_names_it():
    # past 65535 and overlapping in one container: validate_runs' order
    blob = _blob([GOOD, [(100, 9), (105, 9), (65000, 999)]])
    with pytest.raises(spec.InvalidRoaringFormat, match="past 65535"):
        packing.pack_blocked_compact([memoryview(blob)], runs=True)


@pytest.fixture
def no_host_expansion(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a run was expanded or densified on the host")

    monkeypatch.setattr(C, "runs_to_values", boom)
    monkeypatch.setattr(C, "values_to_words", boom)


@pytest.mark.parametrize("form", ["bytes", "bytes view", "heap"])
def test_dense_build_expands_no_run_on_the_host(form, request):
    bms = _run_bitmaps(seed=5)
    want = {op: _host_fold(op, bms) for op in ("or", "xor")}
    srcs = {"bytes": lambda: [b.serialize() for b in bms],
            "bytes view": lambda: [memoryview(b.serialize()) for b in bms],
            "heap": lambda: bms}[form]()
    request.getfixturevalue("no_host_expansion")
    native.reset_calls()
    ds = tagg.DeviceBitmapSet(srcs, layout="dense", device=CPU)
    # the C++ ingest engine expands runs, so no dense pack may take it
    assert native.CALLS["native"] == 0
    assert ds._streams is None and ds._runs is None
    for op in ("or", "xor"):
        assert ds.aggregate(op) == want[op]


# ------------------------------------------------------ B8's plain routes

def _streams(c: dict):
    streams = tuple(as_i32(c[k].astype(np.int32) if k == "values" else c[k],
                           CPU)
                    for k in ("dense_words", "dense_dest", "values",
                              "val_counts", "val_dest"))
    runs = (as_i32(c["runs"].view(np.uint32), CPU),
            as_i32(c["run_counts"], CPU), as_i32(c["run_dest"], CPU))
    return streams, runs


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("case", ROW_CASES)
def test_plain_route_equals_the_reference_and_the_kernel_walk(case, seed):
    c = row_stream_case(case, seed)
    n = c["n_rows"]
    streams, runs = _streams(c)
    got = dense.densify_streams(*streams, n, int(c["values"].size),
                                runs=runs)
    want = plain_rows.build_rows(*streams, n, runs=runs)
    assert torch.equal(got, want)
    plan = kernels.row_build_plan(streams[3], streams[4], streams[1], n,
                                  runs[1], runs[2])
    assert torch.equal(kernels.row_build_emulated(streams[0], streams[2],
                                                  runs[0], plan, n), want)
    assert (plan.values, plan.runs, plan.dense_rows) == (
        int(c["val_counts"][:-1].sum()), int(c["run_counts"][:-1].sum()), 2)
    # a whole-row run sets every bit of its row
    if case == "whole row":
        assert bool((want[0] == -1).all())


def test_row_build_plan_needs_sorted_destinations():
    c = row_stream_case("word edge")
    streams, runs = _streams(c)
    n = c["n_rows"]
    with pytest.raises(ValueError, match="val_dest"):
        kernels.row_build_plan(streams[3], streams[4].flip(0), streams[1], n)
    with pytest.raises(ValueError, match="run_dest"):
        kernels.row_build_plan(streams[3], streams[4], streams[1], n,
                               runs[1], runs[2].flip(0))


def test_launch_bytes_closed_form():
    """8 KiB a row written and a dense-wire row read, 2 bytes a value and 4
    a run pair read: the benchmark's count (row_build_roofline.setup)."""
    assert kernels.b8_launch_bytes(10, 7, 5, 2) == 8192 * 12 + 14 + 20
    assert kernels.b8_launch_bytes(470_016, 14_517_767, 8_329_979, 0) == (
        8192 * 470_016 + 2 * 14_517_767 + 4 * 8_329_979)


# ------------------------------------------- sets against the reference

@pytest.fixture(scope="module")
def srt_draw():
    cfg = json.loads((ROOT / "cardbench" / "configs" /
                      "census1881_srt_like.json").read_text())
    cfg["segments"], cfg["attributes"] = 2, 12
    sources = gen.dataset_bytes(cfg, 2**31 + 19)
    return sources, reference.decode_set(sources, workers=1)


@pytest.mark.parametrize("layout", ["dense", "counts", "compact", "auto"])
def test_srt_draw_equals_the_reference(srt_draw, layout):
    sources, dec = srt_draw
    ds = tagg.DeviceBitmapSet(sources, layout=layout, device=CPU)
    if ds.layout == "dense":
        assert ds._mutation_base_values > 0
    for op in ("or", "xor"):
        keys, words, cards = reference.wide(op, dec)
        got_w, got_c = ds.aggregate_device(op)
        got_w, got_c = to_u32(got_w), got_c.numpy()
        nz = got_c > 0
        assert np.array_equal(ds.keys[nz], keys)
        assert np.array_equal(got_w[nz], words)
        assert np.array_equal(got_c[nz], cards)


def test_srt_draw_holds_runs_past_4096_values(srt_draw):
    p = packing.pack_blocked_compact(srt_draw[0], runs=True)
    cards = packing.run_cardinalities(p.streams.runs, p.streams.run_counts)
    assert p.streams.kinds["run"] > p.streams.kinds["array"]
    assert (cards > 4096).any() and (cards <= 4096).any()


# --------------------------------------------- what stays as it was

def test_mutation_floor_is_counted_as_before(srt_draw):
    """Each run container counts its values up to 4,096, or 4,096 above
    that, as the value stream and the dense-wire rows counted it."""
    sources = srt_draw[0]
    old = packing.pack_blocked_compact(sources, min_block=4).streams
    want = old.values.size + 4096 * old.dense_words.shape[0]
    for layout in ("dense", "counts", "compact"):
        ds = tagg.DeviceBitmapSet(sources, layout=layout, device=CPU)
        assert ds._mutation_base_values == want, layout
    heap = tagg.DeviceBitmapSet(_run_bitmaps(), layout="dense", device=CPU)
    st = packing.pack_blocked_compact(_run_bitmaps(), min_block=4).streams
    assert heap._mutation_base_values == (st.values.size
                                          + 4096 * st.dense_words.shape[0])


def _state(ds) -> dict:
    """The arrays of a port set, as ``from_numpy_state`` takes them (the
    JAX-shaped state, which has no run keys)."""
    st = {"keys": ds.keys, "n": ds.n, "block": ds.block,
          "blk_seg": ds.blk_seg.numpy(), "n_blocks": int(
              (ds.blk_seg < ds.keys.size).sum()),
          "seg_sizes": ds._seg_sizes, "seg_offsets": ds._seg_offsets,
          "row_src": ds.row_src, "carry_row": ds.carry_row}
    if ds.words is not None:
        st["words"] = to_u32(ds.words)
        return st
    st.update(zip(tagg._STATE_STREAMS, (t.numpy() for t in ds._streams)))
    st["dense_words"] = st["dense_words"].view(np.uint32)
    if ds.counts is not None:
        st["counts"] = ds.counts.numpy()
        st["grp_seg"] = ds._grp_seg_counts.numpy()
    else:
        st["chunk_vals"], st["chunk_row"] = (t.numpy() for t in ds._chunks)
    return st


@pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
def test_states_without_run_keys_load_as_before(layout):
    bms = _run_bitmaps(seed=8)
    built = tagg.DeviceBitmapSet(bms, layout=layout, device=CPU)
    ds = tagg.DeviceBitmapSet.from_numpy_state(_state(built), device=CPU)
    assert ds.layout == layout
    for op in ("or", "xor"):
        assert ds.aggregate(op) == _host_fold(op, bms)
    assert ds._mutation_base_values == built._mutation_base_values or (
        layout == "dense")   # a words state counts the image's bits


def test_a_run_stream_in_a_value_layout_raises():
    bms = _run_bitmaps(seed=9)
    state = tagg._pack_state(bms, None, "counts")
    dense_state = tagg._pack_state(bms, None, "dense")
    state.update({k: dense_state[k] for k in tagg._STATE_RUNS})
    with pytest.raises(ValueError, match="run stream"):
        tagg.DeviceBitmapSet.from_numpy_state(state, device=CPU)
