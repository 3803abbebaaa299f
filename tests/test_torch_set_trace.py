"""Spans and counters inside the port's wide path and set build, on the CPU.

- ``DeviceBitmapSet.aggregate_device`` is the ``set.aggregate`` span, one a
  call, with its tags, under a caller's span; it writes nothing with
  tracing off and never waits for the card with tracing on.
- Each kernel launch passes the bytes it must move (``ops/kernels.py``'s
  ``b*_launch_bytes``, the closed forms below), recorded as a
  ``kernel.launch`` event on the enclosing span while tracing is on.  The
  counts layout runs B7 where it reads no more than B4, and B4 otherwise:
  ``"counts-b4"`` is a counts set over bitmap containers, which keeps B4.
  A dense set runs B2 off the card, and on the card B7's run variant where
  it reads at most half of B2's bytes: ``"dense-b7"`` is a dense set built
  as on the card, which keeps its streams.  The CPU tests have no card, so
  the launches go to a library that does nothing: the wrappers take the
  card's path up to the C call, and their outputs are not read.
- A set build (``DeviceBitmapSet(...)``, ``from_numpy_state(...)``) times
  its phases once each: child spans of ``set.build`` and
  ``rb_ingest_phase_seconds{layout, phase}``, beside
  ``rb_ingest_build_seconds{layout}``.
- A span's JSONL ``t_start`` and ``dur_ms`` are on the clock of its
  ``torch.profiler`` range.
- A build counts what it ingested (``rb_ingest_containers_total{layout,
  kind}``, ``rb_ingest_values_total``, ``rb_ingest_run_pairs_total``,
  ``rb_ingest_rows_total``) and tags ``set.build.pack`` with its run
  containers and runs; the dense layout's B8 launch records its bytes on
  ``set.build.device``, and on the card its CUDA-event time as
  ``rb_kernel_seconds{kernel="b8"}``.
"""

import json

import numpy as np
import pytest
import torch

from roaringbitmap_tpu_torch import RoaringBitmap, obs
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops import megakernel as mk
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet

CPU = "cpu"
LAYOUTS = ("dense", "counts", "compact")
#: the sets the tests build (``_build``): one a layout, "counts-b4" and
#: "dense-b7"
SETS = LAYOUTS + ("counts-b4", "dense-b7")
#: (set, engine) -> the kernels one wide OR launches, in order
LAUNCHES = {("dense", "cuda"): ["B2"], ("counts", "cuda"): ["B7"],
            ("counts-b4", "cuda"): ["B4"], ("dense-b7", "cuda"): ["B7"],
            ("compact", "cuda"): ["B3", "B2"],
            ("compact", "cuda-nibble"): ["B6"]}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # enable(xprof=...) sets the profiler bridge for the process
    monkeypatch.setattr(obs.trace, "_xprof", obs.trace._xprof)
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _bitmaps(n: int = 12, seed: int = 7) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = np.unique(rng.integers(0, 1 << 19, 300 + 40 * i))
        if i % 3 == 0:    # a bitmap container in some bitmaps
            vals = np.union1d(vals, np.arange(1 << 16, (1 << 16) + 6000))
        out.append(RoaringBitmap.from_values(vals.astype(np.uint32)))
    return out


def _container_bitmaps(n: int = 64, seed: int = 5) -> list:
    """``n`` bitmaps of one bitmap container on each of keys 0-2."""
    rng = np.random.default_rng(seed)
    return [RoaringBitmap.from_values(np.concatenate(
        [(k << 16) + np.sort(rng.choice(1 << 16, 6000, replace=False))
         for k in range(3)]).astype(np.uint32)) for _ in range(n)]


def _build(name: str, n: int = 12) -> DeviceBitmapSet:
    """The set ``name`` of ``SETS``: a layout over ``_bitmaps(n)``, or
    "counts-b4", the counts layout over ``_container_bitmaps()``, whose
    dense-wire rows (8 KiB each, 64 a key) outweigh its count groups (32
    KiB each, 12 a key with the padding), so that it keeps B4, or
    "dense-b7", the dense layout over ``_bitmaps(n)`` built as on the card,
    where it keeps its streams for B7."""
    if name == "dense-b7":
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(kernels, "DENSE_STREAM_DEVICES", ("cuda", CPU))
            ds = DeviceBitmapSet(_bitmaps(n), layout="dense", device=CPU)
        assert ds.reduce_path == "streams"
        return ds
    if name != "counts-b4":
        return DeviceBitmapSet(_bitmaps(n), layout=name, device=CPU)
    ds = DeviceBitmapSet(_container_bitmaps(), layout="counts", device=CPU)
    assert ds.reduce_path == "counts"
    return ds


@pytest.fixture(scope="module")
def sets():
    return {name: _build(name) for name in SETS}


def _read(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture
def fake_card(monkeypatch):
    """Kernel launches on CPU tensors, into a library that does nothing."""

    class Lib:
        def __getattr__(self, name):
            return lambda *args: 0

    monkeypatch.setattr(kernels.build, "load", lambda source: Lib())
    monkeypatch.setattr(kernels, "_on_cuda", lambda *ts: True)
    monkeypatch.setattr(kernels, "_stream", lambda: 0)
    monkeypatch.setattr(kernels, "_sm_count", lambda dev: kernels.H100_SMS)
    for k in kernels.KERNELS:
        monkeypatch.setattr(k, "_fn", None)


# ------------------------------------------------------- set.aggregate

@pytest.mark.parametrize("op", ["or", "xor", "and"])
@pytest.mark.parametrize("name", SETS)
def test_aggregate_is_one_span_a_call_under_the_caller(tmp_path, sets, name,
                                                       op):
    ds = sets[name]
    layout = ds.layout
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    with obs.span("caller") as outer:
        ds.aggregate_device(op)
        ds.aggregate_device(op, engine="torch")
    obs.disable()
    spans = _read(path)
    aggs = [s for s in spans if s["name"] == "set.aggregate"]
    assert len(aggs) == 2
    extent = "groups" if layout == "counts" else "rows"
    for s in aggs:
        assert s["parent_id"] == outer.span_id
        path = ({"path": {"counts": "counts", "dense": "image"}[layout]}
                if layout != "compact" and op != "and" else {})
        assert s["tags"] == {"op": op, "layout": layout, "engine": "torch",
                             "keys": int(ds.keys.size),
                             extent: (int(ds.counts.shape[0])
                                      if layout == "counts" else ds._n_rows),
                             **path}
        assert s["dur_ms"] >= 0


def test_aggregate_span_carries_the_error(tmp_path, sets):
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    with pytest.raises(ValueError):
        sets["dense"].aggregate_device("andnot")
    obs.disable()
    (s,) = _read(path)
    assert s["name"] == "set.aggregate"
    assert s["tags"]["error_class"] == "ValueError"


@pytest.mark.parametrize("layout,engine", sorted(LAUNCHES))
def test_tracing_off_writes_nothing(monkeypatch, fake_card, sets, layout,
                                    engine):
    def boom(*a, **k):
        raise AssertionError("the tracer ran with tracing off")

    monkeypatch.setattr(obs.trace, "Span", boom)
    monkeypatch.setattr(obs.trace, "current", boom)
    sets[layout].aggregate_device("or", engine=engine)
    _build(layout, 4)


@pytest.mark.parametrize("xprof", [False, True])
@pytest.mark.parametrize("layout,engine", sorted(LAUNCHES))
def test_tracing_never_waits_for_the_card(tmp_path, monkeypatch, fake_card,
                                          sets, layout, engine, xprof):
    def boom(*a, **k):
        raise AssertionError("the span waited for the card")

    monkeypatch.setattr(torch.cuda, "synchronize", boom)
    monkeypatch.setattr(torch.cuda.Event, "synchronize", boom)
    monkeypatch.setattr(obs.trace.Span, "sync", boom)
    obs.enable(str(tmp_path / "t.jsonl"), xprof=xprof)
    for op in ("or", "xor"):
        sets[layout].aggregate_device(op, engine=engine)
    obs.disable()
    aggs = [s for s in _read(tmp_path / "t.jsonl")
            if s["name"] == "set.aggregate"]
    assert [s["tags"]["engine"] for s in aggs] == [engine] * 2


# ------------------------------------------------ bytes a launch moves

@pytest.mark.parametrize("fn,args,want", [
    (kernels.b1_launch_bytes, (100, 256, 3), 105_484),
    (kernels.b1_launch_bytes, (131_072, 2048, 256), 1_075_840_000),
    (kernels.b2_launch_bytes, (1000, 10), 8_273_960),
    (kernels.b2_launch_bytes, (262_144, 8443), 2_216_682_476),
    (kernels.b3_launch_bytes, (40, 24), 217_088),
    (kernels.b3_launch_bytes, (383_624, 116_480), 1_150_619_648),
    (kernels.b4_launch_bytes, (9, 2), 311_304),
    (kernels.b4_launch_bytes, (65_400, 65_400), 2_679_045_600),
    (kernels.b6_launch_bytes, (18, 4), 622_608),
    (kernels.b6_launch_bytes, (56_610, 256), 1_859_159_040),
])
def test_launch_bytes_closed_forms(fn, args, want):
    """Rows of 8 KiB (B1 at its width) and count groups of 32 KiB read
    once, B3's chunks of 128 values read and its rows written once, B6's
    partial rows read once, and 8,192 + 4 bytes a head and cardinality
    written once; B6's scratch group is not read."""
    assert fn(*args) == want


def _expected_bytes(ds, layout, engine) -> list:
    k = int(ds.keys.size)
    if layout == "dense":
        return [kernels.b2_launch_bytes(ds.words.shape[0], k)]
    if layout == "counts-b4":
        return [kernels.b4_launch_bytes(ds.counts.shape[0], k)]
    if layout in ("counts", "dense-b7"):
        plan = ds._stream_plan
        runs = plan.runs if layout == "dense-b7" else None
        return [kernels.b7_launch_bytes(plan.values, plan.dense_rows, k,
                                        runs)]
    if engine == "cuda-nibble":
        return [kernels.b6_launch_bytes(ds._grp_seg.shape[0], k)]
    return [kernels.b3_launch_bytes(ds._chunks[0].shape[0], ds._n_rows),
            kernels.b2_launch_bytes(ds._n_rows, k)]


@pytest.mark.parametrize("layout,engine", sorted(LAUNCHES))
def test_each_launch_records_its_bytes_on_the_span(tmp_path, fake_card, sets,
                                                   layout, engine):
    ds = sets[layout]
    kernels.reset_launches()
    obs.enable(str(tmp_path / "t.jsonl"))
    ds.aggregate_device("xor", engine=engine)
    obs.disable()
    (agg,) = [s for s in _read(tmp_path / "t.jsonl")
              if s["name"] == "set.aggregate"]
    events = [e for e in agg["events"] if e["name"] == "kernel.launch"]
    assert [e["kernel"] for e in events] == LAUNCHES[(layout, engine)]
    assert [e["bytes"] for e in events] == _expected_bytes(ds, layout,
                                                           engine)
    for e in events:
        kern = next(k for k in kernels.KERNELS if k.label == e["kernel"])
        assert kern.launches >= 1
        assert e["variant"] == (2048 if e["kernel"] in ("B1", "B2")
                                else None)
    kernels.reset_launches()


def test_b1_and_b5_launches_record_their_bytes(tmp_path, fake_card):
    rng = np.random.default_rng(3)
    width, m, k = 512, 40, 5
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (m, width),
                                          dtype=np.int64).astype(np.int32))
    seg = torch.from_numpy(np.sort(rng.integers(0, k, m)).astype(np.int32))
    mega, banks = mk.random_plan(5, n_steps=64)
    banks = [as_i32(b, CPU) for b in banks]
    obs.enable(str(tmp_path / "t.jsonl"))
    with obs.span("caller"):
        kernels.segmented_reduce("or", words, seg, k)
        mk.raw_call(mega, *banks)
    obs.disable()
    (rec,) = _read(tmp_path / "t.jsonl")
    b1, b5 = rec["events"]
    assert (b1["kernel"], b1["variant"], b1["bytes"]) == (
        "B1", width, kernels.b1_launch_bytes(m, width, k))
    assert (b5["kernel"], b5["variant"], b5["bytes"]) == (
        "B5", mega.mode, mk.stream_bytes(mega))


# --------------------------------------------------------- set.build

def _phase_rows() -> dict:
    snap = obs.snapshot()["histograms"]
    return {(r["labels"]["layout"], r["labels"]["phase"]): r
            for r in snap.get("rb_ingest_phase_seconds", [])}


def _check_build(path, layout: str, phases: list, ds) -> None:
    builds = obs.snapshot()["histograms"]["rb_ingest_build_seconds"]
    (build,) = [r for r in builds if r["labels"]["layout"] == layout]
    assert build["count"] == 1
    rows = _phase_rows()
    assert sorted(rows) == sorted((layout, p) for p in phases)
    assert all(r["count"] == 1 for r in rows.values())
    assert sum(r["sum"] for r in rows.values()) <= build["sum"]
    spans = _read(path)
    (root,) = [s for s in spans if s["name"] == "set.build"]
    assert root["tags"] == {"layout": layout, "n": ds.n,
                            "keys": int(ds.keys.size), "rows": ds._n_rows}
    kids = [s for s in spans if s["name"].startswith("set.build.")]
    assert sorted(s["name"] for s in kids) == sorted(
        "set.build." + p for p in phases)
    assert all(s["parent_id"] == root["span_id"] for s in kids)
    assert sum(s["dur_ms"] for s in kids) <= root["dur_ms"]


@pytest.mark.parametrize("layout", ("auto",) + LAYOUTS)
def test_build_times_its_phases(tmp_path, layout):
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    ds = DeviceBitmapSet(_bitmaps(), layout=layout, device=CPU)
    obs.disable()
    phases = ["pack", "upload", "device"]
    if layout == "auto":
        phases.insert(0, "choose_layout")
    _check_build(path, ds.layout, phases, ds)


def _state(ds) -> dict:
    """The arrays of a port set, as ``from_numpy_state`` takes them."""
    st = {"keys": ds.keys, "n": ds.n, "block": ds.block,
          "blk_seg": ds.blk_seg.numpy(), "n_blocks": int(
              (ds.blk_seg < ds.keys.size).sum()),
          "seg_sizes": ds._seg_sizes, "seg_offsets": ds._seg_offsets,
          "row_src": ds.row_src, "carry_row": ds.carry_row}
    if ds.words is not None:
        st["words"] = to_u32(ds.words)
        return st
    names = ("dense_words", "dense_dest", "values", "val_counts", "val_dest")
    st.update(zip(names, (t.numpy() for t in ds._streams)))
    st["dense_words"] = st["dense_words"].view(np.uint32)
    if ds.counts is not None:
        st["counts"] = ds.counts.numpy()
        st["grp_seg"] = ds._grp_seg_counts.numpy()
    else:
        st["chunk_vals"], st["chunk_row"] = (t.numpy() for t in ds._chunks)
    return st


@pytest.mark.parametrize("layout", LAYOUTS)
def test_from_numpy_state_times_its_phases(tmp_path, sets, layout):
    st = _state(sets[layout])
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    ds = DeviceBitmapSet.from_numpy_state(st, device=CPU)
    obs.disable()
    _check_build(path, layout, ["upload", "device"], ds)
    for op in ("or", "xor"):
        got, want = ds.aggregate_device(op), sets[layout].aggregate_device(op)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_build_phases_are_counted_with_tracing_off():
    DeviceBitmapSet(_bitmaps(), layout="counts", device=CPU)
    assert sorted(_phase_rows()) == [("counts", "device"), ("counts", "pack"),
                                     ("counts", "upload")]


# ------------------------------------------------------------ clock

def test_span_is_on_its_profiler_range_clock(tmp_path, sets):
    """The JSONL record and the ``record_function`` range of one
    ``set.aggregate`` span start and last alike, to within 1 ms: the
    profiler stamps host events in Unix nanoseconds, as ``time.time``."""
    from torch.profiler import ProfilerActivity, profile

    path = tmp_path / "t.jsonl"
    obs.enable(str(path), xprof=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sets["dense"].aggregate_device("or")
    obs.disable()
    (rec,) = _read(path)
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "set.aggregate"]
    assert abs(rec["t_start"] * 1e9 - ev.start_ns()) < 1e6
    assert abs(rec["dur_ms"] * 1e6 - (ev.end_ns() - ev.start_ns())) < 1e6



# ------------------------------------------------------- what a build ingests

def _run_sources(n: int = 10, seed: int = 4) -> list:
    """Serialized views of run-optimized bitmaps: runs, arrays, bitmaps."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        vals = np.unique(rng.integers(0, 1 << 19, 300))
        a = int(rng.integers(0, 1 << 19))
        vals = np.union1d(vals, np.arange(a, a + 5000 + 700 * i))
        if i % 3 == 0:
            vals = np.union1d(vals, (9 << 16) + rng.choice(1 << 16, 6000,
                                                           replace=False))
        rb = RoaringBitmap.from_values(vals.astype(np.uint32))
        rb.run_optimize()
        out.append(memoryview(rb.serialize()))
    return out


def _counters(name: str) -> dict:
    rows = obs.snapshot()["counters"].get(name, [])
    return {tuple(sorted(r["labels"].items())): r["value"] for r in rows}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_build_counts_what_it_ingested(tmp_path, layout):
    from roaringbitmap_tpu_torch.ops import packing

    sources = _run_sources()
    want = packing.pack_blocked_compact(
        sources, min_block=4 if layout == "dense" else 8,
        runs=layout == "dense").streams
    obs.enable(str(tmp_path / "t.jsonl"))
    ds = DeviceBitmapSet(sources, layout=layout, device=CPU)
    obs.disable()
    assert want.kinds["run"] and want.kinds["bitmap"] and want.kinds["array"]
    assert _counters("rb_ingest_containers_total") == {
        (("kind", k), ("layout", layout)): float(n)
        for k, n in want.kinds.items()}
    lay = (("layout", layout),)
    assert _counters("rb_ingest_values_total") == {lay: want.values.size}
    assert _counters("rb_ingest_run_pairs_total") == {lay: want.total_runs}
    assert _counters("rb_ingest_rows_total") == {lay: ds._n_rows}
    assert (want.total_runs > 0) == (layout == "dense")
    (pack,) = [s for s in _read(tmp_path / "t.jsonl")
               if s["name"] == "set.build.pack"]
    assert pack["tags"] == {"run_containers": want.kinds["run"],
                            "runs": want.total_runs}


def test_b8_launch_records_its_bytes_on_the_build(tmp_path, fake_card):
    obs.enable(str(tmp_path / "t.jsonl"))
    ds = DeviceBitmapSet(_run_sources(), layout="dense", device=CPU)
    obs.disable()
    assert kernels.B8.launches == 1
    (dev,) = [s for s in _read(tmp_path / "t.jsonl")
              if s["name"] == "set.build.device"]
    (ev,) = [e for e in dev["events"] if e["name"] == "kernel.launch"]
    from roaringbitmap_tpu_torch.ops import packing

    s = packing.pack_blocked_compact(_run_sources(), min_block=4,
                                     runs=True).streams
    assert (ev["kernel"], ev["variant"]) == ("B8", None)
    assert ev["bytes"] == kernels.b8_launch_bytes(
        ds._n_rows, s.values.size, s.total_runs, s.dense_words.shape[0])
    # a CPU set times nothing with CUDA events
    assert "rb_kernel_seconds" not in obs.snapshot()["histograms"]
    kernels.reset_launches()


def test_b8_time_is_observed_from_its_events(monkeypatch, fake_card):
    """One observation of ``rb_kernel_seconds{kernel="b8"}`` for the launch
    inside the timer, from its events' elapsed milliseconds."""

    class Event:
        clock = iter((1.0, 3.5))

        def __init__(self, enable_timing=False):
            assert enable_timing

        def record(self):
            self.at = next(Event.clock)

        def elapsed_time(self, end):
            return end.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    from roaringbitmap_tpu_torch.utils.datasets import row_stream_case

    c = row_stream_case("many words")
    t = {k: as_i32(v.astype(np.int32) if k == "values" else
                   (v.view(np.uint32) if k == "runs" else v), CPU)
         for k, v in c.items() if k != "n_rows"}
    timer = kernels.LaunchTimer("b8")
    kernels.row_build(t["dense_words"], t["dense_dest"], t["values"],
                      t["val_counts"], t["val_dest"], c["n_rows"],
                      int(c["values"].size),
                      runs=(t["runs"], t["run_counts"], t["run_dest"]),
                      timer=timer)
    timer.observe()
    (row,) = obs.snapshot()["histograms"]["rb_kernel_seconds"]
    assert row["labels"] == {"kernel": "b8"}
    assert (row["count"], row["sum"]) == (1, pytest.approx(2.5e-3))
    kernels.reset_launches()
