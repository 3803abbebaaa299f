"""The dense layout's wide OR/XOR off its kept streams (B7's run variant), on
the CPU.  A dense set keeps its streams on the card alone
(``kernels.DENSE_STREAM_DEVICES``); these tests build theirs as on the card,
where the kernel engines' CPU wrappers run B7's plain version.

- B7's run-aware plain version (``stream_segmented_reduce_plain`` with a
  run triple), its CPU wrapper and its kernel walked on the host
  (``stream_segmented_reduce_emulated`` with the pair stream, blocks in any
  order) against B2's plain version over the set's image, the JAX package's
  dense set and the host ``FastAggregation``: over a census1881_srt-shaped
  set (runs, few arrays), a census1881-shaped set (arrays and bitmap
  containers), runs of different rows that overlap and cancel under XOR,
  heavy keys cut into pieces that hold runs, keys with no entries, the
  64-bit tier and a ``from_numpy_state`` state whose streams come unsorted.
- The rule that picks the path at load (``reduce_path``,
  ``kernels.dense_streams_win``): ``"streams"`` where B7 reads at most half
  the bytes B2 reads of the image, else ``"image"`` (bitmap containers
  alone, 4,096-value arrays), ``"image"`` for a state of the image alone,
  and ``"image"`` off the card, where a set keeps no stream.
- Coherence under mutation: an in-place patch drops the streams and
  switches the set to ``"image"``; a repack builds them again.
- ``rb_wide_reduce_total{layout="dense", path}`` once a call, the
  ``set.aggregate`` span's ``path`` tag, and resident bytes that count the
  kept streams and B7's plan.

All bit-exact (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.core.bitmap64 import Roaring64Bitmap as J64
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap as T64
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.obs import memory as obs_memory
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops.words import to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import fast_aggregation

torch.set_num_threads(2)

CPU = "cpu"
OPS = ("or", "xor")
B = 1 << 16


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # sets built as on the card, which keep their streams for B7
    monkeypatch.setattr(kernels, "DENSE_STREAM_DEVICES", ("cuda", CPU))
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ------------------------------------------------------------ set shapes

def _runs_in(rng, lo: int, hi: int, n_runs: int) -> np.ndarray:
    """Values of ``n_runs`` runs of log-uniform length inside [lo, hi)."""
    out = []
    for _ in range(n_runs):
        length = int(np.exp(rng.uniform(0, np.log(3000))))
        a = int(rng.integers(lo, hi))
        out.append(np.arange(a, min(a + length, hi)))
    return np.concatenate(out)


def _values(shape: str, seed: int = 11) -> list:
    """u32 value arrays of one set shape.

    - "srt": census1881_srt-shaped: each bitmap on a contiguous window of
      keys, 95% of its containers runs (1-60 runs of up to ~3,000 values),
      the rest small arrays, some runs past a key's end;
    - "census": census1881-shaped: small arrays on most keys, a bitmap
      container on some;
    - "overlap": runs of different rows on one key that coincide (XOR
      cancels them), nest and overlap, one run covering a whole key;
    - "bitmaps": bitmap containers alone;
    - "arrays": 4,096-value array containers (16 KiB of values a row)."""
    rng = np.random.default_rng(seed)
    out = []
    if shape == "srt":
        for i in range(28):
            k0 = int(rng.integers(0, 6))
            parts = []
            for k in range(k0, k0 + int(rng.integers(1, 4))):
                if rng.random() < 0.95:
                    parts.append(_runs_in(rng, k << 16, (k + 1) << 16,
                                          int(rng.integers(1, 60))))
                else:
                    parts.append((k << 16) + rng.choice(
                        B, int(rng.integers(1, 300)), replace=False))
            out.append(np.concatenate(parts))
    elif shape == "census":
        for i in range(24):
            parts = [(k << 16) + rng.choice(B, int(rng.integers(1, 400)),
                                            replace=False)
                     for k in rng.choice(8, 5, replace=False)]
            if i % 4 == 0:
                parts.append((3 << 16) + rng.choice(B, 7000, replace=False))
            out.append(np.concatenate(parts))
    elif shape == "overlap":
        same = np.arange(1000, 5000)
        for i in range(12):
            parts = [same if i < 4 else np.arange(100 * i, 100 * i + 9000),
                     (1 << 16) + np.arange(30 * i, 30 * i + 200 + 500 * i),
                     np.arange(2 << 16, 3 << 16) if i % 5 == 0 else
                     (2 << 16) + np.arange(64 * i, 64 * i + 33)]
            out.append(np.concatenate(parts))
    elif shape == "bitmaps":
        for i in range(12):
            out.append(np.concatenate(
                [(k << 16) + rng.choice(B, 6000 + 100 * i, replace=False)
                 for k in range(3)]))
    elif shape == "arrays":
        for i in range(12):
            out.append(np.concatenate(
                [(k << 16) + rng.choice(B, 4096, replace=False)
                 for k in range(3)]))
    else:
        raise ValueError(shape)
    return [np.unique(v).astype(np.uint32) for v in out]


def _bitmaps(vals: list) -> list:
    out = []
    for v in vals:
        rb = TRB.from_values(v)
        rb.run_optimize()
        out.append(rb)
    return out


_SETS: dict = {}


def _sets(shape: str):
    """(bitmaps, the port's dense set on the CPU, the JAX dense set)."""
    if shape not in _SETS:
        vals = _values(shape)
        ts = tagg.DeviceBitmapSet(_bitmaps(vals), layout="dense", device=CPU)
        js = jagg.DeviceBitmapSet([JRB.from_values(v) for v in vals],
                                  layout="dense")
        _SETS[shape] = (_bitmaps(vals), ts, js)
    return _SETS[shape]


def _host(op: str, bitmaps: list):
    fold = (fast_aggregation.naive_or if op == "or"
            else fast_aggregation.naive_xor)
    return fold(*bitmaps)


def _same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _b2_plain(op: str, ds):
    return kernels.segmented_reduce_blocked_plain(op, ds.words, ds.blk_seg,
                                                  ds.keys.size, ds.block)


def _pairs(ds):
    return None if ds._runs is None else ds._runs[0]


SHAPES = ("srt", "census", "overlap")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_stream_path_matches_b2_jax_and_host(op, shape):
    bms, ts, js = _sets(shape)
    assert ts.reduce_path == "streams"
    if shape != "census":
        assert ts._stream_plan.runs > 0
    k = ts.keys.size
    want = _b2_plain(op, ts)
    _same(ts.aggregate_device(op, engine="cuda"), want)      # B7's wrapper
    _same(kernels.stream_segmented_reduce_plain(
        op, *ts._streams, ts.seg_ids, k, runs=ts._runs), want)
    _same(kernels.stream_segmented_reduce_emulated(
        op, ts._streams[2], ts._streams[0], ts._stream_plan, k,
        runs=_pairs(ts))[:2], want)
    jw, jc = js.aggregate_device(op, engine="xla")
    assert np.array_equal(to_u32(want[0]), np.asarray(jw))
    assert np.array_equal(want[1].numpy(), np.asarray(jc))
    host = _host(op, bms)
    assert ts.aggregate(op, engine="cuda") == host
    assert ts.aggregate(op, engine="cuda-nibble") == host
    assert ts.aggregate(op, engine="torch") == host


def test_overlapping_runs_cancel_under_xor():
    bms, ts, _ = _sets("overlap")
    words, cards = ts.aggregate_device("xor", engine="cuda")
    assert int(cards.sum()) == _host("xor", bms).cardinality
    assert int(cards.sum()) < int(ts.aggregate_device("or", engine="cuda")
                                  [1].sum())
    # the first four bitmaps' one run over [1000, 5000) on key 0: an even
    # count of rows, so it cancels whole, edge words included
    four = tagg.DeviceBitmapSet(bms[:4], layout="dense", device=CPU)
    assert four.reduce_path == "streams"
    heads = to_u32(four.aggregate_device("xor", engine="cuda")[0])
    assert not heads[0].any()
    assert four.aggregate("xor", engine="cuda") == _host("xor", bms[:4])


@pytest.mark.parametrize("piece_bytes", [16, 256, 1024])
@pytest.mark.parametrize("op", OPS)
def test_heavy_keys_cut_into_pieces_that_hold_runs(op, piece_bytes):
    """Every key past ``piece_bytes`` cut into value, run and dense pieces,
    folded by the last piece to finish, the blocks in shuffled orders; each
    counter ends at its key's piece count."""
    _, ts, _ = _sets("srt")
    k = ts.keys.size
    dw, dd, v, vc, vd = ts._streams
    plan = kernels.stream_reduce_plan(
        vc.numpy(), vd.numpy(), dd.numpy(), ts.row_seg, k, piece_bytes,
        run_counts=ts._runs[1].numpy(), run_dest=ts._runs[2].numpy())
    p = plan.pieces.numpy()
    assert p.shape[1] == kernels.B7_RUN_PIECE_COLS and plan.n_split >= 1
    assert np.any(p[:, 9] > p[:, 8])          # pieces that hold runs
    for key in np.unique(p[:, 0]):
        q = p[p[:, 0] == key]
        assert (q[:, 9] - q[:, 8]).sum() == int(plan.roff[key + 1]
                                                - plan.roff[key])
        assert (q[:, 2] - q[:, 1]).sum() == int(plan.voff[key + 1]
                                                - plan.voff[key])
    want = _b2_plain(op, ts)
    rng = np.random.default_rng(piece_bytes)
    for order in (None, rng.permutation(p.shape[0] + k).tolist()):
        h, c, counters = kernels.stream_segmented_reduce_emulated(
            op, v, dw, plan, k, order=order, runs=ts._runs[0])
        _same((h, c), want)
        assert np.array_equal(counters.numpy(), np.bincount(
            p[:, 7], minlength=plan.n_split))
    _same(kernels.stream_segmented_reduce(op, *ts._streams, ts.seg_ids, plan,
                                          k, runs=ts._runs), want)


@pytest.mark.parametrize("op", OPS)
def test_keys_with_no_entries(op):
    """The set's keys spread to the even ids of twice as many: each odd
    key has no entry in any stream, and writes a zero head and
    cardinality."""
    _, ts, _ = _sets("srt")
    k = ts.keys.size
    seg = np.where(ts.row_seg < k, 2 * ts.row_seg, 2 * k).astype(np.int32)
    seg_ids = torch.from_numpy(seg)
    blk_seg = seg_ids[::ts.block].contiguous()
    dw, dd, v, vc, vd = ts._streams
    plan = kernels.stream_reduce_plan(
        vc.numpy(), vd.numpy(), dd.numpy(), seg, 2 * k,
        run_counts=ts._runs[1].numpy(), run_dest=ts._runs[2].numpy())
    assert np.all(np.diff(plan.voff.numpy())[1::2] == 0)
    assert np.all(np.diff(plan.roff.numpy())[1::2] == 0)
    want = kernels.segmented_reduce_blocked_plain(op, ts.words, blk_seg,
                                                  2 * k, ts.block)
    assert not want[0][1::2].any() and not want[1][1::2].any()
    _same(kernels.stream_segmented_reduce_emulated(
        op, v, dw, plan, 2 * k, runs=ts._runs[0])[:2], want)
    _same(kernels.stream_segmented_reduce_plain(
        op, *ts._streams, seg_ids, 2 * k, runs=ts._runs), want)


def _values64(seed: int = 5) -> list:
    """Runs, arrays and bitmap containers under four high words."""
    lows = _values("srt", seed)[:16]
    high = [0, 1, 2**31 - 7, 2**32 - 1]
    return [(np.uint64(high[i % 4]) << np.uint64(32)) | v.astype(np.uint64)
            for i, v in enumerate(lows)]


@pytest.mark.parametrize("op", OPS)
def test_64_bit_tier(op):
    vals = _values64()
    tb = []
    for v in vals:
        b = T64.from_values(v)
        b.run_optimize()
        tb.append(b)
    ds = tagg.DeviceBitmapSet(tb, layout="dense", device=CPU)
    assert ds.keys.dtype == np.uint64
    assert ds.reduce_path == "streams" and ds._stream_plan.runs > 0
    _same(ds.aggregate_device(op, engine="cuda"), _b2_plain(op, ds))
    got = ds.aggregate(op, engine="cuda")
    want = getattr(jagg, op + "64")(*[J64.from_values(v) for v in vals],
                                    engine="xla", fallback=False)
    assert np.array_equal(got.to_array(), want.to_array())
    assert got == tagg._sequential_reduce(op, tb)


@pytest.mark.parametrize("op", OPS)
def test_from_numpy_state_with_unsorted_streams(op):
    """The packed streams of a dense set (no image) with the dense-wire
    rows, the sparse containers and the run containers in descending row
    order: the set sorts all three on load and answers as the set built
    from the bitmaps."""
    bms, ts, _ = _sets("census")
    st = tagg._pack_state(bms + _sets("srt")[0], None, "dense")
    assert st["dense_words"].shape[0] > 1 and st["runs"].size > 0
    st["dense_words"], st["dense_dest"] = (st["dense_words"][::-1],
                                           st["dense_dest"][::-1])
    vc, starts = st["val_counts"], np.concatenate(
        ([0], np.cumsum(st["val_counts"])[:-1]))
    st["values"] = np.concatenate([st["values"][a:a + c] for a, c in
                                   zip(starts[::-1], vc[::-1])])
    st["val_counts"], st["val_dest"] = vc[::-1], st["val_dest"][::-1]
    pairs = st["runs"].view(np.uint32)
    rc, rstart = st["run_counts"], np.concatenate(
        ([0], np.cumsum(st["run_counts"])[:-1]))
    st["runs"] = np.concatenate([pairs[a:a + c] for a, c in
                                 zip(rstart[::-1], rc[::-1])]).view(np.uint16)
    st["run_counts"], st["run_dest"] = rc[::-1], st["run_dest"][::-1]
    assert np.any(np.diff(st["dense_dest"]) < 0)
    us = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    assert us.layout == "dense" and us.reduce_path == "streams"
    for i in (1, 4):
        assert np.all(np.diff(us._streams[i].numpy()) >= 0)
    assert np.all(np.diff(us._runs[2].numpy()) >= 0)
    built = tagg.DeviceBitmapSet(bms + _sets("srt")[0], layout="dense",
                                 device=CPU)
    assert torch.equal(us.words, built.words)
    _same(us.aggregate_device(op, engine="cuda"),
          built.aggregate_device(op, engine="torch"))


# ------------------------------------------------------------------ rule

def test_rule_picks_streams_for_the_dense_cells_shapes():
    for shape in SHAPES:
        _, ts, _ = _sets(shape)
        plan = ts._stream_plan
        rows = int((ts.row_seg < ts.keys.size).sum())
        assert 2 * (4 * (plan.values + plan.runs)
                    + 8192 * plan.dense_rows) <= 8192 * rows
        assert ts.reduce_path == "streams"
    auto = tagg.DeviceBitmapSet(_bitmaps(_values("srt", 3)), device=CPU)
    assert auto.layout == "dense" and auto.reduce_path == "streams"


@pytest.mark.parametrize("image_rows,wins", [
    (8, True), (7, False), (0, False)])
def test_rule_in_bytes(image_rows, wins):
    """B7's bytes (4 a value and a run pair, 8 KiB a dense-wire row) at
    most half of B2's (8 KiB an image row): 2 x (4 x (4,072 + 24) + 8 KiB
    x 2) = 8 x 8 KiB exactly."""
    assert kernels.dense_streams_win(4072, 24, 2, image_rows) is wins


def test_off_the_card_a_dense_set_keeps_no_stream(monkeypatch):
    """Off the card the kernel engines run plain versions and "auto" reads
    the image: the set drops its streams after the build, as before."""
    monkeypatch.setattr(kernels, "DENSE_STREAM_DEVICES", ("cuda",))
    bms = _bitmaps(_values("srt"))
    ds = tagg.DeviceBitmapSet(bms, layout="dense", device=CPU)
    assert ds.reduce_path == "image"
    assert ds._streams is None and ds._runs is None and ds._stream_plan is None
    parts = insights.resident_set_bytes(ds)
    assert "streams" not in parts
    assert insights.predict_resident_bytes(bms, layout="dense",
                                           device=CPU) == parts
    card = insights.predict_resident_bytes(bms, layout="dense")
    assert card["words"] == parts["words"] and card["streams"] > 0
    for op in OPS:
        for engine in ("cuda", "auto"):
            assert ds.aggregate(op, engine=engine) == _host(op, bms)


@pytest.mark.parametrize("shape", ["arrays", "bitmaps"])
def test_rule_keeps_b2_where_the_streams_weigh_half_the_image(shape):
    """4,096-value array containers (16 KiB of values for each 8 KiB image
    row), or bitmap containers alone (a dense-wire row for each image row):
    B7 would read more than half of B2's bytes, so the set keeps B2 (its
    plain version on the CPU, under any kernel engine) and keeps no
    stream."""
    vals = _values(shape)
    ds = tagg.DeviceBitmapSet(_bitmaps(vals), layout="dense", device=CPU)
    assert ds.reduce_path == "image"
    assert ds._streams is None and ds._runs is None and ds._stream_plan is None
    assert "streams" not in insights.resident_set_bytes(ds)
    host = {op: _host(op, _bitmaps(vals)) for op in OPS}
    for op in OPS:
        for engine in ("cuda", "cuda-nibble", "auto"):
            assert ds.aggregate(op, engine=engine) == host[op]
    reg = obs.metrics.REGISTRY
    assert reg.counter("rb_wide_reduce_total", layout="dense",
                       path="image").value == 6
    assert reg.counter("rb_wide_reduce_total", layout="dense",
                       path="streams").value == 0


def test_a_state_of_the_image_alone_reads_the_image():
    _, ts, _ = _sets("srt")
    st = {"keys": ts.keys, "n": ts.n, "block": ts.block,
          "blk_seg": ts.blk_seg.numpy(),
          "n_blocks": int((ts.blk_seg < ts.keys.size).sum()),
          "seg_sizes": ts._seg_sizes, "seg_offsets": ts._seg_offsets,
          "words": to_u32(ts.words)}
    ds = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    assert ds.reduce_path == "image" and ds._streams is None
    for op in OPS:
        _same(ds.aggregate_device(op, engine="cuda"),
              ts.aggregate_device(op, engine="cuda"))


# -------------------------------------------------------------- mutation

def _patch_adds(ds) -> dict:
    """Values into containers sources 0 and 1 already hold: a patch."""
    out = {}
    for src in (0, 1):
        b = ds.host_bitmaps()[src]
        key = int(b.keys[0])
        out[src] = [(key << 16) + 65535, (key << 16) + 7]
    return out


@pytest.mark.parametrize("op", OPS)
def test_a_patch_switches_to_the_image_and_a_repack_back(op):
    # a repack rebuilds from host copies, which hold no run container: a
    # shape without runs keeps its streams' size across it
    bms, _, _ = _sets("census")
    ds = tagg.DeviceBitmapSet(bms, layout="dense", device=CPU)
    assert ds.reduce_path == "streams"
    led = obs_memory.LEDGER
    before = led.resident_bytes("bitmap_set", "dense") - ds.hbm_bytes()
    with_streams = ds.hbm_bytes()
    rep = ds.apply_delta(adds=_patch_adds(ds), repack="never")
    assert rep["mode"] == "patch"
    assert ds.reduce_path == "image" and ds._streams is None
    assert ds.hbm_bytes() < with_streams
    assert led.resident_bytes("bitmap_set", "dense") == before + ds.hbm_bytes()
    hosts = ds.host_bitmaps()
    for engine in ("cuda", "torch"):
        assert ds.aggregate(op, engine=engine) == _host(op, hosts)
    rep = ds.apply_delta(adds={2: [5]}, repack="always")
    assert rep["mode"] == "repack"
    assert ds.reduce_path == "streams" and ds._streams is not None
    assert ds.aggregate(op, engine="cuda") == _host(op, ds.host_bitmaps())


# ------------------------------------------------------ counters, bytes

def test_wide_reduce_total_counts_one_a_call(tmp_path):
    _, ts, _ = _sets("census")
    path = tmp_path / "t.jsonl"
    obs.enable(str(path))
    for op in ("or", "xor", "or"):
        ts.aggregate_device(op, engine="cuda")
    ts.aggregate_device("and", engine="cuda")
    ts.aggregate_device("xor", engine="torch")
    ts.aggregate_range_cardinality("or", 0, 1 << 18, engine="cuda")
    int(ts.chained_aggregate("xor", 2, engine="cuda")())
    obs.disable()
    reg = obs.metrics.REGISTRY
    streams = reg.counter("rb_wide_reduce_total", layout="dense",
                          path="streams")
    image = reg.counter("rb_wide_reduce_total", layout="dense", path="image")
    assert (streams.value, image.value) == (6, 1)
    spans = [json.loads(line) for line in open(path) if line.strip()]
    tags = [s["tags"].get("path") for s in spans
            if s["name"] == "set.aggregate"]
    assert tags == ["streams"] * 3 + [None, "image", "streams"]


def test_resident_bytes_count_the_kept_streams():
    for shape in ("srt", "census"):
        bms, ts, _ = _sets(shape)
        parts = insights.resident_set_bytes(ts)
        kept = sum(t.numel() * t.element_size()
                   for t in (*ts._streams, *(ts._runs or ())))
        base = sum(t.numel() * 4 for t in (ts.blk_seg, ts.seg_ids,
                                           ts.head_idx))
        assert parts == {"words": ts.words.numel() * 4, "streams": kept,
                         "meta": base + ts._stream_plan.nbytes()}
        assert ts.hbm_bytes() == sum(parts.values())
        assert insights.predict_resident_bytes(bms, layout="dense",
                                               device=CPU) == parts


@pytest.mark.parametrize("args,want", [
    ((0, 0, 1, 0), 12 * 2 + 8196 + 16),
    ((10, 2, 3, 7), 40 + 16_384 + 48 + 3 * 8196 + 28 + 32),
    ((14_517_767, 0, 8_448, 8_329_979),
     58_071_068 + 101_388 + 69_239_808 + 33_319_916 + 67_592),
])
def test_b7_launch_bytes_with_runs(args, want):
    """The run variant adds 4 bytes a run pair and 8 bytes a key (and one)
    of run offsets to the closed form, which holds as it was without
    runs."""
    assert kernels.b7_launch_bytes(*args) == want
    assert kernels.b7_launch_bytes(*args[:3]) == want - 4 * args[3] - 8 * (
        args[2] + 1)
