"""B7, the counts layout's wide OR/XOR off its resident value stream, on the
CPU.

- The per-key plan (``kernels.stream_reduce_plan``): each key's value and
  dense-row range, and the pieces of a heavy key.
- B7's plain version, its CPU wrapper and its
  kernel walked on the host (``stream_segmented_reduce_emulated``, pieces
  in any order) against B4's plain version over the same rows' nibble
  counts and a NumPy fold of the rows: XOR that cancels, empty keys, keys of
  dense-wire rows alone and mixed keys, a 4,096-value array container.
- A counts set's ``aggregate_device`` on the kernel engine (B7's path)
  against the "torch" engine (B4's plain path), the JAX package's set and a
  host fold, over sets of the same shapes, a ``from_numpy_state`` state whose
  streams do not ascend and a uscensus2000-shaped set.
- The rule that picks the reduce at load, ``chained_aggregate`` on the
  counts layout, the ``path`` tag and ``rb_wide_reduce_total``.

All bit-exact (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.ops import dense, kernels
from roaringbitmap_tpu_torch.ops.words import WORDS32, to_u32
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.utils.datasets import uscensus_like_values

torch.set_num_threads(2)

CPU = "cpu"
OPS = ("or", "xor")
B = 1 << 16


@pytest.fixture(autouse=True)
def _clean():
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


# ------------------------------------------------------------ hand streams

def _hand_streams(seed: int, k: int = 9, heavy: bool = False):
    """Streams of K keys laid out as the blocked layout lays them: key k
    owns whole blocks of 8 rows (none where it has no rows), then two
    padding blocks of id K.  Each row is a dense-wire row, a sparse
    container or empty (a zero padding row); keys 2 and 6 have no rows,
    key 4 has dense-wire rows alone, key 5 has rows that share values, and
    with ``heavy`` key 1 holds 4,096-value containers in every row.
    Returns (streams as CPU tensors, seg_ids, the image as NumPy u32)."""
    rng = np.random.default_rng(seed)
    row_seg, image = [], []
    dense_words, dense_dest, values, val_counts, val_dest = [], [], [], [], []
    for key in range(k):
        n = 0 if key in (2, 6) else int(rng.integers(1, 12))
        if heavy and key == 1:
            n = 16
        n_rows = -(-n // 8) * 8
        pool = rng.choice(B, 40, replace=False)
        for r in range(n_rows):
            row = len(row_seg)
            row_seg.append(key)
            img = np.zeros(WORDS32, np.uint32)
            kind = ("empty" if r >= n else "dense" if key == 4
                    else "full" if heavy and key == 1
                    else rng.choice(["dense", "sparse", "sparse"]))
            if kind == "dense":
                img = rng.integers(0, 1 << 32, WORDS32, dtype=np.uint64
                                   ).astype(np.uint32)
                dense_words.append(img)
                dense_dest.append(row)
            elif kind != "empty":
                size = 4096 if kind == "full" else int(rng.integers(1, 30))
                src = pool if key == 5 else np.arange(B)
                vals = np.sort(rng.choice(src, min(size, src.size),
                                          replace=False))
                values.append(vals)
                val_counts.append(vals.size)
                val_dest.append(row)
                np.bitwise_or.at(img, vals >> 5,
                                 np.uint32(1) << (vals & 31).astype(np.uint32))
            image.append(img)
    for _ in range(16):
        row_seg.append(k)
        image.append(np.zeros(WORDS32, np.uint32))
    md = len(dense_dest)
    streams = (
        torch.from_numpy(np.asarray(dense_words, np.uint32).reshape(md, WORDS32)
                         .view(np.int32)),
        torch.tensor(dense_dest, dtype=torch.int32),
        torch.from_numpy(np.concatenate(values).astype(np.int32)),
        torch.tensor(val_counts, dtype=torch.int32),
        torch.tensor(val_dest, dtype=torch.int32))
    return (streams, torch.tensor(row_seg, dtype=torch.int32),
            np.asarray(image))


def _fold_numpy(op: str, image: np.ndarray, row_seg: np.ndarray, k: int):
    fn = np.bitwise_or if op == "or" else np.bitwise_xor
    heads = np.zeros((k, WORDS32), np.uint32)
    for r, key in enumerate(row_seg.tolist()):
        if key < k:
            heads[key] = fn(heads[key], image[r])
    cards = np.unpackbits(heads.view(np.uint8), axis=1).sum(1)
    return heads, cards


def _plan(streams, seg_ids, k, piece_bytes=kernels.B7_PIECE_BYTES):
    dw, dd, v, vc, vd = streams
    return kernels.stream_reduce_plan(vc.numpy(), vd.numpy(), dd.numpy(),
                                      seg_ids.numpy(), k, piece_bytes)


def _b4_plain(op, streams, seg_ids, k):
    n_groups = seg_ids.shape[0] // dense.NIBBLE_GROUP
    counts = dense.build_group_counts(*streams, n_groups,
                                      streams[2].shape[0])[:n_groups]
    grp_seg = seg_ids[::dense.NIBBLE_GROUP].contiguous()
    return kernels.counts_segmented_reduce_plain(op, counts, grp_seg, k)


def _eq(got, heads, cards):
    assert np.array_equal(to_u32(got[0]), heads)
    assert np.array_equal(got[1].numpy(), cards)


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("op", OPS)
def test_plain_and_wrapper_match_b4_and_numpy(op, seed, heavy):
    streams, seg_ids, image = _hand_streams(seed, heavy=heavy)
    k = 9
    heads, cards = _fold_numpy(op, image, seg_ids.numpy(), k)
    assert cards[2] == cards[6] == 0
    plan = _plan(streams, seg_ids, k)
    _eq(kernels.stream_segmented_reduce_plain(op, *streams, seg_ids, k),
        heads, cards)
    _eq(kernels.stream_segmented_reduce(op, *streams, seg_ids, plan, k),
        heads, cards)
    _eq(_b4_plain(op, streams, seg_ids, k), heads, cards)


@pytest.mark.parametrize("piece_bytes", [64, 8192, 40_000,
                                         kernels.B7_PIECE_BYTES])
@pytest.mark.parametrize("op", OPS)
def test_emulated_kernel_in_any_block_order(op, piece_bytes):
    """The kernel's walk: heavy keys cut into pieces folded by the last to
    finish, blocks in shuffled orders; each counter ends at its key's piece
    count."""
    streams, seg_ids, image = _hand_streams(3, heavy=True)
    k = 9
    heads, cards = _fold_numpy(op, image, seg_ids.numpy(), k)
    plan = _plan(streams, seg_ids, k, piece_bytes)
    if piece_bytes < kernels.B7_PIECE_BYTES:
        assert plan.n_split >= 1 and plan.pieces.shape[0] > plan.n_split
    rng = np.random.default_rng(piece_bytes)
    for order in (None, rng.permutation(plan.pieces.shape[0] + k).tolist()):
        h, c, counters = kernels.stream_segmented_reduce_emulated(
            op, streams[2], streams[0], plan, k, order=order)
        _eq((h, c), heads, cards)
        per_key = np.bincount(plan.pieces[:, 7].numpy(),
                              minlength=plan.n_split)
        assert np.array_equal(counters.numpy(), per_key)


def test_plan_offsets_and_pieces():
    streams, seg_ids, _ = _hand_streams(4, heavy=True)
    dw, dd, v, vc, vd = streams
    k = 9
    plan = _plan(streams, seg_ids, 9, piece_bytes=4 * 4096)
    seg = seg_ids.numpy()
    vkeys = np.repeat(seg[vd.numpy()], vc.numpy())
    assert np.array_equal(np.diff(plan.voff.numpy()),
                          np.bincount(vkeys, minlength=k + 1)[:k])
    assert np.array_equal(np.diff(plan.doff.numpy()),
                          np.bincount(seg[dd.numpy()], minlength=k + 1)[:k])
    assert plan.voff.dtype == torch.int64 and plan.doff.dtype == torch.int32
    assert (plan.values, plan.dense_rows) == (v.shape[0], dw.shape[0])
    # key 1's 16 containers of 4,096 values: 16 value pieces of 4,096
    p = plan.pieces.numpy()
    cut = p[p[:, 0] == 1]
    assert cut.shape[0] == 16 and np.all(cut[:, 2] - cut[:, 1] == 4096)
    assert np.all(cut[:, 5] == cut[0, 5]) and np.all(cut[:, 6] == 16)
    # each cut key's pieces tile its value range and dense-row range
    for key in np.unique(p[:, 0]):
        q = p[p[:, 0] == key]
        nv = int(plan.voff[key + 1] - plan.voff[key])
        nd = int(plan.doff[key + 1] - plan.doff[key])
        assert (q[:, 2] - q[:, 1]).sum() == nv
        assert (q[:, 4] - q[:, 3]).sum() == nd
        assert 4 * nv + 8192 * nd > plan.piece_bytes


def test_wrapper_takes_or_and_xor_and_a_plan_of_k_keys():
    streams, seg_ids, _ = _hand_streams(5)
    plan = _plan(streams, seg_ids, 9, piece_bytes=64)
    with pytest.raises(ValueError, match="or/xor only"):
        kernels.stream_segmented_reduce("and", *streams, seg_ids, plan, 9)
    with pytest.raises(ValueError, match="K \\+ 1 offsets"):
        kernels.stream_segmented_reduce("or", *streams, seg_ids, plan, 8)


def test_plan_needs_ascending_streams():
    streams, seg_ids, _ = _hand_streams(7)
    dw, dd, v, vc, vd = streams
    with pytest.raises(ValueError, match="sorted by destination row"):
        kernels.stream_reduce_plan(vc.numpy(), vd.numpy()[::-1].copy(),
                                   dd.numpy(), seg_ids.numpy(), 9)


@pytest.mark.parametrize("args,want", [
    ((0, 0, 1), 12 * 2 + 8196),
    ((10, 2, 3), 40 + 16_384 + 48 + 3 * 8196),
    ((621_000, 0, 65_400), 2_484_000 + 784_812 + 536_018_400),
])
def test_b7_launch_bytes_closed_form(args, want):
    """Values of 4 bytes and dense rows of 8 KiB read once, 12 bytes of
    offsets a key (and one), 8,192 + 4 bytes a head and cardinality
    written once."""
    assert kernels.b7_launch_bytes(*args) == want


# -------------------------------------------------------------- set level

def _bitmaps(shape: str, seed: int = 11) -> list:
    """u32 value arrays of one set shape (see the module docstring)."""
    rng = np.random.default_rng(seed)
    out = []
    if shape == "repeated":
        # values from a pool of 48 a key, bitmaps repeated: xor cancels
        pool = {k: rng.choice(B, 48, replace=False) for k in range(6)}
        for i in range(24):
            keys = rng.choice(6, 3, replace=False)
            out.append(np.concatenate([(k << 16) + rng.choice(
                pool[k], int(rng.integers(1, 20)), replace=False)
                for k in keys]))
        out += [out[0].copy(), out[1].copy(), out[0].copy()]
    elif shape == "dense_mixed":
        # key 0: bitmap containers alone; keys 1-3 mixed; keys 4-7 arrays
        for i in range(16):
            vals = [rng.choice(B, 5000 + 100 * i, replace=False)]
            for k in range(1, 8):
                n = 6000 if k < 4 and i % 3 == 0 else int(rng.integers(1, 40))
                vals.append((k << 16) + rng.choice(B, n, replace=False))
            out.append(np.concatenate(vals))
    elif shape == "full_array":
        # key 2 holds 4,096-value array containers, the largest array
        for i in range(12):
            vals = [(2 << 16) + rng.choice(B, 4096, replace=False),
                    (5 << 16) + rng.choice(B, int(rng.integers(1, 9)),
                                           replace=False)]
            out.append(np.concatenate(vals))
    else:
        raise ValueError(shape)
    return [np.unique(v).astype(np.uint32) for v in out]


def _host_fold(op, vals):
    acc = TRB.from_values(vals[0])
    for v in vals[1:]:
        b = TRB.from_values(v)
        acc = acc | b if op == "or" else acc ^ b
    return acc


_SETS: dict = {}


def _sets(shape: str):
    """(values, the port's counts set on the CPU, the JAX counts set)."""
    if shape not in _SETS:
        vals = (uscensus_like_values(2) if shape == "uscensus"
                else _bitmaps(shape))
        ts = tagg.DeviceBitmapSet([TRB.from_values(v) for v in vals],
                                  layout="counts", device=CPU)
        js = jagg.DeviceBitmapSet([JRB.from_values(v) for v in vals],
                                  layout="counts")
        _SETS[shape] = (vals, ts, js)
    return _SETS[shape]


SHAPES = ("repeated", "dense_mixed", "full_array", "uscensus")


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("op", OPS)
def test_counts_set_on_streams_matches_b4_jax_and_host(op, shape):
    vals, ts, js = _sets(shape)
    assert ts.reduce_path == "streams"
    got = ts.aggregate_device(op, engine="cuda")      # B7's plain version
    b4 = ts.aggregate_device(op, engine="torch")      # B4's plain path
    jw, jc = js.aggregate_device(op, engine="xla")
    for words, cards in (got, b4):
        assert np.array_equal(to_u32(words), np.asarray(jw))
        assert np.array_equal(cards.numpy(), np.asarray(jc))
    want = _host_fold(op, vals) if shape != "uscensus" else \
        js.aggregate(op, engine="xla")
    assert ts.aggregate(op, engine="cuda").serialize() == want.serialize()
    assert ts.aggregate(op, engine="cuda-nibble") == \
        ts.aggregate(op, engine="cuda")


def test_xor_cancels_on_the_repeated_shape():
    vals, ts, _ = _sets("repeated")
    words, cards = ts.aggregate_device("xor", engine="cuda")
    assert int(cards.sum()) < int(
        ts.aggregate_device("or", engine="cuda")[1].sum())
    assert int(cards.sum()) == _host_fold("xor", vals).cardinality


@pytest.mark.parametrize("op", OPS)
def test_from_numpy_state_with_unsorted_streams(op):
    """A state whose sparse containers and dense rows come in descending
    row order: the set sorts both on load, and B7 reads the same keys."""
    vals, ts, js = _sets("dense_mixed")
    p = js._packed
    st = {"keys": js.keys, "n": js.n, "block": js.block, "blk_seg": p.blk_seg,
          "n_blocks": p.n_blocks, "seg_sizes": p.seg_sizes,
          "seg_offsets": p.seg_offsets, "counts": np.asarray(js.counts),
          "grp_seg": np.asarray(js._grp_seg_counts)}
    dw, dd, v, vc, vd = (np.asarray(a) for a in js._streams)
    starts = np.concatenate(([0], np.cumsum(vc)[:-1]))
    order = np.arange(vc.size)[::-1]
    st.update(dense_words=dw[::-1], dense_dest=dd[::-1],
              values=np.concatenate([v[a:a + c] for a, c in
                                     zip(starts[order], vc[order])]),
              val_counts=vc[order], val_dest=vd[order])
    assert np.any(np.diff(st["val_dest"]) < 0)
    us = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    assert np.all(np.diff(us._streams[4].numpy()) >= 0)
    assert np.all(np.diff(us._streams[1].numpy()) >= 0)
    assert us.reduce_path == "streams"
    jw, jc = js.aggregate_device(op, engine="xla")
    words, cards = us.aggregate_device(op, engine="cuda")
    assert np.array_equal(to_u32(words), np.asarray(jw))
    assert np.array_equal(cards.numpy(), np.asarray(jc))


def test_rule_picks_streams_for_the_uscensus_shape():
    _, ts, _ = _sets("uscensus")
    plan, groups = ts._stream_plan, ts.counts.shape[0]
    assert ts.layout == "counts" and ts.reduce_path == "streams"
    assert 4 * plan.values + 8192 * plan.dense_rows <= 32768 * groups
    auto = tagg.DeviceBitmapSet([TRB.from_values(v) for v in
                                 uscensus_like_values(1, keys=120)],
                                device=CPU)
    assert auto.layout == "counts" and auto.reduce_path == "streams"


def test_rule_keeps_b4_for_a_counts_set_of_bitmap_containers():
    """A forced counts layout whose dense-wire rows outweigh its counts
    keeps B4 (its plain version on the CPU, under any kernel engine)."""
    rng = np.random.default_rng(9)
    vals = [np.unique(np.concatenate([(k << 16) + rng.choice(
        B, 9000, replace=False) for k in range(3)])).astype(np.uint32)
        for _ in range(64)]
    ds = tagg.DeviceBitmapSet([TRB.from_values(v) for v in vals],
                              layout="counts", device=CPU)
    plan, groups = ds._stream_plan, ds.counts.shape[0]
    assert plan.dense_rows == 192
    assert 4 * plan.values + 8192 * plan.dense_rows > 32768 * groups
    assert ds.reduce_path == "counts"
    for op in OPS:
        for engine in ("cuda", "cuda-nibble", "auto"):
            assert ds.aggregate(op, engine=engine) == _host_fold(op, vals)
    total = obs.metrics.REGISTRY.counter("rb_wide_reduce_total",
                                         layout="counts", path="counts")
    assert total.value == 6 and obs.metrics.REGISTRY.counter(
        "rb_wide_reduce_total", layout="counts", path="streams").value == 0


@pytest.mark.parametrize("op", ["or", "xor", "and"])
def test_chained_aggregate_on_counts_is_unchanged(op):
    vals, ts, _ = _sets("dense_mixed")
    reps = 3
    for engine in ("cuda", "torch"):
        card = int(ts.aggregate_device(op, engine=engine)[1].sum())
        assert int(ts.chained_aggregate(op, reps, engine=engine)()) == \
            (reps * card) % 2**32
    want = _host_fold(op, vals) if op != "and" else None
    if want is not None:
        assert int(ts.chained_wide_or(reps, engine="cuda")()) == \
            (reps * _host_fold("or", vals).cardinality) % 2**32


def test_wide_reduce_total_counts_one_a_call(tmp_path):
    _, ts, _ = _sets("repeated")
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
    streams = reg.counter("rb_wide_reduce_total", layout="counts",
                          path="streams")
    counts = reg.counter("rb_wide_reduce_total", layout="counts",
                         path="counts")
    assert (streams.value, counts.value) == (6, 1)
    spans = [json.loads(line) for line in open(path) if line.strip()]
    tags = [s["tags"].get("path") for s in spans
            if s["name"] == "set.aggregate"]
    assert tags == ["streams"] * 3 + [None, "counts", "streams"]
    # a reset drops the children; the next call counts into a new one
    obs.reset()
    ts.aggregate_device("or", engine="cuda")
    assert reg.counter("rb_wide_reduce_total", layout="counts",
                       path="streams").value == 1


def test_resident_bytes_count_the_plan():
    _, ts, _ = _sets("full_array")
    plan = ts._stream_plan
    k = ts.keys.size
    assert plan.nbytes() == 12 * (k + 1) + 64 * plan.pieces.shape[0]
    dense_set = tagg.DeviceBitmapSet(
        [TRB.from_values(v) for v in _bitmaps("full_array")], layout="dense",
        device=CPU)
    # off the card a dense set keeps no plan of B7 (its or/xor read the image)
    assert dense_set._stream_plan is None and dense_set.reduce_path == "image"
