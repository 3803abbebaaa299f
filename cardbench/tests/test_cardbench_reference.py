"""The NumPy reference agrees with roaringbitmap_tpu_torch's plain path at
a small size."""

import json

import numpy as np
import pytest

from roaringbitmap_tpu_torch.core.bitmap import RoaringBitmap
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet

from cardbench import gen, reference

import minibench


def _data(name, segments=2):
    cfg = json.loads((minibench.REPO / "cardbench/configs"
                      / f"{name}.json").read_text())
    cfg.update(segments=segments, attributes=30)
    return cfg, gen.dataset_bytes(cfg, minibench.SEED)


def test_decode_matches_the_program():
    for name in ("census1881_like", "uscensus2000_like"):
        _, src = _data(name)
        dec = reference.decode_set(src)
        for i in range(0, len(src), 7):
            got = RoaringBitmap.deserialize(bytes(src[i])).to_array()
            assert np.array_equal(got.astype(np.uint32),
                                  reference.members(dec, i))


def test_decode_runs():
    rb = RoaringBitmap.from_values(
        np.concatenate([np.arange(10, 5000), np.arange(70000, 70003)]))
    rb.run_optimize()
    dec = reference.decode_set([rb.serialize()])
    assert np.array_equal(reference.members(dec, 0),
                          rb.to_array().astype(np.uint32))


def test_wide_matches_the_plain_path():
    for name in ("census1881_like", "uscensus2000_like"):
        cfg, src = _data(name)
        dec = reference.decode_set(src)
        ds = DeviceBitmapSet(src, layout=cfg["layout"], device="cpu")
        for op in ("or", "xor"):
            words, cards = ds.aggregate_device(op, engine="torch")
            k, w, c = reference.wide(op, dec)
            pc = cards.numpy()
            nz = pc > 0
            assert np.array_equal(ds.keys[nz].astype(np.uint32), k)
            assert np.array_equal(words.numpy().view(np.uint32)[nz], w)
            assert np.array_equal(pc[nz], c)


def _totals(dec):
    return {op: int(reference.wide(op, dec)[2].sum()) for op in ("or", "xor")}


def _by_sorting(vals):
    v, c = np.unique(np.concatenate(vals), return_counts=True)
    return {"or": v.size, "xor": int((c % 2).sum())}


def test_wide_by_sorting_and_one_container_left_out():
    rng = np.random.default_rng(1)
    vals = [np.unique(rng.integers(0, 1 << 20, 500)) for _ in range(6)]
    dec = reference.decode_set(
        [RoaringBitmap.from_values(v).serialize() for v in vals])
    assert _totals(dec) == _by_sorting(vals)
    # bitmap 3's first container (its lowest key) taken out
    lossy = dec.without(int(dec.first[3]))
    assert lossy.keys.size == dec.keys.size - 1
    low_key = vals[3][0] >> 16
    cut = list(vals)
    cut[3] = vals[3][(vals[3] >> 16) != low_key]
    assert cut[3].size < vals[3].size
    assert _totals(lossy) == _by_sorting(cut)


def _run_data():
    return gen.dataset_bytes(minibench.RUN_CONFIG, minibench.SEED)


def test_run_bitmaps_round_trip_through_the_port():
    """Every bitmap with run containers reads back byte for byte through
    the program's deserialize and serialize, with the reference's
    members."""
    src = _run_data()
    dec = reference.decode_set(src)
    runs = 0
    for i, b in enumerate(src):
        b = bytes(b)
        rb = RoaringBitmap.deserialize(b)
        assert rb.serialize() == b
        assert np.array_equal(rb.to_array().astype(np.uint32),
                              reference.members(dec, i))
        runs += int(reference.parse(b)[3].any())
    assert runs > 10


def test_run_decode_in_chunks():
    """Run payloads set a few runs at a time decode as in one go."""
    src = _run_data()
    whole = reference.decode_set(src)
    assert np.array_equal(reference.decode_set(src, chunk=7).rows,
                          whole.rows)


@pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
def test_wide_with_runs_matches_the_plain_path(layout):
    src = _run_data()
    dec = reference.decode_set(src)
    ds = DeviceBitmapSet(src, layout=layout, device="cpu")
    for op in ("or", "xor"):
        words, cards = ds.aggregate_device(op, engine="torch")
        k, w, c = reference.wide(op, dec)
        pc = cards.numpy()
        nz = pc > 0
        assert np.array_equal(ds.keys[nz].astype(np.uint32), k)
        assert np.array_equal(words.numpy().view(np.uint32)[nz], w)
        assert np.array_equal(pc[nz], c)
