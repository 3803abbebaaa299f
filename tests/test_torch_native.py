"""The port's native ingest engine (``roaringbitmap_tpu_torch.native``, the
C++ ``stream_ingest.cpp`` built with g++ at first use) against the port's
NumPy packers and the JAX package's, array for array.

Inputs are serialized bitmaps of census shapes (many sparse keys, run and
bitmap containers, numpy-seeded): ``pack_blocked_compact`` and
``pack_pairwise`` on pure-bytes input take the native engine and must give
the NumPy path's arrays exactly (stream order included, so ``row_src`` and
the carry row too).  Hostile blobs from ``utils.fuzz`` get the same verdict
from both engines.  ``RB_NATIVE=0`` selects NumPy and is counted; a failed
build raises ``NativeBuildError`` (nothing degrades silently).
"""

import dataclasses

import numpy as np
import pytest
import torch

from roaringbitmap_tpu.format import spec as jspec
from roaringbitmap_tpu.ops import packing as jpacking
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import native
from roaringbitmap_tpu_torch.format import spec as tspec
from roaringbitmap_tpu_torch.ops import packing
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.utils import fuzz

torch.set_num_threads(2)

STREAM_FIELDS = ("n_rows", "dense_words", "dense_dest", "values",
                 "val_counts", "val_dest")
PACK_FIELDS = ("keys", "blk_seg", "block", "n_blocks", "seg_sizes",
               "seg_offsets", "carry_row", "row_src")


def _census_blobs(seed: int, n: int) -> list[bytes]:
    """Census-shaped bitmaps: most sparse over many keys, some with long
    runs or dense chunks (fuzz.random_bitmap's mix), run-optimized."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i % 5 == 0:
            rb = fuzz.random_bitmap(rng, max_keys=6)
        else:
            rb = TRB.from_values(rng.integers(
                0, 1 << 26, int(rng.integers(50, 800))).astype(np.uint32))
        rb.run_optimize()
        out.append(rb.serialize())
    return out


def _assert_same_pack(a, b, fields=PACK_FIELDS):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert np.array_equal(x, y), f
    for f in STREAM_FIELDS:
        x, y = getattr(a.streams, f), getattr(b.streams, f)
        assert np.array_equal(x, y), f
        assert getattr(x, "dtype", None) == getattr(y, "dtype", None), f


@pytest.fixture(autouse=True)
def _native_on(monkeypatch):
    monkeypatch.delenv("RB_NATIVE", raising=False)
    native.reset_calls()


@pytest.mark.parametrize("kw", [
    {}, {"block": 8, "round_blocks": 64, "carry_slot": False},
    {"block": 32}, {"min_block": 4}])
@pytest.mark.parametrize("seed", [1, 2])
def test_blocked_pack_matches_numpy_and_jax(seed, kw):
    blobs = _census_blobs(seed, 48)
    nat = packing.pack_blocked_compact(blobs, **kw)
    assert native.CALLS == {"native": 1, "numpy": 0}
    views = packing.pack_blocked_compact(
        [tspec.SerializedView(b) for b in blobs], **kw)
    _assert_same_pack(nat, views)
    jax_np = jpacking.pack_blocked_compact(
        [jspec.SerializedView(b) for b in blobs], **kw)
    _assert_same_pack(nat, jax_np)


def test_pairwise_pack_matches_numpy_and_jax():
    blobs = _census_blobs(3, 40)
    pairs = list(zip(blobs[::2], blobs[1::2]))
    for pad in (True, False):
        nat = packing.pack_pairwise(pairs, pad_rows=pad)
        views = packing.pack_pairwise(
            [(tspec.SerializedView(a), tspec.SerializedView(b))
             for a, b in pairs], pad_rows=pad)
        jax_np = jpacking.pack_pairwise(
            [(jspec.SerializedView(a), jspec.SerializedView(b))
             for a, b in pairs], pad_rows=pad)
        for other in (views, jax_np):
            for f in ("keys", "heads", "m", "n_rows"):
                assert np.array_equal(getattr(nat, f), getattr(other, f)), f
            for side in ("a_streams", "b_streams"):
                for f in STREAM_FIELDS:
                    assert np.array_equal(getattr(getattr(nat, side), f),
                                          getattr(getattr(other, side), f))
    assert native.CALLS["native"] == 2


def test_device_paths_through_native():
    blobs = _census_blobs(4, 24)
    bms = [TRB.deserialize(b) for b in blobs]
    want = tagg._sequential_reduce("or", bms)
    for layout in ("dense", "compact", "counts"):
        before = dict(native.CALLS)
        ds = tagg.DeviceBitmapSet(blobs, layout=layout, device="cpu")
        # the dense layout's pack carries the run stream, which only the
        # NumPy path emits
        engine = "numpy" if layout == "dense" else "native"
        assert native.CALLS[engine] > before[engine], layout
        assert ds.aggregate("or", engine="cuda") == want
        assert ds.host_bitmaps() == bms
    pairs = list(zip(blobs[::2], blobs[1::2]))
    got = tagg.pairwise("xor", pairs, device="cpu")
    assert got == [a ^ b for a, b in zip(bms[::2], bms[1::2])]
    assert native.CALLS["native"] >= 3


def test_rb_native_off_is_counted(monkeypatch):
    blobs = _census_blobs(5, 12)
    nat = packing.pack_blocked_compact(blobs)
    monkeypatch.setenv("RB_NATIVE", "0")
    native.reset_calls()
    off = packing.pack_blocked_compact(blobs)
    pairs = packing.pack_pairwise(list(zip(blobs[::2], blobs[1::2])))
    assert native.CALLS == {"native": 0, "numpy": 2}
    _assert_same_pack(nat, off)
    assert pairs.m > 0
    # object inputs never count: only byte inputs have two engines
    packing.pack_blocked_compact([TRB.deserialize(b) for b in blobs])
    assert native.CALLS == {"native": 0, "numpy": 2}


def _verdict(blobs):
    try:
        p = packing.pack_blocked_compact(blobs)
    except tspec.InvalidRoaringFormat:
        return "invalid"
    return p


@pytest.mark.parametrize("kind", fuzz.MUTATION_KINDS)
def test_hostile_blobs_same_verdict(monkeypatch, kind):
    rng = np.random.default_rng(sum(map(ord, kind)))
    good = _census_blobs(6, 6)
    rejected = 0
    for i in range(12):
        base = fuzz.random_bitmap(rng, max_keys=8)
        base.run_optimize()
        bad = fuzz.mutate_serialized(rng, base.serialize(), kind)
        blobs = good[:3] + [bad] + good[3:]
        monkeypatch.delenv("RB_NATIVE", raising=False)
        nat = _verdict(blobs)
        monkeypatch.setenv("RB_NATIVE", "0")
        ref = _verdict(blobs)
        if isinstance(ref, str) or isinstance(nat, str):
            assert nat == ref, (kind, i)
            rejected += 1
        else:
            _assert_same_pack(nat, ref)
    if kind not in ("grow",):
        assert rejected > 0


def test_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="g\\+\\+ failed"):
        native.load()
    with pytest.raises(native.NativeBuildError):
        packing.pack_blocked_compact(_census_blobs(7, 3))
    # another flag set names another library, so build() runs g++ again,
    # now with no g++ on the path
    monkeypatch.setattr(native, "CXX_FLAGS", ("-O3",))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(native.NativeBuildError, match="could not run"):
        native.build()
