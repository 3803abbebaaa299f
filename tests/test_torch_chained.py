"""The steady-state probes ``chained_wide_or`` and ``chained_aggregate`` on
both packages.

JAX's ``test_chained_aggregate_parity_all_ops_layouts`` on both sides: for
or/xor/and x dense/counts/compact x the port's "cuda"/"cuda-nibble"/"torch"
engines, the port's total equals the JAX probe's total on the matching
engine ("pallas"/"pallas-nibble"/"xla", Pallas in interpret mode) and
(reps * cardinality) % 2^32.  The OR write-back leaves the resident set as it
was.  Bit-exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import fast_aggregation as jfast
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.parallel import aggregation as tagg

torch.set_num_threads(2)

CPU = "cpu"
REPS = 3
LAYOUTS = ("dense", "counts", "compact")
JAX_ENGINE = {"cuda": "pallas", "cuda-nibble": "pallas-nibble",
              "torch": "xla"}


def _values() -> list[np.ndarray]:
    """Twelve bitmaps over 2^19 sharing a run (a non-empty wide AND), two of
    them with bitmap containers (dense-wire rows)."""
    rng = np.random.default_rng(0)
    common = np.arange(100, 600)
    vals = [np.concatenate([rng.integers(0, 1 << 19, 4000), common])
            for _ in range(12)]
    vals[0] = np.concatenate([vals[0], np.arange(1 << 17, (1 << 17) + 30000)])
    vals[5] = np.concatenate([vals[5], np.arange(0, 60000, 3)])
    return [v.astype(np.uint32) for v in vals]


@pytest.fixture(scope="module")
def sets():
    vals = _values()
    j = [JRB.from_values(v) for v in vals]
    t = [TRB.from_values(v) for v in vals]
    want = {"or": jfast.or_(*j).cardinality,
            "xor": jfast.xor(*j).cardinality,
            "and": jfast.and_(*j).cardinality}
    assert want["and"] >= 500
    js = {lay: jagg.DeviceBitmapSet(j, layout=lay) for lay in LAYOUTS}
    ts = {lay: tagg.DeviceBitmapSet(t, layout=lay, device=CPU)
          for lay in LAYOUTS}
    return js, ts, want


def _total(fn) -> int:
    out = fn()
    if isinstance(out, torch.Tensor):
        assert out.dim() == 0 and out.dtype == torch.int64
        return int(out)
    return int(np.asarray(out))


@pytest.mark.parametrize("engine", ["cuda", "cuda-nibble", "torch"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("op", ["or", "xor", "and"])
def test_chained_aggregate_matches_jax(sets, op, layout, engine):
    js, ts, want = sets
    got = _total(ts[layout].chained_aggregate(op, REPS, engine=engine))
    assert got == (REPS * want[op]) % 2**32
    ref = _total(js[layout].chained_aggregate(op, REPS,
                                              engine=JAX_ENGINE[engine]))
    assert got == ref


@pytest.mark.parametrize("engine", ["cuda", "cuda-nibble", "torch"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_chained_wide_or_matches_jax(sets, layout, engine):
    js, ts, want = sets
    ds = ts[layout]
    image = None if ds.words is None else ds.words.clone()
    before = ds.aggregate_device("xor", engine="torch")
    got = _total(ds.chained_wide_or(REPS, engine=engine))
    assert got == (REPS * want["or"]) % 2**32
    ref = _total(js[layout].chained_wide_or(REPS, engine=JAX_ENGINE[engine]))
    assert got == ref
    # the write-back changed nothing: the image is restored, and xor (which
    # a lasting write-back would change) gives the same words
    if image is not None:
        assert torch.equal(ds.words, image)
    after = ds.aggregate_device("xor", engine="torch")
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def test_probe_totals_wrap_mod_2_32(sets):
    """The int64 device total reduces mod 2^32, as JAX's uint32 sum wraps."""
    _, ts, want = sets
    fn = ts["dense"].chained_aggregate("or", 1)
    # the callable runs a fresh loop on each call
    assert _total(fn) == _total(fn) == want["or"]
    # 4097 queries of 2^20 members sum past 2^32
    one = tagg.DeviceBitmapSet([TRB.from_values(np.arange(1 << 20,
                                                          dtype=np.uint32))],
                               layout="dense", device=CPU)
    got = _total(one.chained_aggregate("or", 4097))
    assert got == (4097 << 20) % 2**32 == 1 << 20


def test_dense_probe_takes_words(sets):
    """The dense probes run over a ``words`` argument when given one, and
    the counts and compact probes ignore it, as in JAX."""
    _, ts, want = sets
    ds = ts["dense"]
    zeros = torch.zeros_like(ds.words)
    assert _total(lambda: ds.chained_aggregate("or", 2)(zeros)) == 0
    assert _total(lambda: ds.chained_wide_or(2)(zeros)) == 0
    assert not zeros.any()
    for layout in ("counts", "compact"):
        fn = ts[layout].chained_aggregate("xor", 2)
        assert _total(lambda: fn(zeros)) == (2 * want["xor"]) % 2**32


def test_chained_rejects_unknown_op(sets):
    _, ts, _ = sets
    with pytest.raises(ValueError, match="chained op"):
        ts["dense"].chained_aggregate("andnot", 2)
