"""The port's word tier and plain dense ops against roaringbitmap_tpu.ops.dense.

Same numpy-seeded inputs through both packages; every comparison is
bit-exact (integer set algebra, nothing rounds).  Rows include the edge
words 0x80000000 and 0xFFFFFFFF, where an int32 view is negative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringbitmap_tpu.ops import dense as jdense
from roaringbitmap_tpu_torch.ops import dense as tdense
from roaringbitmap_tpu_torch.ops import words as W

torch.set_num_threads(2)

EDGE = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555],
                np.uint32)


def _rows(seed: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint64).astype(np.uint32)
    rows[:, :EDGE.size] = EDGE
    rows[0] = 0xFFFFFFFF
    rows[-1, -1] = 0x80000000
    return rows


def _t(a: np.ndarray) -> torch.Tensor:
    return W.as_i32(a, "cpu")


def _eq(port: torch.Tensor, ref) -> None:
    got = W.to_u32(port) if port.dtype == torch.int32 else port.numpy()
    want = np.asarray(ref)
    assert got.shape == want.shape
    assert np.array_equal(got, want.astype(got.dtype))


def test_u32_views_roundtrip():
    t = _t(EDGE)
    assert t.dtype == torch.int32
    assert t[2].item() == -(1 << 31) and t[3].item() == -1
    assert np.array_equal(W.to_u32(t), EDGE)


@pytest.mark.parametrize("k", [1, 5, 16, 31])
def test_logical_right_shift(k):
    got = W.to_u32(W.srl(_t(EDGE), k))
    assert np.array_equal(got, EDGE >> np.uint32(k))


def test_fold_u32():
    vals = torch.tensor([0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1],
                        dtype=torch.int64)
    got = W.to_u32(W.fold_u32(vals))
    assert got.tolist() == [0, 1, (1 << 31) - 1, 1 << 31, (1 << 32) - 1]


@pytest.mark.parametrize("seed", [0, 1])
def test_popcount(seed):
    rows = _rows(seed, 5)
    _eq(W.popcount(_t(rows)), jdense.popcount(jnp.asarray(rows)))
    _eq(tdense.popcount(_t(rows), 0), jdense.popcount(jnp.asarray(rows), 0))


@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot"])
def test_segmented_reduce(op):
    rows = _rows(2, 12)
    seg = np.array([0, 0, 0, 1, 2, 2, 2, 2, 2, 3, 4, 4], np.int32)
    head = np.searchsorted(seg, np.arange(5)).astype(np.int32)
    steps = jdense.n_steps_for(5)
    want = jdense.segmented_reduce(op, jnp.asarray(rows), jnp.asarray(seg),
                                   jnp.asarray(head), steps)
    got = tdense.segmented_reduce(op, _t(rows), _t(seg), _t(head), steps)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


def test_doubling_pass_matches():
    rows = _rows(3, 9)
    seg = np.array([0, 0, 1, 1, 1, 1, 1, 2, 2], np.int32)
    want = jdense.doubling_pass(jdense.OPS["xor"], jnp.asarray(rows),
                                jnp.asarray(seg), 3)
    _eq(tdense.doubling_pass(tdense.OPS["xor"], _t(rows), _t(seg), 3), want)


@pytest.mark.parametrize("n", [1, 2, 5, 8])
def test_regular_reduce_and(n):
    rows = _rows(4 + n, 3 * n).reshape(3, n, 2048)
    want = jdense.regular_reduce_and(jnp.asarray(rows))
    got = tdense.regular_reduce_and(_t(rows))
    _eq(got[0], want[0])
    _eq(got[1], want[1])


@pytest.mark.parametrize("max_group", [0, 1, 2, 3, 17, 1024])
def test_n_steps_for(max_group):
    assert tdense.n_steps_for(max_group) == jdense.n_steps_for(max_group)


def _streams(seed: int, n_rows: int):
    """Sparse + dense-wire streams over distinct rows, plus a scratch-row
    sentinel entry (as pad_streams_pow2 emits)."""
    rng = np.random.default_rng(seed)
    rows = rng.permutation(n_rows)
    sparse_rows, dense_rows = np.sort(rows[:4]), np.sort(rows[4:6])
    pieces = [np.unique(rng.integers(0, 1 << 16, rng.integers(1, 3000)))
              for _ in sparse_rows]
    pieces[0] = np.unique(np.concatenate([pieces[0], [0, 31, 32, 65535]]))
    values = np.concatenate(pieces + [np.zeros(3, np.int64)]).astype(np.uint16)
    val_counts = np.array([p.size for p in pieces] + [3], np.int32)
    val_dest = np.array(list(sparse_rows) + [n_rows], np.int32)
    dense_words = _rows(seed + 9, 2)
    return (dense_words, dense_rows.astype(np.int32), values, val_counts,
            val_dest)


def _both(streams):
    j = tuple(jnp.asarray(a) for a in streams)
    dw, dd, v, vc, vd = streams
    t = (_t(dw), _t(dd), _t(v.astype(np.int32)), _t(vc), _t(vd))
    return j, t


@pytest.mark.parametrize("seed", [0, 1])
def test_densify_streams(seed):
    s = _streams(seed, 16)
    j, t = _both(s)
    total = int(s[2].size)
    want = jdense.densify_streams(*j, 16, total)
    _eq(tdense.densify_streams(*t, 16, total), want)
    _eq(tdense.densify_streams_impl(*t, 16, total), want)


@pytest.mark.parametrize("seed", [0, 1])
def test_nibble_counts(seed):
    s = _streams(seed, 16)
    j, t = _both(s)
    total = int(s[2].size)
    want = jdense.nibble_counts_impl(j[2], j[3], j[4], 2, total)
    _eq(tdense.nibble_counts_impl(t[2], t[3], t[4], 2, total), want)


def test_spread_bits_to_nibbles():
    rows = _rows(5, 3)
    _eq(tdense.spread_bits_to_nibbles(_t(rows)),
        jdense.spread_bits_to_nibbles(jnp.asarray(rows)))


@pytest.mark.parametrize("op", ["or", "xor"])
def test_counts_to_words(op):
    rng = np.random.default_rng(6)
    # nibble counts up to 8, including all-eight-nibbles-set words whose
    # int32 view is negative
    nib = rng.integers(0, 9, (3, 4, 2048, 8)).astype(np.uint32)
    nib[0, :, :4] = 8
    counts = (nib << (4 * np.arange(8, dtype=np.uint32))).sum(
        axis=-1, dtype=np.uint64).astype(np.uint32)
    _eq(tdense.counts_to_words(_t(counts), op),
        jdense.counts_to_words(jnp.asarray(counts), op))
    _eq(tdense.counts_tile_to_word(_t(counts[0]), op),
        jdense.counts_tile_to_word(jnp.asarray(counts[0]), op))


@pytest.mark.parametrize("seed", [0, 1])
def test_build_group_counts(seed):
    s = _streams(seed, 16)
    j, t = _both(s)
    total = int(s[2].size)
    want = jdense.build_group_counts(*j, 2, total)
    _eq(tdense.build_group_counts(*t, 2, total), want)


def test_ops_vocabulary():
    a, b = _t(_rows(7, 1)), _t(_rows(8, 1))
    ja, jb = jnp.asarray(W.to_u32(a)), jnp.asarray(W.to_u32(b))
    assert set(tdense.OPS) == set(jdense.OPS)
    for op in tdense.OPS:
        _eq(tdense.OPS[op](a, b), jdense.OPS[op](ja, jb))
