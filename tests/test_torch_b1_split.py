"""B1's chunk plan and its combine order on the host.

The kernel (``csrc/segmented_reduce.cu``) cuts the rows into chunks of R
rows; a segment of at most R rows is folded whole by the chunk of its head
row, a longer one is cut at the chunk edges and its partials are folded by
the last piece to arrive.  ``kernels.b1_chunk_plan`` is that plan and
``kernels.segmented_reduce_emulated`` walks it with the blocks in any order.
Here the plan is held to the rule it implements, and the emulation, at
several forced chunk sizes and block orders, bit-equal to
``kernels.segmented_reduce_plain`` and to the JAX package's
``segmented_reduce_pallas`` (interpret mode on the CPU; a narrow width is
the full-width JAX result over the row slice), for all four ops and all
four row widths.  Tolerance: bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringbitmap_tpu.ops import kernels as jkernels
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops.words import as_i32, popcount, to_u32

torch.set_num_threads(2)

OPS = ("or", "and", "xor", "andnot")
#: forced chunk rows: one row a chunk, odd sizes, and one larger than most
#: segments
CHUNKS = (1, 3, 8, 64)


def _ids(lengths, pad: int):
    """Sorted segment ids with ``lengths[k]`` rows for segment k (0 = an
    empty segment), then ``pad`` padding rows of id K; returns (ids, K)."""
    k = len(lengths)
    ids = np.repeat(np.arange(k, dtype=np.int32), lengths)
    return np.concatenate([ids, np.full(pad, k, np.int32)]), k


def _case(name: str):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":            # 0..40 rows a segment, padding at the end
        lengths = rng.integers(0, 41, 14)
        lengths[[0, 5, 13]] = 0
        ids, k = _ids(lengths, 9)
    elif name == "k1_long":         # one segment over two thousand rows
        ids, k = _ids([2000], 5)
    elif name == "head_alone":      # a long segment's head row alone in its
        # chunk: segment 1 at row 2 for R 3, segment 3 at row 15 for R 8
        ids, k = _ids([2, 8, 5, 20, 1, 30, 0, 3], 3)
    elif name == "empties":         # leading, inner and trailing empties
        ids, k = _ids([0, 0, 3, 0, 0, 0, 1, 9, 0, 2, 0, 0, 0], 2)
    elif name == "pooled":          # 2-8 rows a segment, as the pooled path
        ids, k = _ids(rng.integers(2, 9, 40), 0)
    else:
        raise ValueError(name)
    rows = rng.integers(0, 1 << 32, (ids.size, 2048),
                        dtype=np.uint64).astype(np.uint32)
    rows[:, 0] = 0x80000000         # a sign bit in every row
    rows[:, 1] = rng.integers(0, 2, ids.size) * 0xFFFFFFFF
    return rows, ids, k


CASES = ("ragged", "k1_long", "head_alone", "empties", "pooled")


@pytest.fixture(scope="module")
def cases():
    return {name: _case(name) for name in CASES}


@pytest.fixture(scope="module")
def jax_heads(cases):
    """The JAX kernel's full-width heads, by (case, op)."""
    out = {}

    def get(name, op):
        if (name, op) not in out:
            rows, ids, k = cases[name]
            h, _ = jkernels.segmented_reduce_pallas(
                op, jnp.asarray(rows), jnp.asarray(ids), k)
            out[name, op] = np.asarray(h)
        return out[name, op]
    return get


def _segments(ids, k):
    starts = np.searchsorted(ids, np.arange(k), "left")
    ends = np.searchsorted(ids, np.arange(k), "right")
    return starts, ends


# ------------------------------------------------------------ the plan

@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("name", CASES)
def test_plan_folds_every_real_row_once(cases, name, chunk):
    """Every real row in exactly one run, no padding row read; a segment of
    at most R rows is one whole run in the chunk of its head row; a longer
    one is cut at the chunk edges, head piece first; every empty segment is
    zeroed once and no other."""
    _, ids, k = cases[name]
    m = ids.size
    n = kernels.b1_num_chunks(m, chunk)
    assert n == max(1, -(-m // chunk))
    folded = np.zeros(m, np.int64)
    zeroed = np.zeros(k, np.int64)
    pieces = {}
    for c in range(n):
        gaps, runs = kernels.b1_chunk_plan(ids, k, chunk, c)
        for a, b in gaps:
            zeroed[a:b] += 1
        for seg, a, b, before, after in runs:
            assert (ids[a:b] == seg).all() and seg < k
            folded[a:b] += 1
            pieces.setdefault(seg, []).append((c, a, b, before, after))
    starts, ends = _segments(ids, k)
    assert (folded[ids < k] == 1).all() and (folded[ids == k] == 0).all()
    for seg in range(k):
        s, e = int(starts[seg]), int(ends[seg])
        assert zeroed[seg] == (1 if s == e else 0)
        if s == e:
            assert seg not in pieces
        elif e - s <= chunk:
            assert pieces[seg] == [(s // chunk, s, e, False, False)]
        else:
            cuts = [s] + list(range((s // chunk + 1) * chunk, e, chunk)) + [e]
            want = [(a // chunk, a, b, i > 0, i < len(cuts) - 2)
                    for i, (a, b) in enumerate(zip(cuts, cuts[1:]))]
            assert pieces[seg] == want


def test_plan_of_no_rows_zeroes_every_segment():
    gaps, runs = kernels.b1_chunk_plan([], 5, 8, 0, m=0)
    assert gaps == [(0, 5)] and runs == []


@pytest.mark.parametrize("chunk", (1, 4))
def test_plan_takes_one_id_per_block_of_rows(chunk):
    """``scale`` rows per id: the plan over ids repeated ``scale`` times."""
    blk = np.array([0, 0, 1, 3, 3, 3, 5], np.int32)
    for c in range(kernels.b1_num_chunks(blk.size * 4, chunk)):
        assert kernels.b1_chunk_plan(blk, 5, chunk, c, scale=4) == \
            kernels.b1_chunk_plan(np.repeat(blk, 4), 5, chunk, c)


@pytest.mark.parametrize("per_segment", (1, 5, 8, 441))
@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("m", (0, 1300, 65536, 131072, 1 << 22))
def test_chunk_rows_fill_the_card(m, width, per_segment):
    """The launch: B1_BLOCKS_PER_SM blocks an SM on a 132-SM card where the
    rows allow (a whole number of waves of resident blocks, 1,024 threads
    an SM), twice as many where the mean segment is shorter than
    B1_UNROLL rows, one batch of loads per row group at least, at most
    B1_MAX_CHUNK_ROWS rows a chunk; the workspace holds two partials a chunk
    and three words a segment."""
    threads = kernels.b1_block_threads(width)
    assert threads % (width // 4) == 0 and threads >= 256
    groups = threads // (width // 4)
    assert kernels.B1_BLOCKS_PER_SM % (1024 // threads) == 0
    k = max(1, m // per_segment)
    r = kernels.b1_chunk_rows(m, width, k, 132)
    n = kernels.b1_num_chunks(m, r)
    assert kernels.B1_UNROLL * groups <= r <= kernels.B1_MAX_CHUNK_ROWS
    short = m < kernels.B1_UNROLL * k
    assert short == (per_segment < kernels.B1_UNROLL) or m == 0
    blocks = 132 * kernels.B1_BLOCKS_PER_SM * (2 if short else 1)
    if m >= blocks * kernels.B1_UNROLL * groups \
            and r < kernels.B1_MAX_CHUNK_ROWS:
        assert blocks <= n <= 2 * blocks
    assert kernels.b1_work_words(m, width, 7, r) == 2 * n * width + 21


# ------------------------------------------------------ the emulation

def _orders(n: int, seed: int):
    return {"in order": range(n), "reversed": range(n - 1, -1, -1),
            "shuffled": np.random.default_rng(seed).permutation(n).tolist()}


@pytest.mark.parametrize("width", kernels.ROW_WIDTHS)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("name", CASES)
def test_emulation_matches_plain_and_jax(cases, jax_heads, name, op, width):
    rows, ids, k = cases[name]
    w = as_i32(np.ascontiguousarray(rows[:, :width]), "cpu")
    s = as_i32(ids, "cpu")
    jh = np.ascontiguousarray(jax_heads(name, op)[:, :width])
    jc = popcount(as_i32(jh, "cpu")).numpy()
    ph, pc = kernels.segmented_reduce_plain(op, w, s, k)
    assert np.array_equal(to_u32(ph), jh) and np.array_equal(pc.numpy(), jc)
    for chunk in CHUNKS:
        n = kernels.b1_num_chunks(ids.size, chunk)
        for label, order in _orders(n, chunk).items():
            h, c, counters = kernels.segmented_reduce_emulated(
                op, w, s, k, chunk, order=order)
            assert np.array_equal(to_u32(h), jh), (chunk, label)
            assert np.array_equal(c.numpy(), jc), (chunk, label)
            assert not counters.any(), "a counter did not come back to 0"


@pytest.mark.parametrize("op", OPS)
def test_emulation_of_no_rows_is_zero(op):
    w = torch.zeros((0, 256), dtype=torch.int32)
    s = torch.zeros(0, dtype=torch.int32)
    h, c, counters = kernels.segmented_reduce_emulated(op, w, s, 4, 8)
    assert not h.any() and not c.any() and not counters.any()


@pytest.mark.parametrize("op", ("or", "xor"))
def test_emulation_over_blocked_ids(cases, op):
    """One id per block of rows (B2's layout) gives B1's result over the
    repeated ids."""
    rows, ids, k = cases["ragged"]
    blk = ids[:ids.size // 4 * 4:4]
    w = as_i32(rows[:blk.size * 4], "cpu")
    want = kernels.segmented_reduce_plain(
        op, w, as_i32(np.repeat(blk, 4), "cpu"), k)
    h, c, counters = kernels.segmented_reduce_emulated(
        op, w, as_i32(blk, "cpu"), k, 5, scale=4)
    assert torch.equal(h, want[0]) and torch.equal(c, want[1])
    assert not counters.any()


def test_wrapper_on_cpu_takes_the_plain_version(cases):
    """On CPU tensors the wrapper is the plain version and launches
    nothing."""
    rows, ids, k = cases["ragged"]
    w, s = as_i32(rows, "cpu"), as_i32(ids, "cpu")
    kernels.reset_launches()
    got = kernels.segmented_reduce("xor", w, s, k)
    want = kernels.segmented_reduce_plain("xor", w, s, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert kernels.B1.launches == 0


def test_footprint_model_counts_the_workspace():
    """The footprint model counts B1's workspace with the heads it shares
    an allocation with, one call a bucket, on the kernel rung; none on the
    plain rung or on B5.  A pooled op group's one call over the same
    buckets needs no more."""
    from roaringbitmap_tpu_torch.insights import analysis

    sigs = [("or", 64, 16, 256, 5, False), ("or", 8, 4, 2, 2, False)]
    calls = [(q * r, q * (k + 1)) for _, q, r, k, _, _ in sigs]
    work = [4 * kernels.b1_work_words(
        rows, 2048, segs, kernels.b1_chunk_rows(rows, 2048, segs, 132))
        for rows, segs in calls]
    assert [kernels.b1_workspace_bytes(*c) for c in calls] == work
    group = kernels.b1_workspace_bytes(*map(sum, zip(*calls)))
    assert group <= sum(work)
    cuda = analysis.predict_batch_dispatch_bytes(sigs, "dense", 0, "cuda")
    assert cuda["scratch_bytes"] == 0
    assert cuda["heads_bytes"] == sum(
        segs * (analysis.ROW_BYTES + analysis.INDEX_BYTES)
        for _, segs in calls) + sum(work)
    plain = analysis.predict_batch_dispatch_bytes(sigs, "dense", 0, "torch")
    assert plain["scratch_bytes"] == sum(
        analysis.DOUBLING_BLOCKS * q * r * analysis.ROW_BYTES
        + analysis.POPCOUNT_ROWS * q * (k + 1) * analysis.ROW_BYTES
        for _, q, r, k, _, _ in sigs)
    mega = analysis.predict_batch_dispatch_bytes(sigs, "dense", 0,
                                                 "megakernel")
    assert mega["scratch_bytes"] == 0
