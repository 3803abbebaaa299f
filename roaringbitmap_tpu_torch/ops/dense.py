"""Dense word algebra in plain PyTorch: popcount, segmented reduce, densify.

Containers live on the device as int32 views of u32[..., 2048] word rows
(``ops.words``).  These functions are the plain versions of every device op
on the wide-aggregation path, one twin for each function of
``roaringbitmap_tpu.ops.dense`` that the path uses, and they give the same
bits.  ``pairwise``, ``regular_reduce_and``, ``range_cardinality``,
``build_group_counts``, ``nibble_counts_impl`` and ``dense_partial_impl``
stay plain PyTorch on the main path, as the JAX package runs them in XLA;
the rest, ``densify_streams`` among them (B8, ``ops.kernels.row_build``),
are the references the hand-written kernels (``ops.kernels``) are held
against.

Scatter-adds that build words from distinct bits or nibble counts accumulate
in int64 and fold to the int32 view explicitly (``words.fold_u32``), so no
step relies on int32 overflow.
"""

from __future__ import annotations

import torch

from .words import WORDS32, fold_u32, popcount, srl

__all__ = [
    "OPS", "WORDS32", "NIBBLE_GROUP", "NIBBLE_WORDS", "popcount", "pairwise",
    "doubling_pass", "segmented_reduce", "regular_reduce_and",
    "range_cardinality", "n_steps_for", "densify_streams",
    "densify_streams_impl", "nibble_counts_impl", "spread_bits_to_nibbles",
    "counts_tile_to_word", "counts_to_words", "build_group_counts",
    "dense_partial_impl",
]

#: The bitwise op vocabulary of the wide path.
OPS = {
    "or": torch.bitwise_or,
    "and": torch.bitwise_and,
    "xor": torch.bitwise_xor,
    "andnot": lambda a, b: a & ~b,
}

#: Rows per nibble-count group: divides the blocked layout's block size and
#: stays below 16, so per-bit occurrence counts fit a nibble carry-free.
NIBBLE_GROUP = 8
#: int32 count words per group: 2^16 bit positions x 4 bits, plane-major
#: (plane j holds bits [8j, 8j+8) of every word).
NIBBLE_WORDS = 4 * WORDS32


def pairwise(op: str, a: torch.Tensor, b: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched pairwise container op with fused cardinality: aligned
    int32[K, 2048] payloads -> (int32[K, 2048], int32[K])."""
    out = OPS[op](a, b)
    return out, popcount(out)


def doubling_pass(fn, words: torch.Tensor, seg_ids: torch.Tensor,
                  n_steps: int) -> torch.Tensor:
    """Parallel-doubling segmented scan: afterwards row i holds the reduction
    of rows [i, i + 2^n_steps) of its own segment, so segment heads hold the
    whole segment once n_steps >= ceil(log2(max segment size)).  seg_ids
    must be sorted."""
    m = words.shape[0]
    d = 1
    for _ in range(n_steps):
        if d >= m:
            break
        shifted = torch.cat([words[d:], words.new_zeros((d, words.shape[1]))])
        same = torch.cat([seg_ids[d:] == seg_ids[:-d],
                          torch.zeros(d, dtype=torch.bool, device=words.device)])
        words = torch.where(same[:, None], fn(words, shifted), words)
        d *= 2
    return words


def segmented_reduce(op: str, words: torch.Tensor, seg_ids: torch.Tensor,
                     head_idx: torch.Tensor, n_steps: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ragged per-key reduction by parallel doubling over sorted segments:
    (int32[M, 2048], sorted int32[M]) -> (int32[K, 2048] heads, int32[K]
    cards)."""
    heads = doubling_pass(OPS[op], words, seg_ids, n_steps)[head_idx.long()]
    return heads, popcount(heads)


def regular_reduce_and(words: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Wide AND over a regular block int32[K, N, 2048] (after the key
    intersection), as a halving tree over the N axis."""
    if words.shape[1] == 0:
        out = torch.full((words.shape[0], words.shape[2]), -1,
                         dtype=torch.int32, device=words.device)
        return out, popcount(out)
    x = words
    while x.shape[1] > 1:
        n = x.shape[1]
        h = n // 2
        y = x[:, :h] & x[:, h:2 * h]
        if n % 2:
            y[:, 0] &= x[:, n - 1]
        x = y
    out = x[:, 0]
    return out, popcount(out)


def range_cardinality(words: torch.Tensor, start: torch.Tensor,
                      stop: torch.Tensor) -> torch.Tensor:
    """Popcount of bits [start, stop) of each int32[..., 2048] container
    image (start/stop broadcast against the leading axes, in [0, 2^16]).

    Each word's mask is the ``n = hi - lo`` bits above bit ``lo``, built in
    int64 so that n = 32 gives the all-ones word and nothing wraps, then
    folded to the int32 view.  A reversed range (stop < start) is empty:
    n is clamped at 0, where the JAX function's u32 cast of a negative n
    counts the whole word."""
    word_lo = torch.arange(WORDS32, dtype=torch.int64,
                           device=words.device) * 32
    lo = (start.long() - word_lo).clamp(0, 32)
    hi = (stop.long() - word_lo).clamp(0, 32)
    n = (hi - lo).clamp(min=0)
    mask = ((1 << n) - 1) << lo                # n + lo <= 32: below 2^32
    return popcount(words & fold_u32(mask), dim=-1)


def n_steps_for(max_group: int) -> int:
    return max(1, int(max(1, max_group - 1)).bit_length())


def _value_rows(val_dest: torch.Tensor, val_counts: torch.Tensor,
                total_values: int) -> torch.Tensor:
    """int64 destination row of every value in the sparse stream."""
    return torch.repeat_interleave(val_dest.long(), val_counts.long(),
                                   output_size=total_values)


def _run_words(runs, run_counts, run_dest):
    """(int64 flat word index row*2048 + word, int64 mask) of every word a
    run stream touches: ``runs`` int32[R] holds each (start, length - 1)
    u16 pair as serialized, read as one little-endian u32 (start in the low
    half), ``run_counts`` / ``run_dest`` the runs and row of each run
    container.  A run (s, l) sets bits s..s+l of its row; a word it covers
    whole gets the all-ones mask, its edge words the bits inside it."""
    dev = runs.device
    r = runs.long() & 0xFFFFFFFF
    start = r & 0xFFFF
    last = start + (r >> 16)
    rows = torch.repeat_interleave(run_dest.long(), run_counts.long(),
                                   output_size=r.shape[0])
    w0, w1 = start >> 5, last >> 5
    n = w1 - w0 + 1
    run_of = torch.repeat_interleave(torch.arange(r.shape[0], device=dev), n)
    first = torch.cumsum(n, 0) - n
    w = w0[run_of] + torch.arange(run_of.shape[0], device=dev) - first[run_of]
    lo = (start[run_of] - 32 * w).clamp(0, 31)
    hi = (last[run_of] - 32 * w).clamp(0, 31)
    mask = ((1 << (hi - lo + 1)) - 1) << lo      # under 2^32: no wrap
    return rows[run_of] * WORDS32 + w, mask


def densify_streams_impl(dense_words, dense_dest, values, val_counts, val_dest,
                         n_rows: int, total_values: int,
                         runs=None) -> torch.Tensor:
    """Build the dense int32[n_rows, 2048] container image from compact
    streams (``ops.packing.CompactStreams``, values as int32) on the device.

    Each sparse value adds its bit at flat position row*2048 + (v>>5); a run
    stream ``runs`` (int32 pairs, run counts and destination rows, as
    ``_run_words`` reads them), where given, adds the masks of the words its
    runs cover.  The adds are exact: one container a row, so (row, word,
    bit) triples are unique and sums never carry across bits.  Row n_rows
    is a scratch row for sentinel-padded entries.  This is B8's plain
    version (``ops.kernels.row_build``).
    """
    dev = values.device
    flat = torch.zeros((n_rows + 1) * WORDS32, dtype=torch.int64, device=dev)
    if total_values:
        rows = _value_rows(val_dest, val_counts, total_values)
        v = values.long()
        flat.index_add_(0, rows * WORDS32 + (v >> 5), 1 << (v & 31))
    if runs is not None and runs[0].shape[0]:
        at, mask = _run_words(*runs)
        flat.index_add_(0, at, mask)
    out = fold_u32(flat).view(n_rows + 1, WORDS32)
    if dense_words.shape[0]:
        out[dense_dest.long()] = dense_words
    return out[:n_rows]


#: PyTorch runs eagerly, so the JAX package's jitted entry and its
#: traceable body are one function here.
densify_streams = densify_streams_impl


def _nibble_counts64(values, val_counts, val_dest, n_groups: int,
                     total_values: int) -> torch.Tensor:
    flat = torch.zeros((n_groups + 1) * NIBBLE_WORDS, dtype=torch.int64,
                       device=values.device)
    if total_values:
        rows = _value_rows(val_dest, val_counts, total_values)
        v = values.long()
        g = (rows >> 3) * NIBBLE_WORDS + ((v >> 3) & 3) * WORDS32 + (v >> 5)
        flat.index_add_(0, g, 1 << (4 * (v & 7)))
    return flat.view(n_groups + 1, NIBBLE_WORDS)


def nibble_counts_impl(values, val_counts, val_dest, n_groups: int,
                       total_values: int) -> torch.Tensor:
    """Sparse streams -> int32[n_groups + 1, NIBBLE_WORDS] occurrence counts.

    Value v of destination row r adds count 1 to group r >> 3, plane
    (v >> 3) & 3, word v >> 5, nibble v & 7.  The trailing group absorbs
    sentinel-padded entries (val_dest == n_rows).
    """
    return fold_u32(_nibble_counts64(values, val_counts, val_dest, n_groups,
                                     total_values))


def spread_bits_to_nibbles(words: torch.Tensor) -> torch.Tensor:
    """int32[..., 2048] bit image -> int32[..., 4, 2048] plane-major nibble
    counts (each set bit becomes count 1)."""
    planes = []
    for j in range(4):
        b = srl(words, 8 * j) & 0xFF if j else words & 0xFF
        s = (b | (b << 12)) & 0x000F000F
        s = (s | (s << 6)) & 0x03030303
        s = (s | (s << 3)) & 0x11111111
        planes.append(s)
    return torch.stack(planes, dim=-2)


def counts_tile_to_word(c: torch.Tensor, op: str) -> torch.Tensor:
    """Plane-axis-0 nibble counts int32[4, ...] -> bit words int32[...]
    (OR: bit = count != 0; XOR: bit = count odd, the nibble's LSB)."""
    if op == "or":
        t = c | srl(c, 1)
        t = t | srl(t, 2)
        m = t & 0x11111111
    elif op == "xor":
        m = c & 0x11111111
    else:
        raise ValueError(f"counts support or/xor only, got {op!r}")
    # compress the 8 nibble flags (bits 0, 4, .., 28) into the low byte
    v = (m | srl(m, 3)) & 0x03030303
    w = (v | srl(v, 6)) & 0x000F000F
    r = (w | srl(w, 12)) & 0xFF
    # int32 << moves bits as u32 would (PyTorch shifts integers unsigned)
    return r[0] | (r[1] << 8) | (r[2] << 16) | (r[3] << 24)


def counts_to_words(counts: torch.Tensor, op: str) -> torch.Tensor:
    """int32[..., 4, 2048] plane-major nibble counts -> int32[..., 2048]."""
    return counts_tile_to_word(torch.movedim(counts, -2, 0), op)


def build_group_counts(dense_words, dense_dest, values, val_counts, val_dest,
                       n_groups: int, total_values: int) -> torch.Tensor:
    """One-time build of a counts-resident layout: sparse values add their
    nibble counts, dense-wire rows fold in through the bit -> nibble spread.
    int32[n_groups + 1, NIBBLE_WORDS]; exact, since each row adds at most
    one occurrence per bit and a group holds at most NIBBLE_GROUP rows."""
    counts = _nibble_counts64(values, val_counts, val_dest, n_groups,
                              total_values)
    if dense_words.shape[0]:
        spread = spread_bits_to_nibbles(dense_words).to(torch.int64)
        counts = counts.view(n_groups + 1, 4, WORDS32)
        counts.index_add_(0, dense_dest.long() >> 3, spread)
        counts = counts.view(n_groups + 1, NIBBLE_WORDS)
    return fold_u32(counts)


def dense_partial_impl(op: str, dense_words, dseg, head_idx, head_valid,
                       n_steps: int, num_segments: int) -> torch.Tensor:
    """Per-segment reduction of the dense-wire rows alone: int32[Md, 2048]
    with sorted int32[Md] segment ids -> int32[K + 1, 2048].  A segment
    with no dense rows (``head_valid`` False) gets a zero row; row K is the
    scratch segment's."""
    if dense_words.shape[0] == 0:
        return torch.zeros((num_segments + 1, WORDS32), dtype=torch.int32,
                           device=dense_words.device)
    red = doubling_pass(OPS[op], dense_words, dseg, n_steps)
    safe = head_idx.long().clamp(max=dense_words.shape[0] - 1)
    return torch.where(head_valid[:, None], red[safe], 0)
