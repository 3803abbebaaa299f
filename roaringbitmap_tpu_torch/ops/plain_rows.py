"""The dense image of a set's compact streams, by its definition, in plain
torch: the reference B8 (``ops.kernels.row_build``) and the plain route
(``ops.dense.densify_streams_impl``) are held against.

It imports nothing of the port and nothing of JAX.  A row of the image is
the 65,536 bits of one container, held as 2,048 int32 words with the bits
of the u32 words (bit ``b`` of a row is bit ``b & 31`` of word ``b >> 5``):

- a value ``v`` of the value stream sets bit ``v`` of its row;
- a run ``(s, l)`` of the run stream (the u16 start and length - 1 as
  serialized, read as one little-endian u32 with the start in the low half)
  sets bits ``s`` to ``s + l`` of its row;
- a dense-wire row is copied into its row.

Entries destined to rows outside ``[0, n_rows)`` are dropped.  Rows are
built ``block_rows`` at a time as a bit matrix, runs through a running sum
of +1 at each start and -1 after each end, so the memory is bounded at any
image size.  The one departure from a float32 forward pass: a bitmap set has
no tolerance, so whatever is compared with this is compared bit for bit.
"""

from __future__ import annotations

import torch

WORDS = 2048
BITS = 1 << 16


def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 with the same 32 bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def build_rows(dense_words: torch.Tensor, dense_dest: torch.Tensor,
               values: torch.Tensor, val_counts: torch.Tensor,
               val_dest: torch.Tensor, n_rows: int, runs=None,
               block_rows: int = 64) -> torch.Tensor:
    """int32[n_rows, 2048] image of the streams (CPU tensors): ``values``
    in ``val_counts`` pieces to rows ``val_dest``, ``runs`` the triple
    (int32 pairs, runs per container, destination rows) or None, and
    ``dense_words`` int32[Md, 2048] to rows ``dense_dest``."""
    v_rows = torch.repeat_interleave(val_dest.long(), val_counts.long())
    v_bits = values.long()[:v_rows.shape[0]] & 0xFFFF
    if runs is None:
        r_rows = r_lo = r_hi = torch.zeros(0, dtype=torch.int64)
    else:
        pairs, run_counts, run_dest = runs
        p = pairs.long() & 0xFFFFFFFF
        r_rows = torch.repeat_interleave(run_dest.long(), run_counts.long())
        r_lo = p & 0xFFFF
        r_hi = r_lo + (p >> 16)
    weights = torch.ones(32, dtype=torch.int64) << torch.arange(32)
    out = torch.zeros((n_rows, WORDS), dtype=torch.int32)
    for r0 in range(0, n_rows, block_rows):
        r1 = min(r0 + block_rows, n_rows)
        m = r1 - r0
        step = torch.zeros((m, BITS + 1), dtype=torch.int8)
        sel = (r_rows >= r0) & (r_rows < r1)
        rows = r_rows[sel] - r0
        step.index_put_((rows, r_lo[sel]), torch.ones_like(rows,
                        dtype=torch.int8), accumulate=True)
        step.index_put_((rows, r_hi[sel] + 1), -torch.ones_like(
            rows, dtype=torch.int8), accumulate=True)
        bits = torch.cumsum(step, dim=1, dtype=torch.int8)[:, :BITS] > 0
        sel = (v_rows >= r0) & (v_rows < r1)
        bits[v_rows[sel] - r0, v_bits[sel]] = True
        words = (bits.view(m, WORDS, 32).long() * weights).sum(dim=2)
        out[r0:r1] = _to_int32(words)
    ok = (dense_dest >= 0) & (dense_dest < n_rows)
    out[dense_dest[ok].long()] = dense_words[ok]
    return out
