"""Hand-written CUDA kernels of the wide-aggregation path, with their plain
PyTorch versions and launch counts.

Each wrapper checks its tensors, then

- for tensors on the CPU, runs the kernel's plain PyTorch version;
- for tensors on a CUDA device, launches the kernel (``csrc/*.cu``, built by
  ``ops.build``) on the current stream and adds one to its launch count,
  or raises.  Nothing falls back.

| kernel | wrapper                    | TPU kernel replaced (roaringbitmap_tpu/ops/kernels.py) |
|--------|----------------------------|---------------------------------------------------------|
| B1     | ``segmented_reduce``        | ``segmented_reduce_pallas`` (any of ``ROW_WIDTHS``)    |
| B2     | ``segmented_reduce_blocked``| ``segmented_reduce_pallas_blocked``                    |
| B3     | ``densify_chunks``          | ``densify_chunks_impl`` / ``densify_chunks_pallas``    |
| B4     | ``counts_segmented_reduce`` | ``counts_segmented_reduce``                            |
| B5     | ``megakernel.raw_call``     | ``megakernel.py`` ``_kernel`` (via ``_raw_call``)      |
| B6     | ``fused_nibble_reduce``     | ``fused_nibble_reduce``                                |

Rows are int32 views of u32[2048] words (``ops.words``).  Segment ids are
sorted; id K (``num_segments``) marks padding rows, which no segment reads.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, dense
from .packing import CHUNK_VALUES
from .words import WORDS32, fold_u32, popcount

_OPCODE = {"or": 0, "and": 1, "xor": 2, "andnot": 3}

_P = ctypes.c_void_p
_I = ctypes.c_int


class KernelLaunchError(RuntimeError):
    """A CUDA kernel launch returned an error."""


class CudaKernel:
    """One hand-written kernel: its source, C entry point and launch count."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: list,
                 replaces: str):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        #: launches since the last reset, counted where the kernel launches
        self.launches = 0
        #: the same launches by variant (the row width of B1 and B2, B5's
        #: stream mode), counted by the wrapper right after its launch
        self.variants: dict = {}
        self._fn = None

    def count_variant(self, key) -> None:
        self.variants[key] = self.variants.get(key, 0) + 1

    def launch(self, *args) -> None:
        if self._fn is None:
            lib = build.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = (lib, fn)
        lib, fn = self._fn
        err = fn(*args)
        if err:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {err} "
                f"({lib.rb_error_string(err).decode()})")
        self.launches += 1


_ROW_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _P]
B1 = CudaKernel("segmented_reduce", "segmented_reduce.cu",
                "rb_segmented_reduce", _ROW_ARGS,
                "roaringbitmap_tpu/ops/kernels.py:61")
B2 = CudaKernel("segmented_reduce_blocked", "segmented_reduce.cu",
                "rb_segmented_reduce", _ROW_ARGS,
                "roaringbitmap_tpu/ops/kernels.py:116")
B3 = CudaKernel("densify_chunks", "densify_chunks.cu", "rb_densify_chunks",
                [_P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:286")
B4 = CudaKernel("counts_segmented_reduce", "counts_reduce.cu",
                "rb_counts_reduce", [_P, _P, _P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:334")
B5 = CudaKernel("megakernel", "megakernel.cu", "rb_megakernel",
                [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                "roaringbitmap_tpu/ops/megakernel.py:140")
B6 = CudaKernel("fused_nibble_reduce", "counts_reduce.cu", "rb_nibble_reduce",
                [_P, _P, _P, _P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:170")
KERNELS = (B1, B2, B3, B4, B5, B6)

#: the row widths B1 takes, in words: the full row, and the slices a mesh's
#: "lanes" axis of 2, 4 or 8 devices hands each shard
ROW_WIDTHS = (2048, 1024, 512, 256)


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0
        k.variants = {}


# ------------------------------------------------------------------ checks

def _check(name: str, t: torch.Tensor, ndim: int, last: int | None = None):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 (the u32 bit view), got {t.dtype}")
    if t.dim() != ndim or (last is not None and t.shape[-1] != last):
        raise ValueError(f"{name}: unexpected shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _on_cuda(*ts: torch.Tensor) -> bool:
    """False for CPU tensors (plain version); True for CUDA tensors on one
    device; raises for anything else."""
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on different devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return True


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def segment_ranges(seg_ids: torch.Tensor, num_segments: int, scale: int = 1):
    """Per-segment [start, end) ranges (int32) of sorted segment ids, in
    units of ``scale`` rows per id (the kernels' launch plan)."""
    seg = torch.arange(num_segments, dtype=torch.int32, device=seg_ids.device)
    starts = torch.searchsorted(seg_ids, seg, out_int32=True)
    ends = torch.searchsorted(seg_ids, seg, right=True, out_int32=True)
    if scale != 1:
        starts, ends = starts * scale, ends * scale
    return starts, ends


def _launch_rows(kernel: CudaKernel, op: str, rows: torch.Tensor,
                 starts: torch.Tensor, ends: torch.Tensor, num_segments: int):
    """One launch of B1 or B2 over rows int32[M, W] into int32[K, W] heads,
    the width W passed to the kernel and counted as the launch's variant."""
    width = int(rows.shape[1])
    heads = torch.empty((num_segments, width), dtype=torch.int32,
                        device=rows.device)
    cards = torch.zeros(num_segments, dtype=torch.int32, device=rows.device)
    if num_segments:
        kernel.launch(rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                      heads.data_ptr(), cards.data_ptr(), num_segments,
                      _OPCODE[op], width, _stream())
        kernel.count_variant(width)
    return heads, cards


# ------------------------------------------------------- B1 + B2: reduce

def segmented_reduce_plain(op: str, words: torch.Tensor, seg_ids: torch.Tensor,
                           num_segments: int):
    """Plain version of B1: ``dense.segmented_reduce`` over the sorted row
    segment ids.  andnot folds in row order, head & ~(or of the rest), which
    is what the kernel computes (the doubling pass alone would nest it).
    A segment with no rows reduces to zero, as in the kernel."""
    if num_segments == 0 or words.shape[0] == 0:
        return (words.new_zeros((num_segments, words.shape[1])),
                torch.zeros(num_segments, dtype=torch.int32,
                            device=words.device))
    starts, ends = segment_ranges(seg_ids, num_segments)
    empty = (starts == ends)[:, None]
    heads_at = starts.clamp(max=words.shape[0] - 1)
    n_steps = dense.n_steps_for(int((ends - starts).max()))
    if op != "andnot":
        heads, _ = dense.segmented_reduce(op, words, seg_ids, heads_at,
                                          n_steps)
    else:
        rest = words.clone()
        rest[starts[~empty[:, 0]].long()] = 0
        tails, _ = dense.segmented_reduce("or", rest, seg_ids, heads_at,
                                          n_steps)
        heads = words[heads_at.long()] & ~tails
    heads = torch.where(empty, 0, heads)
    return heads, popcount(heads)


def segmented_reduce(op: str, words: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int):
    """B1, ragged per-key reduce: (int32[M, W], sorted int32[M]) ->
    (int32[K, W] per-key words, int32[K] cardinalities); op is one of
    or/and/xor/andnot, applied in row order.  The row width W is one of
    ``ROW_WIDTHS``: the full 2048-word row, or the slice of it a shard of a
    mesh's "lanes" axis holds.  A segment with no rows reduces to zero."""
    if op not in _OPCODE:
        raise ValueError(f"unsupported op {op!r}")
    _check("words", words, 2)
    if words.shape[1] not in ROW_WIDTHS:
        raise ValueError(f"words: row width {words.shape[1]} is not one of "
                         f"{ROW_WIDTHS}")
    _check("seg_ids", seg_ids, 1)
    if seg_ids.shape[0] != words.shape[0]:
        raise ValueError("seg_ids must hold one id per row")
    if not _on_cuda(words, seg_ids):
        return segmented_reduce_plain(op, words, seg_ids, num_segments)
    starts, ends = segment_ranges(seg_ids, num_segments)
    return _launch_rows(B1, op, words, starts, ends, num_segments)


def segmented_reduce_blocked_plain(op: str, words: torch.Tensor,
                                   blk_seg: torch.Tensor, num_segments: int,
                                   block: int):
    """Plain version of B2: B1's plain version over the row segment ids."""
    return segmented_reduce_plain(
        op, words, torch.repeat_interleave(blk_seg, block), num_segments)


def segmented_reduce_blocked(op: str, words: torch.Tensor,
                             blk_seg: torch.Tensor, num_segments: int,
                             block: int):
    """B2, the blocked layout's reduce: rows int32[NB*block, 2048], one
    sorted segment id per block of rows.  OR/XOR only: the segment-padding
    rows are zero, which is the identity of those two ops alone."""
    if op not in ("or", "xor"):
        raise ValueError(f"blocked reduce supports or/xor only, got {op!r}")
    _check("words", words, 2, WORDS32)
    _check("blk_seg", blk_seg, 1)
    if words.shape[0] != blk_seg.shape[0] * block:
        raise ValueError("words must hold block rows per blk_seg entry")
    if not _on_cuda(words, blk_seg):
        return segmented_reduce_blocked_plain(op, words, blk_seg,
                                              num_segments, block)
    starts, ends = segment_ranges(blk_seg, num_segments, scale=block)
    return _launch_rows(B2, op, words, starts, ends, num_segments)


# ------------------------------------------------------------ B3: densify

def densify_chunks_plain(chunk_vals: torch.Tensor, chunk_row: torch.Tensor,
                         n_rows: int) -> torch.Tensor:
    """Plain version of B3: a scatter of each valid slot's bit, accumulated
    in int64 (the bits of one row are distinct, so the sum is their OR)."""
    v = chunk_vals.long() & 0xFFFFFFFF
    rows = chunk_row.long()[:, None].expand_as(v)
    ok = (v <= 0xFFFF) & (rows >= 0) & (rows < n_rows)
    v, rows = v[ok], rows[ok]
    flat = torch.zeros(n_rows * WORDS32, dtype=torch.int64,
                       device=chunk_vals.device)
    flat.index_add_(0, rows * WORDS32 + (v >> 5), 1 << (v & 31))
    return fold_u32(flat).view(n_rows, WORDS32)


def densify_chunk_bounds(chunk_row: torch.Tensor, n_rows: int) -> torch.Tensor:
    """B3's launch plan: int32[n_rows + 1] bounds over a chunk stream sorted
    by row, row r owning chunks [bounds[r], bounds[r + 1]).  Chunks of the
    scratch row n_rows, or of any row outside [0, n_rows), lie outside
    [bounds[0], bounds[n_rows])."""
    rows = torch.arange(n_rows + 1, dtype=torch.int32, device=chunk_row.device)
    return torch.searchsorted(chunk_row, rows, out_int32=True)


def densify_chunks(chunk_vals: torch.Tensor, chunk_row: torch.Tensor,
                   n_rows: int, bounds: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """B3: chunked value stream (int32[NC, 128] values, CHUNK_PAD slots;
    int32[NC] destination rows sorted ascending, n_rows = scratch) ->
    int32[n_rows, 2048] dense image.  Rows that own no chunk are zero.  The
    kernel writes every row once, so the image is not zero-filled first.
    It takes each row's chunks between two ``bounds``
    (:func:`densify_chunk_bounds`, computed here unless the caller keeps
    them, as a resident set does), so ``chunk_row`` must ascend: the packer
    emits it so, and ``DeviceBitmapSet`` sorts a state's stream when it
    loads it.  The kernel does not check the order; on the CPU the wrapper
    raises ``ValueError`` for a ``chunk_row`` that does not ascend or
    ``bounds`` that are not its plan, so that the CPU tests catch such a
    caller."""
    _check("chunk_vals", chunk_vals, 2, CHUNK_VALUES)
    _check("chunk_row", chunk_row, 1)
    if chunk_row.shape[0] != chunk_vals.shape[0]:
        raise ValueError("chunk_row must hold one row per chunk")
    if bounds is None:
        bounds = densify_chunk_bounds(chunk_row, n_rows)
    _check("bounds", bounds, 1)
    if bounds.shape[0] != n_rows + 1:
        raise ValueError("bounds must hold n_rows + 1 entries")
    if not _on_cuda(chunk_vals, chunk_row, bounds):
        if bool((chunk_row[1:] < chunk_row[:-1]).any()):
            raise ValueError("chunk_row must ascend")
        if not torch.equal(bounds, densify_chunk_bounds(chunk_row, n_rows)):
            raise ValueError("bounds are not chunk_row's launch plan")
        return densify_chunks_plain(chunk_vals, chunk_row, n_rows)
    out = torch.empty((n_rows, WORDS32), dtype=torch.int32,
                      device=chunk_vals.device)
    if n_rows:
        B3.launch(chunk_vals.data_ptr(), bounds.data_ptr(), out.data_ptr(),
                  CHUNK_VALUES, n_rows, _stream())
    return out


# ------------------------------------------------------ B4: counts reduce

def counts_segmented_reduce_plain(op: str, counts: torch.Tensor,
                                  grp_seg: torch.Tensor, num_segments: int):
    """Plain version of B4: ``dense.counts_to_words`` per group, then the
    segmented reduce over groups."""
    g = counts.shape[0]
    words = dense.counts_to_words(counts.view(g, 4, WORDS32), op)
    return segmented_reduce_plain(op, words, grp_seg, num_segments)


def counts_segmented_reduce(op: str, counts: torch.Tensor,
                            grp_seg: torch.Tensor, num_segments: int):
    """B4: wide OR/XOR off a counts-resident layout: int32[G, 4*2048]
    plane-major nibble counts with sorted group segment ids int32[G] ->
    (int32[K, 2048], int32[K])."""
    if op not in ("or", "xor"):
        raise ValueError(f"counts reduce supports or/xor only, got {op!r}")
    _check("counts", counts, 2, dense.NIBBLE_WORDS)
    _check("grp_seg", grp_seg, 1)
    if grp_seg.shape[0] != counts.shape[0]:
        raise ValueError("grp_seg must hold one id per count group")
    if not _on_cuda(counts, grp_seg):
        return counts_segmented_reduce_plain(op, counts, grp_seg, num_segments)
    starts, ends = segment_ranges(grp_seg, num_segments)
    heads = torch.empty((num_segments, WORDS32), dtype=torch.int32,
                        device=counts.device)
    cards = torch.zeros(num_segments, dtype=torch.int32, device=counts.device)
    if num_segments:
        B4.launch(counts.data_ptr(), starts.data_ptr(), ends.data_ptr(),
                  heads.data_ptr(), cards.data_ptr(), num_segments,
                  _OPCODE[op], _stream())
    return heads, cards


# ------------------------------------------------ B6: fused nibble reduce

def fused_nibble_reduce_plain(op: str, counts: torch.Tensor,
                              dense_partial: torch.Tensor,
                              grp_seg: torch.Tensor, num_segments: int):
    """Plain version of B6: B4's plain version over the count groups, then
    each segment's dense-row partial folded in with ``op``."""
    heads, _ = counts_segmented_reduce_plain(op, counts, grp_seg,
                                             num_segments)
    heads = dense.OPS[op](heads, dense_partial[:num_segments])
    return heads, popcount(heads)


def fused_nibble_reduce(op: str, counts: torch.Tensor,
                        dense_partial: torch.Tensor, grp_seg: torch.Tensor,
                        num_segments: int):
    """B6, the compact layout's fused wide OR/XOR: int32[G + 1, 4*2048]
    plane-major nibble counts with sorted group segment ids int32[G + 1]
    (the scratch group carries id K), and the per-segment dense-row
    partials int32[K + 1, 2048] -> (int32[K, 2048], int32[K]).  Each
    segment's words are its groups' count bits folded with ``op``, then
    with its partial.  OR/XOR only, as in JAX."""
    if op not in ("or", "xor"):
        raise ValueError(f"fused nibble reduce supports or/xor only, "
                         f"got {op!r}")
    _check("counts", counts, 2, dense.NIBBLE_WORDS)
    _check("dense_partial", dense_partial, 2, WORDS32)
    _check("grp_seg", grp_seg, 1)
    if grp_seg.shape[0] != counts.shape[0]:
        raise ValueError("grp_seg must hold one id per count group")
    if dense_partial.shape[0] != num_segments + 1:
        raise ValueError("dense_partial must hold K + 1 rows")
    if not _on_cuda(counts, dense_partial, grp_seg):
        return fused_nibble_reduce_plain(op, counts, dense_partial, grp_seg,
                                         num_segments)
    starts, ends = segment_ranges(grp_seg, num_segments)
    heads = torch.empty((num_segments, WORDS32), dtype=torch.int32,
                        device=counts.device)
    cards = torch.zeros(num_segments, dtype=torch.int32, device=counts.device)
    if num_segments:
        B6.launch(counts.data_ptr(), dense_partial.data_ptr(),
                  starts.data_ptr(), ends.data_ptr(), heads.data_ptr(),
                  cards.data_ptr(), num_segments, _OPCODE[op], _stream())
    return heads, cards
