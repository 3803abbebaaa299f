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
| B7     | ``stream_segmented_reduce`` | none: a set's or/xor off its value and run streams    |
| B8     | ``row_build``               | none: the dense image built once from the streams      |

Rows are int32 views of u32[2048] words (``ops.words``).  Segment ids are
sorted; id K (``num_segments``) marks padding rows, which no segment reads.

Each launch passes the bytes it must move, counted from the tensors' shapes
by the kernel's ``b*_launch_bytes`` function beside its wrapper (B5's is
``megakernel.stream_bytes``): the resident input read once, the heads and
cardinalities written once.  Workspace, partial rows and segment metadata,
which stay in L2 or are a few KiB, are left out (B7 counts its per-key
offsets, which grow with the keys, and B8 its per-row plan); padding rows
or groups of id K, which the kernels skip, are counted, since only the
shapes are read (a resident set pads fewer than 8 blocks).  While tracing is on the count
rides a ``kernel.launch`` event on the enclosing span.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
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
                 replaces: str, label: str = "", prepare: str | None = None):
        self.name = name
        #: a C entry that readies the kernel once, at load, where it has one
        self.prepare = prepare
        #: the kernel's name in the port's table (B1-B7)
        self.label = label
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.replaces = replaces
        #: launches since the last reset, counted where the kernel launches
        self.launches = 0
        #: the same launches by variant (the row width of B1 and B2, B5's
        #: stream mode), as the wrappers pass it
        self.variants: dict = {}
        self._fn = None

    def load(self) -> tuple:
        """The loaded library and C entry (building the libraries at first
        use, ``build.load``), readied by the kernel's ``prepare`` entry."""
        if self._fn is None:
            lib = build.load(self.source)
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            if self.prepare is not None:
                ready = getattr(lib, self.prepare)
                ready.argtypes, ready.restype = [], ctypes.c_int
                err = ready()
                if err:
                    raise KernelLaunchError(
                        f"{self.name}: CUDA error {err} "
                        f"({lib.rb_error_string(err).decode()})")
            self._fn = (lib, fn)
        return self._fn

    def launch(self, *args, nbytes, variant=None) -> None:
        """Launch the C entry with ``args`` and count the launch, and its
        ``variant`` where one is given.  ``nbytes`` is what the launch must
        move, or a function that counts it (called only while tracing is
        on); while tracing is on it is recorded as a ``kernel.launch``
        event (``kernel``, ``variant``, ``bytes``) on the enclosing span,
        with no wait on the card."""
        lib, fn = self.load()
        err = fn(*args)
        if err:
            raise KernelLaunchError(
                f"{self.name}: CUDA error {err} "
                f"({lib.rb_error_string(err).decode()})")
        self.launches += 1
        if variant is not None:
            self.variants[variant] = self.variants.get(variant, 0) + 1
        if obs_trace.enabled():
            obs_trace.current().event(
                "kernel.launch", kernel=self.label, variant=variant,
                bytes=int(nbytes() if callable(nbytes) else nbytes))


_CHUNK_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
B1 = CudaKernel("segmented_reduce", "segmented_reduce.cu",
                "rb_segmented_reduce_chunked", _CHUNK_ARGS,
                "roaringbitmap_tpu/ops/kernels.py:61", "B1")
B2 = CudaKernel("segmented_reduce_blocked", "segmented_reduce.cu",
                "rb_segmented_reduce_chunked", _CHUNK_ARGS,
                "roaringbitmap_tpu/ops/kernels.py:116", "B2")
B3 = CudaKernel("densify_chunks", "densify_chunks.cu", "rb_densify_chunks",
                [_P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:286", "B3")
B4 = CudaKernel("counts_segmented_reduce", "counts_reduce.cu",
                "rb_counts_reduce", [_P, _P, _P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:334", "B4")
B5 = CudaKernel("megakernel", "megakernel.cu", "rb_megakernel",
                [_P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
                "roaringbitmap_tpu/ops/megakernel.py:140", "B5")
B6 = CudaKernel("fused_nibble_reduce", "counts_reduce.cu", "rb_nibble_reduce",
                [_P, _P, _P, _P, _P, _P, _I, _I, _P],
                "roaringbitmap_tpu/ops/kernels.py:170", "B6")
B7 = CudaKernel("stream_segmented_reduce", "stream_reduce.cu",
                "rb_stream_reduce",
                [_P] * 11 + [_I, _I, _I, ctypes.c_int64, _I, _P],
                "none (no TPU kernel: the TPU streamed nibble counts or the "
                "dense image)", "B7")
B8 = CudaKernel("row_build", "row_build.cu", "rb_row_build",
                [_P] * 7 + [_I, _P],
                "none (no TPU kernel: XLA built the image by a scatter-add)",
                "B8", prepare="rb_row_build_prepare")
KERNELS = (B1, B2, B3, B4, B5, B6, B7, B8)

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
    """The current CUDA stream as a raw handle, without the
    ``torch.cuda.Stream`` object ``current_stream()`` builds (a share of
    B1's shortest calls); Triton's launcher makes the same call."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def segment_ranges(seg_ids: torch.Tensor, num_segments: int):
    """Per-segment [start, end) row ranges (int32) of sorted segment ids."""
    seg = torch.arange(num_segments, dtype=torch.int32, device=seg_ids.device)
    starts = torch.searchsorted(seg_ids, seg, out_int32=True)
    ends = torch.searchsorted(seg_ids, seg, right=True, out_int32=True)
    return starts, ends


# ----------------------------------------------------- B1: the chunk plan
#
# B1's kernel (csrc/segmented_reduce.cu) cuts the rows into chunks of R
# rows; block c folds chunk c.  A segment of at most R rows belongs whole to
# the chunk its head row lies in; a longer one is cut at the chunk edges,
# each piece a partial that the last piece to arrive folds.  The functions
# below are that plan, written once: ``b1_chunk_rows`` sizes the launch,
# ``b1_chunk_plan`` is what block c works out from the ids around it (the
# kernel does the same steps in parallel), and ``segmented_reduce_emulated``
# walks the plan on the host, blocks in any order, counters and all.

#: row loads each thread of B1 keeps in flight (csrc ``kUnroll``)
B1_UNROLL = 8
#: most rows a B1 chunk may take (csrc ``kMaxChunkRows``)
B1_MAX_CHUNK_ROWS = 1024
#: B1 blocks an SM its chunks make: two waves of resident blocks at 2,048
#: words (512 threads, two resident), one wave at the narrower widths (256
#: threads, four resident).  Twice as many where the mean segment has
#: fewer rows than a thread's batch of loads (``B1_UNROLL``): a chunk then
#: folds its many runs one after another, and smaller chunks spread them
#: over more blocks.  ``chip_smoke.py`` phase 6 times half and twice as
#: many beside the choice (PERF.md section 6)
B1_BLOCKS_PER_SM = 4

_SMS: dict = {}


def b1_block_threads(width: int) -> int:
    """Threads of one B1 block: one 16-byte column each, 256 at least."""
    return max(width // 4, 256)


def b1_chunk_rows(m: int, width: int, num_segments: int, sms: int) -> int:
    """Rows of one B1 chunk for ``m`` rows of ``width`` words in K segments
    on a card of ``sms`` SMs: enough chunks for ``B1_BLOCKS_PER_SM`` blocks
    an SM (twice as many for short segments), at least one batch of loads
    per row group, and at most ``B1_MAX_CHUNK_ROWS``."""
    groups = b1_block_threads(width) // (width // 4)
    per_sm = B1_BLOCKS_PER_SM * (2 if m < B1_UNROLL * num_segments else 1)
    return min(max(m // (per_sm * sms), B1_UNROLL * groups),
               B1_MAX_CHUNK_ROWS)


def b1_num_chunks(m: int, chunk_rows: int) -> int:
    return max(1, -(-m // chunk_rows))


def b1_work_words(m: int, width: int, num_segments: int,
                  chunk_rows: int) -> int:
    """int32 words of B1's workspace: two partial rows a chunk, then a
    counter and two chunk indices a segment."""
    return 2 * b1_num_chunks(m, chunk_rows) * width + 3 * num_segments


#: SMs of an NVIDIA H100 SXM, for sizing B1's launch where no card is seen
H100_SMS = 132


def b1_workspace_bytes(m: int, num_segments: int, width: int = WORDS32,
                       sms: int | None = None) -> int:
    """Device bytes of B1's workspace for one call over ``m`` rows and K
    segments on a card of ``sms`` SMs: the footprint model's term for B1.
    Without ``sms`` it reads the current card's SM count (an H100's where
    no card is seen), since the launch is sized by it."""
    if sms is None:
        sms = (_sm_count(torch.device("cuda")) if torch.cuda.is_available()
               else H100_SMS)
    rows = b1_chunk_rows(m, width, num_segments, sms)
    return 4 * b1_work_words(m, width, num_segments, rows)


def b1_chunk_plan(ids, num_segments: int, chunk_rows: int, c: int,
                  m: int | None = None, scale: int = 1):
    """What block ``c`` of B1 works out from the sorted ids of the rows
    around its chunk [cR, cR + R) (``ids`` one per ``scale`` rows, ``m``
    rows): the empty segments it zeroes, as ranges [a, b), and the runs it
    folds, as (segment, first row, end row, continues a piece from the chunk
    before, continues into the chunk after).  A run that continues either
    way is a piece of a split segment.

    The block sees only rows [cR - R, cR + 2R): a run whose boundary lies
    outside them has more than R rows, which is all the plan needs to
    know."""
    ids = list(map(int, ids))
    K, R = num_segments, chunk_rows
    m = len(ids) * scale if m is None else m
    last = b1_num_chunks(m, R) - 1
    lo, base = c * R, c * R - R
    hi = min(lo + R, m)

    def sid(r):
        return -1 if r < 0 else (K if r >= m else ids[r // scale])

    hr = next((r for r in range(lo, hi)
               if sid(r) == K and (r == lo or sid(r - 1) != K)), hi)
    k0 = sid(lo) if hr > lo else K
    kl = sid(hr - 1) if hr > lo else K
    s0 = sl = base - 1
    e0 = el = base + 3 * R + 1
    gaps, runs = [], []
    for r in range(base + 1, base + 3 * R):
        a, b = sid(r - 1), sid(r)
        if a == b:
            continue
        s0 = r if b == k0 else s0
        e0 = r if a == k0 else e0
        sl = r if b == kl else sl
        el = r if a == kl else el
        if b > a + 1 and (lo <= r < hi or (r == m and c == last)):
            gaps.append((a + 1, b))
    if hr <= lo:
        return gaps, runs
    before0, short0 = s0 < lo, e0 - s0 <= R
    p0 = e0 if before0 and short0 else lo
    if sl < lo:
        p1 = p0 if short0 else hr
    else:
        p1 = el if el - sl <= R else hr
    a = p0
    while a < p1:
        k, b = sid(a), a + 1
        while b < p1 and sid(b) == k:
            b += 1
        runs.append((k, a, b, a == lo and before0,
                     b == hr and hr < m and sid(hr) == k))
        a = b
    return gaps, runs


def _fold_run(op: str, rows: torch.Tensor, head: bool) -> torch.Tensor:
    """One run's value: the op over its rows; andnot with ``head`` keeps row
    0 aside, head & ~(or of the rest), and without it is the or."""
    if op == "andnot":
        rest = rows[1:] if head else rows
        acc = torch.zeros_like(rows[0])
        for r in rest:
            acc |= r
        return rows[0] & ~acc if head else acc
    fn = dense.OPS[op]
    acc = rows[0].clone()
    for r in rows[1:]:
        acc = fn(acc, r)
    return acc


def segmented_reduce_emulated(op: str, words: torch.Tensor,
                              seg_ids: torch.Tensor, num_segments: int,
                              chunk_rows: int, order=None, scale: int = 1):
    """B1's kernel walked on the host: the blocks of ``b1_chunk_plan`` run
    one after another in ``order`` (a permutation of the chunks; blocks on
    the card run in no order), each folding its runs, publishing the pieces
    of split segments and counting them in; the last piece folds the
    partials in chunk order.  Outputs start as garbage, as the kernel's
    ``torch.empty`` ones do.  Returns (heads, cards, counters): the counters
    must end at 0."""
    m, width = words.shape
    K = num_segments
    n = b1_num_chunks(m, chunk_rows)
    ids = seg_ids.tolist()
    heads = torch.full((K, width), 0x5A5A5A5A, dtype=torch.int32)
    cards = torch.full((K,), -7, dtype=torch.int32)
    partials = torch.full((2 * n, width), -1, dtype=torch.int32)
    counters = torch.zeros(K, dtype=torch.int64)
    ends = torch.full((2 * K,), -1, dtype=torch.int64)
    for c in (range(n) if order is None else order):
        gaps, runs = b1_chunk_plan(ids, K, chunk_rows, c, m, scale)
        for a, b in gaps:
            heads[a:b] = 0
            cards[a:b] = 0
        for k, a, b, before, after in runs:
            v = _fold_run(op, words[a:b], head=not before)
            if before or after:
                partials[2 * c + (0 if before else 1)] = v
                if not before:
                    ends[2 * k] = c
                if not after:
                    ends[2 * k + 1] = c
                add = 1 + (0 if before else c) - (0 if after else c + 1)
                counters[k] += add
                if counters[k] != 0:
                    continue
                cf = int(ends[2 * k]) if before else c
                cl = int(ends[2 * k + 1]) if after else c
                parts = torch.stack([partials[2 * cf + 1]]
                                    + [partials[2 * j]
                                       for j in range(cf + 1, cl + 1)])
                v = _fold_run(op, parts, head=True)
            heads[k] = v
            cards[k] = popcount(v[None])[0]
    return heads, cards, counters


def _sm_count(device: torch.device) -> int:
    """SMs of a CUDA device, read once."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


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


#: bytes of one result row and its cardinality, written once
HEAD_BYTES = 4 * WORDS32 + 4


def b1_launch_bytes(m: int, width: int, num_segments: int) -> int:
    """Bytes one B1 launch must move: ``m`` rows of ``width`` words read
    once, K heads of that width and their cardinalities written once."""
    return 4 * m * width + num_segments * (4 * width + 4)


def segmented_reduce(op: str, words: torch.Tensor, seg_ids: torch.Tensor,
                     num_segments: int):
    """B1, ragged per-key reduce: (int32[M, W], sorted int32[M]) ->
    (int32[K, W] per-key words, int32[K] cardinalities); op is one of
    or/and/xor/andnot, applied in row order.  The row width W is one of
    ``ROW_WIDTHS``: the full 2048-word row, or the slice of it a shard of a
    mesh's "lanes" axis holds.  A segment with no rows reduces to zero.
    On the card one launch of the chunked kernel."""
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
    return _launch_chunked(B1, op, words, seg_ids, num_segments)


def _launch_chunked(kernel: CudaKernel, op: str, words: torch.Tensor,
                    ids: torch.Tensor, num_segments: int,
                    chunk_rows: int | None = None, scale: int = 1):
    """One launch of the chunked kernel (B1, or B2 over blocks) over rows
    int32[M, W], one sorted id per ``scale`` rows, into int32[K, W] heads
    and int32[K] cards, the width W counted as the launch's variant.  The
    chunk rows are ``b1_chunk_rows`` unless ``chunk_rows`` forces them (the
    tests).  Heads, workspace and cards are one allocation, in that order
    (the workspace's partial rows stay 16-byte aligned): the workspace lives
    as long as the heads or the cards do."""
    m, width = words.shape
    rows = chunk_rows or b1_chunk_rows(m, width, num_segments,
                                       _sm_count(words.device))
    if not 1 <= rows <= B1_MAX_CHUNK_ROWS:
        raise ValueError(f"chunk_rows {rows} is not in [1, "
                         f"{B1_MAX_CHUNK_ROWS}]")
    k = num_segments
    head_words = k * width
    work_words = b1_work_words(m, width, k, rows) if k else 0
    buf = words.new_empty(head_words + work_words + k)
    heads = buf[:head_words].view(k, width)
    cards = buf[head_words + work_words:]
    if k:
        ptr = buf.data_ptr()
        # B2's count is B1's at 2,048 words (b2_launch_bytes)
        kernel.launch(words.data_ptr(), ids.data_ptr(), ptr,
                      ptr + 4 * (head_words + work_words), ptr + 4 * head_words,
                      m, k, _OPCODE[op], width, rows, scale, _stream(),
                      nbytes=b1_launch_bytes(m, width, k), variant=width)
    return heads, cards


def segmented_reduce_blocked_plain(op: str, words: torch.Tensor,
                                   blk_seg: torch.Tensor, num_segments: int,
                                   block: int):
    """Plain version of B2: B1's plain version over the row segment ids."""
    return segmented_reduce_plain(
        op, words, torch.repeat_interleave(blk_seg, block), num_segments)


def b2_launch_bytes(m: int, num_segments: int) -> int:
    """Bytes one B2 launch must move: the ``m`` rows of the blocked image
    read once (a segment's zero padding rows too: the kernel folds them),
    K heads and cardinalities written once."""
    return b1_launch_bytes(m, WORDS32, num_segments)


def segmented_reduce_blocked(op: str, words: torch.Tensor,
                             blk_seg: torch.Tensor, num_segments: int,
                             block: int):
    """B2, the blocked layout's reduce: rows int32[NB*block, 2048], one
    sorted segment id per block of rows.  OR/XOR only: the segment-padding
    rows are zero, which is the identity of those two ops alone.  On the
    card one launch of B1's chunked kernel, reading one id per ``block``
    rows, counted as B2's."""
    if op not in ("or", "xor"):
        raise ValueError(f"blocked reduce supports or/xor only, got {op!r}")
    _check("words", words, 2, WORDS32)
    _check("blk_seg", blk_seg, 1)
    if words.shape[0] != blk_seg.shape[0] * block:
        raise ValueError("words must hold block rows per blk_seg entry")
    if not _on_cuda(words, blk_seg):
        return segmented_reduce_blocked_plain(op, words, blk_seg,
                                              num_segments, block)
    return _launch_chunked(B2, op, words, blk_seg, num_segments, scale=block)


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


def b3_launch_bytes(n_chunks: int, n_rows: int) -> int:
    """Bytes one B3 launch must move: the chunk stream's values read once,
    the ``n_rows`` rows of the image written once."""
    return 4 * n_chunks * CHUNK_VALUES + 4 * n_rows * WORDS32


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
                  CHUNK_VALUES, n_rows, _stream(),
                  nbytes=b3_launch_bytes(chunk_vals.shape[0], n_rows))
    return out


# ------------------------------------------------------ B4: counts reduce

def counts_segmented_reduce_plain(op: str, counts: torch.Tensor,
                                  grp_seg: torch.Tensor, num_segments: int):
    """Plain version of B4: ``dense.counts_to_words`` per group, then the
    segmented reduce over groups."""
    g = counts.shape[0]
    words = dense.counts_to_words(counts.view(g, 4, WORDS32), op)
    return segmented_reduce_plain(op, words, grp_seg, num_segments)


def b4_launch_bytes(groups: int, num_segments: int) -> int:
    """Bytes one B4 launch must move: each count group's four planes
    (32 KiB) read once, K heads and cardinalities written once."""
    return 4 * groups * dense.NIBBLE_WORDS + num_segments * HEAD_BYTES


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
                  _OPCODE[op], _stream(),
                  nbytes=b4_launch_bytes(counts.shape[0], num_segments))
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


def b6_launch_bytes(groups: int, num_segments: int) -> int:
    """Bytes one B6 launch must move: the ``groups`` count groups read once
    (the scratch group, which no segment reads, left out), K dense-row
    partials read once, K heads and cardinalities written once."""
    return (4 * (groups - 1) * dense.NIBBLE_WORDS
            + num_segments * (4 * WORDS32 + HEAD_BYTES))


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
                  cards.data_ptr(), num_segments, _OPCODE[op], _stream(),
                  nbytes=b6_launch_bytes(counts.shape[0], num_segments))
    return heads, cards


# ---------------------------------------------------- B7: stream reduce
#
# B7 (csrc/stream_reduce.cu) runs a resident set's wide or/xor off the
# compact streams it keeps: block b builds key k's head in shared memory
# from the key's sparse values (and, on the dense layout, its run pairs),
# folds in its dense-wire rows and writes the head once.  What it reads of a
# key is one contiguous range of each stream, so the streams must be sorted
# by destination row and the rows must lie in key order, as the blocked
# layout puts them.  The ranges are planned once, on the host, when a set is
# loaded: ``stream_reduce_plan``.  A plan with run offsets (``roff``)
# launches the kernel's run variant, which also reads the values 16 bytes at
# a time; one without, the counts layout's.

#: most bytes one B7 block reads for a key (4 a value or a run pair, 8,192 a
#: dense-wire row); a heavier key is cut into pieces of at most this many
#: bytes each, and the last of its pieces to finish folds the others'
#: partial heads
B7_PIECE_BYTES = 1 << 18
#: bytes of one dense-wire row
_ROW_BYTES = 4 * WORDS32
#: int64 columns of B7's piece table: the key, its value range [v0, v1),
#: its dense-row range [d0, d1), the key's first piece, the key's piece
#: count and the key's counter (csrc ``kPieceCols``)
B7_PIECE_COLS = 8
#: the run variant's piece table: the same columns, then the run range
#: [r0, r1) (csrc ``kRunPieceCols``)
B7_RUN_PIECE_COLS = 10


@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """B7's per-key metadata: ``voff`` int64[K + 1] and ``doff`` int32[K + 1],
    each key's value and dense-row offsets into the streams; ``pieces``
    int64[P, B7_PIECE_COLS], the pieces of the keys that read more than
    ``piece_bytes`` (the first ``n_split`` keys' counters); ``values`` and
    ``dense_rows``, what the keys read in all.  A plan of a run stream also
    holds ``roff`` int64[K + 1], each key's run-pair offsets, and ``runs``,
    the pairs the keys read; its pieces have B7_RUN_PIECE_COLS columns."""

    voff: torch.Tensor
    doff: torch.Tensor
    pieces: torch.Tensor
    n_split: int
    piece_bytes: int
    values: int
    dense_rows: int
    roff: torch.Tensor | None = None
    runs: int = 0

    def to(self, device) -> "StreamPlan":
        return dataclasses.replace(
            self, voff=self.voff.to(device), doff=self.doff.to(device),
            pieces=self.pieces.to(device),
            roff=None if self.roff is None else self.roff.to(device))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.voff, self.doff, self.pieces, self.roff)
                   if t is not None)


def _key_offsets(dest: np.ndarray, row_seg: np.ndarray, k: int) -> np.ndarray:
    """int64[K + 1] offsets of each key's entries in a stream whose entries
    go to rows ``dest`` (row n_rows, the scratch row, belongs to no key);
    the keys must ascend along the stream."""
    seg = np.append(np.asarray(row_seg, np.int64), k)[np.asarray(dest,
                                                                 np.int64)]
    if seg.size and np.any(np.diff(seg) < 0):
        raise ValueError("B7 needs the stream sorted by destination row, "
                         "with the rows in key order")
    return np.searchsorted(seg, np.arange(k + 1)).astype(np.int64)


def _entry_offsets(counts, dest, row_seg, k: int) -> np.ndarray:
    """int64[K + 1] offsets of each key's entries in a stream of
    ``counts[i]`` entries to row ``dest[i]``."""
    ends = np.concatenate(([0], np.cumsum(np.asarray(counts, np.int64))))
    return ends[_key_offsets(dest, row_seg, k)]


def stream_reduce_plan(val_counts, val_dest, dense_dest, row_seg,
                       num_segments: int,
                       piece_bytes: int = B7_PIECE_BYTES,
                       run_counts=None, run_dest=None) -> StreamPlan:
    """B7's plan of host NumPy streams (``val_counts`` / ``val_dest`` per
    sparse container, ``dense_dest`` per dense-wire row, and where given
    ``run_counts`` / ``run_dest`` per run container) over rows whose key is
    ``row_seg`` (K on padding rows): each key's value range (its containers'
    values, in order), dense-row range and run range, and the pieces of
    every key that reads more than ``piece_bytes``: value pieces of up to
    ``piece_bytes // 4`` values, then run pieces of up to ``piece_bytes //
    4`` pairs, then dense pieces of up to ``piece_bytes // 8192`` rows (at
    least one each).  CPU tensors; ``StreamPlan.to`` moves them."""
    k = num_segments
    voff = _entry_offsets(val_counts, val_dest, row_seg, k)
    doff = _key_offsets(dense_dest, row_seg, k)
    with_runs = run_counts is not None
    roff = (_entry_offsets(run_counts, run_dest, row_seg, k) if with_runs
            else np.zeros(k + 1, np.int64))
    work = 4 * np.diff(voff) + 4 * np.diff(roff) + _ROW_BYTES * np.diff(doff)
    per_v = max(1, piece_bytes // 4)
    per_d = max(1, piece_bytes // _ROW_BYTES)
    heavy = np.flatnonzero(work > piece_bytes)
    rows = []
    for c, key in enumerate(heavy.tolist()):
        v0, v1, d0, d1, r0, r1 = (int(voff[key]), int(voff[key + 1]),
                                  int(doff[key]), int(doff[key + 1]),
                                  int(roff[key]), int(roff[key + 1]))
        cuts = ([(a, min(a + per_v, v1), d0, d0, r0, r0)
                 for a in range(v0, v1, per_v)]
                + [(v1, v1, d0, d0, a, min(a + per_v, r1))
                   for a in range(r0, r1, per_v)]
                + [(v1, v1, a, min(a + per_d, d1), r1, r1)
                   for a in range(d0, d1, per_d)])
        first = len(rows)
        rows += [(key, *cut[:4], first, len(cuts), c, *cut[4:])
                 for cut in cuts]
    cols = B7_RUN_PIECE_COLS if with_runs else B7_PIECE_COLS
    pieces = np.array([r[:cols] for r in rows], np.int64).reshape(-1, cols)
    return StreamPlan(
        voff=torch.from_numpy(voff), doff=torch.from_numpy(doff.astype(
            np.int32)), pieces=torch.from_numpy(pieces),
        n_split=int(heavy.size), piece_bytes=int(piece_bytes),
        values=int(voff[k]), dense_rows=int(doff[k]),
        roff=torch.from_numpy(roff) if with_runs else None,
        runs=int(roff[k]))


#: device types on which a dense set built from its streams keeps them,
#: with B7's plan, for its or/xor where ``dense_streams_win``: the card,
#: where the kernel engines run B7.  Elsewhere they run plain versions and
#: "auto" resolves to "torch", which reads the image.
DENSE_STREAM_DEVICES = ("cuda",)


def dense_streams_win(values: int, run_pairs: int, dense_rows: int,
                      image_rows: int) -> bool:
    """The dense layout's choice of its or/xor: True where B7's run variant
    reads at most half the bytes B2 reads of the image (both write the same
    heads).  B7 reads 4 bytes a value and a run pair and 8 KiB a dense-wire
    row; B2 8 KiB a row of the ``image_rows`` in blocks of a key (it skips
    the padding blocks).  The half, not the whole: B7 scatters with shared
    atomics and folds a key's dense rows in one block, B2 streams rows at
    ~88% of HBM's bandwidth, and on an H100 B2 is the faster of the two
    where B7 reads 0.81-1.0 of its bytes, B7 where it reads 0.49."""
    return (2 * (4 * (values + run_pairs) + _ROW_BYTES * dense_rows)
            <= _ROW_BYTES * image_rows)


def stream_segmented_reduce_plain(op: str, dense_words, dense_dest, values,
                                  val_counts, val_dest, seg_ids,
                                  num_segments: int, runs=None):
    """Plain version of B7: the streams densified into the row image
    (``dense.densify_streams``, with the run triple ``runs`` where given),
    then B1's plain version over the rows' segment ids."""
    words = dense.densify_streams(dense_words, dense_dest, values, val_counts,
                                  val_dest, seg_ids.shape[0],
                                  values.shape[0], runs=runs)
    return segmented_reduce_plain(op, words, seg_ids, num_segments)


def stream_segmented_reduce_emulated(op: str, values, dense_words,
                                     plan: StreamPlan, num_segments: int,
                                     order=None, runs=None):
    """B7's kernel walked on the host: blocks 0..P-1 take the pieces, block
    P + k takes key k unless the key reads more than ``plan.piece_bytes``,
    in ``order`` (a permutation of the blocks; on the card they run in no
    order).  A piece publishes its partial head and counts itself in; the
    last of a key's pieces folds the others' partials into its own.
    ``runs`` is the int32 pair stream of a plan with run offsets.  Outputs
    start as garbage, as the kernel's ``torch.empty`` ones do.  Returns
    (heads, cards, counters): each counter ends at its key's piece count."""
    fn = dense.OPS[op]
    k, p = num_segments, plan.pieces.shape[0]
    heads = torch.full((k, WORDS32), 0x5A5A5A5A, dtype=torch.int32)
    cards = torch.full((k,), -7, dtype=torch.int32)
    partials = torch.full((p, WORDS32), -1, dtype=torch.int32)
    counters = torch.zeros(plan.n_split, dtype=torch.int64)
    voff, doff = plan.voff.tolist(), plan.doff.tolist()
    roff = [0] * (k + 1) if plan.roff is None else plan.roff.tolist()
    for b in (range(p + k) if order is None else order):
        if b < p:
            key, v0, v1, d0, d1, first, count, ctr, *rr = \
                plan.pieces[b].tolist()
            r0, r1 = rr or (0, 0)
        else:
            key = b - p
            v0, v1, d0, d1 = voff[key], voff[key + 1], doff[key], doff[key + 1]
            r0, r1 = roff[key], roff[key + 1]
            if (4 * (v1 - v0) + 4 * (r1 - r0) + _ROW_BYTES * (d1 - d0)
                    > plan.piece_bytes):
                continue
        acc = _b7_block_head(values[v0:v1], dense_words[d0:d1], fn,
                             None if runs is None else runs[r0:r1])
        if b < p:
            partials[b] = acc
            counters[ctr] += 1
            if counters[ctr] != count:
                continue
            for q in range(first, first + count):
                if q != b:
                    acc = fn(acc, partials[q])
        heads[key] = acc
        cards[key] = popcount(acc[None])[0]
    return heads, cards, counters


def _b7_block_head(values, dense_words, fn, runs=None) -> torch.Tensor:
    """One block's head of B7: the runs' bits (int32 pairs ``runs``, where
    given) and the values' bits set (or) or toggled (xor) in a zero row, then
    the dense rows folded in with ``fn``."""
    bits = torch.zeros(WORDS32 * 32, dtype=torch.int64)
    v = values.long() & 0xFFFF
    if runs is not None and runs.shape[0]:
        r = runs.long() & 0xFFFFFFFF
        start = r & 0xFFFF
        lens = (r >> 16) + 1
        at = torch.repeat_interleave(start - torch.cumsum(lens, 0) + lens,
                                     lens) + torch.arange(int(lens.sum()))
        v = torch.cat([at, v])
    if fn is torch.bitwise_xor:
        bits.index_add_(0, v, torch.ones_like(v))
        bits &= 1
    else:
        bits[v] = 1
    acc = fold_u32((bits.view(WORDS32, 32)
                    << torch.arange(32, dtype=torch.int64)).sum(1))
    for row in dense_words:
        acc = fn(acc, row)
    return acc


def b7_launch_bytes(values: int, dense_rows: int, num_segments: int,
                    runs: int | None = None) -> int:
    """Bytes one B7 launch must move: the keys' values (4 bytes each) and
    dense-wire rows (8 KiB each) read once, the per-key offsets (int64 value
    and int32 dense-row offsets, K + 1 each) read once, K heads and
    cardinalities written once; for the run variant (``runs`` given, 0
    included) also the run pairs (4 bytes each) and the int64 run offsets.
    A heavy key's partial heads, in L2, are left out."""
    out = (4 * values + _ROW_BYTES * dense_rows + 12 * (num_segments + 1)
           + num_segments * HEAD_BYTES)
    if runs is not None:
        out += 4 * runs + 8 * (num_segments + 1)
    return out


def stream_segmented_reduce(op: str, dense_words, dense_dest, values,
                            val_counts, val_dest, seg_ids,
                            plan: StreamPlan, num_segments: int, runs=None):
    """B7, a resident set's wide OR/XOR off its resident streams: the
    compact streams (``dense_words`` int32[Md, 2048], ``dense_dest``,
    ``values`` int32[V], ``val_counts``, ``val_dest``) sorted by
    destination row, the rows' sorted segment ids int32[n_rows] and their
    ``stream_reduce_plan`` -> (int32[K, 2048], int32[K]).  A plan with run
    offsets also reads ``runs``, the triple of int32[R] pairs, runs per
    container and destination rows, sorted the same way.  On the card one
    launch, which reads only the values, the run pairs, the dense-wire rows
    and the plan; on the CPU the plain version, which reads the streams and
    not the plan."""
    if op not in ("or", "xor"):
        raise ValueError(f"stream reduce supports or/xor only, got {op!r}")
    # the kernel reads the values, the run pairs, the dense rows and the
    # plan alone: the other streams are checked where the plain version
    # reads them
    _check("values", values, 1)
    _check("dense_words", dense_words, 2, WORDS32)
    if plan.voff.shape[0] != num_segments + 1:
        raise ValueError("plan must hold K + 1 offsets")
    if plan.runs and runs is None:
        raise ValueError("the plan reads a run stream; none was given")
    if runs is not None:
        _check("runs", runs[0], 1)
    if not _on_cuda(values, dense_words, plan.voff, *(runs or ())[:1]):
        for name, t in (("dense_dest", dense_dest), ("val_counts", val_counts),
                        ("val_dest", val_dest), ("seg_ids", seg_ids),
                        *zip(("run_counts", "run_dest"), (runs or ())[1:])):
            _check(name, t, 1)
        return stream_segmented_reduce_plain(
            op, dense_words, dense_dest, values, val_counts, val_dest,
            seg_ids, num_segments, runs=runs)
    with_runs = plan.roff is not None
    if with_runs and values.data_ptr() % 16:
        raise ValueError("the run variant reads values 16 bytes at a time: "
                         "they must be 16-byte aligned")
    k, p = num_segments, plan.pieces.shape[0]
    head_words, part_words = k * WORDS32, p * WORDS32
    buf = values.new_empty(head_words + part_words + k + plan.n_split)
    heads = buf[:head_words].view(k, WORDS32)
    cards = buf[head_words + part_words:head_words + part_words + k]
    if k:
        ptr = buf.data_ptr()
        B7.launch(values.data_ptr(), plan.voff.data_ptr(),
                  dense_words.data_ptr(), plan.doff.data_ptr(),
                  plan.pieces.data_ptr(), ptr, cards.data_ptr(),
                  ptr + 4 * head_words,
                  ptr + 4 * (head_words + part_words + k),
                  runs[0].data_ptr() if runs is not None else None,
                  plan.roff.data_ptr() if with_runs else None,
                  k, p, plan.n_split, plan.piece_bytes, _OPCODE[op],
                  _stream(),
                  nbytes=b7_launch_bytes(plan.values, plan.dense_rows, k,
                                         plan.runs if with_runs else None))
    return heads, cards


# ------------------------------------------------------- B8: row build
#
# B8 (csrc/row_build.cu) builds the dense int32[n_rows, 2048] image of a
# set's compact streams once: block r builds row r in shared memory from the
# row's dense-wire row, runs and values, and stores it whole.  What it reads
# of a row is one contiguous range of the value and of the run stream, so
# both must be sorted by destination row, as the packer emits them; the
# ranges are planned from the sorted destinations (``row_build_plan``), on
# the host by a resident set's build, on the device by the other callers.


@dataclasses.dataclass(frozen=True)
class RowPlan:
    """B8's per-row metadata: ``voff`` and ``roff`` int64[n_rows + 1], each
    row's range of the value and of the run stream; ``drow`` int32[n_rows],
    the dense-wire row copied into each row (-1: none); ``values``, ``runs``
    and ``dense_rows``, what the rows read in all."""

    voff: torch.Tensor
    roff: torch.Tensor
    drow: torch.Tensor
    values: int
    runs: int
    dense_rows: int

    def to(self, device) -> "RowPlan":
        return dataclasses.replace(
            self, voff=self.voff.to(device), roff=self.roff.to(device),
            drow=self.drow.to(device))


def _row_offsets(counts: torch.Tensor, dest: torch.Tensor,
                 n_rows: int) -> torch.Tensor:
    """int64[n_rows + 1] offsets of each row's entries in a stream of
    ``counts[i]`` entries to row ``dest[i]``, ``dest`` ascending; entries of
    the scratch row ``n_rows`` lie past the last offset."""
    ends = torch.zeros(counts.shape[0] + 1, dtype=torch.int64,
                       device=counts.device)
    torch.cumsum(counts.long(), 0, out=ends[1:])
    rows = torch.arange(n_rows + 1, dtype=dest.dtype, device=dest.device)
    return ends[torch.searchsorted(dest, rows)]


def row_build_plan(val_counts: torch.Tensor, val_dest: torch.Tensor,
                   dense_dest: torch.Tensor, n_rows: int,
                   run_counts: torch.Tensor | None = None,
                   run_dest: torch.Tensor | None = None) -> RowPlan:
    """B8's plan of the streams' destinations (tensors on one device;
    ``run_counts`` and ``run_dest`` where there is a run stream).  On the
    CPU it raises ``ValueError`` for a value or run stream not sorted by
    destination row; on the card it does not check."""
    dev = val_dest.device
    if run_counts is None:
        run_counts, run_dest = val_counts[:0], val_dest[:0]
    if dev.type == "cpu":
        for name, d in (("val_dest", val_dest), ("run_dest", run_dest)):
            if bool((d[1:] < d[:-1]).any()):
                raise ValueError(f"B8 needs {name} sorted by row")
    voff = _row_offsets(val_counts, val_dest, n_rows)
    roff = _row_offsets(run_counts, run_dest, n_rows)
    # padding rows of the stream go to the scratch slot n_rows, dropped
    md = dense_dest.shape[0]
    drow = torch.full((n_rows + 1,), -1, dtype=torch.int32, device=dev)
    drow[dense_dest.long().clamp(0, n_rows)] = torch.arange(
        md, dtype=torch.int32, device=dev)
    return RowPlan(voff=voff, roff=roff, drow=drow[:n_rows].contiguous(),
                   values=int(voff[-1]), runs=int(roff[-1]),
                   dense_rows=int((drow[:n_rows] >= 0).sum()))


def b8_launch_bytes(rows: int, values: int, run_pairs: int,
                    dense_rows: int) -> int:
    """Bytes the image's build needs to move, whatever builds it: the
    ``rows`` image rows written once (8 KiB each), and the serialized
    payload read once: 2 bytes a value (its u16), 4 a run pair, 8 KiB a
    dense-wire row.  The kernel reads more, each value as an int32 and a
    plan of 20 bytes a row, which this count leaves out: a share of the
    bound is of the needed bytes."""
    return (_ROW_BYTES * (rows + dense_rows) + 2 * values + 4 * run_pairs)


class LaunchTimer:
    """The device seconds of the launches made inside ``around()``, from a
    pair of CUDA events recorded on the current stream around each.
    ``observe`` reads them once the caller has synchronised the card, and
    records each in ``rb_kernel_seconds{kernel}``: for a kernel that runs
    outside any traced window, as a set's build does."""

    def __init__(self, kernel: str):
        self.kernel = kernel
        self._events: list = []

    @contextlib.contextmanager
    def around(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self._events.append((start, end))

    def observe(self) -> None:
        for start, end in self._events:
            obs_metrics.histogram("rb_kernel_seconds", kernel=self.kernel
                                  ).observe(start.elapsed_time(end) / 1e3)
        self._events.clear()


def row_build(dense_words, dense_dest, values, val_counts, val_dest,
              n_rows: int, total_values: int, runs=None,
              plan: RowPlan | None = None,
              timer: LaunchTimer | None = None) -> torch.Tensor:
    """B8: compact streams (``dense_words`` int32[Md, 2048] to rows
    ``dense_dest``; ``values`` int32[V] in ``val_counts`` pieces to rows
    ``val_dest``; ``runs``, where given, the triple of int32[R] pairs as
    ``dense._run_words`` reads them, runs per container and destination
    rows) -> the int32[n_rows, 2048] image, one container a row.  Entries of
    row ``n_rows`` (padding) are dropped.  On the card one launch writes
    every row once into ``torch.empty``, under ``plan``
    (``row_build_plan``, made here unless the caller made it) and inside
    ``timer.around()`` where a timer is given; on the CPU (and on the
    ``meta`` device, which has no kernels) the plain version
    (``dense.densify_streams_impl``), which reads no plan."""
    _check("dense_words", dense_words, 2, WORDS32)
    _check("values", values, 1)
    for name, t in (("dense_dest", dense_dest), ("val_counts", val_counts),
                    ("val_dest", val_dest)):
        _check(name, t, 1)
    for name, t in zip(("runs", "run_counts", "run_dest"), runs or ()):
        _check(name, t, 1)
    if values.device.type == "meta" or not _on_cuda(
            dense_words, values, val_dest, *(runs or ())):
        return dense.densify_streams_impl(dense_words, dense_dest, values,
                                          val_counts, val_dest, n_rows,
                                          total_values, runs=runs)
    if plan is None:
        plan = row_build_plan(val_counts, val_dest, dense_dest, n_rows,
                              *(runs or (None,))[1:])
    if plan.voff.shape[0] != n_rows + 1:
        raise ValueError("plan must hold n_rows + 1 offsets")
    out = torch.empty((n_rows, WORDS32), dtype=torch.int32,
                      device=values.device)
    if n_rows:
        run_ptr = runs[0].data_ptr() if runs is not None else 0
        with timer.around() if timer is not None else contextlib.nullcontext():
            B8.launch(dense_words.data_ptr(), plan.drow.data_ptr(),
                      values.data_ptr(), plan.voff.data_ptr(), run_ptr,
                      plan.roff.data_ptr(), out.data_ptr(), n_rows, _stream(),
                      nbytes=b8_launch_bytes(n_rows, plan.values, plan.runs,
                                             plan.dense_rows))
    return out


def row_build_emulated(dense_words, values, runs, plan: RowPlan,
                       n_rows: int) -> torch.Tensor:
    """B8's kernel walked on the host, block by block: a row with no values
    and no runs is its dense-wire row or zeros, stored straight; any other
    starts as that and takes each run's word masks (a word the run covers
    whole stored, an edge word ORed) and each value's bit.  ``runs`` is the
    int32 pair stream (or None).  Rows start as garbage, as the kernel's
    ``torch.empty`` output does."""
    out = torch.full((n_rows, WORDS32), 0x5A5A5A5A, dtype=torch.int32)
    voff, roff, drow = (plan.voff.tolist(), plan.roff.tolist(),
                        plan.drow.tolist())
    for r in range(n_rows):
        row = (dense_words[drow[r]].clone() if drow[r] >= 0
               else torch.zeros(WORDS32, dtype=torch.int32))
        acc = (row.long() & 0xFFFFFFFF).tolist()
        for p in ([] if runs is None else runs[roff[r]:roff[r + 1]].tolist()):
            p &= 0xFFFFFFFF
            lo_bit, hi_bit = p & 0xFFFF, min((p & 0xFFFF) + (p >> 16), 65535)
            for w in range(lo_bit >> 5, (hi_bit >> 5) + 1):
                lo = max(lo_bit - 32 * w, 0)
                hi = min(hi_bit - 32 * w, 31)
                m = (0xFFFFFFFF >> (31 - hi)) & (0xFFFFFFFF << lo) & 0xFFFFFFFF
                acc[w] = m if m == 0xFFFFFFFF else acc[w] | m
        for v in values[voff[r]:voff[r + 1]].tolist():
            v &= 0xFFFF
            acc[v >> 5] |= 1 << (v & 31)
        out[r] = fold_u32(torch.tensor(acc, dtype=torch.int64))
    return out
