"""Host -> device packing: the group-by-key rotation, vectorized (NumPy).

N bitmaps are rotated into key -> containers, the reference's
ParallelAggregation.groupByKey, and emitted as flat fixed-shape arrays:

  words    u32[M, 2048]   every container densified to its 2^16-bit image
  seg_ids  i32[M]         index into the distinct-key axis, sorted ascending
  head_idx i32[K]         first row of each segment
  keys     [K]            distinct container keys, sorted: u16 on the
                          32-bit tier, u64 (u48 keys) on the 64-bit tier

or, for the blocked layouts, as compact transfer streams that the device
densifies (``pack_blocked_compact``).  This is the NumPy path of
``roaringbitmap_tpu.ops.packing``; it produces the same arrays, array for
array.  The device tensors are built from these arrays by the callers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

from ..core import containers as C
from ..core.bitmap import RoaringBitmap
from ..core.containers import ARRAY_MAX_SIZE, WORDS_PER_CONTAINER
from ..format import spec
from ..format.spec import InvalidRoaringFormat, validate_runs

WORDS32 = 2 * WORDS_PER_CONTAINER  # 2048 u32 words per container


def next_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (int(n - 1).bit_length())


def container_words_u32(c) -> np.ndarray:
    """Dense u32[2048] image of one container (little-endian word split)."""
    return c.words().view(np.uint32)


def _expand_runs_batch(run_arrays: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """Interleaved (start, len-1) u16 arrays -> (concatenated member values
    i64, per-container value counts i64), with one cumsum over the whole run
    stream.  Every input array must be non-empty."""
    starts = np.concatenate([r[0::2] for r in run_arrays]).astype(np.int64)
    lens = np.concatenate([r[1::2] for r in run_arrays]).astype(np.int64) + 1
    n_runs = np.array([r.size // 2 for r in run_arrays], dtype=np.int64)
    deltas = np.ones(int(lens.sum()), dtype=np.int64)
    ends = np.cumsum(lens)
    deltas[0] = starts[0]
    deltas[ends[:-1]] = starts[1:] - (starts[:-1] + lens[:-1] - 1)
    values = np.cumsum(deltas)
    run_heads = np.concatenate(([0], np.cumsum(n_runs)[:-1]))
    counts = np.add.reduceat(lens, run_heads)
    return values, counts


#: Containers per packbits scatter chunk: the scatter is random-access within
#: the bit buffer, so the buffer stays cache-resident (16 * 64 KiB = 1 MiB).
_PACK_CHUNK = 16


def densify_containers(conts: list, dest, n_rows: int) -> np.ndarray:
    """Dense u32[n_rows, 2048] image of a container list: conts[i] lands in
    row dest[i], the remaining rows stay zero.  Bitmap containers are one
    stacked row assignment, array and run containers one packbits scatter
    per _PACK_CHUNK containers."""
    out = np.zeros((n_rows, WORDS32), dtype=np.uint32)
    if not conts:
        return out
    dest = np.asarray(dest, dtype=np.int64)
    bm_rows: list[int] = []
    bm_words: list[np.ndarray] = []
    run_rows: list[int] = []
    run_arrays: list[np.ndarray] = []
    scatter: list[tuple[int, np.ndarray]] = []  # (row, member values)
    for r, c in zip(dest, conts):
        if isinstance(c, C.BitmapContainer):
            bm_rows.append(r)
            bm_words.append(c.words())
        elif isinstance(c, C.RunContainer):
            if c.runs.size:  # empty run container: row stays zero
                run_rows.append(r)
                run_arrays.append(c.runs)
        else:
            scatter.append((r, c.values()))
    if bm_rows:
        out[np.asarray(bm_rows)] = np.stack(bm_words).view(np.uint32)
    if run_arrays:
        values, counts = _expand_runs_batch(run_arrays)
        pieces = np.split(values, np.cumsum(counts)[:-1])
        scatter.extend(zip(run_rows, pieces))
    buf = np.empty(_PACK_CHUNK << 16, dtype=np.uint8)
    for lo in range(0, len(scatter), _PACK_CHUNK):
        chunk = scatter[lo:lo + _PACK_CHUNK]
        k = len(chunk)
        sizes = np.array([v.size for _, v in chunk], dtype=np.int64)
        flat = (np.repeat(np.arange(k, dtype=np.int64) << 16, sizes)
                + np.concatenate([v for _, v in chunk]))
        bits = buf[:k << 16]
        bits[:] = 0
        bits[flat] = 1
        packed = np.packbits(bits, bitorder="little").view(np.uint32)
        out[np.asarray([r for r, _ in chunk])] = packed.reshape(k, WORDS32)
    return out


@dataclass
class PackedAggregation:
    """One wide-aggregation problem, rotated and densified."""

    keys: np.ndarray          # [K] distinct keys, sorted (u16 or u64)
    words: np.ndarray         # u32[M_pad, 2048]; rows >= M are zero
    seg_ids: np.ndarray       # i32[M_pad]; padding rows get segment K
    head_idx: np.ndarray      # i32[K] first row of each segment
    seg_sizes: np.ndarray     # i32[K]
    m: int                    # true row count
    max_group: int            # largest segment size

    @property
    def num_keys(self) -> int:
        return int(self.keys.size)


def pack_for_aggregation(bitmaps: list[RoaringBitmap],
                         pad_rows: bool = True) -> PackedAggregation:
    """Rotate + densify N bitmaps for a wide OR/XOR (ragged segments)."""
    all_keys = [b.keys for b in bitmaps]
    flat_keys = np.concatenate(all_keys) if all_keys else np.empty(0, np.uint16)
    order = np.argsort(flat_keys, kind="stable")
    keys, seg_of_row = np.unique(flat_keys, return_inverse=True)
    m = flat_keys.size

    conts = [c for b in bitmaps for c in b.containers]
    m_pad = next_pow2(m) if pad_rows else m
    words = densify_containers([conts[s] for s in order], np.arange(m), m_pad)

    seg_ids = np.full(m_pad, keys.size, dtype=np.int32)
    seg_ids[:m] = seg_of_row[order]
    head_idx = np.searchsorted(seg_ids[:m], np.arange(keys.size)).astype(np.int32)
    seg_sizes = np.diff(np.append(head_idx, m)).astype(np.int32)
    return PackedAggregation(
        keys=keys, words=words, seg_ids=seg_ids,
        head_idx=head_idx, seg_sizes=seg_sizes, m=m,
        max_group=int(seg_sizes.max()) if keys.size else 0)


def blocked_block_count(bitmaps: list, block: int = 8) -> int:
    """Block count pack_blocked_compact would produce, from key counts only."""
    flat_keys = np.concatenate([_keys_of(b) for b in bitmaps])
    _, counts = np.unique(flat_keys, return_counts=True)
    return int((-(-counts // block)).sum())


# ------------------------------------------------------- stream (byte) ingest
#
# Aggregate straight off the serialized layout without building per-container
# objects (the reference's BufferFastAggregation).  The rotated batch splits
# into transfer-minimal streams:
#   - dense containers (bitmap + large-run) ship their 8 KB wire image as-is,
#   - sparse containers (array + small-run) ship raw u16 member values,
#   - with ``runs=True`` (the dense layout's build), every run container
#     ships its (start, length - 1) u16 pairs as serialized instead, whatever
#     its cardinality: no run is expanded or densified on the host.
# The device builds the dense [rows, 2048] image from them.

#: Run containers above this cardinality ship as dense wire images instead of
#: expanded value streams (4096 u16 values = one 8 KB dense row).
RUN_DENSIFY_THRESHOLD = ARRAY_MAX_SIZE


@dataclass
class CompactStreams:
    """Transfer-minimal ingest form of a rotated container batch."""

    n_rows: int               # dense image row count (excluding scratch row)
    dense_words: np.ndarray   # u32[Md, 2048] wire images (bitmap / big-run)
    dense_dest: np.ndarray    # i32[Md] destination rows
    values: np.ndarray        # u16[V] concat member values (array / small-run)
    val_counts: np.ndarray    # i32[Mv] values per sparse container
    val_dest: np.ndarray      # i32[Mv] destination row per sparse container
    # the run stream (``runs=True`` only; None otherwise)
    runs: np.ndarray | None = None        # u16[2R] (start, length-1) pairs
    run_counts: np.ndarray | None = None  # i32[Mr] runs per run container
    run_dest: np.ndarray | None = None    # i32[Mr] destination row each
    #: source containers by kind ({"array", "bitmap", "run"}: count), where
    #: the packer counted them
    kinds: dict | None = None

    @property
    def total_values(self) -> int:
        return int(self.values.size)

    @property
    def total_runs(self) -> int:
        return 0 if self.runs is None else int(self.runs.size) // 2

    def transfer_bytes(self) -> int:
        return sum(a.nbytes for a in (
            self.dense_words, self.dense_dest, self.values, self.val_counts,
            self.val_dest, self.runs, self.run_counts, self.run_dest)
            if a is not None)


def _as_view(b):
    """SerializedView of ``b`` when it is byte-backed (bytes, a view, or an
    ``ImmutableRoaringBitmap``, whose parsed header is its ``_view``), else
    None."""
    if isinstance(b, (bytes, bytearray, memoryview)):
        return spec.SerializedView(b)
    if isinstance(b, spec.SerializedView):
        return b
    view = getattr(b, "_view", None)
    if isinstance(view, spec.SerializedView):
        return view
    return None


def _keys_of(b) -> np.ndarray:
    """Container keys of a bitmap or of serialized bytes, without building
    containers."""
    v = _as_view(b)
    return b.keys if v is None else v.keys


def _view_table(view) -> tuple:
    """A SerializedView's per-container header as Python lists, so the
    per-container loop reads no NumPy scalars: (buffer, payload offsets,
    kinds (0 array, 1 bitmap, 2 run), cardinalities, payload sizes)."""
    kinds = view.is_bitmap.astype(np.int8) + 2 * view.is_run.astype(np.int8)
    return (view.buf, view.payload_offsets.tolist(), kinds.tolist(),
            view.cardinalities.tolist(), view.payload_sizes.tolist())


#: the kinds of ``_view_table`` by name, in its order
KINDS = ("array", "bitmap", "run")


def _check_increasing(values: np.ndarray, counts: list, conts: list) -> None:
    """Every value piece (``counts`` values each, concatenated in
    ``values``) strictly increasing, checked in one pass: a byte-backed
    array payload is validated here rather than container by container."""
    if values.size < 2:
        return
    bad = values[1:] <= values[:-1]
    ends = np.cumsum(counts)
    bad[ends[:-1] - 1] = False     # comparisons across two pieces
    if bad.any():
        k = int(np.searchsorted(ends, int(np.argmax(bad)), side="right"))
        raise InvalidRoaringFormat(
            f"container {conts[k]}: array values not strictly increasing")


def run_cardinalities(runs: np.ndarray, run_counts) -> np.ndarray:
    """i64[Mr] values of each run container of a run stream (``runs`` the
    u16 (start, length - 1) pairs, ``run_counts[j]`` pairs a container)."""
    counts = np.asarray(run_counts, np.int64)
    lens = np.asarray(runs)[1::2].astype(np.int64) + 1
    return np.bincount(np.repeat(np.arange(counts.size), counts),
                       weights=lens, minlength=counts.size).astype(np.int64)


def _check_runs(runs: np.ndarray, run_counts: list, cards: list,
                conts: list) -> None:
    """``validate_runs``' guards over a whole run stream at once (``runs``
    the u16 pairs of every run container, ``run_counts[j]`` pairs of
    container ``conts[j]``, whose header declares ``cards[j]`` values):
    runs sorted and not overlapping within a container, none past 65535,
    and each container's run cardinality equal to its header's.  Each
    failure raises ``InvalidRoaringFormat`` naming the first container at
    fault, with ``validate_runs``' message."""
    if not conts:
        return
    starts = runs[0::2].astype(np.int64)
    ends = starts + runs[1::2].astype(np.int64)
    counts = np.asarray(run_counts, np.int64)
    cont_of = np.repeat(np.arange(counts.size), counts)
    # each container's first failing guard, in validate_runs' order (4: none)
    code = np.full(counts.size, 4, np.int8)
    np.minimum.at(code, cont_of[ends > 0xFFFF], 1)
    later = np.ones(starts.size, bool)
    later[(np.cumsum(counts) - counts)[counts > 0]] = False
    over = np.flatnonzero(later[1:] & (starts[1:] <= ends[:-1])) + 1
    np.minimum.at(code, cont_of[over], 2)
    card = run_cardinalities(runs, counts)
    code[(code == 4) & (card != np.asarray(cards, np.int64))] = 3
    if (code < 4).any():
        j = int(np.argmax(code < 4))
        why = {1: "run extends past 65535",
               2: "overlapping/unsorted runs",
               3: "run cardinality mismatch"}[int(code[j])]
        raise InvalidRoaringFormat(f"container {conts[j]}: {why}")


def _emit_container_streams(sources: list, order: np.ndarray, dest: np.ndarray,
                            n_rows: int, runs: bool = False) -> CompactStreams:
    """Classify every container of the rotated batch into the dense or the
    sparse stream, in ``order`` (rows sorted by segment), to rows ``dest``;
    with ``runs``, every run container into the run stream.

    A byte-backed source streams its payloads off the buffer with the same
    corruption guards as ``SerializedView.container``, minus the bitmap
    popcount (a wrong declared bitmap cardinality cannot shift the stream,
    payloads are fixed 8 KB, and every device aggregate recomputes
    cardinalities exactly).  Its array payloads are checked for order
    together, after the loop, and so are the run stream's runs
    (``_check_runs``)."""
    sizes = [_keys_of(s).size for s in sources]
    src_of = np.repeat(np.arange(len(sources)), sizes).tolist()
    idx_in_src = (np.concatenate([np.arange(k) for k in sizes]).tolist()
                  if sizes else [])

    dense_rows: list[int] = []
    dense_words: list[np.ndarray] = []
    pieces: list[np.ndarray] = []       # sparse per-container value arrays
    piece_cont: list[int] = []          # the container index of each piece
    val_dest: list[int] = []
    run_pieces: list[np.ndarray] = []   # each run container's u16 pairs
    run_cont: list[int] = []            # the container index of each
    run_cards: list[int] = []           # its declared cardinality
    run_dest: list[int] = []
    n_kind = [0, 0, 0]                  # containers by kind (``KINDS``)
    views = [_as_view(s) for s in sources]
    tables = [None if v is None else _view_table(v) for v in views]
    for pos, row in zip(np.asarray(order).tolist(),
                        np.asarray(dest, dtype=np.int64).tolist()):
        s, i = src_of[pos], idx_in_src[pos]
        table = tables[s]
        if table is not None:
            buf, offs, kinds, cards, psizes = table
            kind = kinds[i]
            n_kind[kind] += 1
            if kind == 1:
                dense_rows.append(row)
                dense_words.append(np.frombuffer(buf, "<u4", WORDS32,
                                                 offs[i]))
                continue
            if kind == 0:
                vals = np.frombuffer(buf, "<u2", cards[i], offs[i])
            elif runs:
                # the header scan sized the payload from its run count and
                # raised for one that overruns the buffer
                nruns = (psizes[i] - 2) >> 2
                run_pieces.append(np.frombuffer(buf, "<u2", 2 * nruns,
                                                offs[i] + 2))
                run_cont.append(i)
                run_cards.append(cards[i])
                run_dest.append(row)
                continue
            else:
                payload = views[s].container_payload(i)
                nruns = int(np.frombuffer(payload[:2], dtype="<u2")[0])
                pairs = np.frombuffer(payload[2:2 + 4 * nruns], dtype="<u2")
                if pairs.size != 2 * nruns:
                    raise InvalidRoaringFormat(
                        f"container {i}: truncated run payload")
                starts, ends = validate_runs(pairs, i)
                if int((ends - starts + 1).sum()) != cards[i]:
                    raise InvalidRoaringFormat(
                        f"container {i}: run cardinality mismatch")
                vals = C.runs_to_values(pairs.astype(np.uint16))
        else:
            c = sources[s].containers[i]
            if isinstance(c, C.BitmapContainer):
                n_kind[1] += 1
                dense_rows.append(row)
                dense_words.append(container_words_u32(c))
                continue
            if not isinstance(c, C.RunContainer):
                n_kind[0] += 1
                vals = c.values()
            else:
                n_kind[2] += 1
                if runs:
                    if c.runs.size:    # an empty run container: a zero row
                        run_pieces.append(c.runs)
                        run_cont.append(i)
                        run_cards.append(c.cardinality)
                        run_dest.append(row)
                    continue
                vals = C.runs_to_values(c.runs)
        if vals.size > RUN_DENSIFY_THRESHOLD:
            # dense is the smaller wire form past 4096 values
            dense_rows.append(row)
            dense_words.append(C.values_to_words(vals).view(np.uint32))
        elif vals.size:
            pieces.append(vals)
            piece_cont.append(i)
            val_dest.append(row)
    values = (np.ascontiguousarray(np.concatenate(pieces)).astype(np.uint16)
              if pieces else np.empty(0, np.uint16))
    val_counts = [p.size for p in pieces]
    if any(t is not None for t in tables):
        _check_increasing(values, val_counts, piece_cont)
    run_arrays = None
    if runs:
        pairs = (np.concatenate(run_pieces).astype(np.uint16) if run_pieces
                 else np.empty(0, np.uint16))
        run_counts = [p.size // 2 for p in run_pieces]
        _check_runs(pairs, run_counts, run_cards, run_cont)
        run_arrays = dict(runs=pairs,
                          run_counts=np.array(run_counts, dtype=np.int32),
                          run_dest=np.asarray(run_dest, dtype=np.int32))
    return CompactStreams(
        n_rows=n_rows,
        dense_words=(np.stack(dense_words).astype(np.uint32) if dense_words
                     else np.empty((0, WORDS32), np.uint32)),
        dense_dest=np.asarray(dense_rows, dtype=np.int32),
        values=values,
        val_counts=np.array(val_counts, dtype=np.int32),
        val_dest=np.asarray(val_dest, dtype=np.int32),
        kinds=dict(zip(KINDS, n_kind)), **(run_arrays or {}))


def pad_streams_pow2(s: CompactStreams) -> CompactStreams:
    """Pad stream array lengths to powers of two.  The padding lands in the
    densify scratch row (index n_rows): padded values carry value 0 under a
    sentinel count entry destined there; padded dense rows are zero rows
    destined there too.  A run stream is kept as it is."""
    v, mv, md = s.values.size, s.val_counts.size, s.dense_words.shape[0]
    vpad, mvpad, mdpad = next_pow2(v), next_pow2(mv + 1), next_pow2(md)
    values = np.zeros(vpad, np.uint16)
    values[:v] = s.values
    val_counts = np.zeros(mvpad, np.int32)
    val_counts[:mv] = s.val_counts
    val_counts[mv] = vpad - v  # sentinel soaks up the value padding
    val_dest = np.full(mvpad, s.n_rows, np.int32)
    val_dest[:mv] = s.val_dest
    dense_words = np.zeros((mdpad, WORDS32), np.uint32)
    dense_words[:md] = s.dense_words
    dense_dest = np.full(mdpad, s.n_rows, np.int32)
    dense_dest[:md] = s.dense_dest
    return dataclasses.replace(s, dense_words=dense_words,
                               dense_dest=dense_dest, values=values,
                               val_counts=val_counts, val_dest=val_dest)


#: Values per densify chunk.  Each chunk belongs to exactly one destination
#: row, so padding waste is at most CHUNK_VALUES - 1 values per container.
CHUNK_VALUES = 128

#: Chunk-slot sentinel: any u32 > 0xFFFF is outside the 2^16-bit container
#: domain, and the densify kernel skips it.
CHUNK_PAD = np.uint32(0xFFFFFFFF)


def chunk_value_stream(values: np.ndarray, val_counts: np.ndarray,
                       val_dest: np.ndarray, n_rows: int,
                       chunk: int = CHUNK_VALUES,
                       pad_chunks_pow2: bool = True
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Sparse value streams -> fixed-shape chunks for the densify kernel:
    (u32[NC, chunk] chunk values, i32[NC] chunk destination rows).

    Every chunk's values land in one destination row.  All padding, a
    container's final partial chunk and whole padding chunks (pow2 rounding
    of the chunk count, destination n_rows = the scratch row), carries the
    CHUNK_PAD sentinel.  Chunk destinations ascend whenever val_dest does.
    """
    counts = np.asarray(val_counts, dtype=np.int64)
    nz = counts > 0
    counts_nz = counts[nz]
    dest_nz = np.asarray(val_dest, dtype=np.int64)[nz]
    m = -(-counts_nz // chunk)                       # chunks per container
    nc = int(m.sum())
    nc_pad = max(next_pow2(nc), 1) if pad_chunks_pow2 else max(nc, 1)
    chunk_vals = np.full((nc_pad, chunk), CHUNK_PAD, dtype=np.uint32)
    chunk_row = np.full(nc_pad, n_rows, dtype=np.int32)
    if nc:
        cont_of = np.repeat(np.arange(counts_nz.size), m)
        chunk_head = np.concatenate(([0], np.cumsum(m)[:-1]))
        within = np.arange(nc) - chunk_head[cont_of]
        starts = np.concatenate(([0], np.cumsum(counts_nz)[:-1]))
        base = starts[cont_of] + within * chunk
        idx = base[:, None] + np.arange(chunk)
        last = (starts + counts_nz - 1)[cont_of][:, None]
        cv = np.asarray(values, dtype=np.uint32)[np.minimum(idx, last)]
        cv[idx > last] = CHUNK_PAD  # partial-chunk slots must contribute 0
        chunk_vals[:nc] = cv
        chunk_row[:nc] = dest_nz[cont_of]
    return chunk_vals, chunk_row


@dataclass
class PackedBlockedCompact:
    """Blocked-layout metadata + compact transfer streams (no host densify)."""

    keys: np.ndarray         # [K] distinct keys, sorted (u16 or u64)
    blk_seg: np.ndarray      # i32[n_rows/block]; padding blocks get segment K
    block: int
    n_blocks: int            # true block count
    seg_sizes: np.ndarray    # i64[K] true rows per segment
    seg_offsets: np.ndarray  # i64[K] first (padded) row of each segment
    streams: CompactStreams
    carry_row: int           # a padding row of segment 0 (loop-carry slot)
    row_src: np.ndarray = None  # i32[n_rows] source index per row (-1 padding)

    @property
    def n_rows(self) -> int:
        return int(self.blk_seg.size) * self.block


def choose_block(seg_sizes: np.ndarray, min_block: int = 8) -> int:
    """Block size of a set: larger blocks amortize per-block work but pad
    every segment to a block multiple, so the ladder climbs only while the
    median segment keeps the padding small.  min_block=4 opens a lower rung
    for dense-layout sets whose median segment is tiny (the uscensus2000
    shape); the counts and compact layouts keep 8, since their nibble groups
    of 8 rows must tile the block."""
    if seg_sizes.size == 0:
        return max(min_block, 8) if min_block >= 8 else 8
    med = float(np.median(seg_sizes))
    if med >= 32:
        return 32
    if med >= 16:
        return 16
    if med >= 4 or min_block >= 8:
        return 8
    return 4


def pack_blocked_compact(sources: list, block: int | None = None,
                         round_blocks: int = 8,
                         carry_slot: bool = True,
                         min_block: int = 8,
                         runs: bool = False) -> PackedBlockedCompact:
    """Group-by-key rotation emitting compact streams instead of a host-built
    dense tensor.  ``sources`` may mix RoaringBitmaps,
    ImmutableRoaringBitmaps, SerializedViews and raw serialized bytes; the
    byte-backed ones stream their payloads off the buffer.

    carry_slot guarantees segment 0 at least one zero padding row.
    round_blocks pads the block count to a multiple (not pow2: a resident
    set is built once, so tight padding saves device memory).
    runs puts every run container into the run stream (the dense layout's
    build, whose image the device makes from runs).  The C++ engine, which
    serves inputs that are all ``bytes`` otherwise, emits no run stream, so
    a pack with runs parses the buffers here instead.
    """
    if block is None and min_block < 8 and sources:
        _, counts = np.unique(
            np.concatenate([_keys_of(s) for s in sources]),
            return_counts=True)
        block = choose_block(counts, min_block=min_block)
    # inputs that are all serialized bytes take the C++ ingest engine first
    # (after the block-4 rung above, which the engine's ladder lacks), unless
    # runs are asked for: the engine expands them
    if sources and all(isinstance(s, (bytes, bytearray)) for s in sources):
        from .. import native

        if native.enabled() and not runs:
            native.CALLS["native"] += 1
            packed = native.pack_blocked_compact(
                [bytes(s) for s in sources], block, round_blocks, carry_slot)
            packed.row_src = _row_sources(packed, sources)
            return packed
        native.CALLS["numpy"] += 1
    # parse byte-backed sources once; _as_view is idempotent on views
    sources = [v if (v := _as_view(s)) is not None else s for s in sources]
    all_keys = [_keys_of(s) for s in sources]
    flat_keys = (np.concatenate(all_keys) if all_keys
                 else np.empty(0, np.uint16))
    order = np.argsort(flat_keys, kind="stable")
    keys, seg_of_row = np.unique(flat_keys, return_inverse=True)
    m, k = flat_keys.size, keys.size
    seg_sorted = seg_of_row[order]
    head = np.searchsorted(seg_sorted, np.arange(k)).astype(np.int64)
    g = np.diff(np.append(head, m))
    if block is None:
        block = choose_block(g)
    gp = -(-g // block) * block
    if carry_slot and k and gp[0] == g[0]:
        gp[0] += block  # ensure a spare zero row in segment 0
    offs = np.concatenate(([0], np.cumsum(gp)))
    n_blocks = int(offs[-1]) // block
    nb_pad = -(-n_blocks // round_blocks) * round_blocks
    within = np.arange(m) - head[seg_sorted]
    dest = offs[seg_sorted] + within
    streams = _emit_container_streams(sources, order, dest, nb_pad * block,
                                      runs)
    blk_seg = np.full(nb_pad, k, dtype=np.int32)
    blk_seg[:n_blocks] = np.repeat(np.arange(k, dtype=np.int32),
                                   (gp // block).astype(np.int64))
    row_src = np.full(nb_pad * block, -1, dtype=np.int32)
    row_src[dest] = np.repeat(np.arange(len(sources), dtype=np.int32),
                              [k_.size for k_ in all_keys])[order]
    return PackedBlockedCompact(
        keys=keys, blk_seg=blk_seg, block=block, n_blocks=n_blocks,
        seg_sizes=g, seg_offsets=offs[:-1], streams=streams,
        # without a reserved slot, g[0] may be a live row of segment 1
        carry_row=int(g[0]) if (carry_slot and k) else -1,
        row_src=row_src)


def _row_sources(packed: PackedBlockedCompact, sources: list) -> np.ndarray:
    """i32[n_rows] source index of each row of a packed blocked layout (-1
    padding), rebuilt from the key arrays alone: rows are sorted by segment
    and, within a segment, by source, so the per-source key sets fix every
    row's place."""
    all_keys = [_keys_of(_as_view(s)) for s in sources]
    flat_keys = np.concatenate(all_keys)
    order = np.argsort(flat_keys, kind="stable")
    seg_sorted = np.searchsorted(packed.keys, flat_keys[order])
    head = np.searchsorted(seg_sorted, np.arange(packed.keys.size))
    within = np.arange(flat_keys.size) - head[seg_sorted]
    dest = packed.seg_offsets[seg_sorted] + within
    row_src = np.full(packed.n_rows, -1, dtype=np.int32)
    row_src[dest] = np.repeat(np.arange(len(sources), dtype=np.int32),
                              [k.size for k in all_keys])[order]
    return row_src


def blocked_ragged_meta(blk_seg: np.ndarray, block: int, n_blocks: int,
                        num_keys: int):
    """Row-level ragged metadata of a blocked layout, for the doubling
    reduce: (seg_rows i32[rows], head_idx i32[K], n_steps).  Group sizes end
    at the true row count, so round_blocks padding never deepens the pass."""
    from .dense import n_steps_for

    seg_rows = np.repeat(blk_seg, block).astype(np.int32)
    head_idx = np.searchsorted(seg_rows, np.arange(num_keys)).astype(np.int32)
    seg_sizes = np.diff(np.append(head_idx, n_blocks * block))
    n_steps = n_steps_for(int(seg_sizes.max()) if num_keys else 0)
    return seg_rows, head_idx, n_steps


@dataclass
class PackedIntersection:
    """Wide-AND problem: only keys present in every bitmap survive (the
    reference's workShyAnd), so the payload is a regular [K, N, 2048] block."""

    keys: np.ndarray    # [K] surviving keys (u16 or u64)
    words: np.ndarray   # u32[K, N, 2048]


def _container_at(b, i: int):
    """Container i of a bitmap-like source.  A byte-backed source
    (ImmutableRoaringBitmap) decodes just this payload, so a wide AND never
    decodes the containers its key intersection dropped."""
    get = getattr(b, "_container", None)
    return get(i) if get is not None else b.containers[i]


def pack_for_intersection(bitmaps: list[RoaringBitmap],
                          keys: np.ndarray) -> PackedIntersection:
    """keys is the surviving key set: every bitmap holds a container for
    each (see parallel.aggregation._intersect_keys)."""
    n = len(bitmaps)
    conts, dest = [], []
    for j, b in enumerate(bitmaps):
        for i, bi in enumerate(np.searchsorted(b.keys, keys)):
            conts.append(_container_at(b, int(bi)))
            dest.append(i * n + j)
    words = densify_containers(conts, dest, keys.size * n)
    return PackedIntersection(keys=keys,
                              words=words.reshape(keys.size, n, WORDS32))


def key_presence_masks(bitmaps: list[RoaringBitmap]) -> np.ndarray:
    """u32[N, 2048]: the 65,536-bit key presence mask of each bitmap."""
    n = len(bitmaps)
    masks = np.zeros((n, WORDS32), dtype=np.uint32)
    for i, b in enumerate(bitmaps):
        k = b.keys.astype(np.int64)
        np.bitwise_or.at(masks[i], k >> 5, np.uint32(1) << (k & 31).astype(np.uint32))
    return masks


@dataclass
class PackedPairwiseCompact:
    """P bitmap pairs aligned on per-pair key unions, as one compact stream
    per operand side (the device densifies each into an aligned image).
    Zero rows are the identity of or/xor/andnot and annihilate for and, so
    one alignment serves all four ops."""

    keys: np.ndarray          # u16[M] per-pair union keys, concatenated
    heads: np.ndarray         # i64[P+1] row bounds of each pair's segment
    m: int                    # true row count
    n_rows: int               # padded row count (>= m; padding rows zero)
    a_streams: CompactStreams
    b_streams: CompactStreams


def pack_pairwise(pairs, pad_rows: bool = True) -> PackedPairwiseCompact:
    """Align each pair's containers on its key union and emit one compact
    stream per side.  Operands may mix RoaringBitmaps,
    ImmutableRoaringBitmaps, SerializedViews and raw serialized bytes;
    byte-backed ones stream off the wire layout.
    Pairs that are all serialized bytes take the C++ ingest engine
    (``native``) unless ``RB_NATIVE=0``."""
    if pairs and all(isinstance(a, (bytes, bytearray))
                     and isinstance(b, (bytes, bytearray)) for a, b in pairs):
        from .. import native

        if native.enabled():
            native.CALLS["native"] += 1
            return native.pack_pairwise(
                [bytes(a) for a, _ in pairs], [bytes(b) for _, b in pairs],
                pad_rows)
        native.CALLS["numpy"] += 1
    a_srcs = [v if (v := _as_view(a)) is not None else a for a, _ in pairs]
    b_srcs = [v if (v := _as_view(b)) is not None else b for _, b in pairs]
    a_keys = [_keys_of(s) for s in a_srcs]
    b_keys = [_keys_of(s) for s in b_srcs]
    key_sets = [np.union1d(ka, kb) for ka, kb in zip(a_keys, b_keys)]
    heads = np.concatenate(
        ([0], np.cumsum([k.size for k in key_sets]))).astype(np.int64)
    m = int(heads[-1])
    n_rows = next_pow2(m) if pad_rows else m

    def side(srcs, src_keys):
        if srcs:
            dest = np.concatenate(
                [heads[p] + np.searchsorted(key_sets[p], k)
                 for p, k in enumerate(src_keys)])
        else:
            dest = np.empty(0, np.int64)
        # each source's containers already come in destination order
        return _emit_container_streams(srcs, np.arange(dest.size), dest,
                                       n_rows)

    keys = (np.concatenate(key_sets) if key_sets
            else np.empty(0, np.uint16))
    return PackedPairwiseCompact(
        keys=keys, heads=heads, m=m, n_rows=n_rows,
        a_streams=side(a_srcs, a_keys), b_streams=side(b_srcs, b_keys))


def unpack_result(keys: np.ndarray, words: np.ndarray, cards: np.ndarray,
                  out_cls=None):
    """Dense result (u32[K, 2048] words, [K] cards) -> host bitmap,
    normalized by cardinality.  ``out_cls`` defaults by the key dtype: a
    ``RoaringBitmap`` for u16 keys, a ``Roaring64Bitmap`` for the 64-bit
    tier's u64 keys (both take (keys, containers))."""
    if out_cls is None:
        if keys.dtype != np.uint16:
            from ..core.bitmap64 import Roaring64Bitmap

            out_cls = Roaring64Bitmap
        else:
            out_cls = RoaringBitmap
    words = np.asarray(words, dtype=np.uint32)
    cards = np.asarray(cards)
    out_keys, out_conts = [], []
    for i in range(keys.size):
        card = int(cards[i])
        if card == 0:
            continue
        w64 = words[i].view(np.uint64)
        out_keys.append(keys[i])
        if card > C.ARRAY_MAX_SIZE:
            out_conts.append(C.BitmapContainer(w64.copy(), card))
        else:
            out_conts.append(C.ArrayContainer(C.words_to_values(w64)))
    return out_cls(np.array(out_keys, dtype=keys.dtype), out_conts)
