"""Container-mix insights, the layout choice for resident sets and the
dispatch footprint model, from host metadata alone.

``BitmapAnalyser`` / ``BitmapStatistics`` / ``NaiveWriterRecommender`` are
the port's own copies of the JAX package's (the reference's insights
package): container-type tallies and ``RoaringBitmapWriter`` advice.

The uscensus2000 shape (thousands of mostly-singleton containers) inflates a
few dozen KB of serialized bytes into a dense image tens of MB large, which
every query would stream.  ``choose_layout`` sends that shape to the counts
layout and everything else to the dense one, deciding exactly as
``roaringbitmap_tpu.insights.analysis.choose_layout`` does, so that
``DeviceBitmapSet(layout="auto")`` builds the same layout in both packages.

The ``predict_*_dispatch_bytes`` functions keep the JAX package's names,
signatures and ``peak_bytes`` key, but count what the port allocates on the
card during one dispatch, not what an XLA program or a TPU kernel would:
the gathered row block, B1's heads and its workspace (partials and
counters, one allocation with the heads), the andnot head gather,
popcount's int64 working copies, the plain rung's doubling scratch, B3's
rebuilt image, the pooled image and B5's outputs.  Each term is the sum of
the tensors the code allocates, so the total bounds the allocator's peak
above what was allocated before the dispatch
(``torch.cuda.max_memory_allocated``), which the pooled engine's proactive
split relies on; ``chip_smoke.py`` phase 11c holds a pooled launch's
measured peak under it on the card.  B1's workspace is sized by the card's
SM count, so where a card is visible the model reads it
(``kernels.b1_workspace_bytes``); everything else is host metadata.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..core import containers as C
from ..core.bitmap import RoaringBitmap
from ..core.containers import WORDS_PER_CONTAINER
from ..ops import kernels, packing
from ..runtime.guard import PLAIN_RUNGS as PLAIN_ENGINES

# ------------------------------------------------------ container mix

@dataclass
class ArrayContainersStats:
    """BitmapStatistics.ArrayContainersStats: count and total cardinality."""

    containers_count: int = 0
    cardinality_sum: int = 0

    def average_cardinality(self) -> int:
        if self.containers_count == 0:
            return 2 ** 63 - 1  # Long.MAX_VALUE, the reference's sentinel
        return self.cardinality_sum // self.containers_count


@dataclass
class BitmapStatistics:
    """Container-mix tallies (the reference's BitmapStatistics)."""

    array_stats: ArrayContainersStats = field(default_factory=ArrayContainersStats)
    bitmap_containers_count: int = 0
    run_containers_count: int = 0
    bitmaps_count: int = 0

    def container_count(self) -> int:
        return (self.array_stats.containers_count
                + self.bitmap_containers_count + self.run_containers_count)

    def container_fraction(self, count: int) -> float:
        if self.container_count() == 0:
            return float("nan")
        return count / self.container_count()

    # ------------------------------------------------------------- accounting
    def merge(self, o: "BitmapStatistics") -> "BitmapStatistics":
        return BitmapStatistics(
            ArrayContainersStats(
                self.array_stats.containers_count + o.array_stats.containers_count,
                self.array_stats.cardinality_sum + o.array_stats.cardinality_sum),
            self.bitmap_containers_count + o.bitmap_containers_count,
            self.run_containers_count + o.run_containers_count,
            self.bitmaps_count + o.bitmaps_count)


class BitmapAnalyser:
    """analyse() over one or many bitmaps (the reference's BitmapAnalyser)."""

    @staticmethod
    def analyse(rb: RoaringBitmap) -> BitmapStatistics:
        stats = BitmapStatistics(bitmaps_count=1)
        for c in rb.containers:
            if isinstance(c, C.RunContainer):
                stats.run_containers_count += 1
            elif isinstance(c, C.BitmapContainer):
                stats.bitmap_containers_count += 1
            else:
                stats.array_stats.containers_count += 1
                stats.array_stats.cardinality_sum += c.cardinality
        return stats

    @staticmethod
    def analyse_all(bitmaps) -> BitmapStatistics:
        out = BitmapStatistics()
        for rb in bitmaps:
            out = out.merge(BitmapAnalyser.analyse(rb))
        return out


def analyse(rb: RoaringBitmap) -> BitmapStatistics:
    return BitmapAnalyser.analyse(rb)


class NaiveWriterRecommender:
    """Expert rules mapping stats to writer advice (the reference's
    NaiveWriterRecommender)."""

    # thresholds mirror the reference's rules-of-thumb
    RUN_FRACTION_FOR_RUN_OPT = 0.10
    BITMAP_FRACTION_FOR_CONSTANT = 0.50
    SMALL_ARRAY_AVG = 8

    @staticmethod
    def recommend(stats: BitmapStatistics) -> list[str]:
        advice: list[str] = []
        total = stats.container_count()
        if total == 0:
            return ["empty input: defaults are fine"]
        if stats.container_fraction(stats.run_containers_count) \
                >= NaiveWriterRecommender.RUN_FRACTION_FOR_RUN_OPT:
            advice.append(".optimise_for_runs()")
        else:
            advice.append(".optimise_for_arrays()")
        if stats.container_fraction(stats.bitmap_containers_count) \
                >= NaiveWriterRecommender.BITMAP_FRACTION_FOR_CONSTANT:
            advice.append(".constant_memory()")
        avg = stats.array_stats.average_cardinality()
        if avg < 2 ** 62 and avg <= NaiveWriterRecommender.SMALL_ARRAY_AVG:
            advice.append(f".expected_container_size({max(avg, 1)})")
        if stats.bitmaps_count > 0 and total // stats.bitmaps_count > 1:
            advice.append(
                f".initial_capacity({total // stats.bitmaps_count})")
        return advice

    @staticmethod
    def recommend_for(rb: RoaringBitmap) -> list[str]:
        return NaiveWriterRecommender.recommend(BitmapAnalyser.analyse(rb))


#: bytes of one densified container row: u32[2048] = 2^16 bits = 8 KiB
ROW_BYTES = WORDS_PER_CONTAINER * 8

#: "auto" picks counts only for mostly-singleton segments (median <= this)
#: AND a dense image that inflates the serialized bytes past this factor.
AUTO_COUNTS_MEDIAN_SEGMENT = 1.0
AUTO_COUNTS_INFLATION_X = 100.0


def dense_rows_bytes(n_rows: int) -> int:
    """Device bytes of ``n_rows`` densified container rows."""
    return int(n_rows) * ROW_BYTES


# ------------------------------------------------------- footprint model

#: bytes of one B5 card row: 128 int32 popcount partials, one per slice
MEGA_CARD_ROW_BYTES = 128 * 4
#: operand bytes per gathered row or head slot: its int32 index, the int64
#: copy an index may take on the card, and its bool masks
INDEX_BYTES = 16
#: popcount's working memory in rows of its int32 input (an int64 copy and
#: an int64 scratch, ``ops.words.popcount``)
POPCOUNT_ROWS = 4
#: the plain rung's doubling pass: the blocks it holds beside the gathered
#: one (the previous step, the shifted copy, the op's result, the
#: ``torch.where`` result, the zero tail)
DOUBLING_BLOCKS = 5
#: the plain densify (``dense.densify_streams``) in rows per image row: an
#: int64 accumulator and the int64 temporaries of its fold back to int32
PLAIN_DENSIFY_ROWS = 7
#: what no term names, once per dispatch: segment ranges, the instruction
#: stream, reduction outputs and the allocator's 512-byte rounding
DISPATCH_SLACK_BYTES = 2 << 20


def densify_bytes(n_rows: int, engine: str) -> int:
    """Device bytes of rebuilding an ``n_rows`` image from a stream set: B3
    writes the image once on the kernel rungs; the plain scatter needs
    ``PLAIN_DENSIFY_ROWS`` rows per image row."""
    rows = dense_rows_bytes(int(n_rows) + 1)
    return rows * PLAIN_DENSIFY_ROWS if engine in PLAIN_ENGINES else rows


def _bucket_bytes(bucket_sigs: list, engine: str) -> dict:
    """Per-term bytes of the buckets of one dispatch (a bucket of the batch
    engine, or a member of a pooled op group: both gather ``q * r_pad``
    rows and reduce into ``q * (k_pad + 1)`` head slots)."""
    gather = scratch = heads = outputs = 0
    for op, q, r_pad, k_pad, _n_steps, needs_words in bucket_sigs:
        if engine == "megakernel":
            # rows stream from the image into shared memory: only B5's
            # card partials and the bitmap-form result rows reach memory,
            # twice over for the power-of-two padding of B5's output rows
            outputs += 2 * q * k_pad * MEGA_CARD_ROW_BYTES
            if needs_words:
                outputs += 2 * q * k_pad * ROW_BYTES
            continue
        block, slots = q * r_pad, q * (k_pad + 1)
        gather += block * (ROW_BYTES + INDEX_BYTES)
        if engine in PLAIN_ENGINES:
            scratch += DOUBLING_BLOCKS * block * ROW_BYTES
        heads += slots * (ROW_BYTES + INDEX_BYTES)
        if engine not in PLAIN_ENGINES:
            # B1's workspace lives as long as its heads; a bucket's call
            # needs at least the share of a pooled op group's call
            heads += kernels.b1_workspace_bytes(block, slots)
        if op == "andnot":
            heads += slots * ROW_BYTES          # the head gather
        if op == "andnot" or engine in PLAIN_ENGINES:
            # B1 returns the cards of or/xor/and; andnot and the plain
            # rung count their heads again
            scratch += POPCOUNT_ROWS * slots * ROW_BYTES
        outputs += slots * 4
    return {"gather_bytes": gather, "scratch_bytes": scratch,
            "heads_bytes": heads, "output_bytes": outputs}


def predict_batch_dispatch_bytes(bucket_sigs: list, kind: str,
                                 n_rows: int, engine: str) -> dict:
    """Device bytes of ONE ``BatchEngine`` dispatch (the quantity the batch
    engine's proactive split compares with the budget).

    ``bucket_sigs`` are ``_Bucket.signature`` tuples (op, q, r_pad, k_pad,
    n_steps, needs_words); ``kind`` is "dense" (the resident image) or
    "streams" (a compact or counts set, whose image is rebuilt first);
    ``engine`` is the rung that runs ("megakernel", "cuda", "torch").  Per
    bucket: the gathered block and its operands; the plain rung's doubling
    scratch; the head slots (B1's output or the plain head gather), the
    andnot head gather, popcount's copies where cards are counted again; the
    int32 cards.  Plus the rebuilt image of a stream set and
    ``DISPATCH_SLACK_BYTES``."""
    out = _bucket_bytes(bucket_sigs, engine)
    out["densify_bytes"] = (densify_bytes(n_rows, engine)
                            if kind == "streams" else 0)
    out["peak_bytes"] = sum(out.values()) + DISPATCH_SLACK_BYTES
    return out


def _expr_step_rows(step) -> tuple:
    """(kind, op or None, K rows, unaligned children, children) of one
    compiled expression step signature (``expr.ExprSection.signature``)."""
    kind = step[0]
    if kind == "combine":
        _, op, children, k = step
        return (kind, op, int(k),
                sum(1 for _, aligned in children if not aligned),
                len(children))
    if kind == "reduce":
        return kind, None, int(step[3]), 0, 0
    if kind == "vscan":
        return kind, step[2], int(step[4]), 0, 0
    if kind == "vagg":
        return kind, step[1], int(step[6]), 0 if step[3] else 1, 1
    return kind, None, int(step[1]), 0, 0


def _value_step_depth(step) -> int:
    """Padded slice depth of one value step (0 for other steps)."""
    if step[0] == "vscan":
        return int(step[3])
    if step[0] == "vagg":
        return int(step[5])
    return 0


def predict_expr_dispatch_bytes(expr_sigs, engine: str) -> dict:
    """Device bytes the fused expression sections of a plan add to ONE
    dispatch (the reduce nodes are buckets, costed by
    :func:`predict_batch_dispatch_bytes`).

    On "megakernel" the combines are B5 slots in shared memory: what reaches
    memory is bank 1 (the ad-hoc rows), bank 2 (per value step, the
    column's ``depth x K`` planes and ``K`` existence rows) and the outputs
    (a root's card partials and bitmap-form rows; a sum's per-(slice, key)
    cards; a top-k's rows), twice over for the power-of-two padding of B5's
    output rows.  On "cuda" and "torch" the steps run in plain
    PyTorch: a leaf gather or ad-hoc upload holds K rows; a combine of n
    children one K-row result per pairwise op and two per unaligned child
    (the gather and its mask); a value scan the planes' temporaries
    (``depth + 3`` K-row blocks); a sum the masked planes and popcount's
    copies (``(1 + POPCOUNT_ROWS) x depth`` blocks); a top-k ``depth + 4``
    blocks; and the root's cards and bitmap-form rows."""
    leaf = combine = outputs = scan = 0
    for sig in expr_sigs:
        kind, bitmap_form, steps, _root, root_k = sig
        if kind != "fused":
            continue
        agg_root = False
        for step in steps:
            skind, op, k, copies, n_children = _expr_step_rows(step)
            depth = _value_step_depth(step)
            if engine == "megakernel":
                if skind == "adhoc":
                    leaf += k * ROW_BYTES
                elif skind in ("vscan", "vagg"):
                    scan += (depth + 1) * k * ROW_BYTES
                if skind == "vagg":
                    # outputs twice over: B5 pads its output rows to a
                    # power of two
                    agg_root = True
                    outputs += 2 * ((depth + 1) * k * MEGA_CARD_ROW_BYTES
                                    if op == "sum" else
                                    k * (ROW_BYTES + MEGA_CARD_ROW_BYTES))
                continue
            if skind in ("leaf", "adhoc"):
                leaf += k * ROW_BYTES
            elif skind == "combine":
                combine += (n_children + 2 * copies) * k * ROW_BYTES
            elif skind == "vscan":
                scan += (depth + 3) * k * ROW_BYTES
            elif skind == "vagg":
                agg_root = True
                copies_b = 2 * copies * k * ROW_BYTES
                if op == "sum":
                    scan += ((1 + POPCOUNT_ROWS) * depth * k * ROW_BYTES
                             + copies_b)
                    outputs += depth * k * 4 + k * 4
                else:
                    scan += (depth + 4) * k * ROW_BYTES + copies_b
                    outputs += k * (ROW_BYTES + 4)
        if not agg_root:
            # the root's cards (popcount's copies on the plain combines,
            # partials on B5) and its rows for a bitmap-form root
            if engine == "megakernel":
                outputs += 2 * root_k * MEGA_CARD_ROW_BYTES
                if bitmap_form:
                    outputs += 2 * root_k * ROW_BYTES
            else:
                outputs += root_k * (4 + POPCOUNT_ROWS * ROW_BYTES)
                if bitmap_form:
                    outputs += root_k * ROW_BYTES
    total = leaf + combine + outputs + scan
    return {"leaf_bytes": leaf, "combine_bytes": combine,
            "scan_bytes": scan, "output_bytes": outputs,
            "peak_bytes": total}


def predict_multiset_dispatch_bytes(bucket_sigs: list, sets: list,
                                    engine: str,
                                    pool_rows: int | None = None) -> dict:
    """Device bytes of ONE pooled ``MultiSetBatchEngine`` launch (the
    quantity its proactive split compares with the budget).

    ``bucket_sigs`` are the pooled plan's bucket signatures (the op groups
    gather and reduce exactly their members' rows and slots); ``sets`` is
    ``[(kind, n_rows)]`` for each set the launch touches.  On top of the
    buckets' terms: the pooled image (``pool_rows`` selected rows, or every
    set's rows when not given), which the launch fills set by set, and the
    largest stream set's rebuilt image, which lives only while its rows are
    selected (``concat_bytes`` and ``densify_bytes``)."""
    out = _bucket_bytes(bucket_sigs, engine)
    out["densify_bytes"] = max(
        (densify_bytes(n, engine) for kind, n in sets if kind == "streams"),
        default=0)
    rows = (sum(int(n) for _, n in sets) if pool_rows is None
            else int(pool_rows))
    out["concat_bytes"] = dense_rows_bytes(rows)
    out["peak_bytes"] = sum(out.values()) + DISPATCH_SLACK_BYTES
    return out


# ------------------------------------------------------------ time model
#
# The engines budget a pool's execute time before it dispatches
# (``MultiSetBatchEngine.predict_dispatch_seconds``): bytes and a word-op
# count (``predict_*_word_ops``, the JAX counts with the port's rung names)
# through ``obs.cost.estimate_seconds``, at the card's peak rates until
# dispatches at (site, rung) calibrate the achieved rates in
# ``obs.cost.TRACKER``.  The same counts are each dispatch's
# ``batch.cost`` / ``multiset.cost`` event.

def predict_batch_dispatch_word_ops(bucket_sigs: list, kind: str,
                                    n_rows: int, engine: str) -> int:
    """Word operations of ONE batch dispatch (one u32 lane operation each):
    per bucket the segmented reduce (one pass on the kernel rungs, the
    doubling pass's ``n_steps`` sweeps on "torch"), the mask and popcount
    pass over the head rows and the andnot head pass; plus the rebuilt
    image of a stream set."""
    total = 0
    for op, q, r_pad, k_pad, n_steps, _needs_words in bucket_sigs:
        passes = (1 if engine in ("cuda", "megakernel")
                  else max(1, int(n_steps)))
        total += q * r_pad * WORDS_PER_CONTAINER * 2 * passes
        head_rows = q * (k_pad + 1)
        total += head_rows * WORDS_PER_CONTAINER * 2
        if op == "andnot":
            total += head_rows * WORDS_PER_CONTAINER * 2
    if kind == "streams":
        total += (int(n_rows) + 1) * WORDS_PER_CONTAINER * 2
    return int(total)


def predict_expr_word_ops(expr_sigs, engine: str) -> int:
    """Word operations the fused sections add to one dispatch: per combine
    one K-row sweep per pairwise op and per unaligned child, a value step
    about three per slice plane (plus a sum's popcount sweep), and the
    root's popcount."""
    words = WORDS_PER_CONTAINER * 2
    total = 0
    for sig in expr_sigs:
        kind, _bitmap_form, steps, _root, root_k = sig
        if kind != "fused":
            continue
        for step in steps:
            skind, op, k, copies, n_children = _expr_step_rows(step)
            if skind == "combine":
                total += k * words * max(1, n_children - 1)
                total += k * words * copies
                if op == "andnot":
                    total += k * words
            elif skind in ("vscan", "vagg"):
                depth = _value_step_depth(step)
                total += 3 * depth * k * words
                if skind == "vagg":
                    total += (depth + copies + 1) * k * words
        if not any(step[0] == "vagg" for step in steps):
            total += root_k * words
    return int(total)


def predict_multiset_dispatch_word_ops(bucket_sigs: list, sets: list,
                                       engine: str,
                                       pool_rows: int | None = None) -> int:
    """Word operations of ONE pooled launch: the buckets, each stream
    set's rebuilt image, and one pass over the pooled image."""
    words = WORDS_PER_CONTAINER * 2
    total = predict_batch_dispatch_word_ops(bucket_sigs, "dense", 0, engine)
    total += sum((int(n) + 1) * words for kind, n in sets
                 if kind == "streams")
    if pool_rows:
        total += int(pool_rows) * words
    return int(total)


# ----------------------------------------------------- resident bytes

def hbm_footprint_bytes(rb) -> int:
    """Bytes this bitmap occupies once densified into the device packing
    (int32[K, 2048] rows)."""
    return dense_rows_bytes(rb.container_count())


def _nbytes(t) -> int:
    if isinstance(t, np.ndarray):
        return int(t.nbytes)
    return int(t.numel()) * int(t.element_size())


def resident_set_bytes(ds) -> dict:
    """Component breakdown {component: bytes} of a built DeviceBitmapSet:
    what ``DeviceBitmapSet.hbm_bytes()`` sums and the HBM ledger pulls.
    Components: ``meta`` (segment and head index tensors, on a compact or
    counts set the fused compact reduce's maps, and on a counts set and a
    dense set that keeps its streams B7's per-key plan), and per layout
    ``words`` (the dense image), ``streams`` and ``chunks`` (the compact
    wire payloads, on a dense set with its run stream where its or/xor
    reads them, and B3's chunk stream with its bounds), ``counts`` (the
    nibble tensor).  The port keeps its streams as int32 tensors (u16
    values widened), so a compact or counts set counts 2 bytes a value
    more than the JAX package's."""
    out = {"meta": sum(_nbytes(t) for t in (ds.blk_seg, ds.seg_ids,
                                            ds.head_idx))}
    if ds.words is not None:
        out["words"] = _nbytes(ds.words)
        if ds._streams is not None:
            # a dense set whose or/xor runs off its streams keeps them
            out["streams"] = sum(_nbytes(t) for t in (*ds._streams,
                                                      *(ds._runs or ())))
            out["meta"] += ds._stream_plan.nbytes()
        return out
    out["meta"] += sum(_nbytes(t) for t in (
        ds._grp_seg, ds._dseg, ds._dseg_carry, *ds._dmeta[:2],
        *ds._dmeta_carry[:2]))
    if ds._chunks is not None:
        out["chunks"] = (sum(_nbytes(t) for t in ds._chunks)
                         + _nbytes(ds._chunk_bounds))
    out["streams"] = sum(_nbytes(t) for t in ds._streams)
    if ds.counts is not None:
        out["counts"] = _nbytes(ds.counts)
        out["meta"] += ds._stream_plan.nbytes()
    return out


def predict_resident_bytes(sources: list, layout: str = "dense",
                           block: int | None = None,
                           device: str = "cuda") -> dict:
    """Device-free prediction of ``DeviceBitmapSet(sources, layout,
    block, device=device)``'s resident bytes, the components of
    :func:`resident_set_bytes`, from the host pack alone (nothing touches
    a device; the device's type decides whether a dense set keeps its
    streams, ``kernels.DENSE_STREAM_DEVICES``)."""
    from ..ops import dense as _dense

    packed = packing.pack_blocked_compact(
        sources, block=block,
        min_block=4 if (layout == "dense" and block is None) else 8,
        runs=layout == "dense")
    s = packed.streams
    k = packed.keys.size
    seg_rows, head_idx, _ = packing.blocked_ragged_meta(
        packed.blk_seg, packed.block, packed.n_blocks, k)
    out = {"meta": 4 * (packed.blk_seg.size + seg_rows.size
                        + head_idx.size)}
    if layout == "dense":
        out["words"] = dense_rows_bytes(s.n_rows)
        pairs = 0 if s.runs is None else s.runs.size // 2
        image_rows = int((packed.blk_seg < k).sum()) * packed.block
        if (str(device).split(":")[0] in kernels.DENSE_STREAM_DEVICES
                and kernels.dense_streams_win(s.values.size, pairs,
                                              s.dense_dest.size, image_rows)):
            # the streams and B7's plan, kept for the or/xor
            runs = (() if s.runs is None else (s.run_counts, s.run_dest))
            out["streams"] = 4 * (s.dense_words.size + s.dense_dest.size
                                  + s.values.size + s.val_counts.size
                                  + s.val_dest.size + pairs
                                  + sum(a.size for a in runs))
            none = np.zeros(0, np.int32)
            out["meta"] += kernels.stream_reduce_plan(
                s.val_counts, s.val_dest, s.dense_dest, seg_rows, k,
                run_counts=runs[0] if runs else none,
                run_dest=runs[1] if runs else none).nbytes()
        return out
    n_groups = s.n_rows // _dense.NIBBLE_GROUP
    nd = s.dense_dest.size
    # grp_seg + dseg + dseg_carry + (head int32, valid bool) x {plain,
    # carry}
    out["meta"] += ((n_groups + 1) * 4 + nd * 4 + (nd + 1) * 4
                    + 2 * ((k + 1) * 4 + (k + 1) * 1))
    cv, cr = packing.chunk_value_stream(
        s.values, s.val_counts, s.val_dest, s.n_rows, pad_chunks_pow2=False)
    out["chunks"] = 4 * (cv.size + cr.size + s.n_rows + 1)
    out["streams"] = 4 * (s.dense_words.size + s.dense_dest.size
                          + s.values.size + s.val_counts.size
                          + s.val_dest.size)
    if layout == "counts":
        out["meta"] += kernels.stream_reduce_plan(
            s.val_counts, s.val_dest, s.dense_dest, seg_rows, k).nbytes()
        gps = packed.block // _dense.NIBBLE_GROUP
        g_all = n_groups + 1
        g_pad = g_all + (-g_all) % gps
        out["counts"] = g_pad * _dense.NIBBLE_WORDS * 4
    return out


def predict_delta_patch_bytes(p_rows: int) -> dict:
    """Transient device bytes of ONE in-place delta patch
    (``mutation.delta``): the gathered current rows, the add/remove masks
    and the scattered result, all ``p_rows`` 8 KiB rows."""
    b = int(p_rows) * ROW_BYTES
    return {"gather_bytes": b, "mask_bytes": 2 * b, "output_bytes": b,
            "peak_bytes": 4 * b}


def predict_sharded_dispatch_bytes(bucket_sigs: list, pool_rows: int,
                                   mesh_devices: int,
                                   mesh_rows: int | None = None,
                                   engine: str = "mesh") -> dict:
    """Transient device bytes of ONE mesh-sharded pooled launch
    (``parallel.sharded_engine``), per shard and mesh-total: the quantity
    the sharded proactive split compares with the per-device budget.  The
    arithmetic is the JAX package's, term for term, so the two packages
    split a pool the same number of times at one budget:

    - the gathered operand block and its doubling scratch (one extra block,
      the JAX engines' ping-pong copy) shard over ALL ``mesh_devices``;
    - the per-key head accumulator (``q * (k_pad + 1)`` rows a bucket, plus
      the andnot head gather) and the outputs are replicated per device;
    - the placed pool is resident, not transient: ``resident_per_shard_bytes``
      reports one row-shard's share (over ``mesh_rows``) for context.

    ``peak_bytes`` is the mesh total (sharded parts + D x replicated parts);
    ``per_shard_bytes`` one device's peak, the budget-relevant figure."""
    d = max(1, int(mesh_devices))
    rows_d = max(1, int(mesh_rows if mesh_rows is not None
                        else mesh_devices))
    gather = scratch = heads = outputs = 0
    for op, q, r_pad, k_pad, _n_steps, needs_words in bucket_sigs:
        if engine == "megakernel":
            outputs += q * k_pad * MEGA_CARD_ROW_BYTES
            if needs_words:
                outputs += q * k_pad * ROW_BYTES
            continue
        block = q * r_pad * ROW_BYTES
        gather += block
        if engine != "pallas":
            scratch += block
        heads += q * (k_pad + 1) * ROW_BYTES
        if op == "andnot":
            heads += q * k_pad * ROW_BYTES
        outputs += q * k_pad * 4
        if needs_words:
            outputs += q * k_pad * ROW_BYTES
    sharded = gather + scratch
    replicated = heads + outputs
    per_shard = -(-sharded // d) + replicated
    return {
        "gather_bytes": gather, "scratch_bytes": scratch,
        "heads_bytes": heads, "output_bytes": outputs,
        "resident_per_shard_bytes": dense_rows_bytes(
            -(-int(pool_rows) // rows_d)),
        "per_shard_bytes": int(per_shard),
        "peak_bytes": int(sharded + d * replicated),
    }


def plan_pod_placement(tenant_bytes, n_hosts: int,
                       budget_per_host: int | None = None,
                       qps=None, replicate_max_bytes: int = 64 << 20,
                       hot_share_x: float = 2.0) -> dict:
    """Pure tenant -> host placement math of the pod data plane
    (``parallel.podmesh``), the JAX package's decision for decision, so
    every host (of either package) computes the same plan:

    1. **sharded**: ``bytes > capacity_threshold``, half the per-host budget
       when one resolves, else ``replicate_max_bytes``;
    2. **replicated-N**: rate share >= ``hot_share_x`` x the uniform share
       and small enough to copy; N = clamp(ceil(share * n_hosts) + 1, 2,
       n_hosts) full copies;
    3. **local**: greedy least-loaded byte balancing (descending size, ties
       to the lowest host id).

    Returns ``{"regimes", "hosts", "bytes_per_host", "over_budget",
    "capacity_threshold"}``; one host degenerates to ``local``."""
    t_bytes = [int(b) for b in tenant_bytes]
    n_hosts = max(1, int(n_hosts))
    s = len(t_bytes)
    cap = (int(budget_per_host) // 2 if budget_per_host
           else int(replicate_max_bytes))
    shares = None
    if qps is not None and s:
        q = [max(0.0, float(x)) for x in qps]
        total = sum(q)
        if total > 0:
            shares = [x / total for x in q]
    regimes = ["local"] * s
    hosts: list = [()] * s
    loads = [0] * n_hosts
    if n_hosts > 1:
        for sid in range(s):
            if t_bytes[sid] > cap:
                regimes[sid] = "sharded"
            elif (shares is not None
                  and shares[sid] >= hot_share_x / s
                  and t_bytes[sid] <= replicate_max_bytes):
                ceil_share = int(shares[sid] * n_hosts)
                if shares[sid] * n_hosts > ceil_share:
                    ceil_share += 1
                n = min(n_hosts, max(2, ceil_share + 1))
                regimes[sid] = f"replicated-{n}"
    for sid in range(s):
        if regimes[sid] == "sharded":
            hosts[sid] = tuple(range(n_hosts))
            share = t_bytes[sid] // n_hosts
            loads = [b + share for b in loads]

    def assign(sid, n_copies):
        order = sorted(range(n_hosts), key=lambda h: (loads[h], h))
        picked = tuple(sorted(order[:n_copies]))
        for h in picked:
            loads[h] += t_bytes[sid]
        hosts[sid] = picked

    by_size = sorted(range(s), key=lambda i: (-t_bytes[i], i))
    for sid in by_size:
        if regimes[sid].startswith("replicated"):
            assign(sid, int(regimes[sid].split("-")[1]))
    for sid in by_size:
        if regimes[sid] == "local":
            assign(sid, 1)
    over = bool(budget_per_host
                and any(b > int(budget_per_host) for b in loads))
    return {"regimes": regimes, "hosts": [list(h) for h in hosts],
            "bytes_per_host": loads, "over_budget": over,
            "capacity_threshold": cap}


def expr_node_report(sig) -> list:
    """Per-DAG-node EXPLAIN rows for one compiled section signature:
    ``{kind, op, keys, est_bytes, est_word_ops}`` per step, the counts of
    :func:`predict_expr_dispatch_bytes` and :func:`predict_expr_word_ops`
    node by node."""
    _kind, bitmap_form, steps, root, root_k = sig
    rows = []
    words = WORDS_PER_CONTAINER * 2
    for si, step in enumerate(steps):
        skind, op, k, copies, n_children = _expr_step_rows(step)
        if skind in ("leaf", "adhoc"):
            b, w = k * ROW_BYTES, 0
        elif skind == "reduce":
            b, w = 0, 0                  # costed in its bucket's row
        elif skind in ("vscan", "vagg"):
            depth = _value_step_depth(step)
            w = 3 * depth * k * words
            if skind == "vagg":
                # the planes and the aligned found copy, plus the
                # aggregate's compact output (per-slice cards for sum, K
                # result rows for top_k)
                b = (depth + copies) * k * ROW_BYTES
                b += depth * k * 4 if op == "sum" else k * ROW_BYTES + k * 4
                w += (depth + copies + 1) * k * words
            else:
                b = (depth + 1 + copies) * k * ROW_BYTES
        else:
            b = (1 + copies) * k * ROW_BYTES
            w = k * words * (max(1, n_children - 1) + copies
                             + (1 if op == "andnot" else 0))
        if si == root and skind != "vagg":
            # a vagg root's output and popcount are in its own row above
            b += root_k * 4 + (root_k * ROW_BYTES if bitmap_form else 0)
            w += root_k * words
        rows.append({"kind": skind, "op": op, "keys": k,
                     "est_bytes": int(b), "est_word_ops": int(w)})
    return rows


def _serialized_size_of(b) -> int | None:
    if isinstance(b, (bytes, bytearray, memoryview)):
        return len(b)
    end = getattr(b, "serialized_end", None)
    if end is not None:      # format.spec.SerializedView
        return int(end())
    fn = getattr(b, "serialized_size_in_bytes", None)
    return int(fn()) if fn is not None else None


def choose_layout(sources) -> dict:
    """Resolve the adaptive DeviceBitmapSet layout for ``sources`` from key
    counts and serialized sizes (nothing is packed or transferred)::

        {"layout": "dense"|"counts", "median_segment": float,
         "inflation_x": float, "dense_bytes": int, "serialized_bytes": int,
         "why": str[, "dense_block": int]}
    """
    sources = list(sources)
    if not sources:
        return {"layout": "dense", "median_segment": 0.0,
                "inflation_x": 1.0, "dense_bytes": 0, "serialized_bytes": 0,
                "why": "empty input: dense default"}
    ser_sizes = [_serialized_size_of(s) for s in sources]
    if any(s is None for s in ser_sizes):
        return {"layout": "dense", "median_segment": 0.0,
                "inflation_x": 1.0, "dense_bytes": 0,
                "serialized_bytes": 0,
                "why": "unsizeable source: dense default kept"}
    keys = [packing._keys_of(s) for s in sources]
    flat = np.concatenate(keys) if keys else np.empty(0, np.uint16)
    _, seg_sizes = np.unique(flat, return_counts=True)
    median = float(np.median(seg_sizes)) if seg_sizes.size else 0.0
    dense_b = dense_rows_bytes(int(flat.size))
    ser_b = int(sum(ser_sizes))
    inflation = dense_b / ser_b if ser_b else 1.0
    if (median <= AUTO_COUNTS_MEDIAN_SEGMENT
            and inflation > AUTO_COUNTS_INFLATION_X):
        layout, why = "counts", (
            "mostly-singleton segments inflating the dense image "
            f"{inflation:.0f}x past the serialized bytes: the counts layout "
            "halves the streamed image")
    else:
        layout, why = "dense", "dense image inflation within bounds"
    rep = {"layout": layout, "median_segment": median,
           "inflation_x": round(inflation, 1), "dense_bytes": dense_b,
           "serialized_bytes": ser_b, "why": why}
    if layout == "dense":
        # the block the dense layout would pick, from the same key scan
        rep["dense_block"] = int(packing.choose_block(seg_sizes, min_block=4))
    return rep


def recommend_device_layout(bitmaps, hbm_budget_bytes: int = 512 << 20) -> dict:
    """Advise a ``DeviceBitmapSet`` layout from the dense blowup and the
    absolute device bytes: the JAX package's budget ladder.  Dense when
    its image fits the budget (the fastest repeated queries); counts (the
    nibble tensor plus the resident streams) when only it fits; compact
    (the streams alone, rebuilt on the card at every query: a capacity
    tier) when neither does.  The one exception is the inflation-heavy,
    mostly-singleton shape that :func:`choose_layout` (the build
    default) resolves to counts: advised counts here too while it fits
    the budget.  The same inputs give the JAX package's advice."""
    auto = choose_layout(bitmaps)
    dense_b = auto["dense_bytes"]
    ser_b = auto["serialized_bytes"]
    ratio = dense_b / ser_b if ser_b else 1.0
    counts_b = dense_b // 2 + ser_b  # counts tensor + resident streams
    if auto["layout"] == "counts" and counts_b <= hbm_budget_bytes:
        layout = "counts"
        why = ("inflation-heavy mostly-singleton shape: the adaptive "
               "build default (choose_layout) resolves counts — "
               + auto["why"])
    elif auto["layout"] == "counts":
        layout = "compact"
        why = ("inflation-heavy mostly-singleton shape whose counts "
               "footprint still exceeds the budget: keep only the "
               "streams (~serialized size) — capacity tier")
    elif dense_b <= hbm_budget_bytes:
        layout = "dense"
        why = "dense image fits the budget — fastest repeated queries"
    elif counts_b < dense_b and counts_b <= hbm_budget_bytes:
        layout = "counts"
        why = ("dense image exceeds the budget; the counts-resident "
               "layout holds about half of it")
    else:
        layout = "compact"
        why = ("neither dense nor counts fits the budget: keep only the "
               "streams (~serialized size); queries rebuild on the card "
               "— treat as a capacity tier")
    return {
        "layout": layout,
        "dense_hbm_bytes": dense_b,
        "counts_hbm_bytes": counts_b,
        "serialized_bytes": ser_b,
        "dense_blowup": round(ratio, 2),
        "why": why,
    }


# ------------------------------------------------ lattice recommendation

def recommend_lattice(trace_path: str, slack_x: float = 1.0) -> dict:
    """A traffic profile for the closed program-signature lattice
    (``runtime.lattice``) derived from a span dump (``ROARING_TPU_TRACE``):
    the planner spans' ``need_q`` / ``need_rows`` / ``need_keys`` tags
    (``batch.plan`` / ``multiset.plan``), the pooled-row need
    (``multiset.plan``'s ``need_pool``) and the fused expressions' depths
    (``expr.compile``), each value set covered by a sparse pow2 rung list.
    ``slack_x`` scales the observed values before covering.  Returns
    ``{"profile", "points", "observed"}``: feed ``profile`` to
    ``warmup(profile=...)`` or ``ROARING_TPU_WARMUP_PROFILE``.  A dump of
    either package gives the same profile for the same traffic."""
    import json as _json

    from ..runtime import lattice as _lattice

    qs, rows, keys, pools, depths = set(), set(), set(), set(), set()
    bsis = set()
    with open(trace_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                span = _json.loads(line)
            except ValueError:
                continue
            name, tags = span.get("name"), span.get("tags", {})
            if name in ("batch.plan", "multiset.plan", "sharded.plan"):
                if tags.get("need_q"):
                    qs.add(int(tags["need_q"]))
                if tags.get("need_rows"):
                    rows.add(int(tags["need_rows"]))
                if tags.get("need_keys"):
                    keys.add(int(tags["need_keys"]))
                if tags.get("need_pool"):
                    pools.add(int(tags["need_pool"]))
            elif name == "expr.compile" and tags.get("kind") == "fused":
                if tags.get("bsi_depth"):
                    bsis.add(int(tags["bsi_depth"]))
                    if tags.get("depth"):
                        depths.add(int(tags["depth"]))
                else:
                    depths.add(int(tags.get("depth") or 2))

    def rungs(values, fallback):
        if not values:
            return (fallback,)
        return tuple(sorted({packing.next_pow2(max(1, int(v * slack_x)))
                             for v in values}))

    lat = _lattice.Lattice(
        q=rungs(qs, 16), rows=rungs(rows, 16), keys=rungs(keys, 1),
        pool=rungs(pools, 16),
        # a dump does not record result forms per dispatch: both heads
        # planes are programs
        heads=(False, True),
        expr=(0,) + tuple(sorted(depths)),
        # slice depths are pow2-padded at pack time: the observed values
        # are the rungs
        bsi=tuple(sorted(bsis)))
    return {"profile": lat.to_profile(),
            "points": lat.n_points(pooled=True),
            "observed": {"q": sorted(qs), "rows": sorted(rows),
                         "keys": sorted(keys),
                         "pool_rows": sorted(pools),
                         "expr_depths": sorted(depths),
                         "bsi_depths": sorted(bsis)}}
