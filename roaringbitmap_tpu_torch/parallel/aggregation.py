"""Wide aggregation engine on the card: the FastAggregation /
ParallelAggregation analog.

Entry points take N host bitmaps (or a resident ``DeviceBitmapSet``), run the
wide OR/AND/XOR on the device and return a host ``RoaringBitmap`` with exact
cardinalities.  The plan is the JAX package's:

1. the host packs bitmaps (or serialized bytes) by key segment into compact
   streams or u32[2048] rows (``ops.packing``);
2. the device densifies the streams (plain PyTorch, as XLA did) and runs the
   segmented per-key reduce with a fused popcount (``ops.kernels``);
3. ``packing.unpack_result`` turns the per-key words back into a bitmap.

Engines: ``"cuda"`` runs the hand-written kernels, ``"torch"`` their plain
PyTorch versions; ``"auto"`` means ``"cuda"`` for a CUDA device and
``"torch"`` for the CPU.  ``device=None`` means ``"cuda"``: only a caller who
passes ``device="cpu"`` gets the CPU, and without a card the call raises.
The wide AND (key intersection, then one regular [K, N, 2048] AND-reduce)
is plain PyTorch on both engines, as it was XLA in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitmap import RoaringBitmap
from ..insights import analysis as insights
from ..ops import dense, kernels, packing
from ..ops.words import WORDS32, as_i32, resolve_device, to_u32

ENGINES = ("cuda", "torch")

#: Blocked-layout rows per block for ad-hoc (non-resident) calls; resident
#: sets pick theirs with packing.choose_block.
BLOCK = 8


def _engine(engine: str, device: torch.device) -> str:
    if engine == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{('auto',) + ENGINES}")
    return engine


def _flatten(bitmaps) -> list[RoaringBitmap]:
    if len(bitmaps) == 1 and not hasattr(bitmaps[0], "keys"):
        return list(bitmaps[0])
    return list(bitmaps)


def _device_streams(s: packing.CompactStreams, device) -> tuple:
    """Compact streams as int32 device tensors (u16 values widened on the
    host)."""
    return (as_i32(s.dense_words, device), as_i32(s.dense_dest, device),
            as_i32(s.values.astype(np.int32), device),
            as_i32(s.val_counts, device), as_i32(s.val_dest, device))


def _unpack(keys: np.ndarray, words: torch.Tensor,
            cards: torch.Tensor) -> RoaringBitmap:
    return packing.unpack_result(keys, to_u32(words), cards.cpu().numpy())


# ----------------------------------------------------------- ad-hoc calls

def _aggregate_ragged(op: str, bitmaps: list[RoaringBitmap], engine: str,
                      device) -> RoaringBitmap:
    dev = resolve_device(device)
    eng = _engine(engine, dev)
    bitmaps = [b for b in bitmaps if not b.is_empty()]
    if not bitmaps:
        return RoaringBitmap()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()
    # compact stream ingest + device densify, then the blocked reduce (B2);
    # 64-block rounding and pow2 streams coarsen the shapes of ad-hoc calls
    blocked = packing.pack_blocked_compact(
        bitmaps, block=BLOCK, round_blocks=64, carry_slot=False)
    s = packing.pad_streams_pow2(blocked.streams)
    words = dense.densify_streams(*_device_streams(s, dev), blocked.n_rows,
                                  s.total_values)
    k = blocked.keys.size
    if eng == "cuda":
        heads, cards = kernels.segmented_reduce_blocked(
            op, words, as_i32(blocked.blk_seg, dev), k, BLOCK)
    else:
        seg_rows, head_idx, n_steps = packing.blocked_ragged_meta(
            blocked.blk_seg, BLOCK, blocked.n_blocks, k)
        heads, cards = dense.segmented_reduce(
            op, words, as_i32(seg_rows, dev), as_i32(head_idx, dev), n_steps)
    return _unpack(blocked.keys, heads, cards)


def or_(*bitmaps: RoaringBitmap, engine: str = "auto",
        device=None) -> RoaringBitmap:
    """Wide union on the device (FastAggregation.or / ParallelAggregation.or)."""
    return _aggregate_ragged("or", _flatten(bitmaps), engine, device)


def xor(*bitmaps: RoaringBitmap, engine: str = "auto",
        device=None) -> RoaringBitmap:
    """Wide symmetric difference (FastAggregation.xor)."""
    return _aggregate_ragged("xor", _flatten(bitmaps), engine, device)


def _intersect_keys(bitmaps: list[RoaringBitmap]) -> np.ndarray:
    """Surviving key set of a wide AND: AND-reduce the [N, 2048] key presence
    masks on the host (8 KiB each), then extract the set bits."""
    masks = packing.key_presence_masks(bitmaps)
    inter = np.bitwise_and.reduce(masks, axis=0)
    bits = np.unpackbits(inter.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _and_device_words(bitmaps: list[RoaringBitmap], device):
    """Key intersection -> regular [K, N, 2048] pack -> device AND-reduce.
    Returns (keys, words, cards), or None when the intersection is empty."""
    keys = _intersect_keys(bitmaps)
    if keys.size == 0:
        return None
    packed = packing.pack_for_intersection(bitmaps, keys=keys)
    words, cards = dense.regular_reduce_and(as_i32(packed.words, device))
    return packed.keys, words, cards


def and_(*bitmaps: RoaringBitmap, engine: str = "auto",
         device=None) -> RoaringBitmap:
    """Wide intersection (FastAggregation.and, workShyAnd): key-mask
    intersection, then one regular AND-reduce.  ``engine`` is checked but
    both engines run the same plain reduce."""
    dev = resolve_device(device)
    _engine(engine, dev)
    bitmaps = _flatten(bitmaps)
    if not bitmaps or any(b.is_empty() for b in bitmaps):
        return RoaringBitmap()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()
    res = _and_device_words(bitmaps, dev)
    if res is None:
        return RoaringBitmap()
    return _unpack(*res)


def _wide_cardinality(op: str, bitmaps: list, engine: str, device) -> int:
    """Cardinality-only wide op: one dense pack, then the ragged reduce
    (B1) whose cards are summed on the device."""
    dev = resolve_device(device)
    eng = _engine(engine, dev)
    bitmaps = [b for b in _flatten(bitmaps) if not b.is_empty()]
    if not bitmaps:
        return 0
    packed = packing.pack_for_aggregation(bitmaps)
    words = as_i32(packed.words, dev)
    seg_ids = as_i32(packed.seg_ids, dev)
    if eng == "cuda":
        _, cards = kernels.segmented_reduce(op, words, seg_ids,
                                            packed.num_keys)
    else:
        _, cards = dense.segmented_reduce(
            op, words, seg_ids, as_i32(packed.head_idx, dev),
            dense.n_steps_for(packed.max_group))
    return int(cards.sum())


def or_cardinality(*bitmaps: RoaringBitmap, engine: str = "auto",
                   device=None) -> int:
    """Cardinality of the wide union without materializing it on the host."""
    return _wide_cardinality("or", bitmaps, engine, device)


def xor_cardinality(*bitmaps: RoaringBitmap, engine: str = "auto",
                    device=None) -> int:
    return _wide_cardinality("xor", bitmaps, engine, device)


def and_cardinality(*bitmaps: RoaringBitmap, device=None) -> int:
    dev = resolve_device(device)
    bitmaps = _flatten(bitmaps)
    if not bitmaps or any(b.is_empty() for b in bitmaps):
        return 0
    if len(bitmaps) == 1:
        return bitmaps[0].cardinality
    res = _and_device_words(bitmaps, dev)
    return 0 if res is None else int(res[2].sum())


# ---------------------------------------------------------- resident sets

#: state arrays each layout needs (DeviceBitmapSet.from_numpy_state)
_STATE_COMMON = ("keys", "n", "block", "blk_seg", "n_blocks", "seg_sizes",
                 "seg_offsets")
_STATE_STREAMS = ("dense_words", "dense_dest", "values", "val_counts",
                  "val_dest")
_STATE_LAYOUT = {
    "dense": ("words",),
    "counts": ("counts", "grp_seg") + _STATE_STREAMS,
    "compact": ("chunk_vals", "chunk_row") + _STATE_STREAMS,
}


class DeviceBitmapSet:
    """N bitmaps packed once and kept resident on the card for repeated wide
    queries.  Inputs may mix RoaringBitmaps, SerializedViews and raw
    serialized bytes; byte-backed inputs are ingested off the wire layout.

    layout (a device-memory / query-cost ladder):
      - "dense": the dense int32[rows, 2048] image is resident; or/xor run
        the blocked reduce (B2) over it.
      - "counts": per-group 4-bit occurrence counts (half the dense image)
        plus the compact streams; or/xor run one pass off the counts (B4).
      - "compact": only the compact streams and the chunked value stream;
        every query rebuilds the image (B3) and then reduces it (B2).
      - "auto" (default): ``insights.choose_layout`` picks counts for the
        inflation-heavy mostly-singleton shape, dense otherwise.
    """

    def __init__(self, bitmaps: list, block: int | None = None,
                 layout: str = "auto", device=None):
        dev = resolve_device(device)
        if layout == "auto":
            if block is not None:
                layout = "dense"   # an explicit block targets the dense image
            else:
                rep = insights.choose_layout(
                    [v if (v := packing._as_view(b)) is not None else b
                     for b in bitmaps])
                layout = rep["layout"]
                if layout == "dense":
                    block = rep["dense_block"]
        if layout not in _STATE_LAYOUT:
            raise ValueError(f"unknown layout {layout!r}")
        g = dense.NIBBLE_GROUP
        if (layout in ("compact", "counts") and block is not None
                and (block < g or block % g
                     or (block // g) & (block // g - 1))):
            # the nibble count groups (8 rows) must tile the block
            raise ValueError(
                f"{layout} layout requires block = {g} * 2^k, got {block}")
        packed = packing.pack_blocked_compact(
            bitmaps, block=block,
            min_block=4 if (layout == "dense" and block is None) else 8)
        s = packed.streams   # rows in segment order: dense_dest ascends
        state = {"keys": packed.keys, "n": len(bitmaps),
                 "block": packed.block, "blk_seg": packed.blk_seg,
                 "n_blocks": packed.n_blocks, "seg_sizes": packed.seg_sizes,
                 "seg_offsets": packed.seg_offsets, "row_src": packed.row_src}
        state.update(dense_words=s.dense_words, dense_dest=s.dense_dest,
                     values=s.values, val_counts=s.val_counts,
                     val_dest=s.val_dest)
        if layout != "dense":
            state["chunk_vals"], state["chunk_row"] = \
                packing.chunk_value_stream(s.values, s.val_counts, s.val_dest,
                                           s.n_rows, pad_chunks_pow2=False)
        self._load(state, layout, dev)

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "DeviceBitmapSet":
        """Build a set from the packed arrays a JAX ``DeviceBitmapSet``
        holds, as NumPy arrays: ``keys``, ``n``, ``block``, ``blk_seg``,
        ``n_blocks``, ``seg_sizes``, ``seg_offsets``, and

        - dense: ``words``;
        - counts: ``counts`` and ``grp_seg`` (group axis padded as the JAX
          set pads it), plus the compact streams ``dense_words``,
          ``dense_dest``, ``values``, ``val_counts``, ``val_dest``;
        - compact: ``chunk_vals`` and ``chunk_row``, plus the streams;

        and optionally ``row_src`` (the JAX set's ``_packed.row_src``: the
        source bitmap of each row), which ``host_bitmaps`` and the batch
        engine need.  The layout follows from which arrays are present.  The
        set then answers the same queries as the set the arrays came
        from."""
        dev = resolve_device(device)
        layout = next((name for name, need in _STATE_LAYOUT.items()
                       if need[0] in state), None)
        if layout is None:
            raise ValueError("state holds none of words / counts / chunk_vals")
        missing = [k for k in _STATE_COMMON + _STATE_LAYOUT[layout]
                   if k not in state]
        if missing:
            raise ValueError(f"{layout} state is missing {missing}")
        self = cls.__new__(cls)
        self._load(state, layout, dev)
        return self

    def _load(self, state: dict, layout: str, dev: torch.device) -> None:
        self.device = dev
        self.layout = layout
        self.keys = np.asarray(state["keys"], dtype=np.uint16)
        self.n = int(state["n"])
        self.block = int(state["block"])
        self._seg_sizes = np.asarray(state["seg_sizes"])
        self._seg_offsets = np.asarray(state["seg_offsets"])
        blk_seg = np.asarray(state["blk_seg"], dtype=np.int32)
        #: host row maps: the source bitmap (-1 padding) and the key segment
        #: of every row of the blocked layout
        self.row_src = (None if state.get("row_src") is None
                        else np.asarray(state["row_src"], dtype=np.int32))
        self.row_seg = np.repeat(blk_seg, self.block)
        self._host_cache = None
        k = self.keys.size
        self._n_rows = int(blk_seg.size) * self.block
        self.blk_seg = as_i32(blk_seg, dev)
        seg_rows, head_idx, self.n_steps = packing.blocked_ragged_meta(
            blk_seg, self.block, int(state["n_blocks"]), k)
        self.seg_ids = as_i32(seg_rows, dev)
        self.head_idx = as_i32(head_idx, dev)
        self.words = self.counts = self._chunks = self._streams = None
        if "values" in state:
            s = packing.CompactStreams(
                n_rows=self._n_rows,
                dense_words=np.asarray(state["dense_words"], np.uint32),
                dense_dest=np.asarray(state["dense_dest"], np.int32),
                values=np.asarray(state["values"]),
                val_counts=np.asarray(state["val_counts"], np.int32),
                val_dest=np.asarray(state["val_dest"], np.int32))
            self._streams = _device_streams(s, dev)
            self._total_values = s.total_values
        if layout == "dense":
            self.words = (as_i32(np.asarray(state["words"]), dev)
                          if "words" in state else
                          dense.densify_streams(*self._streams, self._n_rows,
                                                self._total_values))
            self._streams = None   # the image is the resident form
            return
        if "chunk_vals" in state:
            self._chunks = (as_i32(np.asarray(state["chunk_vals"]), dev),
                            as_i32(np.asarray(state["chunk_row"]), dev))
        if layout == "counts":
            self._load_counts(state, k, dev)

    def _load_counts(self, state: dict, k: int, dev: torch.device) -> None:
        """Counts layout: the resident counts (built once from the streams
        when the state has none), with the group axis padded to a multiple
        of block // 8 under segment id K, as the JAX set pads it."""
        n_groups = self._n_rows // dense.NIBBLE_GROUP
        if "counts" in state:
            self.counts = as_i32(np.asarray(state["counts"]), dev)
            grp_seg = np.asarray(state["grp_seg"], dtype=np.int32)
        else:
            gps = self.block // dense.NIBBLE_GROUP
            counts = dense.build_group_counts(
                *self._streams, n_groups, self._total_values)
            pad = (-(n_groups + 1)) % gps
            if pad:
                counts = torch.cat([counts, counts.new_zeros(
                    (pad, dense.NIBBLE_WORDS))])
            self.counts = counts
            grp_seg = np.full(n_groups + 1 + pad, k, dtype=np.int32)
            grp_seg[:n_groups] = np.repeat(
                np.asarray(state["blk_seg"], np.int32),
                self.block // dense.NIBBLE_GROUP)
        self._grp_seg_counts = as_i32(grp_seg, dev)
        # group-level ragged metadata for the torch engine
        head_g = np.searchsorted(grp_seg[:n_groups], np.arange(k)).astype(np.int32)
        sizes_g = np.diff(np.append(head_g, n_groups))
        self._counts_head = as_i32(head_g, dev)
        self._counts_steps = dense.n_steps_for(int(sizes_g.max()) if k else 0)

    def _resident_words(self, eng: str) -> torch.Tensor:
        """The dense image: resident (dense layout) or rebuilt on the device,
        by the chunk kernel (B3) under "cuda" or the plain scatter under
        "torch"."""
        if self.words is not None:
            return self.words
        if eng == "cuda" and self._chunks is not None:
            words = kernels.densify_chunks(*self._chunks, self._n_rows)
            dense_words, dense_dest = self._streams[0], self._streams[1]
            if dense_words.shape[0]:
                words[dense_dest.long()] = dense_words
            return words
        return dense.densify_streams(*self._streams, self._n_rows,
                                     self._total_values)

    def aggregate_device(self, op: str, engine: str = "auto"):
        """Run the wide op; returns device (words int32[K, 2048], cards
        int32[K]).

        or/xor: segmented reduce over the resident layout.  and: only keys
        present in every bitmap can survive (segments with exactly n rows),
        so their rows are gathered from the image and AND-reduced as a
        regular block; the other keys get zero rows."""
        eng = _engine(engine, self.device)
        if op == "and":
            return self._and_device(eng)
        if op not in ("or", "xor"):
            raise ValueError(f"unsupported wide op {op!r}")
        k = self.keys.size
        if self.counts is not None:
            if eng == "cuda":
                return kernels.counts_segmented_reduce(
                    op, self.counts, self._grp_seg_counts, k)
            g = self.counts.shape[0]
            words_g = dense.counts_to_words(
                self.counts.view(g, 4, WORDS32), op)
            return dense.segmented_reduce(
                op, words_g, self._grp_seg_counts, self._counts_head,
                self._counts_steps)
        words = self._resident_words(eng)
        if eng == "cuda":
            return kernels.segmented_reduce_blocked(
                op, words, self.blk_seg, k, self.block)
        return dense.segmented_reduce(op, words, self.seg_ids, self.head_idx,
                                      self.n_steps)

    def _and_device(self, eng: str):
        k = self.keys.size
        words = torch.zeros((k, WORDS32), dtype=torch.int32, device=self.device)
        cards = torch.zeros(k, dtype=torch.int32, device=self.device)
        full = np.flatnonzero(self._seg_sizes == self.n)
        if full.size == 0:
            return words, cards
        rows = (self._seg_offsets[full][:, None] + np.arange(self.n)).ravel()
        block = self._resident_words(eng)[
            torch.from_numpy(rows.astype(np.int64)).to(self.device)]
        sub_words, sub_cards = dense.regular_reduce_and(
            block.view(full.size, self.n, WORDS32))
        idx = torch.from_numpy(full).to(self.device)
        words[idx] = sub_words
        cards[idx] = sub_cards
        return words, cards

    def aggregate(self, op: str, engine: str = "auto") -> RoaringBitmap:
        words, cards = self.aggregate_device(op, engine)
        return _unpack(self.keys, words, cards)

    def host_bitmaps(self) -> list[RoaringBitmap]:
        """Host copies of the source bitmaps, rebuilt from the resident rows
        (whatever the set was built from) and cached: the data the batch
        engine's host reference runs on."""
        if self._host_cache is not None:
            return self._host_cache
        if self.row_src is None:
            raise ValueError(
                "resident set lacks row_src metadata (repack required)")
        words = to_u32(self._resident_words("torch"))
        order = np.argsort(self.row_src, kind="stable")
        bounds = np.searchsorted(self.row_src[order], np.arange(self.n + 1))
        hosts = []
        for i in range(self.n):
            rows = order[bounds[i]:bounds[i + 1]]
            w = words[rows]
            cards = np.unpackbits(w.view(np.uint8), axis=1).sum(axis=1)
            hosts.append(packing.unpack_result(self.keys[self.row_seg[rows]],
                                               w, cards))
        self._host_cache = hosts
        return hosts

    def hbm_bytes(self) -> int:
        """Device bytes the set keeps resident."""
        parts = [self.blk_seg, self.seg_ids, self.head_idx, self.words,
                 self.counts, *(self._streams or ()), *(self._chunks or ())]
        return sum(t.numel() * t.element_size() for t in parts
                   if t is not None)
