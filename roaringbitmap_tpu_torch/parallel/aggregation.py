"""Wide aggregation engine on the card: the FastAggregation /
ParallelAggregation analog.

Entry points take N host bitmaps (or a resident ``DeviceBitmapSet``), run the
wide OR/AND/XOR on the device and return a host ``RoaringBitmap`` with exact
cardinalities.  The plan is the JAX package's:

1. the host packs bitmaps (or serialized bytes) by key segment into compact
   streams or u32[2048] rows (``ops.packing``);
2. the device densifies the streams (B8 on the card, which builds each row
   once; plain PyTorch on the CPU, as XLA did) and runs the segmented
   per-key reduce with a fused popcount (``ops.kernels``);
3. ``packing.unpack_result`` turns the per-key words back into a bitmap.

Engines: ``"cuda"`` runs the hand-written kernels, ``"torch"`` their plain
PyTorch versions; ``"auto"`` means ``"cuda"`` for a CUDA device and
``"torch"`` for the CPU.  Resident sets also take ``"cuda-nibble"`` (the JAX
package's ``"pallas-nibble"``): on the compact layout it runs the fused
nibble reduce (B6), on the counts layout what ``"cuda"`` runs there, and on
the dense layout it means ``"cuda"``.  On the counts layout the kernel
engines run the reduce the set recorded at load: B7 off the resident streams
where it reads no more than B4 off the counts, else B4.  ``device=None``
means ``"cuda"``: only a caller who passes ``device="cpu"`` gets the CPU, and
without a card the call raises.  The wide AND (key intersection, then one
regular [K, N, 2048] AND-reduce) is plain PyTorch on every engine, as it was
XLA in the JAX package, and so are the batched pairwise ops and
``DeviceBitmap``'s composition (one fused XLA op + popcount there, with no
Pallas kernel).

The wide calls run under ``runtime.guard`` (``fallback=True``, the default):
transient faults retry, and all of it is counted.  On the CPU lowering
faults and OOM demote "cuda" -> "torch" and the host fold is the last rung;
on the card the requested engine is the only rung, so such a fault
re-raises typed.  A failed kernel build or launch re-raises as it is.  The 64-bit tier (``or64`` / ``xor64``
/ ``and64``, and resident sets, batches and ``DeviceBitmap`` over
``Roaring64Bitmap``s) runs the same engines with the u48 key as the segment
axis; the keys stay ``np.uint64`` on the host.

The steady-state probes (``chained_wide_or``, ``chained_aggregate``,
``DevicePairSet.chained_cardinality``) return a callable that runs ``reps``
dependent queries and returns a 0-d device tensor: the summed cardinality
modulo 2^32, accumulated in int64 on the device with no host
synchronization inside the loop.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import operator
import time

import numpy as np
import torch

from ..core.bitmap import RoaringBitmap
from ..core.bitmap64 import Roaring64Bitmap
from ..core.bitset import RoaringBitSet
from ..insights import analysis as insights
from ..ops import dense, kernels, packing
from ..ops.words import WORDS32, as_i32, resolve_device, to_u32
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime import errors, faults, guard

ENGINES = ("cuda", "torch")
#: resident sets also take the nibble engine
SET_ENGINES = ENGINES + ("cuda-nibble",)

#: Blocked-layout rows per block for ad-hoc (non-resident) calls; resident
#: sets pick theirs with packing.choose_block.
BLOCK = 8

#: process-unique ids of resident sets and of the value columns attached to
#: them (one counter, so the two never collide)
_SET_UIDS = itertools.count(1)


def _engine(engine: str, device: torch.device, allowed=ENGINES) -> str:
    if engine == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if engine not in allowed:
        raise ValueError(f"unknown engine {engine!r}; expected one of "
                         f"{('auto',) + allowed}")
    return engine


def _device_key(device) -> torch.device:
    """``device`` with a bare "cuda" resolved to the current card."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def _source(b):
    """An input as the engines read it: a ``Roaring64NavigableMap`` as the
    ``Roaring64Bitmap`` over the same containers (``to_roaring64``), a
    ``RoaringBitSet`` as its backing bitmap; anything with ``keys`` /
    ``containers`` (heap bitmaps, ``ImmutableRoaringBitmap``s), bytes and
    ``SerializedView``s as they are."""
    if hasattr(b, "to_roaring64"):
        return b.to_roaring64()
    if isinstance(b, RoaringBitSet):
        return b.to_bitmap()
    return b


def _is_source(b) -> bool:
    return hasattr(b, "keys") or hasattr(b, "to_roaring64") or isinstance(
        b, RoaringBitSet)


def _flatten(bitmaps) -> list[RoaringBitmap]:
    if len(bitmaps) == 1 and not _is_source(bitmaps[0]):
        bitmaps = bitmaps[0]
    return [_source(b) for b in bitmaps]


def _device_streams(s: packing.CompactStreams, device) -> tuple:
    """Compact streams as int32 device tensors (u16 values widened on the
    host)."""
    return (as_i32(s.dense_words, device), as_i32(s.dense_dest, device),
            as_i32(s.values.astype(np.int32), device),
            as_i32(s.val_counts, device), as_i32(s.val_dest, device))


def _unpack(keys: np.ndarray, words: torch.Tensor, cards: torch.Tensor,
            out_cls=None):
    """Device words and cards -> a host bitmap (a ``Roaring64Bitmap`` for
    u64 keys unless ``out_cls`` says otherwise)."""
    return packing.unpack_result(keys, to_u32(words), cards.cpu().numpy(),
                                 out_cls=out_cls)


# ------------------------------------------------------------ the guard
#
# Every wide entry point runs its device body under ``runtime.guard``:
# transient faults retry on the same engine.  On the CPU lowering faults and
# OOM demote down ``ENGINES`` ("cuda" -> "torch") and the host fold below is
# the terminal rung; on the card the requested engine is the only rung
# (``guard.chain_from``), so they re-raise typed.  Every retry, demotion and
# landing is counted (``guard.dispatch_stats``).  A failed kernel build or
# launch is not a fault the guard handles: it re-raises as it is.
# ``fallback=False`` runs the requested engine raw (no guard, no injection),
# so a test pinned to one engine sees that engine.

_SEQ_OP = {"or": operator.or_, "and": operator.and_, "xor": operator.xor}


def _sequential_reduce(op: str, bitmaps: list):
    """The host rung: a container-algebra fold with no device, the terminal
    rung of every wide chain and the oracle of the shadow check."""
    acc = bitmaps[0].clone()
    fn = _SEQ_OP[op]
    for b in bitmaps[1:]:
        acc = fn(acc, b)
    return acc


def _guarded_wide(op: str, bitmaps: list, engine: str, dev, raw,
                  fallback: bool, sequential=None, ladder=ENGINES):
    """``raw(eng)`` on ``engine`` alone when ``fallback`` is off; else under
    the guard from ``engine``'s rung of ``ladder`` (``guard.chain_from``
    for ``dev``) with the fault seam before each attempt and the host fold
    as the terminal rung off the card (``sequential`` overrides it for
    cardinality-only calls), then a sampled result shadow-checked against
    that fold."""
    if not fallback:
        return raw(engine)
    site = "aggregation"

    def attempt(rung):
        faults.maybe_fail(site, rung)
        return raw(rung)

    policy = guard.GuardPolicy.from_env()
    with obs_trace.span("aggregation.wide", site=site, op=op,
                        n=len(bitmaps), engine=engine) as sp:
        res, rung = guard.run_with_fallback(
            site, guard.chain_from(engine, ladder, dev), attempt,
            policy=policy, sequential=sequential or (
                lambda: _sequential_reduce(op, bitmaps)))
        sp.tag(rung_used=rung)
    if (rung != guard.SEQUENTIAL and policy.shadow_rate > 0.0
            and guard.shadow_sample(1, policy.shadow_rate,
                                    policy.shadow_seed, site)):
        ref = _sequential_reduce(op, bitmaps)
        if hasattr(res, "cardinality"):   # a materialized result
            bad, got, want = res != ref, res.cardinality, ref.cardinality
        else:                             # a cardinality
            bad, got, want = res != ref.cardinality, res, ref.cardinality
        if bad:
            detail = (f"cardinality {got} != {want}" if got != want else
                      f"equal cardinality {got} but differing members")
            raise errors.ShadowMismatch(
                f"wide {op} over {len(bitmaps)} bitmaps diverged from the "
                f"sequential reference: {detail}")
    return res


# ----------------------------------------------------------- ad-hoc calls

def _aggregate_ragged(op: str, bitmaps: list, engine: str, device,
                      out_cls=None, fallback: bool = True):
    dev = resolve_device(device)
    eng = _engine(engine, dev)
    bitmaps = [b for b in bitmaps if not b.is_empty()]
    if not bitmaps:
        return (out_cls or RoaringBitmap)()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()
    return _guarded_wide(
        op, bitmaps, eng, dev,
        lambda rung: _aggregate_ragged_device(op, bitmaps, rung, dev,
                                              out_cls), fallback)


def _aggregate_ragged_device(op: str, bitmaps: list, eng: str, dev,
                             out_cls=None):
    # compact stream ingest + device densify, then the blocked reduce (B2);
    # 64-block rounding and pow2 streams coarsen the shapes of ad-hoc calls
    blocked = packing.pack_blocked_compact(
        bitmaps, block=BLOCK, round_blocks=64, carry_slot=False)
    s = packing.pad_streams_pow2(blocked.streams)
    build = (dense.densify_streams_impl if eng == "torch"
             else kernels.row_build)
    words = build(*_device_streams(s, dev), blocked.n_rows, s.total_values)
    k = blocked.keys.size
    if eng == "cuda":
        heads, cards = kernels.segmented_reduce_blocked(
            op, words, as_i32(blocked.blk_seg, dev), k, BLOCK)
    else:
        seg_rows, head_idx, n_steps = packing.blocked_ragged_meta(
            blocked.blk_seg, BLOCK, blocked.n_blocks, k)
        heads, cards = dense.segmented_reduce(
            op, words, as_i32(seg_rows, dev), as_i32(head_idx, dev), n_steps)
    return _unpack(blocked.keys, heads, cards, out_cls)


def or_(*bitmaps: RoaringBitmap, engine: str = "auto", device=None,
        fallback: bool = True) -> RoaringBitmap:
    """Wide union on the device (FastAggregation.or / ParallelAggregation.or)."""
    return _aggregate_ragged("or", _flatten(bitmaps), engine, device,
                             fallback=fallback)


def xor(*bitmaps: RoaringBitmap, engine: str = "auto", device=None,
        fallback: bool = True) -> RoaringBitmap:
    """Wide symmetric difference (FastAggregation.xor)."""
    return _aggregate_ragged("xor", _flatten(bitmaps), engine, device,
                             fallback=fallback)


def _intersect_keys(bitmaps: list) -> np.ndarray:
    """Surviving key set of a wide AND: AND-reduce the [N, 2048] key presence
    masks on the host (8 KiB each), then extract the set bits.  The 64-bit
    tier's u48 keys have no fixed-size mask: an intersect1d chain in
    ``np.uint64`` on the host."""
    if bitmaps[0].keys.dtype != np.uint16:
        keys = bitmaps[0].keys
        for b in bitmaps[1:]:
            keys = np.intersect1d(keys, b.keys, assume_unique=True)
            if keys.size == 0:
                break
        return keys
    masks = packing.key_presence_masks(bitmaps)
    inter = np.bitwise_and.reduce(masks, axis=0)
    bits = np.unpackbits(inter.view(np.uint8), bitorder="little")
    return np.flatnonzero(bits).astype(np.uint16)


def _and_device_words(bitmaps: list, device):
    """Key intersection -> regular [K, N, 2048] pack -> device AND-reduce.
    Returns (keys, words, cards), or None when the intersection is empty."""
    keys = _intersect_keys(bitmaps)
    if keys.size == 0:
        return None
    packed = packing.pack_for_intersection(bitmaps, keys=keys)
    words, cards = dense.regular_reduce_and(as_i32(packed.words, device))
    return packed.keys, words, cards


#: the wide AND's one rung: its device engine is plain PyTorch on every
#: engine (the JAX package's "xla"), so off the card the only demotion is
#: to the host fold, and on the card there is none
_AND_RUNG = "torch"


def and_(*bitmaps: RoaringBitmap, engine: str = "auto", device=None,
         out_cls=None, fallback: bool = True) -> RoaringBitmap:
    """Wide intersection (FastAggregation.and, workShyAnd): key-mask
    intersection, then one regular AND-reduce.  ``engine`` is checked but
    both engines run the same plain reduce."""
    dev = resolve_device(device)
    _engine(engine, dev)
    cls = out_cls or RoaringBitmap
    bitmaps = _flatten(bitmaps)
    if not bitmaps or any(b.is_empty() for b in bitmaps):
        return cls()
    if len(bitmaps) == 1:
        return bitmaps[0].clone()

    def raw(_rung):
        res = _and_device_words(bitmaps, dev)
        return cls() if res is None else _unpack(*res, cls)

    return _guarded_wide("and", bitmaps, _AND_RUNG, dev, raw, fallback,
                         ladder=(_AND_RUNG,))


def _wide_cardinality(op: str, bitmaps: list, engine: str, device,
                      fallback: bool = True) -> int:
    """Cardinality-only wide op: one dense pack, then the ragged reduce
    (B1) whose cards are summed on the device."""
    dev = resolve_device(device)
    eng = _engine(engine, dev)
    bitmaps = [b for b in _flatten(bitmaps) if not b.is_empty()]
    if not bitmaps:
        return 0
    packed = packing.pack_for_aggregation(bitmaps)

    def raw(rung):
        words = as_i32(packed.words, dev)
        seg_ids = as_i32(packed.seg_ids, dev)
        if rung == "cuda":
            _, cards = kernels.segmented_reduce(op, words, seg_ids,
                                                packed.num_keys)
        else:
            _, cards = dense.segmented_reduce(
                op, words, seg_ids, as_i32(packed.head_idx, dev),
                dense.n_steps_for(packed.max_group))
        return int(cards.sum())

    return _guarded_wide(
        op, bitmaps, eng, dev, raw, fallback,
        sequential=lambda: _sequential_reduce(op, bitmaps).cardinality)


def or_cardinality(*bitmaps: RoaringBitmap, engine: str = "auto",
                   device=None, fallback: bool = True) -> int:
    """Cardinality of the wide union without materializing it on the host."""
    return _wide_cardinality("or", bitmaps, engine, device, fallback)


def xor_cardinality(*bitmaps: RoaringBitmap, engine: str = "auto",
                    device=None, fallback: bool = True) -> int:
    return _wide_cardinality("xor", bitmaps, engine, device, fallback)


def and_cardinality(*bitmaps: RoaringBitmap, device=None,
                    fallback: bool = True) -> int:
    dev = resolve_device(device)
    bitmaps = _flatten(bitmaps)
    if not bitmaps or any(b.is_empty() for b in bitmaps):
        return 0
    if len(bitmaps) == 1:
        return bitmaps[0].cardinality

    def raw(_rung):
        res = _and_device_words(bitmaps, dev)
        return 0 if res is None else int(res[2].sum())

    return _guarded_wide(
        "and", bitmaps, _AND_RUNG, dev, raw, fallback, ladder=(_AND_RUNG,),
        sequential=lambda: _sequential_reduce("and", bitmaps).cardinality)


# ------------------------------------------------------------- 64-bit tier
# Wide aggregation over Roaring64Bitmaps: the same engines and kernels, with
# the u48 key of the 64-bit tier as the segment axis in place of the u16
# key.  Keys stay u64 NumPy arrays on the host; the kernels see only
# segment ids.

def or64(*bitmaps, engine: str = "auto", device=None,
         fallback: bool = True) -> Roaring64Bitmap:
    return _aggregate_ragged("or", _flatten(bitmaps), engine, device,
                             out_cls=Roaring64Bitmap, fallback=fallback)


def xor64(*bitmaps, engine: str = "auto", device=None,
          fallback: bool = True) -> Roaring64Bitmap:
    return _aggregate_ragged("xor", _flatten(bitmaps), engine, device,
                             out_cls=Roaring64Bitmap, fallback=fallback)


def and64(*bitmaps, engine: str = "auto", device=None,
          fallback: bool = True) -> Roaring64Bitmap:
    return and_(*bitmaps, engine=engine, device=device,
                out_cls=Roaring64Bitmap, fallback=fallback)


def explain_wide(op: str, bitmaps, engine: str = "auto", device=None) -> dict:
    """Plan report of one wide op (the ``BatchEngine.explain`` analog for
    the ad-hoc entry points): the engine that would run and its fallback
    chain, the device rows the call would gather and their bytes
    (``insights.dense_rows_bytes``), and whether that clears the device
    memory budget.  Keys as the JAX package's; engine names the port's."""
    if op not in ("or", "and", "xor"):
        raise ValueError(f"unsupported wide op {op!r}")
    dev = resolve_device(device)
    bitmaps = _flatten([bitmaps] if _is_source(bitmaps) else bitmaps)
    # the AND is pinned to its one rung (see and_): name what really runs
    if op == "and":
        _engine(engine, dev)
        eng, ladder = _AND_RUNG, (_AND_RUNG,)
    else:
        eng, ladder = _engine(engine, dev), ENGINES
    chain = guard.chain_from(eng, ladder, dev)
    containers = sum(b.container_count() for b in bitmaps)
    rows = packing.blocked_block_count(bitmaps, BLOCK) * BLOCK \
        if bitmaps else 0
    predicted = insights.dense_rows_bytes(rows)
    budget = guard.resolve_hbm_budget(None, dev)
    return {
        "site": "aggregation", "op": op, "n": len(bitmaps),
        "engine_requested": engine, "engine": eng,
        "engine_chain": list(chain),
        "containers": int(containers), "device_rows": int(rows),
        "predicted_hbm_bytes": int(predicted),
        "hbm_budget_bytes": budget,
        "within_budget": budget is None or predicted <= budget,
    }


# ---------------------------------------------------------- batched pairwise
#
# P pairs aligned on their per-pair key unions, both sides densified on the
# device, then one elementwise op + popcount (``dense.pairwise``).  The JAX
# package runs this as one XLA fusion and has no Pallas kernel for it, so it
# stays plain PyTorch here.  ``engine`` is checked and both engines run the
# same ops.

class UnsupportedPairOp(KeyError, ValueError):
    """An op outside or/and/xor/andnot: a ``KeyError`` as the JAX package
    raises it (its op table lookup), and a ``ValueError`` as a bad argument
    value, so callers of either package keep working."""


def _check_pair_op(op: str) -> None:
    if op not in dense.OPS:
        raise UnsupportedPairOp(f"unsupported pairwise op {op!r}")


def _densify_side(s: packing.CompactStreams, n_rows: int, device):
    """One operand side's compact streams -> int32[n_rows, 2048] on the
    device.  Eager PyTorch does not recompile per shape, so the streams are
    not padded to powers of two as in JAX."""
    return kernels.row_build(*_device_streams(s, device), n_rows,
                             s.total_values)


def _unpack_pairs(keys: np.ndarray, heads: np.ndarray, words: torch.Tensor,
                  cards: torch.Tensor) -> list[RoaringBitmap]:
    """Device pairwise result -> one host bitmap per pair (heads bounds)."""
    words, cards = to_u32(words), cards.cpu().numpy()
    return [packing.unpack_result(keys[lo:hi], words[lo:hi], cards[lo:hi])
            for lo, hi in zip(heads[:-1], heads[1:])]


def _per_pair_cards(cards: torch.Tensor, heads: np.ndarray) -> np.ndarray:
    """Per-row device cards -> int64[P] per-pair sums over the heads
    bounds."""
    csum = np.concatenate(([0], np.cumsum(cards.cpu().numpy(),
                                          dtype=np.int64)))
    return csum[heads[1:]] - csum[heads[:-1]]


def pairwise_device(op: str, pairs, engine: str = "auto", device=None):
    """Batched pairwise op on P bitmap pairs -> (int32[M, 2048] words,
    int32[M] cards, the pack) on the device, M the aligned rows."""
    _check_pair_op(op)
    dev = resolve_device(device)
    _engine(engine, dev)
    packed = packing.pack_pairwise(list(pairs), pad_rows=False)
    a = _densify_side(packed.a_streams, packed.n_rows, dev)
    b = _densify_side(packed.b_streams, packed.n_rows, dev)
    words, cards = dense.pairwise(op, a, b)
    return words, cards, packed


def pairwise(op: str, pairs, engine: str = "auto",
             device=None) -> list[RoaringBitmap]:
    """[a_i op b_i for each pair], op one of or/and/xor/andnot."""
    words, cards, packed = pairwise_device(op, pairs, engine, device)
    return _unpack_pairs(packed.keys, packed.heads, words, cards)


def pairwise_cardinality(op: str, pairs, engine: str = "auto",
                         device=None) -> np.ndarray:
    """int64[P] result cardinalities only: P scalars leave the device."""
    _, cards, packed = pairwise_device(op, pairs, engine, device)
    return _per_pair_cards(cards, packed.heads)


def chained_pairwise_cardinality(op: str, pairs, reps: int,
                                 engine: str = "auto", device=None):
    """Steady-state probe of the batched pairwise op over a resident dense
    pair set: (callable -> summed cardinality over reps mod 2^32 as a 0-d
    device tensor, the pack)."""
    ps = DevicePairSet(list(pairs), layout="dense", device=device)
    return ps.chained_cardinality(op, reps, engine), ps._packed


class DevicePairSet:
    """P bitmap pairs aligned once and kept resident for repeated pairwise
    queries.

    layout:
      - "dense" (default): both aligned int32[rows, 2048] images resident;
      - "compact": only the compact streams resident; every query
        densifies both sides on the device.
    """

    def __init__(self, pairs: list, layout: str = "dense", device=None):
        if layout not in ("dense", "compact"):
            raise ValueError(f"unknown layout {layout!r}")
        dev = resolve_device(device)
        self.device, self.layout = dev, layout
        p = packing.pack_pairwise(list(pairs), pad_rows=False)
        self._packed = p
        self.keys, self.heads = p.keys, p.heads
        self.n_pairs = int(p.heads.size) - 1
        self._n_rows = p.n_rows
        self._a = (_device_streams(p.a_streams, dev), p.a_streams.total_values)
        self._b = (_device_streams(p.b_streams, dev), p.b_streams.total_values)
        self.a_words = self.b_words = None
        if layout == "dense":
            self.a_words, self.b_words = self._densify()
            # the images are the resident form: drop the device streams and
            # the pack's host streams
            self._a = self._b = None
            p.a_streams = p.b_streams = None
        obs_memory.LEDGER.register("pair_set", layout, self.hbm_bytes(),
                                   owner=self)

    def _densify(self):
        return tuple(kernels.row_build(*s, self._n_rows, nv)
                     for s, nv in (self._a, self._b))

    def _sides(self):
        if self.a_words is not None:
            return self.a_words, self.b_words
        return self._densify()

    def pairwise_device(self, op: str, engine: str = "auto"):
        """(int32[M, 2048] result words, int32[M] cards) on the device."""
        _check_pair_op(op)
        _engine(engine, self.device)
        return dense.pairwise(op, *self._sides())

    def cardinalities(self, op: str, engine: str = "auto") -> np.ndarray:
        """int64[P] per-pair result cardinalities."""
        return _per_pair_cards(self.pairwise_device(op, engine)[1],
                               self.heads)

    def pairwise(self, op: str, engine: str = "auto") -> list[RoaringBitmap]:
        """[a_i op b_i], materialized to host bitmaps."""
        words, cards = self.pairwise_device(op, engine)
        return _unpack_pairs(self.keys, self.heads, words, cards)

    def chained_cardinality(self, op: str, reps: int, engine: str = "auto"):
        """A callable running ``reps`` pairwise queries in turn, each summing
        its cards into an int64 device total; returns the total mod 2^32 as
        a 0-d device tensor.  The compact layout densifies both sides every
        iteration: that is its per-query cost.  Eager PyTorch does not hoist
        or elide a repeated call, so JAX's optimization_barrier has no
        counterpart here."""
        _check_pair_op(op)
        _engine(engine, self.device)

        def run():
            total = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(reps):
                cards = dense.pairwise(op, *self._sides())[1]
                total += cards.sum(dtype=torch.int64)
            return total % (1 << 32)

        return run

    def hbm_bytes(self) -> int:
        """Device bytes the pair set keeps resident."""
        if self.a_words is not None:
            parts = (self.a_words, self.b_words)
        else:
            parts = self._a[0] + self._b[0]
        return sum(t.numel() * t.element_size() for t in parts)


# ---------------------------------------------------------- resident sets

#: state arrays each layout needs (DeviceBitmapSet.from_numpy_state)
_STATE_COMMON = ("keys", "n", "block", "blk_seg", "n_blocks", "seg_sizes",
                 "seg_offsets")
_STATE_STREAMS = ("dense_words", "dense_dest", "values", "val_counts",
                  "val_dest")
#: the run stream, optional: where the dense image is built from the
#: streams (the dense layout's own build), run containers may come as runs
_STATE_RUNS = ("runs", "run_counts", "run_dest")
_STATE_LAYOUT = {
    "dense": ("words",),
    "counts": ("counts", "grp_seg") + _STATE_STREAMS,
    "compact": ("chunk_vals", "chunk_row") + _STATE_STREAMS,
}


class _BuildClock:
    """The clock of one resident set's build, opened as the ``set.build``
    span (use as a context manager).  Each phase (``choose_layout``,
    ``pack``, ``upload``, ``device``) runs once and is timed once: the
    time is a child span ``set.build.<phase>`` and, at ``finish``, one
    observation of ``rb_ingest_phase_seconds{layout, phase}``.  ``finish``
    also observes ``rb_ingest_build_seconds{layout}`` from the clock's
    start and tags the span.  The device phase ends with the card done
    (``DeviceBitmapSet._load``), so the build's clock stops after it."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.seconds: dict = {}
        self._span = obs_trace.span("set.build")

    def __enter__(self):
        self._span.__enter__()
        return self

    def __exit__(self, *exc):
        return self._span.__exit__(*exc)

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the phase ``name``; yields its span, for tags."""
        with obs_trace.span("set.build." + name) as sp:
            t = time.perf_counter()
            yield sp
            self.seconds[name] = time.perf_counter() - t

    def finish(self, ds: "DeviceBitmapSet") -> None:
        for name, sec in self.seconds.items():
            obs_metrics.histogram("rb_ingest_phase_seconds", layout=ds.layout,
                                  phase=name).observe(sec)
        # the cold build (pack, transfer, densify) as a first-class metric
        obs_metrics.histogram("rb_ingest_build_seconds",
                              layout=ds.layout).observe(
                                  time.perf_counter() - self.t0)
        self._span.tag(layout=ds.layout, n=ds.n, keys=int(ds.keys.size),
                       rows=ds._n_rows)


class DeviceBitmapSet:
    """N bitmaps packed once and kept resident on the card for repeated wide
    queries.  Inputs may mix RoaringBitmaps, ImmutableRoaringBitmaps,
    SerializedViews and raw serialized bytes (byte-backed inputs are
    ingested off the wire layout, no container decoded), and over u48 keys
    Roaring64Bitmaps and Roaring64NavigableMaps.

    layout (a device-memory / query-cost ladder):
      - "dense": the dense int32[rows, 2048] image is resident.  Its build
        ships run containers as runs and builds each row once on the card
        (B8).  On the card or/xor run one pass off the streams (B7's run
        variant), which the set then keeps beside the image, where that
        reads at most half what the blocked reduce (B2) reads of the image,
        which runs otherwise (``reduce_path``); AND and the batch engines
        read the image.
      - "counts": per-group 4-bit occurrence counts (half the dense image)
        plus the compact streams; or/xor run one pass off the streams (B7)
        where that reads no more than one pass off the counts (B4), which
        runs otherwise (``reduce_path``).
      - "compact": only the compact streams and the chunked value stream;
        every query rebuilds the image (B3) and then reduces it (B2), or,
        under ``"cuda-nibble"``, builds the value stream's nibble counts
        and the dense-wire rows' per-segment partials and folds both in
        one pass (B6), with no row image.
      - "auto" (default): ``insights.choose_layout`` picks counts for the
        inflation-heavy mostly-singleton shape, dense otherwise.
    """

    def __init__(self, bitmaps: list, block: int | None = None,
                 layout: str = "auto", device=None):
        with _BuildClock() as clock:
            dev = resolve_device(device)
            bitmaps = [_source(b) for b in bitmaps]
            if layout == "auto":
                if block is not None:
                    layout = "dense"   # an explicit block targets the image
                else:
                    with clock.phase("choose_layout"):
                        rep = insights.choose_layout(
                            [v if (v := packing._as_view(b)) is not None
                             else b for b in bitmaps])
                    layout = rep["layout"]
                    if layout == "dense":
                        # empty or unsizeable input carries no block advice
                        block = rep.get("dense_block")
            if layout not in _STATE_LAYOUT:
                raise ValueError(f"unknown layout {layout!r}")
            g = dense.NIBBLE_GROUP
            if (layout in ("compact", "counts") and block is not None
                    and (block < g or block % g
                         or (block // g) & (block // g - 1))):
                # the nibble count groups (8 rows) must tile the block
                raise ValueError(
                    f"{layout} layout requires block = {g} * 2^k, "
                    f"got {block}")
            with clock.phase("pack") as sp:
                state = _pack_state(bitmaps, block, layout)
                kinds = state.get("container_kinds") or {}
                sp.tag(run_containers=kinds.get("run"),
                       runs=_run_pairs(state))
            self._load(state, layout, dev, clock)
            clock.finish(self)

    @classmethod
    def from_numpy_state(cls, state: dict, device=None) -> "DeviceBitmapSet":
        """Build a set from the packed arrays a JAX ``DeviceBitmapSet``
        holds, as NumPy arrays: ``keys``, ``n``, ``block``, ``blk_seg``,
        ``n_blocks``, ``seg_sizes``, ``seg_offsets``, and

        - dense: ``words``, or the compact streams ``dense_words``,
          ``dense_dest``, ``values``, ``val_counts``, ``val_dest`` alone
          (the image is then built from them, as the set's own build does);
        - counts: ``counts`` and ``grp_seg`` (group axis padded as the JAX
          set pads it), plus the compact streams ``dense_words``,
          ``dense_dest``, ``values``, ``val_counts``, ``val_dest``;
        - compact: ``chunk_vals`` and ``chunk_row``, plus the streams;

        and optionally the run stream ``runs`` (u16 (start, length - 1)
        pairs as serialized), ``run_counts`` and ``run_dest``, which only a
        dense image built from the streams reads (a state without them
        loads as before), ``row_src`` (the JAX set's ``_packed.row_src``: the
        source bitmap of each row), which ``host_bitmaps`` and the batch
        engine need, and ``carry_row`` (``_packed.carry_row``, the spare
        segment-0 row the compact probe writes its carry to; by default
        ``seg_sizes[0]``, where the packer puts it).  The dense-wire rows
        may come in any order (the JAX native ingest does not sort them);
        the set sorts them, the sparse containers and the run stream, and
        the chunk stream, by destination row.  The layout follows from
        which arrays are present.  The set then answers the same queries as
        the set the arrays came from."""
        with _BuildClock() as clock:
            dev = resolve_device(device)
            layout = next((name for name, need in _STATE_LAYOUT.items()
                           if need[0] in state), None)
            need = _STATE_LAYOUT.get(layout, ())
            if layout is None and "dense_words" in state:
                # the streams alone: the dense image built from them
                layout, need = "dense", _STATE_STREAMS
            if layout is None:
                raise ValueError(
                    "state holds none of words / counts / chunk_vals / "
                    "dense_words")
            missing = [k for k in _STATE_COMMON + need if k not in state]
            if missing:
                raise ValueError(f"{layout} state is missing {missing}")
            self = cls.__new__(cls)
            self._load(state, layout, dev, clock)
            clock.finish(self)
        return self

    def _load(self, state: dict, layout: str, dev: torch.device,
              clock: "_BuildClock") -> None:
        """Load a packed state: the host maps, then every array the card
        keeps in one upload, then the device work (the image, the counts,
        B3's chunk bounds) in one phase that ends once the card is done."""
        self.device = dev
        self.layout = layout
        # u16 keys (32-bit tier) or u64 u48 keys (64-bit tier): the keys
        # stay on the host, the kernels see only segment ids
        self.keys = np.asarray(state["keys"])
        self.n = int(state["n"])
        # identity and version lineage (``mutation``): a set that already
        # carries them keeps them when its layout is loaded again (the
        # repack path re-runs __init__), so result-cache and plan keys stay
        # honest over the set's whole mutable life; so do the attached
        # columns, which index the row-id universe, not the packed rows
        if not hasattr(self, "uid") or len(self.source_versions) != self.n:
            self.uid = next(_SET_UIDS)
            self.version = 0
            self.structure_version = 0
            self.source_versions = np.zeros(self.n, np.int64)
        if not hasattr(self, "columns"):
            #: attached value columns by name (attach_column)
            self.columns: dict = {}
        self.block = int(state["block"])
        self._seg_sizes = np.asarray(state["seg_sizes"])
        self._seg_offsets = np.asarray(state["seg_offsets"])
        blk_seg = np.asarray(state["blk_seg"], dtype=np.int32)
        #: host row maps: the source bitmap (-1 padding) and the key segment
        #: of every row of the blocked layout
        self.row_src = (None if state.get("row_src") is None
                        else np.asarray(state["row_src"], dtype=np.int32))
        self.row_seg = np.repeat(blk_seg, self.block)
        k = self.keys.size
        self._n_rows = int(blk_seg.size) * self.block
        seg_rows, head_idx, self.n_steps = packing.blocked_ragged_meta(
            blk_seg, self.block, int(state["n_blocks"]), k)
        #: a spare zero row of segment 0: the compact probe's carry slot
        self.carry_row = int(state.get(
            "carry_row", self._seg_sizes[0] if k else -1))
        self.words = self.counts = self._chunks = self._streams = None
        self._chunk_bounds = self._stream_plan = None
        #: the or/xor the kernel engines run, where a layout has a choice
        #: (counts: "streams" or "counts"; dense: "streams" or "image")
        self.reduce_path = None
        # what the card keeps, by attribute: host arrays (or tuples of
        # them) uploaded in one phase
        host = {"blk_seg": blk_seg, "seg_ids": seg_rows, "head_idx": head_idx}
        self._runs = self._row_plan = None
        runs = None
        if state.get("runs") is not None and "words" not in state:
            if layout != "dense":
                raise ValueError(
                    f"a run stream builds a dense image; the {layout} "
                    f"layout reads values")
            runs = (np.ascontiguousarray(state["runs"], np.uint16),
                    np.asarray(state["run_counts"], np.int32),
                    np.asarray(state["run_dest"], np.int32))
        if "words" in state:
            host["words"] = np.asarray(state["words"])
            if layout == "dense":
                self.reduce_path = "image"
        else:
            s = packing.CompactStreams(
                n_rows=self._n_rows,
                dense_words=np.asarray(state["dense_words"], np.uint32),
                dense_dest=np.asarray(state["dense_dest"], np.int32),
                values=np.asarray(state["values"]),
                val_counts=np.asarray(state["val_counts"], np.int32),
                val_dest=np.asarray(state["val_dest"], np.int32))
            s, runs = _sort_streams(s, runs)
            if layout != "dense":
                host.update(self._compact_meta(s, blk_seg))
            else:
                if dev.type == "cuda":
                    # B8's plan, from the sorted destinations
                    host["_row_plan"] = kernels.row_build_plan(
                        *(_host_i32(a) for a in (s.val_counts, s.val_dest,
                                                 s.dense_dest)),
                        self._n_rows,
                        *(_host_i32(a) for a in (runs or ())[1:]))
                if runs is not None:
                    # the run pairs as one u32 each
                    host["_runs"] = (runs[0].view(np.uint32), *runs[1:])
                if dev.type in kernels.DENSE_STREAM_DEVICES:
                    host.update(self._dense_stream_meta(s, runs))
                else:
                    self.reduce_path = "image"
            host["_streams"] = (s.dense_words, s.dense_dest, s.values,
                                s.val_counts, s.val_dest)
            self._total_values = s.total_values
        if "chunk_vals" in state:
            # B3 takes each row's chunks between two bounds of the stream
            # sorted by row: sort it, and plan the bounds once
            rows, vals = _sorted_by(np.asarray(state["chunk_row"]),
                                    np.asarray(state["chunk_vals"]))
            host["_chunks"] = (vals, rows)
        if layout == "counts":
            host.update(self._counts_meta(state, k))
            host["_stream_plan"] = self._stream_meta(
                s, host["_grp_seg_counts"].size)
        with clock.phase("upload"):
            for name, a in host.items():
                setattr(self, name, _to_device(a, dev))
        timer = None
        if layout == "dense" and self.words is None and dev.type == "cuda":
            timer = kernels.LaunchTimer("b8")
            # the kernel libraries' first load (with their nvcc build) is a
            # program build of the process, not a phase of this set's
            kernels.B8.load()
        with clock.phase("device"):
            if layout == "dense" and self.words is None:
                # B8 on the card, timed by CUDA events: a build runs
                # outside any traced window
                self.words = kernels.row_build(
                    *self._streams, self._n_rows, self._total_values,
                    runs=self._runs, plan=self._row_plan, timer=timer)
            if self._chunks is not None:
                self._chunk_bounds = kernels.densify_chunk_bounds(
                    self._chunks[1], self._n_rows)
            if layout == "counts" and self.counts is None:
                self._build_counts()
            if "values" in state:
                # a run container counts as the value stream and the
                # dense-wire rows counted it before it came as runs
                base = (int(np.asarray(state["values"]).size) + 4096
                        * int(np.asarray(state["dense_words"]).shape[0])
                        + (0 if runs is None else int(np.minimum(
                            packing.run_cardinalities(*runs[:2]),
                            4096).sum())))
            else:
                base = int(dense.popcount(self.words).sum(dtype=torch.int64))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        if timer is not None:
            timer.observe()
        self._row_plan = None
        if layout == "dense" and self.reduce_path != "streams":
            # the image is the resident form
            self._streams = self._runs = None
        _count_ingest(state, layout, self._n_rows)
        self._init_mutation(base)

    def _init_mutation(self, base: int) -> None:
        """Per-pack mutation state (``mutation.delta``): every row stamped
        at the current version, an empty delta journal, no host twin, and
        the pack-time value floor ``base`` of the drift heuristic: the
        sparse stream values plus 4,096 per dense-wire row, as the JAX
        package counts it (for a state without streams, the image's set
        bits)."""
        self.row_versions = np.full(self._n_rows, self.version, np.int64)
        self._delta_journal: list = []
        #: the warmed "delta:N" patch programs (``mutation.delta``): keyed
        #: on this image's address, so a repack's new image starts empty
        self._delta_programs: dict = {}
        self._delta_pool = None
        self._journal_dropped_version = getattr(
            self, "_journal_dropped_version", 0)
        self._host_cache = None
        self._mutation_base_values = base
        self._mutated_values = 0
        self._register_residency()

    def _register_residency(self) -> None:
        """Resident bytes in the HBM ledger, released when the set is
        collected, recounted when the structure version or the reduce path
        moves (a patch drops a dense set's streams); a repack
        (``mutation.delta``) registers the set again under its new
        layout."""
        self._ledger_handle = obs_memory.LEDGER.register(
            "bitmap_set", self.layout, DeviceBitmapSet.hbm_bytes, owner=self,
            stamp=lambda s: (s.structure_version, s.layout, s.reduce_path))

    def _compact_meta(self, s: packing.CompactStreams,
                      blk_seg: np.ndarray) -> dict:
        """Host metadata of the fused compact reduce (B6), by attribute:
        the count groups' segment ids (the scratch group last, under id K),
        and the dense-wire rows' segment ids with their head maps, plain
        and with the compact probe's carry row prepended as a segment-0
        row."""
        k = self.keys.size
        n_groups = s.n_rows // dense.NIBBLE_GROUP
        grp_seg = np.full(n_groups + 1, k, dtype=np.int32)
        grp_seg[:n_groups] = np.repeat(blk_seg,
                                       self.block // dense.NIBBLE_GROUP)
        self._n_groups = n_groups
        dseg = blk_seg[s.dense_dest // self.block].astype(np.int32)

        def head_maps(seg_ids: np.ndarray):
            """(head_idx int32[K+1], valid bool[K+1], n_steps) over sorted
            per-dense-row segment ids; row K is the scratch segment."""
            head = np.searchsorted(seg_ids, np.arange(k + 1)).astype(np.int32)
            safe = np.minimum(head, max(seg_ids.size - 1, 0))
            valid = ((head < seg_ids.size) & (seg_ids[safe] == np.arange(k + 1))
                     if seg_ids.size else np.zeros(k + 1, bool))
            sizes = np.diff(np.append(head, seg_ids.size))
            n_steps = dense.n_steps_for(int(sizes.max()) if k else 0)
            return head, valid, n_steps

        dseg_c = np.concatenate(([np.int32(0)], dseg))
        return {"_grp_seg": grp_seg, "_dseg": dseg, "_dmeta": head_maps(dseg),
                "_dseg_carry": dseg_c, "_dmeta_carry": head_maps(dseg_c)}

    def _counts_meta(self, state: dict, k: int) -> dict:
        """Host metadata of the counts layout, by attribute: the groups'
        segment ids, with the group axis padded to a multiple of block // 8
        under segment id K as the JAX set pads it, their heads for the
        torch engine, and the state's counts where it has them (else
        ``_build_counts`` builds them on the device)."""
        n_groups = self._n_rows // dense.NIBBLE_GROUP
        out = {}
        if "counts" in state:
            out["counts"] = np.asarray(state["counts"])
            grp_seg = np.asarray(state["grp_seg"], dtype=np.int32)
        else:
            gps = self.block // dense.NIBBLE_GROUP
            pad = (-(n_groups + 1)) % gps
            grp_seg = np.full(n_groups + 1 + pad, k, dtype=np.int32)
            grp_seg[:n_groups] = np.repeat(
                np.asarray(state["blk_seg"], np.int32),
                self.block // dense.NIBBLE_GROUP)
        # group-level ragged metadata for the torch engine
        head_g = np.searchsorted(grp_seg[:n_groups], np.arange(k)).astype(np.int32)
        sizes_g = np.diff(np.append(head_g, n_groups))
        self._counts_steps = dense.n_steps_for(int(sizes_g.max()) if k else 0)
        out.update(_grp_seg_counts=grp_seg, _counts_head=head_g)
        return out

    def _stream_meta(self, s: packing.CompactStreams,
                     groups: int) -> kernels.StreamPlan:
        """B7's per-key plan of the counts layout's sorted streams, and the
        reduce the kernel engines run (``reduce_path``): ``"streams"`` (B7)
        where what B7 reads, 4 bytes a value and 8 KiB a dense-wire row, is
        no more than B4's 32 KiB a count group (both write the same heads),
        else ``"counts"`` (B4)."""
        plan = kernels.stream_reduce_plan(s.val_counts, s.val_dest,
                                          s.dense_dest, self.row_seg,
                                          self.keys.size)
        reads = 4 * plan.values + 4 * WORDS32 * plan.dense_rows
        self.reduce_path = ("streams" if reads <= 4 * dense.NIBBLE_WORDS
                            * groups else "counts")
        return plan

    def _dense_stream_meta(self, s: packing.CompactStreams, runs) -> dict:
        """The reduce the kernel engines run on a dense set built from its
        sorted streams (``reduce_path``): ``"streams"`` (B7's run variant,
        off the streams the set keeps, with B7's per-key plan) where it
        reads at most half the bytes B2 reads of the image
        (``kernels.dense_streams_win``), else ``"image"`` (B2)."""
        pairs = 0 if runs is None else runs[0].size // 2
        image_rows = int((self.row_seg < self.keys.size).sum())
        if not kernels.dense_streams_win(
                s.values.size, pairs, s.dense_words.shape[0], image_rows):
            self.reduce_path = "image"
            return {}
        self.reduce_path = "streams"
        no_runs = np.zeros(0, np.int32)
        return {"_stream_plan": kernels.stream_reduce_plan(
            s.val_counts, s.val_dest, s.dense_dest, self.row_seg,
            self.keys.size,
            run_counts=no_runs if runs is None else runs[1],
            run_dest=no_runs if runs is None else runs[2])}

    def _drop_streams(self) -> None:
        """Leave the image a dense set's only form: an in-place patch
        (``mutation.delta``) writes the image and not the streams, which
        are stale from then on, so or/xor read the image (B2) until a
        repack builds the streams again."""
        if self.layout == "dense" and self.reduce_path == "streams":
            self._streams = self._runs = self._stream_plan = None
            self.reduce_path = "image"

    def _build_counts(self) -> None:
        """The resident counts built once from the streams, padded with
        zero groups to the length of the groups' segment ids."""
        n_groups = self._n_rows // dense.NIBBLE_GROUP
        counts = dense.build_group_counts(
            *self._streams, n_groups, self._total_values)
        pad = self._grp_seg_counts.shape[0] - counts.shape[0]
        if pad:
            counts = torch.cat([counts, counts.new_zeros(
                (pad, dense.NIBBLE_WORDS))])
        self.counts = counts

    def _select_engine(self, engine: str) -> str:
        """Resolve ``engine`` for this set.  ``"cuda-nibble"`` exists only
        for the stream layouts: on the dense layout it means ``"cuda"``.
        The JAX package's shared-memory guards (demotions to "xla" past
        SMEM_PREFETCH_MAX) have no counterpart on the card."""
        eng = _engine(engine, self.device, SET_ENGINES)
        if eng == "cuda-nibble" and self.words is not None:
            eng = "cuda"
        return eng

    def _resident_words(self, eng: str) -> torch.Tensor:
        """The dense image: resident (dense layout) or rebuilt on the device,
        by the chunk kernel (B3) on the kernel engines or the plain scatter
        under "torch".  A rebuilt image is the caller's to write."""
        if self.words is not None:
            return self.words
        if eng != "torch" and self._chunks is not None:
            words = kernels.densify_chunks(*self._chunks, self._n_rows,
                                           self._chunk_bounds)
            dense_words, dense_dest = self._streams[0], self._streams[1]
            if dense_words.shape[0]:
                words[dense_dest.long()] = dense_words
            return words
        build = (dense.densify_streams_impl if eng == "torch"
                 else kernels.row_build)
        return build(*self._streams, self._n_rows, self._total_values)

    def _reduce_words(self, op: str, words: torch.Tensor, eng: str):
        """Wide or/xor over a blocked row image: B2, or the doubling pass
        under "torch"."""
        if eng == "torch":
            return dense.segmented_reduce(op, words, self.seg_ids,
                                          self.head_idx, self.n_steps)
        return kernels.segmented_reduce_blocked(op, words, self.blk_seg,
                                                self.keys.size, self.block)

    def _wide_path(self, eng: str) -> str:
        """The reduce a counts- or dense-layout or/xor runs under ``eng``:
        the path recorded at load on the kernel engines; under "torch" the
        reference pass over the counts or the image."""
        if eng == "torch":
            return "counts" if self.layout == "counts" else "image"
        return self.reduce_path

    def _counts_reduce(self, op: str, eng: str):
        """Wide or/xor of the counts layout, counted in
        ``rb_wide_reduce_total{layout, path}``: B7 off the resident streams
        or B4 off the counts (``reduce_path``), or per-group words and the
        group-level doubling pass under "torch"."""
        k = self.keys.size
        path = self._wide_path(eng)
        obs_metrics.counter("rb_wide_reduce_total", layout=self.layout,
                            path=path).inc()
        if path == "streams":
            return kernels.stream_segmented_reduce(
                op, *self._streams, self.seg_ids, self._stream_plan, k)
        if eng != "torch":
            return kernels.counts_segmented_reduce(
                op, self.counts, self._grp_seg_counts, k)
        g = self.counts.shape[0]
        words_g = dense.counts_to_words(self.counts.view(g, 4, WORDS32), op)
        return dense.segmented_reduce(op, words_g, self._grp_seg_counts,
                                      self._counts_head, self._counts_steps)

    def _fused_compact(self, op: str, carry: torch.Tensor | None = None):
        """One fused compact-layout wide or/xor (B6).  ``carry`` is the
        write-back probe's loop-carried row, prepended as a segment-0 dense
        row."""
        dense_words = self._streams[0]
        dseg, meta = self._dseg, self._dmeta
        if carry is not None:
            dense_words = torch.cat([carry[None], dense_words])
            dseg, meta = self._dseg_carry, self._dmeta_carry
        return _fused_compact_run(
            op, dense_words, *self._streams[2:], self._grp_seg, dseg, *meta,
            self._n_groups, self._total_values, self.keys.size)

    def _dense_reduce(self, op: str, eng: str):
        """Wide or/xor of the dense layout, counted in
        ``rb_wide_reduce_total{layout, path}``: B7's run variant off the
        kept streams or B2 off the image (``reduce_path``), or the doubling
        pass over the image under "torch"."""
        path = self._wide_path(eng)
        obs_metrics.counter("rb_wide_reduce_total", layout=self.layout,
                            path=path).inc()
        if path == "streams":
            return kernels.stream_segmented_reduce(
                op, *self._streams, self.seg_ids, self._stream_plan,
                self.keys.size, runs=self._runs)
        return self._reduce_words(op, self.words, eng)

    def _aggregate_or_xor(self, op: str, eng: str):
        if self.counts is not None:
            return self._counts_reduce(op, eng)
        if self.layout == "dense":
            return self._dense_reduce(op, eng)
        if self.words is None and eng == "cuda-nibble":
            return self._fused_compact(op)
        return self._reduce_words(op, self._resident_words(eng), eng)

    def aggregate_device(self, op: str, engine: str = "auto"):
        """Run the wide op; returns device (words int32[K, 2048], cards
        int32[K]).

        or/xor: segmented reduce over the resident layout.  and: only keys
        present in every bitmap can survive (segments with exactly n rows),
        so their rows are gathered from the image and AND-reduced as a
        regular block; the other keys get zero rows.  The AND is plain
        PyTorch on every engine; ``"cuda-nibble"`` rebuilds a stream
        layout's image as ``"cuda"`` does.

        The call is the ``set.aggregate`` span (tags ``op``, ``layout``,
        ``engine``, ``keys`` and ``rows``, or ``groups`` on the counts
        layout; an or/xor also tags its ``path``, on the counts layout
        ``streams`` or ``counts``, on the dense layout ``streams`` or
        ``image``), which never waits for the card: the kernels' launches
        record their bytes on it."""
        extent = ({"groups": int(self.counts.shape[0])}
                  if self.counts is not None else {"rows": self._n_rows})
        with obs_trace.span("set.aggregate", op=op, layout=self.layout,
                            keys=int(self.keys.size), **extent) as sp:
            eng = self._select_engine(engine)
            sp.tag(engine=eng)
            if op == "and":
                return self._and_words(self._resident_words(eng))
            if op not in ("or", "xor"):
                raise ValueError(f"unsupported wide op {op!r}")
            if self.reduce_path is not None:
                sp.tag(path=self._wide_path(eng))
            return self._aggregate_or_xor(op, eng)

    def _and_words(self, image: torch.Tensor):
        """The wide AND over a blocked row image."""
        k = self.keys.size
        words = torch.zeros((k, WORDS32), dtype=torch.int32, device=self.device)
        cards = torch.zeros(k, dtype=torch.int32, device=self.device)
        full = np.flatnonzero(self._seg_sizes == self.n)
        if full.size == 0:
            return words, cards
        rows = (self._seg_offsets[full][:, None] + np.arange(self.n)).ravel()
        block = image[torch.from_numpy(rows.astype(np.int64)).to(self.device)]
        sub_words, sub_cards = dense.regular_reduce_and(
            block.view(full.size, self.n, WORDS32))
        idx = torch.from_numpy(full).to(self.device)
        words[idx] = sub_words
        cards[idx] = sub_cards
        return words, cards

    def aggregate(self, op: str, engine: str = "auto") -> RoaringBitmap:
        words, cards = self.aggregate_device(op, engine)
        return _unpack(self.keys, words, cards)

    def aggregate_range_cardinality(self, op: str, start: int, stop: int,
                                    engine: str = "auto") -> int:
        """Cardinality of the wide aggregate within values [start, stop)
        (RoaringBitmap.rangeCardinality applied to the aggregate): masked
        popcount on the device, one scalar to the host."""
        heads, _ = self.aggregate_device(op, engine)
        return _device_range_cardinality(self.keys, heads, start, stop)

    # ----------------------------------------------------- steady-state probes
    #
    # Each probe returns a callable that runs ``reps`` dependent queries and
    # returns the summed cardinality mod 2^32 as a 0-d device tensor (int64
    # accumulation on the device, no host synchronization in the loop);
    # callers check it against (reps * cardinality) % 2^32.  PyTorch runs
    # eagerly and never hoists, caches or elides a repeated call, so the JAX
    # package's optimization_barrier has no counterpart: every iteration
    # runs the whole query.  The callable takes an optional ``words``
    # argument (the dense image to run over; counts and compact ignore it).

    def chained_wide_or(self, reps: int, engine: str = "auto"):
        """``reps`` dependent wide ORs.  Each iteration writes the union's
        first per-key row back into a segment-0 input row: idempotent for
        OR, but a true data dependence between iterations.  On the dense
        layout that row is row 0, written in place and restored after the
        loop (no copy of the image); on the compact layout it is the
        reserved zero row of segment 0 in each rebuilt image, or, under
        ``"cuda-nibble"``, a dense row prepended to segment 0.  The counts
        layout delegates to ``chained_aggregate`` (counts are not
        idempotent under a write-back)."""
        eng = self._select_engine(engine)
        if self.layout == "dense":
            def run(words=None):
                words = self.words if words is None else words
                saved = words[0].clone()
                total = self._zero_total()
                try:
                    for _ in range(reps):
                        heads, cards = self._reduce_words("or", words, eng)
                        words[0] = heads[0]
                        total += cards.sum(dtype=torch.int64)
                finally:
                    words[0] = saved
                return total % (1 << 32)

            return run
        if self.counts is not None:
            return self.chained_aggregate("or", reps, engine)
        return self._chained_compact(reps, eng)

    def chained_aggregate(self, op: str, reps: int, engine: str = "auto"):
        """``reps`` wide ops (or/xor/and) in turn, each over the resident
        layout: the dense image, the counts, or, on the compact layout, an
        image rebuilt every iteration (or, under ``"cuda-nibble"``, the
        fused B6 query), since that rebuild is the query's cost."""
        if op not in ("or", "xor", "and"):
            raise ValueError(f"unsupported chained op {op!r}")
        eng = self._select_engine(engine)

        def query(words):
            if op == "and":
                return self._and_words(self._resident_words(eng)
                                       if words is None else words)[1]
            if words is None:
                return self._aggregate_or_xor(op, eng)[1]
            return self._reduce_words(op, words, eng)[1]

        def run(words=None):
            if self.layout != "dense":
                words = None
            total = self._zero_total()
            for _ in range(reps):
                total += query(words).sum(dtype=torch.int64)
            return total % (1 << 32)

        return run

    def _chained_compact(self, reps: int, eng: str):
        """chained_wide_or on the compact layout: every iteration rebuilds
        from the streams with the carry row threaded through."""
        def run(_words_unused=None):
            carry = torch.zeros(WORDS32, dtype=torch.int32, device=self.device)
            total = self._zero_total()
            for _ in range(reps):
                if eng == "cuda-nibble":
                    heads, cards = self._fused_compact("or", carry=carry)
                else:
                    words = self._resident_words(eng)
                    words[self.carry_row] = carry
                    heads, cards = self._reduce_words("or", words, eng)
                carry = heads[0]
                total += cards.sum(dtype=torch.int64)
            return total % (1 << 32)

        return run

    def _zero_total(self) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=self.device)

    # ----------------------------------------------------------- analytics

    def attach_column(self, column) -> None:
        """Attach a value column (``analytics.BsiColumn`` / ``RangeColumn``)
        on this set's device: expression queries may then carry value
        predicates (``expr.range_`` / ``expr.cmp``) and aggregate roots
        (``expr.sum_`` / ``expr.top_k``) over it.  Re-attaching a name
        replaces the column; plans key on each column's uid, so a replaced
        column never serves a stale plan."""
        if _device_key(column.device) != _device_key(self.device):
            raise ValueError(
                f"column {column.name!r} lives on {column.device}, the "
                f"resident set on {self.device}")
        self.columns[column.name] = column

    def detach_column(self, name: str) -> None:
        self.columns.pop(name, None)

    # ------------------------------------------------------------ mutation

    def apply_delta(self, adds=None, removes=None, repack: str = "auto",
                    drift_limit: int | None = None, worker=None,
                    journal=None) -> dict:
        """Mutate this resident set at container granularity
        (``mutation.delta.apply_delta``): ``adds`` / ``removes`` map source
        index -> u32 values, removes win.  A dense-layout delta over
        existing containers patches the touched rows of the resident image
        in place; structural deltas, the other layouts and the drift
        heuristic escalate to a repack (``worker`` defers it to a
        ``MaintenanceWorker``).  Returns the mutation report."""
        from ..mutation import delta as mut_delta

        return mut_delta.apply_delta(self, adds, removes, repack=repack,
                                     drift_limit=drift_limit, worker=worker,
                                     journal=journal)

    def warmup_delta(self, n: int) -> dict:
        """Prepare the in-place patch program of every "delta:N" rung up to
        ``n`` rows (a captured CUDA graph each on the card), so no in-band
        ``apply_delta`` of up to ``n`` rows pays a capture."""
        from ..mutation import delta as mut_delta

        return mut_delta.warmup_delta(self, n)

    def host_bitmaps(self) -> list[RoaringBitmap]:
        """Host copies of the source bitmaps, rebuilt from the resident rows
        (whatever the set was built from) and cached per ``version``: the
        data the batch engine's host reference runs on.  A patch keeps an
        existing copy fresh incrementally (``mutation.delta``)."""
        from ..mutation import delta as mut_delta

        return mut_delta.host_bitmaps(self)

    def evaluate(self, expression, form: str | None = None,
                 engine: str = "auto"):
        """Evaluate one set-algebra expression over this resident set: one
        fused launch (B5) on the card.  ``expression`` is an ``expr`` tree
        or an ``ExprQuery``; an explicit ``form`` overrides the query's
        own.  Returns the cardinality (``form="cardinality"``) or the
        result bitmap (``form="bitmap"``).  The ``BatchEngine`` behind it
        is built on first use and kept, so repeated shapes hit its plan
        and program caches."""
        from . import expr as expr_mod
        from .batch_engine import BatchEngine

        if getattr(self, "_expr_engine", None) is None:
            self._expr_engine = BatchEngine(self)
        if isinstance(expression, expr_mod.ExprQuery):
            q = (expression if form is None
                 else dataclasses.replace(expression, form=form))
        else:
            q = expr_mod.ExprQuery(expression, form=form or "cardinality")
        [res] = self._expr_engine.execute([q], engine=engine)
        return res.bitmap if q.form == "bitmap" else res.cardinality

    def hbm_bytes(self) -> int:
        """Device bytes the set keeps resident: the sum of
        ``insights.resident_set_bytes``' components."""
        return sum(insights.resident_set_bytes(self).values())


def _pack_state(bitmaps: list, block: int | None, layout: str) -> dict:
    """The packed state of ``bitmaps`` for ``layout``: the blocked
    rotation's maps and compact streams (for the dense layout with its run
    containers as a run stream), the containers by kind where the packer
    counted them, and for the stream layouts the chunked value stream."""
    packed = packing.pack_blocked_compact(
        bitmaps, block=block,
        min_block=4 if (layout == "dense" and block is None) else 8,
        runs=layout == "dense")
    s = packed.streams   # rows in segment order: dense_dest ascends
    state = {"keys": packed.keys, "n": len(bitmaps),
             "block": packed.block, "blk_seg": packed.blk_seg,
             "n_blocks": packed.n_blocks, "seg_sizes": packed.seg_sizes,
             "seg_offsets": packed.seg_offsets, "row_src": packed.row_src,
             "carry_row": packed.carry_row,
             "dense_words": s.dense_words, "dense_dest": s.dense_dest,
             "values": s.values, "val_counts": s.val_counts,
             "val_dest": s.val_dest, "container_kinds": s.kinds}
    if s.runs is not None:
        state.update(runs=s.runs, run_counts=s.run_counts,
                     run_dest=s.run_dest)
    if layout != "dense":
        state["chunk_vals"], state["chunk_row"] = packing.chunk_value_stream(
            s.values, s.val_counts, s.val_dest, s.n_rows,
            pad_chunks_pow2=False)
    return state


def _run_pairs(state: dict) -> int:
    """Run pairs in a state's run stream (0 without one)."""
    runs = state.get("runs")
    return 0 if runs is None else int(np.asarray(runs).size) // 2


def _count_ingest(state: dict, layout: str, rows: int) -> None:
    """What one build ingested, in the registry: the state's source
    containers by kind where the packer counted them, the values of its
    value stream, the pairs of its run stream, and the layout's rows."""
    for kind, n in (state.get("container_kinds") or {}).items():
        obs_metrics.counter("rb_ingest_containers_total", layout=layout,
                            kind=kind).inc(n)
    values = state.get("values")
    obs_metrics.counter("rb_ingest_values_total", layout=layout).inc(
        0 if values is None else int(np.asarray(values).size))
    obs_metrics.counter("rb_ingest_run_pairs_total", layout=layout).inc(
        _run_pairs(state))
    obs_metrics.counter("rb_ingest_rows_total", layout=layout).inc(rows)


def _host_i32(a) -> torch.Tensor:
    """A host int32 tensor sharing a (writeable, contiguous) copy of
    ``a`` where it must."""
    return torch.from_numpy(np.require(a, np.int32, ("C", "W")))


def _to_device(x, device):
    """A host array on ``device``, int32 (bool arrays as they are); a tuple
    of them element by element, with plain numbers left on the host."""
    if isinstance(x, tuple):
        return tuple(_to_device(v, device) for v in x)
    if isinstance(x, (kernels.StreamPlan, kernels.RowPlan)):
        return x.to(device)
    if not isinstance(x, np.ndarray):
        return x
    if x.dtype == np.bool_:
        return torch.from_numpy(x).to(device)
    return as_i32(x, device)


def _sorted_by(key: np.ndarray, *arrays) -> tuple:
    """(key, *arrays) reordered stably by ``key`` when it does not ascend,
    else as they are."""
    if key.size and np.any(np.diff(key) < 0):
        order = np.argsort(key, kind="stable")
        return (key[order], *(a[order] for a in arrays))
    return (key, *arrays)


def _sorted_entries(dest: np.ndarray, counts, entries):
    """(entries, counts, dest) of a stream of ``counts[i]`` entries to row
    ``dest[i]``, its containers reordered stably by ``dest``, each with its
    entries, where ``dest`` does not ascend; else as they are."""
    if dest.size and np.any(np.diff(dest) < 0):
        order = np.argsort(dest, kind="stable")
        c = np.asarray(counts, np.int64)
        starts = np.concatenate(([0], np.cumsum(c)[:-1]))[order]
        n = c[order]
        at = np.repeat(starts - np.concatenate(([0], np.cumsum(n)[:-1])),
                       n) + np.arange(int(n.sum()))
        return entries[at], counts[order], dest[order]
    return entries, counts, dest


def _sort_streams(s: packing.CompactStreams, runs=None) -> tuple:
    """The dense-wire rows, the sparse containers with their runs of values
    and the run containers of ``runs`` (u16 pairs, pairs per container,
    destination rows) with their pairs, reordered by destination row where
    they do not ascend, so that their segment ids ascend: the dense
    partial's doubling pass needs sorted segments, B7 reads each key's
    entries as one range of each stream and B8 each row's.  The NumPy
    packer emits all sorted; the JAX native ingest may not.  Returns
    (streams, runs)."""
    dest, words = _sorted_by(s.dense_dest, s.dense_words)
    values, counts, vd = _sorted_entries(s.val_dest, s.val_counts, s.values)
    s = dataclasses.replace(s, dense_words=words, dense_dest=dest,
                            values=values, val_counts=counts, val_dest=vd)
    if runs is not None:
        pairs, rc, rd = _sorted_entries(runs[2], runs[1],
                                        runs[0].view(np.uint32))
        runs = (np.ascontiguousarray(pairs).view(np.uint16), rc, rd)
    return s, runs


def _fused_compact_run(op: str, dense_words, values, val_counts, val_dest,
                       grp_seg, dseg, head, valid, steps: int, n_groups: int,
                       total_values: int, k: int):
    """The compact layout's fused query: the value stream's nibble counts
    (int64 scatter-add, plain PyTorch as XLA in JAX), the dense-wire rows'
    per-segment partial, then B6."""
    counts = dense.nibble_counts_impl(values, val_counts, val_dest, n_groups,
                                      total_values)
    dp = dense.dense_partial_impl(op, dense_words, dseg, head, valid, steps,
                                  k)
    return kernels.fused_nibble_reduce(op, counts, dp, grp_seg, k)


def _device_range_cardinality(keys: np.ndarray, words: torch.Tensor,
                              start: int, stop: int) -> int:
    """Bits of a device int32[K, 2048] image within values [start, stop):
    per-key bounds clamped on the host in Python ints (a u64-tier key base
    passes int64), masked popcount on the device, one scalar back."""
    bases = [int(k) << 16 for k in keys]
    lo = np.array([min(max(start - kb, 0), 1 << 16) for kb in bases],
                  np.int32).reshape(-1, 1)
    hi = np.array([min(max(stop - kb, 0), 1 << 16) for kb in bases],
                  np.int32).reshape(-1, 1)
    dev = words.device
    return int(dense.range_cardinality(words, as_i32(lo, dev),
                                       as_i32(hi, dev)).sum())


# ----------------------------------------------------- device query plans

class DeviceBitmap:
    """A bitmap on the device: host key index + int32[K, 2048] image.

    Results of wide aggregates stay on the device and compose (and / or /
    xor / andnot) without a host round trip; only ``materialize`` and the
    cardinality calls move data to the host (the latter one scalar).  Key
    alignment of two operands runs on the host (keys are a few hundred
    u16s), the word algebra on the device: both operands are scattered into
    the union key space (zero rows are the identity of or/xor/andnot and
    annihilate for and), then one elementwise op + popcount.
    """

    def __init__(self, keys: np.ndarray, words: torch.Tensor,
                 cards: torch.Tensor | None = None):
        self.keys = np.asarray(keys)
        self.words = words              # int32[K, 2048] on the device
        self._cards = cards             # int32[K] on the device, or None

    @staticmethod
    def aggregate(ds: DeviceBitmapSet, op: str,
                  engine: str = "auto") -> "DeviceBitmap":
        """Wide op over a resident set -> a result on the device."""
        words, cards = ds.aggregate_device(op, engine=engine)
        return DeviceBitmap(ds.keys, words, cards)

    @staticmethod
    def from_host(rb: RoaringBitmap, device=None) -> "DeviceBitmap":
        packed = packing.pack_for_aggregation([rb], pad_rows=False)
        return DeviceBitmap(packed.keys,
                            as_i32(packed.words, resolve_device(device)))

    def _aligned(self, other: "DeviceBitmap"):
        """Both operands scattered into the union key space."""
        if self.keys.dtype != other.keys.dtype:
            # u16 keys (32-bit tier) and u64 high-48 keys (64-bit tier) live
            # in different key domains: a union would merge them wrongly
            raise TypeError(
                f"cannot combine bitmaps of different tiers: "
                f"{self.keys.dtype} vs {other.keys.dtype} keys")
        union = np.union1d(self.keys, other.keys)
        dev = self.words.device

        def expand(db):
            out = torch.zeros((union.size, WORDS32), dtype=torch.int32,
                              device=dev)
            if db.keys.size:
                idx = np.searchsorted(union, db.keys).astype(np.int64)
                out[torch.from_numpy(idx).to(dev)] = db.words
            return out

        return union, expand(self), expand(other)

    def _binary(self, other: "DeviceBitmap", op: str) -> "DeviceBitmap":
        union, a, b = self._aligned(other)
        words, cards = dense.pairwise(op, a, b)
        return DeviceBitmap(union, words, cards)

    def __and__(self, o):
        return self._binary(o, "and")

    def __or__(self, o):
        return self._binary(o, "or")

    def __xor__(self, o):
        return self._binary(o, "xor")

    def __sub__(self, o):
        return self._binary(o, "andnot")

    def and_not(self, o):
        return self._binary(o, "andnot")

    def cards(self) -> torch.Tensor:
        if self._cards is None:
            self._cards = dense.popcount(self.words)
        return self._cards

    def cardinality(self) -> int:
        """One scalar to the host."""
        return int(self.cards().sum())

    def range_cardinality(self, start: int, stop: int) -> int:
        """Members in [start, stop): masked popcount on the device."""
        return _device_range_cardinality(self.keys, self.words, start, stop)

    def contains_batch(self, values) -> np.ndarray:
        """bool membership of each value: key binary search, then the
        word's bit on the device.  Float, bool and object probes raise
        ``TypeError`` (a cast would truncate them into plausible answers).
        On the 32-bit tier, probes outside [0, 2^32) are absent and the
        search runs on the device.  On the 64-bit tier, negative ``int64``
        probes are absent and the key search runs on the host in
        ``np.uint64``: a u64 key or probe moved to torch as ``int64`` wraps
        negative from 2^63 on, which would break order and equality."""
        raw = np.asarray(values)
        if raw.size == 0:
            # np.asarray([]) is float64: an empty batch must not trip the
            # dtype check
            return np.zeros(raw.shape, bool)
        if raw.dtype.kind not in "iu":
            raise TypeError(
                f"contains_batch expects integer probes, got {raw.dtype}")
        in_range = (raw >= 0 if raw.dtype.kind == "i"
                    else np.ones(raw.shape, bool))
        if self.keys.size == 0:
            return np.zeros(raw.shape, bool)
        dev = self.words.device
        if self.keys.dtype == np.uint16:
            if raw.itemsize > 4:
                in_range &= raw.astype(np.uint64) < (1 << 32)
            v = torch.from_numpy(raw.astype(np.uint32).astype(np.int64)).to(dev)
            keys = torch.from_numpy(self.keys.astype(np.int64)).to(dev)
            hb = v >> 16
            idx = torch.searchsorted(keys, hb)
            safe = idx.clamp(max=self.keys.size - 1)
            found = (idx < self.keys.size) & (keys[safe] == hb)
            lo = v & 0xFFFF
            bit = (self.words[safe, lo >> 5] >> (lo & 31)) & 1
            return (found & (bit == 1)).cpu().numpy() & in_range
        v = raw.astype(np.uint64)
        hb = v >> np.uint64(16)
        idx = np.searchsorted(self.keys, hb)
        safe = np.minimum(idx, self.keys.size - 1)
        found = (idx < self.keys.size) & (self.keys[safe] == hb)
        lo = torch.from_numpy((v & np.uint64(0xFFFF)).astype(np.int64)).to(dev)
        row = torch.from_numpy(safe.astype(np.int64)).to(dev)
        bit = (self.words[row, lo >> 5] >> (lo & 31)) & 1
        return found & (bit == 1).cpu().numpy() & in_range

    def materialize(self, out_cls=None):
        """Move to the host as a normalized bitmap: a ``RoaringBitmap``, or
        a ``Roaring64Bitmap`` for u64 keys."""
        return _unpack(self.keys, self.words, self.cards(), out_cls)

    def hbm_bytes(self) -> int:
        return self.words.numel() * self.words.element_size()

    def __repr__(self) -> str:
        return f"DeviceBitmap(keys={self.keys.size}, hbm={self.hbm_bytes()}B)"
