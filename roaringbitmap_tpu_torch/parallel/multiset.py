"""Cross-tenant pooled batching: Q queries over S resident sets in few
device launches, with a depth-N pipeline
(``roaringbitmap_tpu.parallel.multiset``).

A ``BatchEngine`` packs the queries of ONE resident ``DeviceBitmapSet`` into
one launch.  A server holding many tenants' sets would still pay one launch
per tenant per tick, however few queries each tenant sends.  This module
repeats Roaring's packing move one level up: as the container layout packs
heterogeneous containers behind one algebra, the pool planner packs
heterogeneous tenants behind one launch.

Execution model
---------------
A pool is a list of :class:`BatchGroup`, each group a list of
:class:`~.batch_engine.BatchQuery` / ``ExprQuery`` requests addressed to one
resident set.  The planner:

1. plans every query against its own set (the per-set ``BatchEngine`` row
   selection, unchanged);
2. remaps row indices by per-set offsets into ONE compacted pooled row
   space: the rows the pool references, once each, sorted; the launch
   selects them from each tenant's image (B3 rebuilds a compact or counts
   tenant's image first) into one pooled image;
3. buckets the pooled queries by (op, pow2 operand rung), as the batch
   engine does, so two tenants' lone OR queries share one padded bucket;
4. merges the buckets of each op into one flat segmented reduce
   (:class:`_OpGroup`): on "cuda" ONE B1 launch per op present, its segment
   ids globally offset per member bucket and therefore still ascending; on
   "torch" the doubling pass, or a halving fold over the row axis when
   every member has one key slot per query.  A plan with fused expression
   sections runs on "megakernel" as ONE B5 launch over the pooled image.
   The cross-check rung "torch-vmap" skips the merge: each bucket runs on
   its own, query by query (``batch_engine.bucket_body``), which proves
   the per-op merge and the query-axis flattening equivalent.

Pipelined (depth-N) dispatch
----------------------------
When a pool needs several launches (the proactive budget split below, or
``execute_pipelined`` streaming several ticks), launches flow through a
window of ``GuardPolicy.pipeline_depth``: launch k+1 is planned on the host
while up to depth - 1 earlier launches run on the card, and the oldest is
drained as the window slides (depth 1 is strictly serial).  The JAX package
overlaps through async dispatch and buffer donation; here the CUDA stream's
own asynchrony does it.  ``_launch_once(sync=False)`` queues the pooled
image, the kernel launches and the per-group outputs on the current stream,
then their copies into pinned host tensors, and records a
``torch.cuda.Event``; ``_Inflight`` carries the event and the pinned
tensors, and ``drain`` waits on the event and assembles from the host
copies.  Plan operands go up through pinned memory too
(``ops.words.upload``), so nothing on the launch path waits for the stream.
The caching allocator recycles a launch's device blocks in stream order as
soon as the launch path drops them, so JAX's ``_donation_supported`` and its
donating programs have no counterpart.  ``last_pipeline`` reports
``launches``, ``depth``, ``host_ms`` (host time spent pulling and
dispatching launches), ``host_overlapped_ms`` (the part spent while a launch
was in flight), ``overlap_ratio`` and ``drain_ms``, as the JAX package
defines them.

Guard
-----
Every launch runs under ``runtime.guard.run_with_fallback`` down ``ENGINES``
from the rung ``resolve_query_engine`` picks: on the CPU down to the
per-query host fold, on the card over the kernel rungs alone
("megakernel" -> "cuda"), so a fault the kernels cannot retry or split away
raises typed.  ``ResourceExhausted`` halves the launch's queries
(``split_count``); a pool whose predicted footprint
(``insights.predict_multiset_dispatch_bytes``) passes the budget
(``guard.resolve_hbm_budget``: ``ROARING_TPU_HBM_BUDGET``, else the card's
free memory) is halved before dispatch (``proactive_split_count``); a fault
that surfaces only at drain time (the ``multiset.drain`` fault seam) re-runs
that launch synchronously down the chain (``drain_retries``).  Every rung is
bit-exact, so degradation and splitting change throughput only.  The JAX
package's trace spans and metrics are plain counters on the engine until
the observability layer is ported.

A pool over one set goes through that set's ``BatchEngine.execute``
verbatim: no pooled plan and no pooled image.  ``execute_pipelined`` always
builds pooled launches.

Lattice
-------
Under an active lattice (``runtime.lattice``) every pool references every
set, each set's row selection pads to one covering ``pool`` rung, and a
snapped plan replays its signature's program (``runtime.programs``: a
captured CUDA graph on the card, in one pool with the member engines'
graphs).  ``warmup(profile=...)`` prepares the member engines' and the
pooled vocabularies, then seals the lattice.

Result cache
------------
``result_cache=`` (``"env"`` by default) is shared with the member engines
the pooled engine builds.  ``execute`` and ``execute_pipelined`` serve each
(set, query) the cache holds and pool only the misses; the planner injects
cached interior nodes of a tenant's expressions as pre-computed operands,
their device rows passed into the plan as they are (the pipelined window
never reads the card at plan time).  Pooled plans key on each referenced
tenant's ``(uid, version)``, and a tenant's repack is picked up before the
next plan (``_sync_with_sets``).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..insights import analysis as insights
from ..mutation import result_cache as mut_cache
from ..obs import cost as obs_cost
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..ops import dense, kernels, megakernel, packing
from ..ops.words import WORDS32, popcount, upload
from ..runtime import errors, faults, guard
from ..runtime import lattice as rt_lattice
from ..runtime import programs as rt_programs
from ..runtime import warmup as rt_warmup
from ..runtime.cache import LRUCache
from . import expr as expr_mod
from .aggregation import DeviceBitmapSet, _device_key
from .batch_engine import (ENGINES, PLAN_CACHE_MAX, _RED_OP, BatchEngine,
                           BatchQuery, BatchResult, analytics_rung_queries,
                           bucket_body, plan_bucket, plan_padding,
                           query_desc, resolve_query_engine,
                           snap_plan_groups)

#: the guard site of every pooled dispatch
SITE = "multiset"

#: pooled launches whose predicted footprint ``dispatch_memory`` keeps
DISPATCH_MEMORY_MAX = 256


@dataclasses.dataclass(frozen=True)
class BatchGroup:
    """Queries addressed to ONE resident set (tenant) of the pool:
    ``set_id`` indexes the engine's sets, ``queries`` are ordinary batch
    queries against that set's operands."""

    set_id: int
    queries: tuple

    def __init__(self, set_id: int, queries):
        object.__setattr__(self, "set_id", int(set_id))
        object.__setattr__(self, "queries", tuple(queries))


@dataclasses.dataclass
class _OpGroup:
    """Same-op buckets merged for execution into one flat segmented reduce.
    Segment ids are offset per member bucket, so the reduce never mixes two
    buckets' segments and the merged ``flat_seg`` ascends; the per-key post
    passes (presence mask, workShyAnd keep, the andnot head pass, the
    cards) act on the flat head axis with plan-time masks.  When every
    member has ``k_pad == 1`` the group is REGULAR: each query's one segment
    is exactly its ``r_pad`` rows, and the plain rung folds them by halving
    and keeps one live slot per query."""

    op: str
    bucket_idx: list      # indices into _PoolPlan.buckets, merge order
    seg_offs: list        # per member bucket: its head-slot base in nseg
    nseg: int             # total head slots (sum of q * (k_pad + 1))
    n_rows: int           # total flat gather rows (sum of q * r_pad)
    n_steps: int          # max doubling depth over members
    needs_words: bool
    host: dict            # merged NumPy operands
    #: per member bucket (merge order): (q, r_pad)
    member_shapes: tuple = ()
    regular: bool = False
    _arrays: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def sig(self):
        return (self.op, self.nseg, self.n_rows, self.n_steps,
                self.needs_words,
                self.member_shapes if self.regular else None)

    def device_arrays(self, device, keys) -> dict:
        """The operands ``keys`` on ``device``, uploaded once per key set
        (the set depends on the rung, ``_op_group_keys``)."""
        sel = (str(device), tuple(keys))
        got = self._arrays.get(sel)
        if got is None:
            got = self._arrays[sel] = {k: upload(self.host[k], device)
                                       for k in keys}
        return got


@dataclasses.dataclass
class _PoolPlan:
    """One pooled plan: shape buckets over a COMPACTED pooled row space.
    ``row_sel[sid]`` holds the set-local rows the pool references (sorted),
    their concatenation over ``sids`` is the pooled image of
    ``n_pool_rows`` rows, and every bucket gather and expression leaf
    gather indexes it."""

    buckets: list
    op_groups: list
    sids: tuple
    row_sel: dict         # sid -> int32 host array of set-local rows
    n_pool_rows: int
    #: expression sections and the pseudo-query -> query owner map
    exprs: list = dataclasses.field(default_factory=list)
    owner: dict = dataclasses.field(default_factory=dict)
    #: per-bucket readback constants, computed once per plan
    rb_meta: dict = dataclasses.field(default_factory=dict)
    #: the B5 program when the plan has fused sections
    mega: object = None
    #: the footprint model and the word-op count per rung, computed once
    #: per plan
    predicted: dict = dataclasses.field(default_factory=dict)
    word_ops: dict = dataclasses.field(default_factory=dict)
    #: the covering lattice point when an active lattice snapped this pool
    #: (every set referenced, one padded row selection each); None = exact
    point: object = None
    #: (padding_bytes, padded_fraction) of the snap
    padding: tuple = (0, 0.0)
    #: operand packs and static program-key parts by rung
    #: (``runtime.programs``)
    packs: dict = dataclasses.field(default_factory=dict)
    keys: dict = dataclasses.field(default_factory=dict)
    _row_sel_dev: dict = dataclasses.field(default_factory=dict)

    def row_sel_dev(self, sid: int, device):
        dev = self._row_sel_dev.get(sid)
        if dev is None:
            dev = self._row_sel_dev[sid] = upload(self.row_sel[sid], device)
        return dev

    @property
    def fused(self) -> list:
        return expr_mod.fused_of(self.exprs)

    @property
    def expr_signature(self) -> tuple:
        return expr_mod.signature_of(self.exprs)

    @property
    def signature(self):
        return (self.sids,
                tuple(int(self.row_sel[s].shape[0]) for s in self.sids),
                tuple(b.signature for b in self.buckets),
                self.expr_signature)


def _merge_op_groups(buckets) -> list:
    """The per-op execution groups of remapped plan buckets (see
    :class:`_OpGroup`), in op order."""
    by_op: dict = {}
    for bi, b in enumerate(buckets):
        by_op.setdefault(b.op, []).append((bi, b))
    groups = []
    for op in sorted(by_op):
        members = by_op[op]
        row_off = seg_off = 0
        seg_offs: list = []
        parts: dict = {k: [] for k in ("gather", "valid", "flat_seg",
                                       "flat_head", "mask_ok")}
        if op == "andnot":
            parts["head_gather"] = []
            parts["head_ok"] = []
        n_steps = 1
        regular = all(b.k_pad == 1 for _, b in members)
        live: dict = {k: [] for k in (("mask_live", "head_gather_live",
                                       "head_ok_live") if regular else ())}
        for _bi, b in members:
            qn, k_pad = b.q, b.k_pad
            seg_offs.append(seg_off)
            parts["gather"].append(b.host["gather"].reshape(-1))
            parts["valid"].append(b.host["valid"].reshape(-1))
            parts["flat_seg"].append(b.host["flat_seg"] + seg_off)
            parts["flat_head"].append(b.host["flat_head"] + row_off)
            # per-key masks over the (k_pad + 1) slots of the flat head
            # axis (slot k_pad is always dead)
            mask = np.zeros((qn, k_pad + 1), bool)
            mask[:, :k_pad] = (b.host["heads_ok"] & b.host["key_keep"]
                               if op == "and" else b.host["heads_ok"])
            parts["mask_ok"].append(mask.reshape(-1))
            if op == "andnot":
                hg = np.zeros((qn, k_pad + 1), np.int32)
                hg[:, :k_pad] = b.host["head_gather"]
                ho = np.zeros((qn, k_pad + 1), bool)
                ho[:, :k_pad] = b.host["head_ok"]
                parts["head_gather"].append(hg.reshape(-1))
                parts["head_ok"].append(ho.reshape(-1))
            if regular:
                # the live layout: one slot per query, no dead slots
                live["mask_live"].append(mask[:, 0])
                if op == "andnot":
                    live["head_gather_live"].append(
                        b.host["head_gather"][:, 0])
                    live["head_ok_live"].append(b.host["head_ok"][:, 0])
            row_off += qn * b.r_pad
            seg_off += qn * (k_pad + 1)
            n_steps = max(n_steps, b.n_steps)
        host = {k: np.concatenate(v) for k, v in parts.items()}
        host.update({k: np.concatenate(v) for k, v in live.items() if v})
        groups.append(_OpGroup(
            op=op, bucket_idx=[bi for bi, _ in members], seg_offs=seg_offs,
            nseg=seg_off, n_rows=row_off, n_steps=n_steps,
            needs_words=any(b.needs_words for _, b in members), host=host,
            member_shapes=tuple((b.q, b.r_pad) for _, b in members),
            regular=regular))
    return groups


def _op_group_keys(g: _OpGroup, eng: str) -> tuple:
    """The operands ``_op_body`` reads for ``(eng, g)``: the padded flat
    layout on the kernel rung and for irregular groups, the live layout for
    a regular group on the plain rung."""
    if eng == "cuda" or not g.regular:
        keys = ("gather", "valid", "flat_seg", "mask_ok")
        if eng != "cuda":
            keys += ("flat_head",)
        if g.op == "andnot":
            keys += ("head_gather", "head_ok")
        return keys
    keys = ("gather", "valid", "mask_live")
    if g.op == "andnot":
        keys += ("head_gather_live", "head_ok_live")
    return keys


def _fold_rows(fn, blk: torch.Tensor) -> torch.Tensor:
    """Tree-reduce int32[q, r_pad, 2048] over axis 1 by halving (r_pad is a
    power of two)."""
    while blk.shape[1] > 1:
        half = blk.shape[1] // 2
        blk = fn(blk[:, :half], blk[:, half:])
    return blk[:, 0]


def _op_body(words: torch.Tensor, g_sig, arrays: dict, eng: str,
             force_heads: bool = False):
    """One op group on the device: ONE gather and ONE flat segmented
    reduce for every same-op bucket of the pool (B1 on "cuda"; on "torch"
    the doubling pass, or the halving fold of a regular group), then the
    post passes on the flat head axis, in place.  Returns (heads int32[nseg
    or live slots, 2048] or None, cards).  B1's cards serve or/xor/and;
    andnot and the plain rung count their heads.  ``force_heads`` returns
    the heads for fused combine steps that read them."""
    op, nseg, _n_rows, n_steps, needs_words, reg_shapes = g_sig
    needs_words = needs_words or force_heads
    red = _RED_OP[op]
    g = words[arrays["gather"]]
    g.masked_fill_(~arrays["valid"][:, None], -1 if op == "and" else 0)
    cards = None
    live = eng != "cuda" and reg_shapes is not None
    if eng == "cuda":
        heads, cards = kernels.segmented_reduce(red, g, arrays["flat_seg"],
                                                nseg)
    elif live:
        # every member query's one key segment is its r_pad rows: a halving
        # fold per member rung, with outputs in the live layout
        parts, row0 = [], 0
        for qn, r_pad in reg_shapes:
            blk = g[row0:row0 + qn * r_pad].view(qn, r_pad, WORDS32)
            parts.append(_fold_rows(dense.OPS[red], blk))
            row0 += qn * r_pad
        heads = parts[0] if len(parts) == 1 else torch.cat(parts)
        del parts
    else:
        red_rows = dense.doubling_pass(dense.OPS[red], g,
                                       arrays["flat_seg"], n_steps)
        heads = red_rows[arrays["flat_head"].clamp(max=g.shape[0] - 1)]
        del red_rows
    del g
    mask = arrays["mask_live" if live else "mask_ok"]
    heads.masked_fill_(~mask[:, None], 0)
    if op == "andnot":
        hg_key, ok_key = (("head_gather_live", "head_ok_live") if live
                          else ("head_gather", "head_ok"))
        hg = words[arrays[hg_key]]
        hg.masked_fill_(~arrays[ok_key][:, None], 0)
        heads.bitwise_not_().bitwise_and_(hg)      # head & ~rest
        del hg
        cards = None
    if cards is None:
        cards = popcount(heads)
    else:
        cards.masked_fill_(~mask, 0)
    return (heads if needs_words else None), cards


def assemble_pooled_results(bucket_outputs, pooled, rb_meta: dict,
                            owner: dict | None = None) -> list:
    """Per-bucket host outputs ``(bucket, heads u32[q, k_pad, 2048] | None,
    cards [q, k_pad])`` -> per-query ``BatchResult``s in pooled order.  One
    masked sum per bucket; the masks are plan constants cached in
    ``rb_meta`` by bucket identity.  ``owner`` maps pseudo-query ids to
    pooled query indices (expression plans; None = identity; internal
    reduce nodes are skipped)."""
    pooled = list(pooled)
    results: list = [None] * len(pooled)
    for b, heads, cards in bucket_outputs:
        meta = rb_meta.get(id(b))
        if meta is None:
            kqs = np.fromiter((k.size for k in b.keys), np.int64,
                              len(b.keys))
            meta = kqs, (np.arange(b.k_pad)[None, :] < kqs[:, None])
            rb_meta[id(b)] = meta
        kqs, live = meta
        sums = np.where(live[:, :cards.shape[1]],
                        cards[:len(b.keys)], 0).sum(axis=1)
        for slot, (pid, keys_q) in enumerate(zip(b.qids, b.keys)):
            qid = pid if owner is None else owner.get(pid)
            if qid is None:
                continue        # internal expression reduce node
            kq = keys_q.size
            bm = None
            if pooled[qid][1].form == "bitmap":
                bm = packing.unpack_result(
                    keys_q,
                    heads[slot, :kq] if kq else
                    np.zeros((0, WORDS32), np.uint32),
                    cards[slot, :kq])
            results[qid] = BatchResult(cardinality=int(sums[slot]),
                                       bitmap=bm)
    return results


@dataclasses.dataclass
class _Inflight:
    """A dispatched, not yet drained launch: the host copies of its outputs
    (pinned on a card) and the event recorded after the copies were
    queued (None on the CPU, where the outputs are already final)."""

    plan: _PoolPlan
    outs: object
    event: object
    queries: tuple
    eng: str
    inject: bool
    #: launch start (perf_counter) and the process's one-time work count
    #: then: the drain calibrates the time model only if nothing one-time
    #: happened in between
    t0: float = 0.0
    one_time: int = 0
    #: the timing event recorded before the launch (tracing on a card),
    #: and the ``multiset.dispatch`` span the launch ran in
    start: object = None
    span_id: str | None = None
    #: whether the ``multiset.cost`` event was already recorded (a sync
    #: launch records it in its dispatch span)
    costed: bool = False


class MultiSetBatchEngine:
    """Plan and execute mixed-op query pools over S resident sets.

    ``sets`` may mix ``DeviceBitmapSet``s and already-built ``BatchEngine``s
    (adopted, so a server upgrades to pooled execution without repacking).
    All sets must live on one device."""

    def __init__(self, sets: list, result_cache="env"):
        if not sets:
            raise ValueError("multi-set engine needs at least one set")
        #: the materialized-result cache, shared with the member engines
        #: built here (adopted BatchEngines keep their own)
        self.result_cache = (mut_cache.from_env()
                             if result_cache == "env" else result_cache)
        self._engines = [
            s if isinstance(s, BatchEngine)
            else BatchEngine(s, result_cache=self.result_cache)
            for s in sets]
        devs = {_device_key(e.device) for e in self._engines}
        if len(devs) != 1:
            raise ValueError(f"resident sets on different devices: "
                             f"{sorted(map(str, devs))}")
        self.device = self._engines[0].device
        self.n_sets = len(self._engines)
        #: rows of each set's resident image (its pooled-row extent)
        self._rows = [int(e._row_src.size) for e in self._engines]
        self._plans = LRUCache(PLAN_CACHE_MAX, name="multiset_plans")
        #: the pooled programs (captured graphs on the card) by key; the
        #: member engines capture into its pool (all replay on one stream)
        self._programs = rt_programs.ProgramCache(self.device, SITE)
        for e in self._engines:
            e._programs.share_pool(self._programs)
        #: each set's structure version the pooled programs were built on
        self._structures = [e._ds.structure_version for e in self._engines]
        #: reactive (ResourceExhausted) and proactive (budget) halvings
        self.split_count = 0
        self.proactive_split_count = 0
        #: pooled launches that reached the device, and the launches the
        #: per-set loop would have paid beyond them (one per referenced set
        #: per pool)
        self.launch_count = 0
        self.launches_saved = 0
        #: launches re-run synchronously after a fault at drain time
        self.drain_retries = 0
        self.queries_total = 0
        #: the footprint of the latest pooled launches: {"engine", "q",
        #: "sets", "predicted_bytes"}, newest last
        self.dispatch_memory: deque = deque(maxlen=DISPATCH_MEMORY_MAX)
        #: stats of the latest pipelined run of more than one launch
        self.last_pipeline: dict | None = None
        #: the ``multiset.cost`` payload of the latest costed launch
        self.last_dispatch_cost: dict | None = None
        self._first_query_done = False

    @classmethod
    def from_bitmap_sets(cls, bitmap_sets: list, layout: str = "auto",
                         **kw) -> "MultiSetBatchEngine":
        return cls([DeviceBitmapSet(b, layout=layout, **kw)
                    for b in bitmap_sets])

    @property
    def sets(self) -> list:
        return [e._ds for e in self._engines]

    @property
    def last_dispatch_memory(self) -> dict | None:
        return self.dispatch_memory[-1] if self.dispatch_memory else None

    # ------------------------------------------------------------- planning

    def _flatten(self, groups):
        """[(set_id, query)] in group order, and the per-group lengths."""
        pooled, lengths = [], []
        for g in groups:
            if not isinstance(g, BatchGroup):
                g = BatchGroup(*g)
            if g.set_id < 0 or g.set_id >= self.n_sets:
                raise IndexError(
                    f"set_id out of range 0..{self.n_sets - 1}: {g.set_id}")
            pooled.extend((g.set_id, q) for q in g.queries)
            lengths.append(len(g.queries))
        return tuple(pooled), lengths

    @staticmethod
    def _regroup(flat, lengths):
        out, i = [], 0
        for n in lengths:
            out.append(flat[i:i + n])
            i += n
        return out

    def _sync_with_sets(self) -> None:
        """Pick up member-set mutations: a repack changes a tenant's row
        count, so the pooled row extents are read again (the version in the
        plan key retires the stale plans) and the pooled programs are
        retired."""
        for i, e in enumerate(self._engines):
            e._sync_with_ds()
            self._rows[i] = int(e._row_src.size)
        structures = [e._ds.structure_version for e in self._engines]
        if structures != self._structures:
            # a repacked tenant's image or streams moved: its pooled graphs
            # (every pooled graph, under a lattice) read the old ones
            self._structures = structures
            self._programs.retire()

    def _cache_probe_for(self, sid: int):
        """The plan-time subtree probe of tenant ``sid``, or None without a
        cache.  A hit's device rows go into the plan as they are: the plan
        only reads them, and nothing waits for the card."""
        if self.result_cache is None:
            return None
        e = self._engines[sid]
        return mut_cache.subtree_probe(self.result_cache, e._leaf_token,
                                       e._col_token)

    def _plan_pool(self, pooled) -> _PoolPlan:
        """The pooled plan: per-set row selection, the offset remap into
        the compacted pooled row space, the shared shape bucketing and the
        op groups.  Cached by the exact (set_id, query) tuple, the
        referenced sets' identities, versions and columns, and the lattice.

        Under an active lattice every pool references EVERY set (the tenant
        mix stops being a signature dimension), same-op queries share one
        bucket, the plan snaps to its covering point, and each set's row
        selection pads to one covering ``pool`` rung (dead slots re-gather
        the set's row 0, which no bucket reads)."""
        self._sync_with_sets()
        lat = rt_lattice.active()
        sids = (tuple(range(self.n_sets)) if lat is not None
                else tuple(sorted({sid for sid, _ in pooled})))
        key = (tuple(pooled),
               tuple((self._engines[s]._ds.uid, self._engines[s]._ds.version)
                     for s in sids),
               tuple(self._engines[s]._columns_token() for s in sids),
               rt_lattice.plan_token())
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        with obs_slo.phase("plan"), \
                obs_trace.span("multiset.plan", q=len(pooled),
                               sets=len(sids)) as sp:
            plan = self._plan_pool_fresh(pooled, lat, sids, sp)
        self._plans.put(key, plan)
        return plan

    def _plan_pool_fresh(self, pooled, lat, sids, sp) -> _PoolPlan:
        """The body of ``_plan_pool`` on a cache miss, inside its span."""
        offsets, base = {}, 0
        for sid in sids:
            offsets[sid] = base
            base += self._rows[sid]
        groups: dict = {}
        owner: dict = {}
        sections: list = []
        counter = [0]

        def add_item(sid, pq, own):
            pid = counter[0]
            counter[0] += 1
            rows, segs, keys_q, keep, hrows = \
                self._engines[sid]._plan_query(pq)
            off = offsets[sid]
            rows = rows + off
            if hrows is not None:
                hrows = hrows + off
            rung = (0 if lat is not None
                    else packing.next_pow2(max(1, len(set(pq.operands)))))
            groups.setdefault((pq.op, rung), []).append(
                (pid, pq, rows, segs, keys_q, keep, hrows))
            if own is not None:
                owner[pid] = own
            return pid, keys_q

        def plan_leaf(sid, i):
            rows, keys = self._engines[sid]._plan_leaf(i)
            return rows + offsets[sid], keys

        for qid, (sid, q) in enumerate(pooled):
            if isinstance(q, expr_mod.ExprQuery):
                sections.append(expr_mod.compile_query(
                    q, qid,
                    lambda pq, own, sid=sid: add_item(sid, pq, own),
                    lambda i, sid=sid: plan_leaf(sid, i),
                    cache_probe=self._cache_probe_for(sid),
                    col_resolve=self._engines[sid]._column))
            else:
                add_item(sid, q, qid)
        pad_to, point = snap_plan_groups(
            lat, groups, sections, any(q.form == "bitmap" for _, q in pooled),
            counter, self._engines[0].keys[:0], placement="single",
            pool=self._pool_need(lat, groups, sections, sids, offsets))
        sp.tag(need_q=max((len(i) for i in groups.values()), default=0),
               need_rows=max((it[2].size for i in groups.values()
                              for it in i), default=0),
               need_keys=max((it[4].size for i in groups.values()
                              for it in i), default=0))
        with obs_trace.span("multiset.pool", groups=len(groups)):
            buckets = [plan_bucket(op, items, pad_to=pad_to)
                       for (op, _), items in sorted(groups.items())]
        # the compacted pooled row space: every row the pool references
        # (bucket gathers, andnot heads, expression leaves), once, sorted;
        # padded cells gather global row 0, which therefore always joins
        refs = [b.host["gather"].ravel() for b in buckets]
        refs += [b.host["head_gather"].ravel() for b in buckets
                 if "head_gather" in b.host]
        refs += [v.ravel() for sec in sections
                 if sec.kind == "fused" and sec.host
                 for k, v in sec.host.items() if k.startswith("g")]
        pool_rows = (np.unique(np.concatenate(refs)) if refs
                     else np.zeros(1, np.int64))
        if pool_rows.size == 0:
            pool_rows = np.zeros(1, np.int64)
        row_sel = {}
        for sid in sids:
            off = offsets[sid]
            in_set = pool_rows[(pool_rows >= off)
                               & (pool_rows < off + self._rows[sid])]
            row_sel[sid] = (in_set - off).astype(np.int32)
        # the pooled-row need, pre-pad: what a lattice's pool rungs cover
        # (insights.recommend_lattice reads it off the plan span)
        sp.tag(need_pool=int(max((r.size for r in row_sel.values()),
                                 default=1)))
        n_pool = int(pool_rows.size)
        pos = np.arange(n_pool, dtype=np.int64)
        if point is not None:
            # one covering selection rung B for every set; ``pos`` maps
            # compact pooled positions to their padded homes (the rung was
            # judged with the shape snap: never under-pad)
            width = max(point.pool, max(r.size for r in row_sel.values()))
            parts = []
            for i, sid in enumerate(sids):
                sel = row_sel[sid]
                padded = np.zeros(width, np.int32)
                padded[:sel.size] = sel
                row_sel[sid] = padded
                parts.append(i * width + np.arange(sel.size, dtype=np.int64))
            pos = np.concatenate(parts)
            n_pool = width * len(sids)
            point = dataclasses.replace(point, pool=width)
        # remap the host gathers into pooled positions (uploaded later,
        # only for the rung that reads them)
        for b in buckets:
            for k in ("gather", "head_gather"):
                if k in b.host:
                    b.host[k] = pos[np.searchsorted(
                        pool_rows, b.host[k])].astype(np.int32)
        for sec in sections:
            if sec.kind != "fused" or not sec.host:
                continue
            for k in list(sec.host):
                if k.startswith("g"):
                    sec.host[k] = pos[np.searchsorted(
                        pool_rows, sec.host[k])].astype(np.int32)
        expr_mod.finalize_sections(sections, buckets)
        # B5's stream assembles from the remapped gathers
        mega = (megakernel.build_full(buckets, sections)
                if expr_mod.fused_of(sections) else None)
        obs_metrics.gauge("rb_multiset_pool_occupancy", site=SITE).set(
            len(pooled) / max(1, sum(b.q for b in buckets)))
        padding = (0, 0.0)
        if point is not None:
            pb, _pf = plan_padding(buckets, groups)
            pb += (n_pool - int(pool_rows.size)) * insights.ROW_BYTES
            total = sum(b.q * b.r_pad for b in buckets) + n_pool
            padding = (pb, (pb / insights.ROW_BYTES) / max(1, total))
        plan = _PoolPlan(buckets=buckets, op_groups=_merge_op_groups(buckets),
                         sids=sids, row_sel=row_sel, n_pool_rows=n_pool,
                         exprs=sections, owner=owner, mega=mega, point=point,
                         padding=padding)
        sp.tag(buckets=len(buckets),
               occupancy=round(len(pooled) / max(1, sum(b.q for b in buckets)),
                               4),
               pool_rows=n_pool, exprs=len(sections),
               snapped=point is not None)
        return plan

    def _pool_need(self, lat, groups, sections, sids, offsets) -> int:
        """The per-set row-selection need of a pool, judged before the shape
        snap plants anything: -1 without a lattice or with an empty set.
        Global row 0 always joins (padded cells gather it), so a need on a
        rung boundary is judged with it."""
        if lat is None or not all(self._rows[s] >= 1 for s in sids):
            return -1
        refs = [it[2] for items in groups.values() for it in items]
        refs += [it[6] for items in groups.values() for it in items
                 if it[6] is not None]
        refs += [v.ravel() for sec in sections
                 if sec.kind == "fused" and sec.host
                 for k, v in sec.host.items() if k.startswith("g")]
        refs.append(np.zeros(1, np.int64))
        allr = np.unique(np.concatenate([np.asarray(r).ravel()
                                         for r in refs]))
        need = 1
        for sid in sids:
            off = offsets[sid]
            need = max(need, int(((allr >= off)
                                  & (allr < off + self._rows[sid])).sum()))
        return need

    def _pool_engine(self, plan: _PoolPlan, engine: str,
                     note: bool = True) -> str:
        """The rung a pooled plan runs on: "megakernel" resolves to "cuda"
        when the plan has no fused section or does not fit B5, counted by
        reason in ``rb_mega_capacity_demotions_total`` (``note=False`` for a
        prediction).  The JAX package's demotion past its scalar-memory
        prefetch bound has no counterpart: B1 and B3 take any length."""
        if engine == "megakernel" and not (plan.mega is not None
                                           and plan.mega.fits()):
            if note:
                megakernel.note_capacity_demotion(SITE, plan.mega)
            return "cuda"
        return engine

    def predict_dispatch_bytes(self, pooled_or_groups,
                               engine: str = "auto") -> int:
        """Predicted device bytes of ONE pooled launch on the rung it would
        run on (``insights.predict_multiset_dispatch_bytes``): what the
        proactive split compares with the budget."""
        pooled = self._as_pooled(pooled_or_groups)
        plan = self._plan_pool(pooled)
        eng = self._pool_engine(plan, resolve_query_engine(
            engine, [q for _, q in pooled], self.device), note=False)
        return self._predict(plan, eng)["peak_bytes"]

    def predict_dispatch_seconds(self, pooled_or_groups,
                                 engine: str = "auto") -> float:
        """Execute-time estimate of ONE pooled launch, before it dispatches:
        the footprint model's bytes and the word-op count
        (``insights.predict_multiset_dispatch_word_ops``) over the card's
        peak rates, or over the rates this rung's measured launches
        achieved (``obs.cost.TRACKER``).  What the serving loop's
        deadline-aware assembly budgets against."""
        pooled = self._as_pooled(pooled_or_groups)
        if not pooled:
            return 0.0
        plan = self._plan_pool(pooled)
        eng = self._pool_engine(plan, resolve_query_engine(
            engine, [q for _, q in pooled], self.device), note=False)
        return obs_cost.estimate_seconds(
            self._word_ops(plan, eng), self._predict(plan, eng)["peak_bytes"],
            SITE, eng)

    def _word_ops(self, plan: _PoolPlan, eng: str) -> int:
        ops = plan.word_ops.get(eng)
        if ops is None:
            ops = insights.predict_multiset_dispatch_word_ops(
                [b.signature for b in plan.buckets], self._plan_sets(plan),
                eng, pool_rows=plan.n_pool_rows)
            if plan.exprs:
                ops += insights.predict_expr_word_ops(plan.expr_signature, eng)
            plan.word_ops[eng] = ops
        return ops

    def _as_pooled(self, pooled_or_groups):
        seq = list(pooled_or_groups)
        if seq and isinstance(seq[0], (BatchGroup, tuple)) \
                and not (isinstance(seq[0], tuple) and len(seq[0]) == 2
                         and isinstance(seq[0][1],
                                        (BatchQuery, expr_mod.ExprQuery))):
            return self._flatten(seq)[0]
        return tuple(seq)

    def _plan_sets(self, plan: _PoolPlan) -> list:
        """``[(resident kind, n_rows)]`` of every set a plan touches."""
        return [(self._engines[s]._resident_kind(),
                 self._engines[s]._ds._n_rows) for s in plan.sids]

    def _predict(self, plan: _PoolPlan, eng: str) -> dict:
        out = plan.predicted.get(eng)
        if out is None:
            out = insights.predict_multiset_dispatch_bytes(
                [b.signature for b in plan.buckets], self._plan_sets(plan),
                eng, pool_rows=plan.n_pool_rows)
            if plan.exprs:
                e = insights.predict_expr_dispatch_bytes(
                    plan.expr_signature, eng)
                out["expr_bytes"] = e["peak_bytes"]
                out["peak_bytes"] += e["peak_bytes"]
            plan.predicted[eng] = out
        return out

    # ------------------------------------------------------------ execution

    def execute(self, groups, engine: str = "auto", fallback: bool = True,
                policy: guard.GuardPolicy | None = None) -> list:
        """Run a pool of per-set query groups; returns per-group result
        lists aligned with ``groups``.

        One pooled launch per budget-respecting sub-pool (usually one);
        several launches flow through the pipelined dispatcher.  Guarded
        like ``BatchEngine.execute``: per-launch retries and demotion down
        the chain, reactive OOM halving, proactive budget halving, the
        optional shadow check.  A pool over a single set goes through that
        set's ``BatchEngine.execute``.  With a result cache the guarded path
        pools only the queries the cache does not hold, and fills it.
        ``fallback=False`` runs the requested rung raw (no guard, no fault
        injection, no cache)."""
        groups = list(groups)
        pooled, lengths = self._flatten(groups)
        if not pooled:
            return [[] for _ in groups]
        if engine not in ("auto",) + ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{('auto',) + ENGINES}")
        self.queries_total += len(pooled)
        sids = sorted({sid for sid, _ in pooled})
        with obs_trace.span("multiset.execute", site=SITE, q=len(pooled),
                            sets=len(sids), engine=engine,
                            fallback=fallback):
            obs_metrics.counter("rb_multiset_queries_total",
                                site=SITE).inc(len(pooled))
            if len(sids) == 1:
                flat = self._engines[sids[0]].execute(
                    [q for _, q in pooled], engine=engine, fallback=fallback,
                    policy=policy)
                return self._regroup(flat, lengths)
            if not fallback:
                start = resolve_query_engine(engine, [q for _, q in pooled],
                                             self.device)
                return self._regroup(self._launch_once(pooled, start,
                                                       inject=False), lengths)
            t_exec0 = time.perf_counter()
            policy = policy or guard.GuardPolicy.from_env()
            budget = guard.resolve_hbm_budget(policy, self.device)
            deadline = guard.Deadline(policy.deadline)

            def run_misses(qs):
                qs = tuple(qs)
                chain = guard.chain_from(
                    resolve_query_engine(engine, [q for _, q in qs],
                                         self.device), ENGINES, self.device)
                # an in-budget pool is one launch, dispatched synchronously; a
                # pool the budget splits stays a generator, so that the halving
                # and planning of launch k+1 run while launch k is on the card
                if (budget is None or len(qs) < 2
                        or self.predict_dispatch_bytes(qs, chain[0]) <= budget):
                    launches = [(0, qs)]
                else:
                    launches = ((0, sub) for sub in
                                self._launch_iter(qs, chain[0], budget))
                return self._pipeline(launches, chain, policy, deadline,
                                      budget).get(0, [])

            with obs_slo.query(SITE, deadline_ms=policy.slo_deadline_ms):
                flat = self._serve(pooled, run_misses)
            if not self._first_query_done:
                self._first_query_done = True
                obs_metrics.histogram("rb_first_query_seconds",
                                      site=SITE).observe(
                                          time.perf_counter() - t_exec0)
            if policy.shadow_rate > 0.0:
                self._shadow_check(pooled, flat, policy)
            return self._regroup(flat, lengths)

    def execute_pipelined(self, pools, engine: str = "auto",
                          policy: guard.GuardPolicy | None = None) -> list:
        """Stream several pools (serving ticks) through ONE pipeline window:
        pool p+1's planning overlaps pool p's device work even when each
        pool is one launch.  Returns per-pool lists of per-group result
        lists (``execute``'s shape, one per pool).  With a result cache, the
        queries it holds are served first and only the misses of each pool
        stream through the window."""
        pools = [list(p) for p in pools]
        metas = [self._flatten(p) for p in pools]
        if engine not in ("auto",) + ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{('auto',) + ENGINES}")
        policy = policy or guard.GuardPolicy.from_env()
        budget = guard.resolve_hbm_budget(policy, self.device)
        deadline = guard.Deadline(policy.deadline)
        n_sets = len({sid for pooled, _ in metas for sid, _ in pooled})
        with obs_trace.span("multiset.execute", site=SITE,
                            q=sum(len(p) for p, _ in metas), sets=n_sets,
                            engine=engine, pools=len(pools)):
            for pooled, _ in metas:
                self.queries_total += len(pooled)
                obs_metrics.counter("rb_multiset_queries_total",
                                    site=SITE).inc(len(pooled))

            def run_misses(items):
                # items: (pool index, set id, query), in pool order
                by_pi: dict = {}
                for pi, sid, q in items:
                    by_pi.setdefault(pi, []).append((sid, q))
                chain = guard.chain_from(
                    resolve_query_engine(engine, [q for _, _, q in items],
                                         self.device), ENGINES, self.device)

                def launches():
                    for pi, pooled in by_pi.items():
                        for qs in self._launch_iter(pooled, chain[0], budget):
                            yield pi, qs

                got = self._pipeline(launches(), chain, policy, deadline, budget)
                return [r for pi in by_pi for r in got.get(pi, [])]

            items = [(pi, sid, q) for pi, (pooled, _) in enumerate(metas)
                     for sid, q in pooled]
            # one attribution context over the whole streamed window (a
            # per-pool wall cannot be separated once launches overlap)
            with obs_slo.query(SITE, deadline_ms=policy.slo_deadline_ms):
                flat_all = self._serve(items, run_misses) if items else []
            out, i = [], 0
            for pooled, lengths in metas:
                flat = flat_all[i:i + len(pooled)]
                i += len(pooled)
                if policy.shadow_rate > 0.0 and flat:
                    self._shadow_check(pooled, flat, policy)
                out.append(self._regroup(flat, lengths))
            return out

    def _serve(self, items, run_misses) -> list:
        """``run_misses(items)`` alone without a result cache; with one, the
        items the cache holds are served and only the misses run and fill
        it.  An item ends in ``(set id, query)``."""
        if self.result_cache is None:
            return run_misses(items)
        self._sync_with_sets()
        return mut_cache.serve_and_fill(
            self.result_cache, items,
            lambda it: self._engines[it[-2]]._cache_key_of(it[-1]),
            run_misses, SITE, device=self.device)[0]

    def count_cache_hits(self, pooled_or_groups) -> int:
        """How many of a pool's queries the result cache would serve now:
        count-free (``would_hit``), so a predictor may ask without skewing
        the hit and miss counts."""
        if self.result_cache is None:
            return 0
        n = 0
        for sid, q in self._as_pooled(pooled_or_groups):
            key, _leaves, form = self._engines[sid]._cache_key_of(q)
            n += self.result_cache.would_hit(key, form)
        return n

    def _launch_iter(self, pooled, engine: str, budget: int | None):
        """Left-to-right launch partition of ``pooled``, computed lazily: a
        sub-pool predicted past the budget is halved here (the proactive
        split), and launch k+1 is halved and planned only when the pipeline
        pulls it, while launch k is on the card."""
        stack = [list(pooled)]
        while stack:
            qs = stack.pop()
            while budget is not None and len(qs) >= 2:
                predicted = self.predict_dispatch_bytes(qs, engine)
                if predicted <= budget:
                    break
                mid = (len(qs) + 1) // 2
                self.proactive_split_count += 1
                obs_metrics.counter("rb_multiset_proactive_splits_total",
                                    site=SITE).inc()
                obs_trace.current().event(
                    "proactive_split", site=SITE, q=len(qs),
                    predicted_bytes=predicted, budget_bytes=budget,
                    halves=(mid, len(qs) - mid))
                stack.append(qs[mid:])
                qs = qs[:mid]
            yield tuple(qs)

    def _pipeline(self, launches, chain, policy, deadline, budget) -> dict:
        """Depth-``policy.pipeline_depth`` window over ``launches`` (an
        iterable of ``(tag, queries)``): dispatch launch k+1 while up to
        depth - 1 earlier launches are in flight, then drain the oldest.
        Returns ``{tag: [BatchResult, ...]}`` in pooled order (drains are
        FIFO).  Host time spent pulling and dispatching while a launch was
        in flight is the hidden share the overlap ratio reports."""
        depth = max(1, policy.pipeline_depth)
        # a known single launch has nothing to overlap: dispatch it sync
        single = isinstance(launches, (list, tuple)) and len(launches) == 1
        inflight: deque = deque()
        out: dict = {}
        host_ms = overlapped_ms = drain_ms = 0.0
        n_launches = 0          # window slots; device launches come from
        launches0 = self.launch_count      # the counter (splits add)
        #: referenced sets per tag: the per-set loop's launches
        tag_sids: dict = {}

        def drain():
            nonlocal drain_ms
            tag, qs, payload = inflight.popleft()
            t0 = time.perf_counter()
            if isinstance(payload, list):   # a landing or a split recovery
                res = payload
            else:
                try:
                    # the drain-time fault seam: a deferred device fault
                    # surfaces after the dispatching slot returned
                    if payload.inject:
                        faults.maybe_fail(f"{SITE}.drain", payload.eng)
                    res = self._finish(payload)
                except Exception as exc:
                    fault = errors.classify(exc)
                    if fault is None or isinstance(fault,
                                                   errors.ShadowMismatch):
                        raise
                    # re-run this launch synchronously down the chain
                    self.drain_retries += 1
                    obs_metrics.counter("rb_multiset_drain_retries_total",
                                        site=SITE).inc()
                    obs_trace.current().event(
                        "drain_retry", site=SITE, q=len(qs),
                        error_class=type(fault).__name__)
                    res, _ = self._launch_guarded(qs, chain, policy,
                                                  deadline, budget, sync=True)
            drain_ms += (time.perf_counter() - t0) * 1e3
            out.setdefault(tag, []).extend(res)

        with obs_trace.span("multiset.pipeline", depth=depth) as sp:
            it = iter(launches)
            while True:
                t0 = time.perf_counter()
                # pulling the iterator runs the next launch's budget halving
                nxt = next(it, None)
                if nxt is None:
                    break
                tag, qs = nxt
                tag_sids.setdefault(tag, set()).update(sid for sid, _ in qs)
                payload, _rung = self._launch_guarded(
                    qs, chain, policy, deadline, budget, sync=single)
                h = (time.perf_counter() - t0) * 1e3
                host_ms += h
                # overlapped only when a device launch was in flight:
                # finished lists (landings, split recoveries) hide nothing
                if any(isinstance(p, _Inflight) for _, _, p in inflight):
                    overlapped_ms += h
                n_launches += 1
                inflight.append((tag, qs, payload))
                # keep at most depth - 1 undrained: depth 1 drains at once
                while len(inflight) >= depth:
                    drain()
            while inflight:
                drain()
            stats = {"launches": n_launches, "depth": depth,
                     "host_ms": round(host_ms, 3),
                     "host_overlapped_ms": round(overlapped_ms, 3),
                     "overlap_ratio": round(overlapped_ms / host_ms
                                            if host_ms else 0.0, 4),
                     "drain_ms": round(drain_ms, 3)}
            sp.tag(**stats)
        if n_launches > 1:
            # a single launch has no overlap to measure
            obs_metrics.gauge("rb_multiset_pipeline_overlap_ratio",
                              site=SITE).set(stats["overlap_ratio"])
            self.last_pipeline = stats
        device_launches = self.launch_count - launches0
        saved = (max(0, sum(len(s) for s in tag_sids.values())
                     - device_launches) if device_launches else 0)
        self.launches_saved += saved
        obs_metrics.counter("rb_multiset_launches_saved_total",
                            site=SITE).inc(saved)
        return out

    def _launch_guarded(self, qs, chain, policy, deadline, budget,
                        sync: bool):
        """One guarded launch of pooled queries ``qs`` down ``chain``.
        ``sync=False`` returns an :class:`_Inflight` (drained later); host
        landings and OOM-split recoveries return finished result lists."""

        def attempt(eng):
            return self._launch_once(qs, eng, sync=sync)

        def on_oom(eng, fault, dl):
            if len(qs) < 2:
                return guard.NO_SPLIT
            sub = chain[chain.index(eng):] if eng in chain else chain
            mid = (len(qs) + 1) // 2
            self.split_count += 1
            obs_metrics.counter("rb_multiset_oom_splits_total",
                                site=SITE).inc()
            obs_trace.current().event(
                "oom_split", site=SITE, engine_from=eng, engine_to=eng,
                q=len(qs), halves=(mid, len(qs) - mid))
            return (self._launch_guarded(qs[:mid], sub, policy, dl, budget,
                                         sync=True)[0]
                    + self._launch_guarded(qs[mid:], sub, policy, dl, budget,
                                           sync=True)[0])

        return guard.run_with_fallback(
            SITE, chain, attempt, policy=policy,
            sequential=lambda: self._sequential(qs),
            on_resource_exhausted=on_oom, deadline=deadline)

    def _launch_once(self, pooled, engine: str, inject: bool = True,
                     sync: bool = True):
        """One pooled launch on one rung: plan, the device part, the copies
        of its outputs to the host; then the host assembly (``sync``) or an
        :class:`_Inflight`.  The fault hooks sit at the engine boundary."""
        pooled = tuple(pooled)
        t0, one0 = time.perf_counter(), rt_programs.one_time_work()
        plan = self._plan_pool(pooled)
        eng = self._pool_engine(plan, engine)
        obs_slo.note_engine(eng)
        if inject:
            faults.maybe_fail(SITE, eng)
        # the program is built before the launch, outside its span
        with obs_slo.phase("program_build"):
            self._program(plan, eng, run=False)
        with obs_trace.span("multiset.dispatch", engine=eng, q=len(pooled),
                            sets=len(plan.sids), buckets=len(plan.buckets),
                            pipelined=not sync) as sp:
            # device time is read only while tracing is on, and the
            # allocator's (device-global) peak only on a sync launch
            start = obs_cost.launch_timer(self.device)
            window = obs_memory.PeakWindow(
                self.device if start is not None and sync else "cpu")
            with window, obs_slo.phase("dispatch"):
                outs = self._program(plan, eng)
                event = obs_cost.end_event(self.device, start is not None)
            # counted here, not per window slot: an OOM-split slot
            # dispatches 2+ launches, a sequential landing none
            self.launch_count += 1
            obs_metrics.counter("rb_multiset_launches_total",
                                site=SITE).inc()
            if plan.exprs:
                expr_mod.record_fused_dispatch(SITE, plan.exprs)
                expr_mod.record_analytics_dispatch(SITE, plan.exprs, sp)
            if eng == "megakernel":
                sp.event("expr.megakernel", **plan.mega.stats_event())
            flight = _Inflight(plan=plan, outs=outs, event=event,
                               queries=pooled, eng=eng, inject=inject, t0=t0,
                               one_time=one0, start=start,
                               span_id=sp.span_id)
            if sync:
                with obs_slo.phase("sync"):
                    sp.sync(event)          # sync_ms, while tracing
                    if event is not None:
                        event.synchronize()
            mem = obs_memory.record_dispatch(
                SITE, self._predict(plan, eng)["peak_bytes"],
                window.peak() if sync else None)
            mem.update(engine=eng, q=len(pooled), sets=len(plan.sids))
            if plan.point is not None:
                pb, pf = plan.padding
                mem["lattice_padding_bytes"] = int(pb)
                mem["lattice_padding_fraction"] = round(pf, 6)
                rt_lattice.record_padding(SITE, int(pb), pf)
            self.dispatch_memory.append(mem)
            sp.event("multiset.memory", **mem)
            if sync:
                sp.event("multiset.cost", **self._record_cost(flight))
        return flight if not sync else self._finish(flight)

    def _record_cost(self, flight: _Inflight, **extra) -> dict:
        """The launch's ``multiset.cost`` payload (``obs.cost``): the plan's
        word ops and bytes over its CUDA-event device time while tracing,
        else over its wall from the host plan to the host outputs.  That
        wall also calibrates ``predict_dispatch_seconds`` unless the launch
        paid one-time work (a kernel library load, a capture, a first
        eager run)."""
        flight.costed = True
        wall = time.perf_counter() - flight.t0
        plan, eng = flight.plan, flight.eng
        predicted = self._predict(plan, eng)["peak_bytes"]
        cost_ev = obs_cost.record_dispatch(
            SITE, eng, obs_cost.plan_cost(self._word_ops(plan, eng),
                                          predicted),
            obs_cost.launch_seconds(flight.start, flight.event, wall),
            track=(flight.start is not None
                   or rt_programs.one_time_work() == flight.one_time),
            q=len(flight.queries), sets=len(plan.sids), **extra)
        self.last_dispatch_cost = cost_ev
        return cost_ev

    def _pooled_words(self, plan: _PoolPlan, eng: str, sels) -> torch.Tensor:
        """The pooled image: each referenced set's selected rows (``sels``,
        per set in ``sids`` order), written into one int32[n_pool_rows,
        2048] tensor (a stream set's image is rebuilt, B3 on the kernel
        rungs, and dropped once its rows are selected)."""
        words = torch.empty((plan.n_pool_rows, WORDS32), dtype=torch.int32,
                            device=self.device)
        off = 0
        for sid, sel in zip(plan.sids, sels):
            n = int(plan.row_sel[sid].size)
            if n:
                torch.index_select(self._engines[sid]._words(eng), 0, sel,
                                   out=words[off:off + n])
            off += n
        if off < plan.n_pool_rows:      # only when every set is empty
            words[off:].zero_()
        return words

    def _operands(self, plan: _PoolPlan, eng: str, packed: bool) -> dict:
        """The device part's operand tree: the row selections, then B5's
        stream and banks, or the op groups' and fused sections' arrays;
        cached device arrays (``packed=False``) or host arrays for an
        operand pack (``runtime.programs``)."""
        dev = self.device
        ops = {"r": [plan.row_sel[s] if packed else plan.row_sel_dev(s, dev)
                     for s in plan.sids]}
        if eng == "megakernel":
            ops["m"] = (plan.mega.operands(dev) if packed
                        else plan.mega.device_arrays(dev))
            return ops
        if eng == guard.PLAIN_VMAP:
            ops["b"] = [b.host if packed else b.device_arrays(dev)
                        for b in plan.buckets]
        else:
            ops["g"] = [{k: g.host[k] for k in _op_group_keys(g, eng)} if packed
                        else g.device_arrays(dev, _op_group_keys(g, eng))
                        for g in plan.op_groups]
        ops["s"] = [sec.host if packed else sec.device_arrays(dev)
                    for sec in plan.fused]
        ops["c"] = [[c.device_operands() for c in sec.cols]
                    for sec in plan.fused]
        return ops

    def _run(self, plan: _PoolPlan, eng: str, ops: dict,
             static: bool = False):
        """The device part of one launch over the operand tree ``ops``: on
        "megakernel" B5's raw output rows and card partials; otherwise
        (per-group outputs, fused section outputs).  ``static``: the
        operands are a program's."""
        words = self._pooled_words(plan, eng, ops["r"])
        if eng == "megakernel":
            m = ops["m"]
            return megakernel.raw_call(plan.mega, words, m["extra"],
                                       m["cols"], stream=m["stream"],
                                       steps_dev=m.get("steps"))
        feeding = expr_mod.expr_bucket_ids(plan.exprs)
        if eng == guard.PLAIN_VMAP:
            # unmerged: one body a bucket, outputs per bucket
            outs, heads_by_bi = [], []
            for bi, (b, arrs) in enumerate(zip(plan.buckets, ops["b"])):
                heads, cards = bucket_body(words, b.signature, arrs, eng)
                heads_by_bi.append(heads if bi in feeding else None)
                outs.append((heads if b.needs_words else None, cards))
            return outs, (expr_mod.eval_sections(
                plan.fused, words, heads_by_bi,
                ops["s"] if static else None,
                ops["c"] if static else None) if plan.fused else [])
        outs, group_heads = [], []
        for g, arrs in zip(plan.op_groups, ops["g"]):
            force = any(bi in feeding for bi in g.bucket_idx)
            heads, cards = _op_body(words, g.sig, arrs, eng,
                                    force_heads=force)
            group_heads.append((heads if force else None, cards))
            outs.append((heads if g.needs_words else None, cards))
        if not plan.fused:
            return outs, []
        bucket_heads = expr_mod.traced_bucket_heads(
            plan.buckets, plan.op_groups, group_heads, live_ok=eng != "cuda")
        return outs, expr_mod.eval_sections(
            plan.fused, words, bucket_heads, ops["s"] if static else None,
            ops["c"] if static else None)

    def _program_key(self, plan: _PoolPlan, eng: str, layout) -> tuple:
        """The pooled program of a plan: the JAX package's key (rung, the
        plan's signature, the referenced sets' uids and structure versions,
        the stream's shape on "megakernel"), then the program cache's
        generation and the operand pack's layout.  The JAX package's
        donating variant has no counterpart: nothing is donated here."""
        key = plan.keys.get(eng)
        if key is None:
            key = (eng, plan.signature,
                   tuple((self._engines[s]._ds.uid,
                          self._engines[s]._ds.structure_version)
                         for s in plan.sids))
            if eng == "megakernel":
                key += (plan.mega.signature,)
            plan.keys[eng] = key
        return key + (self._programs.generation, layout)

    def _program(self, plan: _PoolPlan, eng: str, run: bool = True):
        """The device part of one launch through its program, its outputs
        copied into pinned host tensors (queued, not waited for): a snapped
        plan replays its signature's graph, an unsnapped one runs eagerly
        (``BatchEngine._program``).  ``run=False`` only prepares."""
        if plan.point is None:
            key = self._program_key(plan, eng, None)
            if not run:
                self._programs.note_eager(
                    key, eng, None, 0.0, tags=lambda: self._build_tags(
                        plan, eng))
                return None
            t0 = time.perf_counter()
            outs = rt_programs.copy_out(self._run(
                plan, eng, self._operands(plan, eng, False)))
            if key not in self._programs:   # no prepare noted it
                self._programs.note_eager(key, eng, None,
                                          time.perf_counter() - t0)
            return outs
        pack = plan.packs.get(eng)
        if pack is None:
            pack = plan.packs[eng] = rt_programs.pack_operands(
                self._operands(plan, eng, packed=True), self.device)
        if eng == "megakernel":
            # the replayed stream is this plan's: check it against the banks
            m = plan.mega
            m.check((plan.n_pool_rows, m.extra_rows, max(1, m.col_rows)))
        key = self._program_key(plan, eng, pack.layout)

        def device_part(ops, plan=plan):
            return self._run(plan, eng, ops, static=True)

        if not run:
            self._programs.prepare(key, eng, plan.point, device_part, pack,
                                   tags=lambda: self._build_tags(plan, eng))
            return None
        return self._programs.dispatch(key, eng, plan.point, device_part,
                                       pack)

    def _build_tags(self, plan: _PoolPlan, eng: str) -> dict:
        """The ``multiset.program_build`` span's tags (the JAX package's
        keys; nothing is donated here, there is no compiler analysis, and
        the cost is the plan's own count)."""
        predicted = self._predict(plan, eng)["peak_bytes"]
        return {"sets": len(plan.sids), "buckets": len(plan.buckets),
                "donate": False, "exprs": len(plan.fused),
                "predicted_bytes": predicted, "measured_peak_bytes": None,
                "flops": float(self._word_ops(plan, eng)),
                "bytes_accessed": float(predicted)}

    def _finish(self, flight: _Inflight) -> list:
        if flight.event is not None:
            flight.event.synchronize()
        if not flight.costed:
            # a pipelined launch completed under this drain: its cost is
            # stamped here, flagged async and pointing at the launch span
            # (the wall includes pipeline queueing: a lower bound)
            obs_trace.current().event("multiset.cost", **self._record_cost(
                flight, **{"async": True, "launch_span_id": flight.span_id}))
        return self._readback(flight.plan, flight.outs, flight.queries,
                              flight.eng, flight.inject)

    def _bucket_outputs(self, plan: _PoolPlan, outs, eng: str):
        """Per-group host outputs -> per-bucket (bucket, heads u32 | None,
        cards) NumPy arrays, each bucket's slots sliced out of the flat head
        axis (one live slot per query for a regular group on "torch"); the
        unmerged "torch-vmap" rung's outputs are per bucket already."""
        if eng == guard.PLAIN_VMAP:
            for b, (heads, cards) in zip(plan.buckets, outs):
                yield (b, None if heads is None
                       else heads.numpy().view(np.uint32), cards.numpy())
            return
        for grp, (heads_f, cards_f) in zip(plan.op_groups, outs):
            heads_f = (None if heads_f is None
                       else heads_f.numpy().view(np.uint32))
            cards_f = cards_f.numpy()
            live = grp.regular and eng != "cuda"
            for bi, s0 in zip(grp.bucket_idx, grp.seg_offs):
                b = plan.buckets[bi]
                if live:
                    s0, n = s0 // 2, b.q
                    cards = cards_f[s0:s0 + n].reshape(b.q, 1)
                    heads = (None if heads_f is None else
                             heads_f[s0:s0 + n].reshape(b.q, 1, WORDS32))
                else:
                    n = b.q * (b.k_pad + 1)
                    cards = cards_f[s0:s0 + n].reshape(
                        b.q, b.k_pad + 1)[:, :b.k_pad]
                    heads = (None if heads_f is None else
                             heads_f[s0:s0 + n].reshape(
                                 b.q, b.k_pad + 1, WORDS32)[:, :b.k_pad])
                yield b, heads, cards

    def _readback(self, plan: _PoolPlan, outs, pooled, eng: str,
                  inject: bool) -> list:
        """Host outputs -> per-query ``BatchResult``s in pooled order."""
        with obs_slo.phase("readback"), \
                obs_trace.span("multiset.readback", engine=eng,
                               q=len(pooled)):
            return self._readback_results(plan, outs, pooled, eng, inject)

    def _readback_results(self, plan: _PoolPlan, outs, pooled, eng: str,
                          inject: bool) -> list:
        if eng == "megakernel":
            b_outs, expr_outs = megakernel._slice_outputs(plan.mega, *outs)
            bucket_outs = (
                (b, None if h is None else h.numpy().view(np.uint32),
                 c.numpy()) for b, (h, c) in zip(plan.buckets, b_outs))
        else:
            outs, expr_outs = outs
            bucket_outs = self._bucket_outputs(plan, outs, eng)
        # the owner map skips the pseudo queries of expression reduce nodes
        # and of the lattice's dead buckets
        results = assemble_pooled_results(
            bucket_outs, pooled, plan.rb_meta,
            owner=(plan.owner if plan.exprs or plan.point is not None
                   else None))
        fi = 0
        for sec in plan.exprs:
            if sec.kind == "flat":
                continue        # read back from its bucket above
            out = None
            if sec.kind == "fused":
                out = expr_outs[fi]
                fi += 1
            sid, q = pooled[sec.qid]
            card, bm, value = expr_mod.assemble_section_result(
                sec, out, q.form, self._engines[sid]._empty_cls)
            results[sec.qid] = BatchResult(cardinality=card, bitmap=bm,
                                           value=value)
        if inject and faults.should_corrupt(SITE, eng):
            results[0] = dataclasses.replace(
                results[0], cardinality=results[0].cardinality + 1)
        return results

    # ------------------------------------------------ host reference rung

    def _sequential(self, pooled) -> list:
        """The host rung: each query on its own set's host container
        algebra, the reference every pooled rung is held against."""
        return [self._engines[sid]._sequential_result(q)
                for sid, q in pooled]

    def _shadow_check(self, pooled, results, policy) -> None:
        idx = guard.shadow_sample(len(pooled), policy.shadow_rate,
                                  policy.shadow_seed, SITE)
        for i in idx:
            sid, q = pooled[i]
            ref = self._engines[sid]._sequential_result(q)
            got = results[i]
            bad = (got.cardinality != ref.cardinality
                   or got.value != ref.value)
            if not bad and q.form == "bitmap":
                bad = got.bitmap != ref.bitmap
            if bad:
                raise errors.ShadowMismatch(
                    f"multiset query {i} ({query_desc(q)} on set {sid}) "
                    f"diverged from the sequential reference: got "
                    f"cardinality {got.cardinality}/value {got.value}, "
                    f"want {ref.cardinality}/{ref.value}")

    # ---------------------------------------------------------- warmup

    def _lattice_pools(self, point) -> list:
        """The representative pools of one pooled lattice point (the JAX
        package's): two tenants, so that the pool is pooled; flat points
        one query per op of the point, expression depths the
        ``rung_expressions`` DAGs sized per tenant, analytics depths tenant
        0's column batches."""
        if point.bsi:
            return [[BatchGroup(0, batch)] for batch in analytics_rung_queries(
                self._engines[0]._ds.columns, point.bsi,
                self._engines[0].n)]
        if point.expr:
            return [[BatchGroup(0, expr_mod.rung_expressions(
                        point.expr, self._engines[0].n)),
                     BatchGroup(1, expr_mod.rung_expressions(
                         point.expr, self._engines[1].n)[:1])]]
        return [[BatchGroup(0, [BatchQuery(op, (0,)) for op in point.ops]),
                 BatchGroup(1, [BatchQuery(point.ops[0], (0,))])]]

    def _prepare_pool(self, pool, engine: str) -> list:
        """Plan a pool and prepare its pooled program on its rung, and on
        "megakernel" too where its plan fits there.  Returns the plan and
        the rungs."""
        pooled, _ = self._flatten(list(pool))
        plan = self._plan_pool(pooled)
        eng = self._pool_engine(plan, resolve_query_engine(
            engine, [q for _, q in pooled], self.device), note=False)
        engs = [eng]
        if eng != "megakernel" and self._pool_engine(
                plan, "megakernel", note=False) == "megakernel":
            engs.append("megakernel")
        for e in engs:
            self._program(plan, e, run=False)
        return plan, engs

    def _compile_lattice_points(self, lat, engine: str) -> int:
        """Prepare the POOLED half of the vocabulary: each flat point pins a
        two-tenant mini-pool (single-tenant pools run on the member engines,
        warmed separately), so that its program carries the point's bucket
        shapes, every set and the pinned row rung; expression and analytics
        shape-classes their representative pools; delta rungs every
        tenant's patch path.  The JAX package also compiles a donating
        variant of each pooled program where its backend donates; the port
        donates nothing, so it has one program less per point there."""
        if self.n_sets < 2:
            return 0
        points = lat.enumerate_points(pooled=True)
        self._programs.maxsize = max(self._programs.maxsize,
                                     2 * len(points) + 8)
        compiled = 0
        for point in points:
            if point.delta:
                for e in self._engines:
                    e._ds.warmup_delta(point.delta)
                compiled += 1
                continue
            with lat.pin(point):
                for pool in self._lattice_pools(point):
                    plan, _ = self._prepare_pool(pool, engine)
                    for sec in plan.exprs:
                        lat.note_expr(sec.signature)
            compiled += 1
        return compiled

    def _check_pool_budget(self, lat, engine: str, budget) -> int:
        """The largest predicted pooled dispatch of the vocabulary's
        representative pools (``insights.predict_multiset_dispatch_bytes``),
        or of a member engine's: the graph pools one replay at a time
        needs.  Past ``budget``: ``GraphPoolBudgetError``."""
        peak = max([0] + [e._check_pool_budget(lat, engine, budget)
                          for e in self._engines])
        if self.n_sets >= 2:
            for point in lat.enumerate_points(pooled=True):
                if point.delta:
                    continue
                with lat.pin(point):
                    for pool in self._lattice_pools(point):
                        pooled, _ = self._flatten(pool)
                        plan = self._plan_pool(pooled)
                        eng = self._pool_engine(plan, resolve_query_engine(
                            engine, [q for _, q in pooled], self.device),
                            note=False)
                        peak = max(peak, self._predict(plan, eng)[
                            "peak_bytes"])
        if budget is not None and peak > budget:
            raise errors.GraphPoolBudgetError(
                f"{SITE}: the lattice's predicted graph pool is {peak} "
                f"bytes, past the budget of {budget}; narrow the profile")
        return peak

    def _warmup_lattice(self, profile, engine: str) -> dict:
        """``warmup(profile=...)`` over the pooled engine: activate the
        lattice, check the predicted pools against the budget, prepare
        every member engine's vocabulary (the single-set route), then the
        pooled one, and seal."""
        t0 = time.perf_counter()
        lat = rt_lattice.activate(profile)
        budget = guard.resolve_hbm_budget(None, self.device)
        try:
            predicted = self._check_pool_budget(lat, engine, budget)
        except errors.GraphPoolBudgetError:
            rt_lattice.deactivate()     # a refused vocabulary snaps nothing
            raise
        compiled = 0
        for e in self._engines:
            compiled += e._compile_lattice_points(lat, engine)
        compiled += self._compile_lattice_points(lat, engine)
        lat.seal()
        progs = [self._programs] + [e._programs for e in self._engines]
        return {"site": SITE,
                "compile_cache_dir": str(rt_warmup.build_dir()),
                "lattice": {"profile": lat.to_profile(),
                            "points": lat.n_points(pooled=True),
                            "compiled": compiled, "sealed": True},
                "programs": [],
                "graphs": sum(p.graphs for p in progs),
                "pool_bytes": self._programs.pool_bytes(),
                "predicted_pool_bytes": int(predicted),
                "hbm_budget_bytes": budget,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def warmup(self, rungs=(1, 2, 4, 8),
               ops=("or", "and", "xor", "andnot"),
               engine: str = "auto", pools=None, profile=None) -> dict:
        """Prepare pooled programs for known pow2 operand rungs (one pool
        per rung: every tenant contributes each op over its first ``rung``
        residents; ``"expr:N"`` and ``"delta:N"`` as in
        ``BatchEngine.warmup``), or for explicit ``pools=``.  A pool over
        one set warms that set's engine, as ``execute`` routes it.
        ``profile=`` is the closed-lattice boot: the member engines' and
        the pooled vocabularies are prepared, then the lattice seals."""
        rt_warmup.enable_compile_cache()
        if profile is not None:
            return self._warmup_lattice(profile, engine)
        t0 = time.perf_counter()
        programs = []
        if pools is None:
            pools = []
            for r in rungs:
                kind, n = expr_mod.parse_warmup_rung(r)
                if kind == "delta":
                    for e in self._engines:
                        rep = e._ds.warmup_delta(n)
                        programs.append({"delta_rung": n,
                                         "engine": "mutation",
                                         "compiled": rep["compiled"]})
                    continue
                pools.append([
                    BatchGroup(sid, expr_mod.rung_expressions(n, e.n)
                               if kind == "expr"
                               else e._rung_queries(n, ops))
                    for sid, e in enumerate(self._engines)])
        for pool in pools:
            pooled, _ = self._flatten(list(pool))
            if not pooled:
                continue
            sids = sorted({sid for sid, _ in pooled})
            if len(sids) == 1:
                rep = self._engines[sids[0]].warmup(
                    queries=[q for _, q in pooled], engine=engine)
                programs.extend(rep["programs"])
                continue
            plan, engs = self._prepare_pool(pool, engine)
            for e in engs:
                programs.append({"q": len(pooled), "sets": len(sids),
                                 "buckets": len(plan.buckets), "engine": e})
        return {"site": SITE, "compile_cache_dir": str(rt_warmup.build_dir()),
                "programs": programs,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    # --------------------------------------------------------- conveniences

    def cardinalities(self, groups, engine: str = "auto") -> list:
        """Per-group int64 arrays of result cardinalities."""
        return [np.array([r.cardinality for r in rows], dtype=np.int64)
                for rows in self.execute(groups, engine=engine)]

    def cache_stats(self) -> dict:
        """The pooled plan cache and the engine's counters."""
        return {"plans": self._plans.stats(),
                "programs": self._programs.stats(),
                "splits": self.split_count,
                "proactive_splits": self.proactive_split_count,
                "launches": self.launch_count,
                "launches_saved": self.launches_saved,
                "drain_retries": self.drain_retries,
                "queries": self.queries_total}

    def hbm_bytes(self) -> int:
        """Device bytes the member sets keep resident, summed."""
        return sum(e.hbm_bytes() for e in self._engines)


def random_multiset_pool(set_sizes: list, q: int, seed: int = 0x5E75,
                         max_operands: int = 8) -> list:
    """Deterministic pooled workload (the JAX package's generator: the same
    seed gives the same pool): ``q`` mixed-op queries dealt round-robin over
    ``len(set_sizes)`` tenants, set ``i`` holding ``set_sizes[i]`` resident
    bitmaps.  The op is drawn independently of the tenant."""
    rng = np.random.default_rng(seed)
    per_set: list = [[] for _ in set_sizes]
    for i in range(q):
        sid = i % len(set_sizes)
        n = set_sizes[sid]
        op = ("or", "xor", "and", "andnot")[int(rng.integers(4))]
        hi = max(3, min(max_operands + 1, n))
        k = int(rng.integers(2, hi)) if n >= 3 else 2
        per_set[sid].append(BatchQuery(op=op, operands=tuple(
            int(x) for x in rng.choice(n, size=min(k, n), replace=False))))
    return [BatchGroup(sid, qs) for sid, qs in enumerate(per_set) if qs]
