"""Batched multi-query aggregation: Q wide ops per device dispatch
(``roaringbitmap_tpu.parallel.batch_engine``).

A batch holds flat ``BatchQuery``s (an op in {or, and, xor, andnot} over a
subset of one resident ``DeviceBitmapSet``, with a result form) and
expression queries (``expr.ExprQuery``).  The resident blocked layout keeps
one container per row, sorted by key segment, with ``row_src`` recording
each row's source bitmap.  A query over subset S selects its rows on the
host, and the planner lays every query of a batch out as segments of ONE
flat segmented reduce:

    flat segment id = q * (K_pad + 1) + local_key_slot

Per-op lowering:
  or / xor   masked rows (padding) carry the identity 0.
  and        padding rows carry 0xFFFFFFFF; key slots whose presence count
             is below |S| are zeroed after the reduce (a missing container
             annihilates the AND: the workShyAnd rule).
  andnot     operands[0] minus OR(operands[1:]): the reduce computes the
             rest-union on the head's key slots, then head & ~rest.

Queries are grouped by (op, pow2(|operands|)), and each bucket pads its
per-query row count, key count and query count to powers of two.

Rungs (``engine``):
  "megakernel"  the whole plan as one instruction stream, one B5 launch
                (``ops.megakernel``); a plan without fused expression
                sections, or past B5's capacity, resolves to "cuda", counted
                in ``rb_mega_capacity_demotions_total`` by reason;
  "cuda"        per bucket a gather + the ragged reduce B1
                (``ops.kernels.segmented_reduce``), then the expression
                combines and the value columns' plane scans in plain
                PyTorch (the JAX "pallas" rung);
  "torch"       the plain versions: gather + the doubling reduce (the JAX
                "xla" rung);
  "torch-vmap"  the per-query cross-check (the JAX "xla-vmap" rung): each
                bucket reduced query by query, neither flattened over the
                query axis nor merged per op, which proves both equivalent;
                on the card it runs only when asked for by name;
  "auto"        "megakernel" on a CUDA device when the batch holds an
                ``ExprQuery``, else "cuda" on the card and "torch" on the
                CPU.
``predict_dispatch_bytes`` is the port's footprint model of one dispatch
(``insights.analysis``); a batch predicted past the budget
(``runtime.guard.resolve_hbm_budget``) is halved before dispatch.
Compact and counts sets rebuild the row image first: B3 on the "cuda" and
"megakernel" rungs, the plain scatter on "torch" and "torch-vmap".

Programs and the lattice (``runtime.lattice``, ``runtime.programs``): the
device part of a plan runs through the engine's program cache.  Under an
active lattice a plan snaps to its covering point and replays its
signature's program, on the card a captured CUDA graph; an unsnapped plan
runs eagerly.  ``warmup(profile=...)`` prepares the whole vocabulary and
seals it: a new program after the seal is a counted escape.

``execute`` runs a batch under ``runtime.guard`` down ``ENGINES`` from the
rung above: on the CPU with the per-query host fold as the last rung, on
the card over the kernel rungs alone (see ``BatchEngine.execute``).  A set of ``Roaring64Bitmap``s (u64 keys) gives
``Roaring64Bitmap`` results.
"""

from __future__ import annotations

import dataclasses
import operator
import time

import numpy as np
import torch

from ..core.bitmap import RoaringBitmap
from ..core.bitmap64 import Roaring64Bitmap
from ..insights import analysis as insights
from ..mutation import result_cache as mut_cache
from ..obs import cost as obs_cost
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..ops import dense, kernels, megakernel, packing
from ..ops.words import WORDS32, to_u32
from ..runtime import errors, faults, guard
from ..runtime import lattice as rt_lattice
from ..runtime import programs as rt_programs
from ..runtime import warmup as rt_warmup
from ..runtime.cache import LRUCache
from . import expr as expr_mod
from .aggregation import DeviceBitmapSet, _engine

_RED_OP = {"or": "or", "xor": "xor", "and": "and", "andnot": "or"}

#: also the guard's ladder for a batch, in order
ENGINES = ("megakernel", "cuda", "torch", guard.PLAIN_VMAP)

#: cap of the prepared-plan cache: novel query shapes must not grow a
#: long-lived server without bound
PLAN_CACHE_MAX = 256

#: the guard and lattice site of single-set batches
SITE = "batch_engine"


def query_desc(q) -> str:
    """Human-readable query tag for error messages (flat or expression)."""
    if isinstance(q, expr_mod.ExprQuery):
        return (f"expr depth={expr_mod.dag_stats(q.expr)['depth']} "
                f"form={q.form}")
    return f"{q.op} over {q.operands}"


def resolve_query_engine(engine: str, queries, device) -> str:
    """The rung a batch starts at: an explicit "megakernel" always starts
    there; "auto" starts there only on a CUDA device and only when the batch
    holds expression queries (flat batches gain nothing from the
    instruction stream); "torch-vmap" runs only when asked for."""
    if engine in ("megakernel", guard.PLAIN_VMAP):
        return engine
    eng = _engine(engine, torch.device(device))
    if (engine == "auto" and eng == "cuda"
            and any(isinstance(q, expr_mod.ExprQuery) for q in queries)):
        return "megakernel"
    return eng


@dataclasses.dataclass(frozen=True)
class BatchQuery:
    """One wide-aggregation request against a resident set.

    operands index the resident set's inputs and are treated as a SET
    (duplicates dropped).  form "cardinality" returns only the count;
    "bitmap" also materializes the result bitmap on the host."""

    op: str
    operands: tuple[int, ...]
    form: str = "cardinality"

    def __post_init__(self):
        if self.op not in ("or", "and", "xor", "andnot"):
            raise ValueError(f"unsupported batch op {self.op!r}")
        if self.form not in ("cardinality", "bitmap"):
            raise ValueError(f"unsupported result form {self.form!r}")


@dataclasses.dataclass
class BatchResult:
    cardinality: int
    bitmap: RoaringBitmap | None = None
    #: the total of a sum_ root (cardinality is then the found count);
    #: None otherwise
    value: int | None = None


@dataclasses.dataclass
class _Bucket:
    """One shape-specialized slice of a batch plan."""

    op: str
    qids: list            # pseudo-query ids, bucket order
    keys: list            # per-query np key arrays (true K_q, unpadded)
    q: int                # padded query count (pow2)
    r_pad: int            # padded rows per query (pow2)
    k_pad: int            # padded key slots per query (pow2)
    n_steps: int
    needs_words: bool
    host: dict            # NumPy operands
    _arrays: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def signature(self):
        return (self.op, self.q, self.r_pad, self.k_pad, self.n_steps,
                self.needs_words)

    def device_arrays(self, device) -> dict:
        key = str(device)
        if key not in self._arrays:
            self._arrays[key] = expr_mod._upload(self.host, device)
        return self._arrays[key]


def plan_bucket(op: str, items, pad_to=None) -> _Bucket:
    """Build one bucket from ``items``: [(qid, query, gather_rows,
    seg_local, keys_q, key_keep, head_rows)] sharing (op, operand rung).

    ``pad_to`` is the lattice snap (``runtime.lattice``): a ``(q, rows,
    keys, heads)`` covering point every bucket of the plan pads up to, with
    the same dead queries, rows and slots the pow2 padding makes, so the
    bucket's shape comes from the closed vocabulary.  ``n_steps`` then
    follows the padded row rung (extra doubling passes are exact)."""
    qn = packing.next_pow2(len(items))
    r_pad = packing.next_pow2(max(1, max(it[2].size for it in items)))
    k_pad = packing.next_pow2(max(1, max(it[4].size for it in items)))
    force_heads = False
    if pad_to is not None:
        q_l, r_l, k_l, force_heads = pad_to
        qn, r_pad, k_pad = max(qn, q_l), max(r_pad, r_l), max(k_pad, k_l)
    gather = np.zeros((qn, r_pad), np.int32)
    valid = np.zeros((qn, r_pad), bool)
    seg_local = np.full((qn, r_pad), k_pad, np.int32)
    heads_ok = np.zeros((qn, k_pad), bool)
    key_keep = np.ones((qn, k_pad), bool) if op == "and" else None
    head_gather = (np.zeros((qn, k_pad), np.int32)
                   if op == "andnot" else None)
    head_ok = np.zeros((qn, k_pad), bool) if op == "andnot" else None
    max_group = 1
    for i, (_qid, _q, rows, segs, _keys_q, keep, hrows) in enumerate(items):
        gather[i, :rows.size] = rows
        valid[i, :rows.size] = True
        seg_local[i, :rows.size] = segs
        heads_ok[i, np.unique(segs)] = True
        if segs.size:
            max_group = max(max_group, int(np.bincount(segs).max()))
        if op == "and":
            key_keep[i, :keep.size] = keep
            key_keep[i, keep.size:] = False
        if op == "andnot":
            head_gather[i, :hrows.size] = hrows
            head_ok[i, :hrows.size] = True
    flat_seg = (seg_local
                + (k_pad + 1) * np.arange(qn, dtype=np.int32)[:, None]
                ).reshape(-1)
    flat_head = np.searchsorted(
        flat_seg, np.arange(qn * (k_pad + 1), dtype=np.int64)
    ).astype(np.int32)
    host = {"gather": gather, "valid": valid, "seg_local": seg_local,
            "flat_seg": flat_seg, "flat_head": flat_head,
            "heads_ok": heads_ok}
    if key_keep is not None:
        host["key_keep"] = key_keep
    if head_gather is not None:
        host["head_gather"] = head_gather
        host["head_ok"] = head_ok
    return _Bucket(
        op=op, qids=[it[0] for it in items], keys=[it[4] for it in items],
        q=qn, r_pad=r_pad, k_pad=k_pad,
        n_steps=dense.n_steps_for(r_pad if pad_to is not None
                                  else max_group),
        needs_words=(force_heads
                     or any(it[1].form == "bitmap" for it in items)),
        host=host)


def snap_plan_groups(lat, groups, sections, has_bitmap: bool, counter,
                     empty_keys, placement: str = "auto", pool: int = 0):
    """Lattice snap of a grouped plan (shared by the engines): the covering
    ``ProgramSignature`` of the concrete needs, and one DEAD bucket per op
    of the covering op set that traffic did not request (an owner-less
    all-padding pseudo query, which readback skips), so that the plan's
    buckets follow from the point alone.  Returns ``(pad_to, point)``, or
    ``(None, None)`` when no lattice is active or a dimension is beyond the
    vocabulary.  ``pool`` is the pooled engine's per-set row-selection need
    (< 0: not coverable).  Every dimension is judged before any dead
    bucket is planted, so a refused snap leaves the plan as it was."""
    if lat is None or not groups or pool < 0:
        return None, None
    q_need = max(len(items) for items in groups.values())
    rows_need = max((it[2].size for items in groups.values()
                     for it in items), default=1)
    keys_need = max((it[4].size for items in groups.values()
                     for it in items), default=1)
    expr_depth = max((sec.depth for sec in sections
                      if sec.kind == "fused"), default=0)
    point = lat.snap(ops=[op for op, _ in groups], q=q_need,
                     rows=rows_need, keys=keys_need, heads=has_bitmap,
                     expr=expr_depth, placement=placement, pool=pool,
                     bsi=expr_mod.value_depth_of(sections))
    if point is None:
        return None, None
    for op in point.ops:
        if (op, 0) in groups:
            continue
        pid = counter[0]
        counter[0] += 1
        groups[(op, 0)] = [(
            pid, BatchQuery(op, ()), np.empty(0, np.int64),
            np.empty(0, np.int32), empty_keys,
            np.empty(0, bool) if op == "and" else None,
            np.empty(0, np.int64) if op == "andnot" else None)]
    return (point.q, point.rows, point.keys, point.heads), point


def plan_padding(buckets, groups) -> tuple:
    """(padding_bytes, padded_fraction) of a snapped plan: the gather rows
    the padded bucket shapes stream beyond the rows traffic referenced,
    the measured price of the bounded vocabulary."""
    real = sum(it[2].size for items in groups.values() for it in items)
    padded = sum(b.q * b.r_pad for b in buckets)
    pad_rows = max(0, padded - real)
    return pad_rows * insights.ROW_BYTES, pad_rows / max(1, padded)


class BatchPlan(list):
    """A bucketed batch plan (a list of buckets) with the expression
    sections, the owner map (pseudo-query id -> query index, absent for
    internal reduce nodes and dead lattice buckets), the assembled
    megakernel program (None when the plan has no fused section), the
    covering lattice point (None: exact shapes) with its padding
    ``(bytes, fraction)``, and the operand packs by rung."""

    def __init__(self, buckets=(), exprs=(), owner=None, mega=None,
                 point=None, padding=(0, 0.0)):
        super().__init__(buckets)
        self.exprs = list(exprs)
        self.owner = owner if owner is not None else {}
        self.mega = mega
        self.point = point
        self.padding = padding
        #: by rung: operand packs, static program-key parts, predicted
        #: bytes, word operations
        self.packs: dict = {}
        self.keys: dict = {}
        self.predicted: dict = {}
        self.word_ops: dict = {}

    @property
    def fused(self) -> list:
        return expr_mod.fused_of(self.exprs)

    @property
    def expr_signature(self) -> tuple:
        return expr_mod.signature_of(self.exprs)


def bucket_body(words: torch.Tensor, b_sig, arrays: dict, eng: str):
    """One bucket on the device: gather -> flat segmented reduce (B1 on the
    "cuda" rung, the doubling pass on "torch", one doubling reduce per query
    over its own rows on "torch-vmap") -> per-op post pass.
    Returns (heads int32[q, k_pad, 2048], cards int32[q, k_pad]).  The masks
    apply in place on tensors the body made; B1's cards serve or/xor/and,
    and andnot and the plain rung count their heads again."""
    op, qn, r_pad, k_pad, n_steps, _needs_words = b_sig
    red = _RED_OP[op]
    g = words[arrays["gather"].reshape(-1)]
    g.masked_fill_(~arrays["valid"].reshape(-1, 1), -1 if op == "and" else 0)
    nseg = qn * (k_pad + 1)
    cards = None
    if eng == "cuda":
        heads, cards = kernels.segmented_reduce(red, g, arrays["flat_seg"],
                                                nseg)
        cards = cards.view(qn, k_pad + 1)[:, :k_pad]
    elif eng == guard.PLAIN_VMAP:
        # query by query on the unflattened [q, r_pad] layout: each query's
        # own segment ids and heads, as the flat reduce must equal
        g3 = g.view(qn, r_pad, WORDS32)
        seg = arrays["seg_local"]
        slots = torch.arange(k_pad + 1, dtype=torch.int32, device=g.device)
        heads = torch.stack([
            dense.segmented_reduce(
                red, g3[i], seg[i],
                torch.searchsorted(seg[i], slots, out_int32=True).clamp(
                    max=r_pad - 1), n_steps)[0]
            for i in range(qn)])
    else:
        red_rows = dense.doubling_pass(dense.OPS[red], g,
                                       arrays["flat_seg"], n_steps)
        heads = red_rows[arrays["flat_head"].clamp(max=g.shape[0] - 1)]
        del red_rows
    del g
    heads = heads.view(qn, k_pad + 1, WORDS32)[:, :k_pad]
    # zero key slots with no contributing rows (an empty rest-union reads
    # as 0) and, for and, slots some operand lacks (workShyAnd)
    keep = arrays["heads_ok"]
    if op == "and":
        keep = keep & arrays["key_keep"]
    heads.masked_fill_(~keep[:, :, None], 0)
    if op == "andnot":
        hg = words[arrays["head_gather"].reshape(-1)].view(qn, k_pad, WORDS32)
        hg.masked_fill_(~arrays["head_ok"][:, :, None], 0)
        heads.bitwise_not_().bitwise_and_(hg)      # head & ~rest
        del hg
        cards = None
    if cards is None:
        return heads, dense.popcount(heads)
    return heads, cards.masked_fill(~keep, 0)


class BatchEngine:
    """Plan + execute mixed-op query batches over one resident set, on the
    set's device.  Plans are cached by the query tuple, the set's version
    and structure version and the attached columns (an LRU of
    ``PLAN_CACHE_MAX``).  ``last_timings`` holds the plan / device / unpack
    milliseconds of the latest ``execute``.

    ``result_cache``: ``"env"`` (the default) resolves
    ``ROARING_TPU_RESULT_CACHE`` (None when unset), a ``ResultCache`` may be
    shared by many engines, None disables it.  With a cache, ``execute``
    serves repeated queries from it and ``plan`` injects cached interior
    nodes into expression plans (``mutation.result_cache``)."""

    def __init__(self, ds: DeviceBitmapSet, result_cache="env"):
        if ds.row_src is None:
            raise ValueError(
                "resident set lacks row_src metadata (repack required)")
        self._ds = ds
        self.device = ds.device
        self.n = ds.n
        self.keys = ds.keys
        self._row_src = ds.row_src
        self._row_seg = ds.row_seg
        self._ds_structure = ds.structure_version
        self.result_cache = (mut_cache.from_env()
                             if result_cache == "env" else result_cache)
        #: (query, set version, columns) -> result-cache key
        self._qkeys = LRUCache(1024, name="batch_cache_keys")
        self._plans = LRUCache(PLAN_CACHE_MAX, name="batch_plans")
        #: the programs (captured graphs on the card) by program key
        self._programs = rt_programs.ProgramCache(self.device, SITE)
        self.last_timings: dict = {}
        #: the ``batch.memory`` / ``batch.cost`` payloads of the latest
        #: dispatch
        self.last_dispatch_memory: dict | None = None
        self.last_dispatch_cost: dict | None = None
        self._first_query_done = False
        #: batches halved on ResourceExhausted (reactive splits)
        self.split_count = 0
        #: batches halved before dispatch, predicted past the budget
        self.proactive_split_count = 0
        #: the class of an empty result: the set's tier
        self._empty_cls = (RoaringBitmap if ds.keys.dtype == np.uint16
                           else Roaring64Bitmap)

    @classmethod
    def from_bitmaps(cls, bitmaps: list, layout: str = "auto",
                     **kw) -> "BatchEngine":
        return cls(DeviceBitmapSet(bitmaps, layout=layout, **kw))

    # ------------------------------------------------------------- mutation

    def _sync_with_ds(self) -> None:
        """Pick up the set's mutations: after a repack (a new structure
        version) the row maps are read again and every program is retired
        (its graph read the old image).  Patches change nothing here: the
        plan key's version retires the plans they outdate, and a graph
        reads the patched image in place."""
        ds = self._ds
        if ds.structure_version != self._ds_structure:
            self._ds_structure = ds.structure_version
            self.keys = ds.keys
            self._row_src = ds.row_src
            self._row_seg = ds.row_seg
            # the graphs read the old image or streams by address
            self._programs.retire()

    def _leaf_token(self, i: int):
        """Result-cache token of source ``i``: (set uid, source, source
        version); None out of range (the planner raises its own error)."""
        ds = self._ds
        if i < 0 or i >= ds.n:
            return None
        return (ds.uid, int(i), int(ds.source_versions[i]))

    def _col_token(self, name: str):
        """Result-cache token of an attached column: (uid, version); None
        when unattached."""
        col = self._ds.columns.get(name)
        return None if col is None else (col.uid, col.version)

    def _cache_key_of(self, q):
        """Result-cache key of one query, memoized per (query, set version,
        columns): a replayed query's key is a dictionary hit, not a
        canonicalization walk."""
        memo_key = (q, self._ds.version, self._columns_token())
        got = self._qkeys.get(memo_key)
        if got is None:
            got = mut_cache.query_key(q, self._leaf_token, self._col_token)
            self._qkeys.put(memo_key, got)
        return got

    # ------------------------------------------------------------- planning

    def _plan_query(self, q: BatchQuery):
        """(gather_rows, seg_local, keys_q, key_keep, head_rows), all
        NumPy, unpadded.  seg_local ascends (rows are key-sorted)."""
        ops_ = np.unique(np.asarray(q.operands, dtype=np.int64))
        if ops_.size and (ops_[0] < 0 or ops_[-1] >= self.n):
            raise IndexError(
                f"operand index out of range 0..{self.n - 1}: {q.operands}")
        if q.op == "andnot":
            if not len(q.operands):
                return (np.empty(0, np.int64), np.empty(0, np.int32),
                        self.keys[:0], None, np.empty(0, np.int64))
            head = int(q.operands[0])
            rest = np.unique(np.asarray(q.operands[1:], dtype=np.int64))
            hrows = np.flatnonzero(self._row_src == head)
            hsegs = self._row_seg[hrows]        # unique & ascending
            rrows = np.flatnonzero(np.isin(self._row_src, rest)
                                   & np.isin(self._row_seg, hsegs))
            seg_local = np.searchsorted(
                hsegs, self._row_seg[rrows]).astype(np.int32)
            return (rrows, seg_local, self.keys[hsegs], None, hrows)
        rows = np.flatnonzero(np.isin(self._row_src, ops_))
        segs = self._row_seg[rows]
        uniq, seg_local = np.unique(segs, return_inverse=True)
        key_keep = None
        if q.op == "and":
            key_keep = np.bincount(
                seg_local, minlength=uniq.size) == ops_.size
        return (rows, seg_local.astype(np.int32), self.keys[uniq],
                key_keep, None)

    def _plan_leaf(self, index: int):
        """(gather_rows, keys) of ONE resident bitmap: the expression
        compiler's leaf planner."""
        if index < 0 or index >= self.n:
            raise IndexError(
                f"expression ref out of range 0..{self.n - 1}: {index}")
        rows = np.flatnonzero(self._row_src == index)
        return rows, self.keys[self._row_seg[rows]]

    def _column(self, name: str):
        """An attached column by name: the expression compiler's column
        resolver."""
        col = self._ds.columns.get(name)
        if col is None:
            raise KeyError(
                f"no column {name!r} attached to this resident set "
                f"(DeviceBitmapSet.attach_column)")
        return col

    def _columns_token(self) -> tuple:
        """The attached columns in a plan key: a re-attached name is a new
        column (a new uid) and must never serve a plan of the old one."""
        return tuple((n, c.uid, c.version, c.structure_version)
                     for n, c in sorted(self._ds.columns.items()))

    def plan(self, queries) -> BatchPlan:
        """Bucketed plan, cached by the query tuple, the set's version and
        structure version (a patched or repacked set never replays a stale
        plan, nor an injected subtree whose leaves moved on) and the
        attached columns: group by (op, pow2 operand count) and pad shapes.
        Expression queries expand here: their all-leaf reduce nodes become
        pseudo flat queries in the same buckets, their combine and value
        steps compile into sections, and a plan with fused sections also
        assembles its megakernel stream.

        Under an active lattice (``runtime.lattice``) same-op queries share
        one bucket whatever their operand rung, and the plan snaps to its
        covering point: every bucket pads to the point's shape and absent
        ops of its op set get dead buckets (``plan.point``,
        ``plan.padding``)."""
        self._sync_with_ds()
        lat = rt_lattice.active()
        key = self.plan_key(queries)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        cache_probe = (None if self.result_cache is None else
                       mut_cache.subtree_probe(self.result_cache,
                                               self._leaf_token,
                                               self._col_token))
        with obs_slo.phase("plan"), \
                obs_trace.span("batch.plan", q=len(queries)) as sp:
            plan = self._plan_fresh(queries, lat, cache_probe, sp)
        self._plans.put(key, plan)
        return plan

    def _plan_fresh(self, queries, lat, cache_probe, sp) -> BatchPlan:
        """The body of ``plan`` on a cache miss, inside its span."""
        groups: dict = {}
        owner: dict = {}
        sections: list = []
        counter = [0]

        def add_item(pq: BatchQuery, own):
            pid = counter[0]
            counter[0] += 1
            rows, segs, keys_q, keep, hrows = self._plan_query(pq)
            # under a lattice same-op queries share ONE bucket: the rung
            # split limits padding, which the lattice trades for a closed
            # signature space
            rung = (0 if lat is not None
                    else packing.next_pow2(max(1, len(set(pq.operands)))))
            groups.setdefault((pq.op, rung), []).append(
                (pid, pq, rows, segs, keys_q, keep, hrows))
            if own is not None:
                owner[pid] = own
            return pid, keys_q

        for qid, q in enumerate(queries):
            if isinstance(q, expr_mod.ExprQuery):
                sections.append(expr_mod.compile_query(
                    q, qid, add_item, self._plan_leaf,
                    cache_probe=cache_probe, col_resolve=self._column))
            else:
                add_item(q, qid)
        pad_to, point = snap_plan_groups(
            lat, groups, sections,
            any(getattr(q, "form", None) == "bitmap" for q in queries),
            counter, self.keys[:0], placement="single")
        sp.tag(need_q=max((len(i) for i in groups.values()), default=0),
               need_rows=max((it[2].size for i in groups.values()
                              for it in i), default=0),
               need_keys=max((it[4].size for i in groups.values()
                              for it in i), default=0))
        with obs_trace.span("batch.bucket", groups=len(groups)):
            buckets = [plan_bucket(op, items, pad_to=pad_to)
                       for (op, _), items in sorted(groups.items())]
        padding = (plan_padding(buckets, groups) if point is not None
                   else (0, 0.0))
        expr_mod.finalize_sections(sections, buckets)
        mega = (megakernel.build_full(buckets, sections)
                if expr_mod.fused_of(sections) else None)
        plan = BatchPlan(buckets, exprs=sections, owner=owner, mega=mega,
                         point=point, padding=padding)
        sp.tag(buckets=len(plan), exprs=len(sections),
               mega=mega is not None, snapped=point is not None)
        return plan

    def plan_key(self, queries) -> tuple:
        """The plan cache's key of ``queries`` at the set's current state
        and lattice (``rt_lattice.plan_token``: a snapped and an exact plan
        of the same queries never alias)."""
        ds = self._ds
        return (tuple(queries), ds.version, ds.structure_version,
                self._columns_token(), rt_lattice.plan_token())

    # ------------------------------------------------------------ execution

    def _bucket_engine(self, plan: BatchPlan, eng: str,
                       note: bool = True) -> str:
        """The rung the plan runs on: a megakernel request resolves to the
        multi-op "cuda" rung when the plan has no fused section or does not
        fit B5, and the demotion is counted by reason (``note=False`` for a
        prediction, which dispatches nothing)."""
        if eng == "megakernel" and not (plan.mega is not None
                                        and plan.mega.fits()):
            if note:
                megakernel.note_capacity_demotion("batch_engine", plan.mega)
            return "cuda"
        return eng

    def _words(self, eng: str) -> torch.Tensor:
        """The resident row image: the dense image itself, or rebuilt from
        the compact streams (B3 on the kernel rungs)."""
        return self._ds._resident_words(
            "torch" if eng in guard.PLAIN_RUNGS else "cuda")

    def _operands(self, plan: BatchPlan, eng: str, packed: bool) -> dict:
        """The device part's operand tree: the plan's cached device arrays
        (``packed=False``, the eager path), or its host arrays for an
        operand pack (``runtime.programs``)."""
        dev = self.device
        if eng == "megakernel":
            return {"m": (plan.mega.operands(dev) if packed
                          else plan.mega.device_arrays(dev))}
        fused = plan.fused
        return {
            "b": [b.host if packed else b.device_arrays(dev) for b in plan],
            "s": [sec.host if packed else sec.device_arrays(dev)
                  for sec in fused],
            "c": [[c.device_operands() for c in sec.cols] for sec in fused]}

    def _run(self, plan: BatchPlan, eng: str, ops: dict,
             static: bool = False):
        """The device part of a batch over the operand tree ``ops`` ->
        (bucket outs, expr outs).  ``static``: the operands are a program's
        (value scans then read their predicates from them)."""
        words = self._words(eng)
        if eng == "megakernel":
            # B5's two output blocks; ``_program`` slices them per bucket
            # and section once they are copied out
            m = ops["m"]
            return megakernel.raw_call(plan.mega, words, m["extra"],
                                       m["cols"], stream=m["stream"],
                                       steps_dev=m.get("steps"))
        feeding = expr_mod.expr_bucket_ids(plan.exprs)
        outs, heads_by_bi = [], []
        for bi, b in enumerate(plan):
            heads, cards = bucket_body(words, b.signature, ops["b"][bi], eng)
            # keep only the heads a combine step reads or a query returns
            heads_by_bi.append(heads if bi in feeding else None)
            outs.append((heads if b.needs_words else None, cards))
        expr_outs = expr_mod.eval_sections(
            plan.fused, words, heads_by_bi,
            ops["s"] if static else None, ops["c"] if static else None)
        return outs, expr_outs

    def _program_key(self, plan: BatchPlan, eng: str, layout) -> tuple:
        """The program of a plan on a rung: the JAX package's key (rung,
        resident kind, set uid and structure version, bucket and expression
        signatures, the stream's shape on "megakernel"; built once per plan
        and rung), then the program cache's generation and the operand
        pack's layout."""
        key = plan.keys.get(eng)
        if key is None:
            ds = self._ds
            key = (eng, self._resident_kind(), ds.uid, ds.structure_version,
                   tuple(b.signature for b in plan), plan.expr_signature)
            if eng == "megakernel":
                key += (plan.mega.signature,)
            plan.keys[eng] = key
        return key + (self._programs.generation, layout)

    def _pack(self, plan: BatchPlan, eng: str) -> rt_programs.OperandPack:
        pack = plan.packs.get(eng)
        if pack is None:
            pack = plan.packs[eng] = rt_programs.pack_operands(
                self._operands(plan, eng, packed=True), self.device)
        return pack

    def _program(self, plan: BatchPlan, eng: str, run: bool = True):
        """The device part of a plan through its program.  A snapped plan
        runs as the replay of its signature's program (captured on first
        use); an unsnapped one runs eagerly, its first run reported as a
        new program.  ``run=False`` only prepares the program (warmup).
        Returns the device part's outputs (copied out of a graph, so they
        are read after a synchronize; ``_slice`` makes B5's per bucket and
        section), or None."""
        if plan.point is None:
            key = self._program_key(plan, eng, None)
            if not run:
                self._programs.note_eager(
                    key, eng, None, 0.0, tags=lambda: self._build_tags(
                        plan, eng))
                return None
            t0 = time.perf_counter()
            outs = self._run(plan, eng, self._operands(plan, eng, False))
            if key not in self._programs:   # no prepare noted it
                self._programs.note_eager(key, eng, None,
                                          time.perf_counter() - t0)
            return outs
        pack = self._pack(plan, eng)
        if eng == "megakernel":
            # the replayed stream is this plan's: check it against the banks
            m = plan.mega
            m.check((self._ds._n_rows, m.extra_rows, max(1, m.col_rows)))
        key = self._program_key(plan, eng, pack.layout)

        def device_part(ops, plan=plan):
            return self._run(plan, eng, ops, static=True)

        if not run:
            self._programs.prepare(key, eng, plan.point, device_part, pack,
                                   tags=lambda: self._build_tags(plan, eng))
            return None
        return self._programs.dispatch(key, eng, plan.point, device_part,
                                       pack)

    def _build_tags(self, plan: BatchPlan, eng: str) -> dict:
        """The ``batch.program_build`` span's tags (the JAX package's keys:
        there is no compiler analysis, so no measured peak, and the cost
        is the plan's own count)."""
        predicted = self._predict_plan(plan, eng)
        return {"kind": self._resident_kind(), "buckets": len(plan),
                "exprs": len(plan.fused), "predicted_bytes": predicted,
                "measured_peak_bytes": None,
                "flops": float(self._word_ops(plan, eng)),
                "bytes_accessed": float(predicted)}

    @staticmethod
    def _slice(plan: BatchPlan, eng: str, outs):
        """(bucket outs, expr outs): B5's output blocks sliced per bucket
        and section (other rungs' outputs are already so)."""
        if eng == "megakernel":
            return megakernel._slice_outputs(plan.mega, *outs)
        return outs

    def execute(self, queries, engine: str = "auto", fallback: bool = True,
                policy: guard.GuardPolicy | None = None
                ) -> list[BatchResult]:
        """Run Q queries (flat and expression) as one batch; results in
        input order, bit-exact with the host reference on every rung.

        The batch runs under ``runtime.guard`` down ``ENGINES`` from the
        rung ``resolve_query_engine`` picks: transient faults retry,
        lowering faults demote, and ``ResourceExhausted`` first halves the
        batch (each half restarts at the failing rung) and demotes once one
        query is left.  On the CPU the sequential host rung comes last.  On
        the card the chain stops at the kernel rungs ("megakernel" ->
        "cuda"), so a fault that "cuda" cannot retry or split away
        re-raises typed instead of reaching the plain version or the host.  Every retry,
        split, demotion and landing is counted (``guard.dispatch_stats``,
        ``split_count``).  With a shadow rate (``policy.shadow_rate`` or
        ``ROARING_TPU_SHADOW``) a sample of the queries is re-run on the
        host rung and a divergence raises ``ShadowMismatch``.  A failed
        kernel build or launch is not demoted: it re-raises as it is.
        ``fallback=False`` runs the requested rung raw (no guard, no fault
        injection).  With a result cache, the guarded path serves each
        query the cache holds and dispatches only the misses, which fill it
        (``mutation.result_cache.serve_and_fill``)."""
        queries = list(queries)
        if not queries:
            return []
        if engine not in ("auto",) + ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{('auto',) + ENGINES}")
        t_exec0 = time.perf_counter()
        with obs_trace.span("batch.execute", site=SITE, q=len(queries),
                            engine=engine, fallback=fallback):
            if not fallback:
                return self._execute_once(
                    queries,
                    resolve_query_engine(engine, queries, self.device),
                    inject=False)
            policy = policy or guard.GuardPolicy.from_env()
            # SLO accounting + per-phase attribution for the whole execute
            # (splits and demotions included; the guard's own context is
            # suppressed under this one)
            with obs_slo.query(SITE, deadline_ms=policy.slo_deadline_ms):
                # one budget resolution per execute, not per split: the
                # card's free memory costs an allocator query
                deadline = guard.Deadline(policy.deadline)
                budget = guard.resolve_hbm_budget(policy, self.device)

                def run_misses(qs):
                    chain = guard.chain_from(
                        resolve_query_engine(engine, qs, self.device),
                        ENGINES, self.device)
                    return self._dispatch(qs, chain, policy, deadline,
                                          budget)

                if self.result_cache is None:
                    results = run_misses(queries)
                else:
                    self._sync_with_ds()
                    results = mut_cache.serve_and_fill(
                        self.result_cache, queries, self._cache_key_of,
                        run_misses, SITE, device=self.device)[0]
            if not self._first_query_done:
                # the cold path: this engine's first execute pays the plan
                # and its program's first run or capture
                self._first_query_done = True
                obs_metrics.histogram("rb_first_query_seconds",
                                      site=SITE).observe(
                                          time.perf_counter() - t_exec0)
            return results

    def _dispatch(self, queries, chain, policy, deadline,
                  budget: int | None = None):
        """One guarded run of ``queries`` down ``chain``; recurses on OOM
        splits, each half restarting at the failing rung and sharing the
        deadline.  Before the device is touched, a batch whose predicted
        footprint (``predict_dispatch_bytes``) passes ``budget`` is halved
        (the proactive split, counted in ``proactive_split_count``)."""
        predicted = (self.predict_dispatch_bytes(queries, chain[0])
                     if budget is not None and len(queries) >= 2 else 0)
        if budget is not None and len(queries) >= 2 and predicted > budget:
            mid = (len(queries) + 1) // 2
            self.proactive_split_count += 1
            obs_metrics.counter("rb_batch_proactive_splits_total",
                                site=SITE).inc()
            obs_trace.current().event(
                "proactive_split", site=SITE, q=len(queries),
                predicted_bytes=predicted, budget_bytes=budget,
                halves=(mid, len(queries) - mid))
            return (self._dispatch(queries[:mid], chain, policy, deadline,
                                   budget)
                    + self._dispatch(queries[mid:], chain, policy, deadline,
                                     budget))
        split = False

        def attempt(eng):
            return self._execute_once(queries, eng)

        def on_oom(eng, fault, dl):
            nonlocal split
            if len(queries) < 2:
                return guard.NO_SPLIT     # nothing to halve: demote instead
            sub = chain[chain.index(eng):] if eng in chain else chain
            mid = (len(queries) + 1) // 2
            self.split_count += 1
            obs_metrics.counter("rb_batch_oom_splits_total",
                                site=SITE).inc()
            obs_trace.current().event(
                "oom_split", site=SITE, engine_from=eng, engine_to=eng,
                q=len(queries), halves=(mid, len(queries) - mid))
            split = True
            return (self._dispatch(queries[:mid], sub, policy, dl, budget)
                    + self._dispatch(queries[mid:], sub, policy, dl, budget))

        t0 = time.perf_counter()
        results, rung = guard.run_with_fallback(
            "batch_engine", chain, attempt, policy=policy,
            sequential=lambda: self._execute_sequential(queries),
            on_resource_exhausted=on_oom, deadline=deadline)
        if rung == guard.SEQUENTIAL:
            self.last_timings = {"engine": guard.SEQUENTIAL, "plan_ms": 0.0,
                                 "device_ms": 0.0,
                                 "unpack_ms": (time.perf_counter() - t0) * 1e3}
        # split halves were shadow-checked inside their own dispatches
        elif not split and policy.shadow_rate > 0.0:
            self._shadow_check(queries, results, policy)
        return results

    def _execute_once(self, queries, engine: str,
                      inject: bool = True) -> list[BatchResult]:
        """One batch on one rung: plan, the device part, host assembly.
        The fault hooks sit at the engine boundary, where a real failure
        would surface; ``inject=False`` skips them."""
        t0 = time.perf_counter()
        plan = self.plan(queries)
        eng = self._bucket_engine(plan, engine)
        obs_slo.note_engine(eng)
        if inject:
            faults.maybe_fail(SITE, eng)
        t1 = time.perf_counter()
        results: list = [None] * len(queries)
        bucket_outs, expr_outs = [], []
        if plan or plan.fused:
            # the program is built (a capture, or a new key's note) before
            # the launch, outside its span, as the JAX package compiles
            with obs_slo.phase("program_build"):
                self._program(plan, eng, run=False)
            with obs_trace.span("batch.dispatch", engine=eng,
                                q=len(queries), buckets=len(plan)) as sp:
                # device time and the allocator's peak are read only while
                # tracing is on (the peak statistics are device-global)
                start = obs_cost.launch_timer(self.device)
                window = obs_memory.PeakWindow(
                    self.device if start is not None else "cpu")
                with window, obs_slo.phase("dispatch"):
                    outs = self._program(plan, eng)
                    end = obs_cost.end_event(self.device, start is not None)
                if plan.exprs:
                    expr_mod.record_fused_dispatch(SITE, plan.exprs)
                    expr_mod.record_analytics_dispatch(SITE, plan.exprs, sp)
                if eng == "megakernel":
                    sp.event("expr.megakernel", **plan.mega.stats_event())
                with obs_slo.phase("sync"):
                    sp.sync(end)           # sync_ms, while tracing
                    if end is not None:
                        torch.cuda.synchronize(self.device)
                t2 = time.perf_counter()
                self._record_dispatch(plan, eng, len(queries), sp,
                                      window.peak(), obs_cost.launch_seconds(
                                          start, end, t2 - t1))
        t2 = time.perf_counter()
        with obs_slo.phase("readback"), \
                obs_trace.span("batch.readback", engine=eng, q=len(queries)):
            if plan or plan.fused:
                bucket_outs, expr_outs = self._slice(plan, eng, outs)
            for b, (heads, cards) in zip(plan, bucket_outs):
                cards = cards.cpu().numpy()
                heads = None if heads is None else to_u32(heads)
                for slot, (pid, keys_q) in enumerate(zip(b.qids, b.keys)):
                    qid = plan.owner.get(pid)
                    if qid is None:
                        continue        # internal expression reduce node
                    kq = keys_q.size
                    bm = None
                    if queries[qid].form == "bitmap":
                        bm = packing.unpack_result(keys_q, heads[slot, :kq],
                                                   cards[slot, :kq])
                    results[qid] = BatchResult(
                        cardinality=int(cards[slot, :kq].sum()), bitmap=bm)
            expr_mod.assemble_section_results(
                plan.exprs, expr_outs, results,
                lambda qid: queries[qid].form, self._empty_cls)
        t3 = time.perf_counter()
        self.last_timings = {"engine": eng, "plan_ms": (t1 - t0) * 1e3,
                             "device_ms": (t2 - t1) * 1e3,
                             "unpack_ms": (t3 - t2) * 1e3}
        if inject and faults.should_corrupt(SITE, eng):
            # deterministic silent corruption (fault kind "silent"): what
            # only the shadow check can catch
            results[0] = dataclasses.replace(
                results[0], cardinality=results[0].cardinality + 1)
        return results

    def _record_dispatch(self, plan: BatchPlan, eng: str, q: int, sp,
                         measured: dict | None, launch_s: float) -> None:
        """The dispatch's accounting: ``last_dispatch_memory`` (the rung,
        the queries, the predicted bytes, the measured peak when taken and,
        for a snapped plan, the lattice padding, also counted by site in
        ``runtime.lattice``) as the span's ``batch.memory`` event, and the
        plan's word ops and bytes against the launch's time as its
        ``batch.cost`` event."""
        predicted = self._predict_plan(plan, eng)
        mem = obs_memory.record_dispatch(SITE, predicted, measured)
        mem["engine"], mem["q"] = eng, q
        if plan.point is not None:
            pb, pf = plan.padding
            mem["lattice_padding_bytes"] = int(pb)
            mem["lattice_padding_fraction"] = round(pf, 6)
            rt_lattice.record_padding(SITE, int(pb), pf)
        self.last_dispatch_memory = mem
        sp.event("batch.memory", **mem)
        cost_ev = obs_cost.record_dispatch(
            SITE, eng, obs_cost.plan_cost(self._word_ops(plan, eng),
                                          predicted), launch_s, q=q)
        self.last_dispatch_cost = cost_ev
        sp.event("batch.cost", **cost_ev)

    def _word_ops(self, plan: BatchPlan, eng: str) -> int:
        """Word operations of the plan's dispatch on a rung
        (``insights.predict_batch_dispatch_word_ops`` plus its fused
        sections'), once per plan."""
        ops = plan.word_ops.get(eng)
        if ops is None:
            ops = insights.predict_batch_dispatch_word_ops(
                [b.signature for b in plan], self._resident_kind(),
                self._ds._n_rows, eng)
            if plan.exprs:
                ops += insights.predict_expr_word_ops(plan.expr_signature,
                                                      eng)
            plan.word_ops[eng] = ops
        return ops

    def _shadow_check(self, queries, results, policy) -> None:
        """Re-run a sampled share of the batch on the host rung; raise
        ``ShadowMismatch`` on a divergence (the silent-corruption
        detector)."""
        idx = guard.shadow_sample(len(queries), policy.shadow_rate,
                                  policy.shadow_seed, "batch_engine")
        for i in idx:
            ref = self._sequential_result(queries[i])
            got = results[i]
            bad = (got.cardinality != ref.cardinality
                   or got.value != ref.value)
            if not bad and queries[i].form == "bitmap":
                bad = got.bitmap != ref.bitmap
            if bad:
                detail = (f"cardinality {got.cardinality} != "
                          f"{ref.cardinality}"
                          if got.cardinality != ref.cardinality else
                          f"value {got.value} != {ref.value}"
                          if got.value != ref.value else
                          f"equal cardinality {ref.cardinality} but "
                          f"differing members")
                raise errors.ShadowMismatch(
                    f"batch_engine query {i} ({query_desc(queries[i])}) "
                    f"diverged from the sequential reference: {detail}")

    # ---------------------------------------------------------- warmup

    def _rung_queries(self, rung: int, ops) -> list:
        """Representative queries of one pow2 operand rung: each op over the
        first ``rung`` residents."""
        k = max(1, min(int(rung), self.n))
        return [BatchQuery(op, tuple(range(k))) for op in ops]

    def _prepare_batch(self, batch, engine: str) -> list:
        """Plan ``batch`` and prepare its program on the rung ``engine``
        resolves to, and on "megakernel" too where its plan fits there (the
        JAX package warms the top rung as well).  Returns the rungs."""
        plan = self.plan(batch)
        eng = self._bucket_engine(
            plan, resolve_query_engine(engine, batch, self.device),
            note=False)
        engs = [eng]
        if eng != "megakernel" and self._bucket_engine(
                plan, "megakernel", note=False) == "megakernel":
            engs.append("megakernel")
        if plan or plan.fused:
            for e in engs:
                self._program(plan, e, run=False)
        return engs

    def _lattice_batches(self, lat, point) -> list:
        """The representative batches of one lattice point (the JAX
        package's): analytics shape-classes per attached column, expression
        depths by ``rung_expressions``, flat points one query per op."""
        if point.bsi:
            return analytics_rung_queries(self._ds.columns, point.bsi,
                                          self.n)
        if point.expr:
            return [expr_mod.rung_expressions(point.expr, self.n)]
        return [[BatchQuery(op, (0,)) for op in point.ops]]

    def _compile_lattice_points(self, lat, engine: str) -> int:
        """Prepare every program of the single-set vocabulary: flat points
        pin a representative batch to the TARGET shape (``Lattice.pin``),
        expression and analytics shape-classes their representative DAGs
        (signatures noted as warmed), delta rungs warm the patch path.
        Returns the prepared-point count."""
        points = lat.enumerate_points(pooled=False)
        # the warmed vocabulary must fit the cache, or steady state would
        # re-capture evicted programs as escapes
        self._programs.maxsize = max(self._programs.maxsize,
                                     2 * len(points) + 8)
        compiled = 0
        for point in points:
            if point.delta:
                self._ds.warmup_delta(point.delta)
                compiled += 1
                continue
            with lat.pin(point):
                for batch in self._lattice_batches(lat, point):
                    plan = self.plan(batch)
                    for sec in plan.exprs:
                        lat.note_expr(sec.signature)
                    self._prepare_batch(batch, engine)
            compiled += 1
        return compiled

    def _check_pool_budget(self, lat, engine: str, budget) -> int:
        """The predicted graph pool of the vocabulary: all graphs share one
        pool and replay one at a time, so the largest predicted dispatch of
        its representative plans (``insights``).  Past ``budget`` this
        raises ``GraphPoolBudgetError``; returns the prediction."""
        peak = 0
        for point in lat.enumerate_points(pooled=False):
            if point.delta:
                continue
            with lat.pin(point):
                for batch in self._lattice_batches(lat, point):
                    plan = self.plan(batch)
                    eng = self._bucket_engine(plan, resolve_query_engine(
                        engine, batch, self.device), note=False)
                    peak = max(peak, self._predict_plan(plan, eng))
        if budget is not None and peak > budget:
            raise errors.GraphPoolBudgetError(
                f"{SITE}: the lattice's predicted graph pool is {peak} "
                f"bytes, past the budget of {budget}; narrow the profile")
        return peak

    def _lattice_report(self, site: str, lat, compiled: int, t0: float,
                        predicted: int, budget, pooled: bool) -> dict:
        progs = self._programs
        return {"site": site,
                "compile_cache_dir": str(rt_warmup.build_dir()),
                "lattice": {"profile": lat.to_profile(),
                            "points": lat.n_points(pooled=pooled),
                            "compiled": compiled, "sealed": True},
                "programs": [],
                "graphs": progs.graphs,
                "pool_bytes": progs.pool_bytes(),
                "predicted_pool_bytes": int(predicted),
                "hbm_budget_bytes": budget,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def _warmup_lattice(self, profile, engine: str) -> dict:
        """``warmup(profile=...)``: activate the lattice, check its
        predicted graph pool against the device-memory budget, prepare the
        whole vocabulary (one graph per program on the card), then seal: a
        new program after this is an escape."""
        t0 = time.perf_counter()
        lat = rt_lattice.activate(profile)
        budget = guard.resolve_hbm_budget(None, self.device)
        try:
            predicted = self._check_pool_budget(lat, engine, budget)
        except errors.GraphPoolBudgetError:
            rt_lattice.deactivate()     # a refused vocabulary snaps nothing
            raise
        with obs_trace.span("lattice.warmup", site=SITE,
                            points=lat.n_points(),
                            profile=lat.to_profile()) as sp:
            compiled = self._compile_lattice_points(lat, engine)
            lat.seal()
            sp.tag(compiled=compiled, sealed=True)
        return self._lattice_report(SITE, lat, compiled, t0, predicted,
                                    budget, pooled=False)

    def warmup(self, rungs=(1, 2, 4, 8),
               ops=("or", "and", "xor", "andnot"),
               engine: str = "auto", queries=None, profile=None) -> dict:
        """Prepare the programs a known workload will use, so that a process
        boots hot.  ``rungs`` plans one batch per pow2 operand rung over
        every op (``"expr:N"`` an expression depth, ``"delta:N"`` a patch
        rung); ``queries=`` prepares that exact batch instead.  Nothing is
        dispatched for an unsnapped plan (it runs eagerly; its key is
        registered); a snapped plan's graph is captured.  Returns a report
        with the JAX package's keys; ``compile_cache_dir`` is the kernels'
        build directory (``runtime.warmup``).

        ``profile=`` is the closed-lattice boot (``runtime.lattice``):
        activate the lattice the profile describes, prepare its whole
        vocabulary, and seal it; the report adds the ``lattice`` dict,
        ``graphs``, ``pool_bytes`` and the predicted pool, which must stay
        within ``guard.resolve_hbm_budget`` (``ROARING_TPU_HBM_BUDGET``,
        else the card's free memory) or ``GraphPoolBudgetError`` is
        raised before anything is captured."""
        rt_warmup.enable_compile_cache()
        if profile is not None:
            return self._warmup_lattice(profile, engine)
        t0 = time.perf_counter()
        programs = []
        if queries is not None:
            batches = [list(queries)]
        else:
            batches = []
            for r in rungs:
                kind, n = expr_mod.parse_warmup_rung(r)
                if kind == "delta":
                    rep = self._ds.warmup_delta(n)
                    programs.append({"delta_rung": n, "engine": "mutation",
                                     "compiled": rep["compiled"]})
                    continue
                batches.append(
                    expr_mod.rung_expressions(n, self.n) if kind == "expr"
                    else self._rung_queries(n, ops))
        for batch in batches:
            if not batch:
                continue
            plan = self.plan(batch)
            for e in self._prepare_batch(batch, engine):
                programs.append({"q": len(batch), "buckets": len(plan),
                                 "engine": e})
        return {"site": SITE, "compile_cache_dir": str(rt_warmup.build_dir()),
                "programs": programs,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def cardinalities(self, queries, engine: str = "auto") -> np.ndarray:
        """i64[Q] result cardinalities of one batch."""
        return np.array([r.cardinality
                         for r in self.execute(queries, engine=engine)],
                        dtype=np.int64)

    # ------------------------------------------------ host reference rung

    def _sequential_one(self, q):
        """Host reference for ONE query, mirroring the batch semantics
        (operands as a set; andnot = head minus the union of the rest);
        expression queries evaluate their canonical DAG on the host, value
        predicates through the columns' host oracles."""
        srcs = self._ds.host_bitmaps()
        if isinstance(q, expr_mod.ExprQuery):
            return expr_mod.evaluate_host(q.expr, srcs,
                                          columns=self._ds.columns)
        if not q.operands:
            return self._empty_cls()
        if q.op == "andnot":
            acc = srcs[int(q.operands[0])].clone()
            for i in sorted({int(i) for i in q.operands[1:]}):
                acc = acc - srcs[i]
            return acc
        fn = {"or": operator.or_, "and": operator.and_,
              "xor": operator.xor}[q.op]
        sub = sorted({int(i) for i in q.operands})
        acc = srcs[sub[0]].clone()
        for i in sub[1:]:
            acc = fn(acc, srcs[i])
        return acc

    def _sequential_result(self, q) -> BatchResult:
        """One query through the host reference as a BatchResult; aggregate
        roots go through the columns' host oracles
        (``expr.evaluate_host_agg``)."""
        if isinstance(q, expr_mod.ExprQuery) and expr_mod.is_agg(q.expr):
            card, value, bm = expr_mod.evaluate_host_agg(
                q.expr, self._ds.host_bitmaps(), columns=self._ds.columns)
            return BatchResult(cardinality=card, value=value,
                               bitmap=bm if q.form == "bitmap" else None)
        rb = self._sequential_one(q)
        return BatchResult(cardinality=rb.cardinality,
                           bitmap=rb if q.form == "bitmap" else None)

    def _execute_sequential(self, queries) -> list[BatchResult]:
        """Per-query host container algebra: the bit-exact reference every
        rung is held against."""
        return [self._sequential_result(q) for q in queries]

    def cache_stats(self) -> dict:
        return {"plans": self._plans.stats(),
                "programs": self._programs.stats(),
                "splits": self.split_count}

    # ------------------------------------------------------- footprint

    def _resident_kind(self) -> str:
        """The footprint model's tag of the set: "dense" (the resident image)
        or "streams" (a compact or counts set, rebuilt per dispatch)."""
        return "dense" if self._ds.words is not None else "streams"

    def predict_dispatch_bytes(self, queries, engine: str = "auto") -> int:
        """Predicted device bytes of dispatching ``queries`` as one batch on
        the rung ``execute`` would start at (``insights.analysis``): what
        the proactive split compares with the budget."""
        queries = list(queries)
        plan = self.plan(queries)
        eng = self._bucket_engine(
            plan, resolve_query_engine(engine, queries, self.device),
            note=False)
        return self._predict_plan(plan, eng)

    def _predict_plan(self, plan: BatchPlan, eng: str) -> int:
        """The footprint model of a plan on a rung, once per plan."""
        total = plan.predicted.get(eng)
        if total is None:
            total = insights.predict_batch_dispatch_bytes(
                [b.signature for b in plan], self._resident_kind(),
                self._ds._n_rows, eng)["peak_bytes"]
            if plan.exprs:
                total += insights.predict_expr_dispatch_bytes(
                    plan.expr_signature, eng)["peak_bytes"]
            plan.predicted[eng] = total
        return total

    def _split_layout(self, queries, eng: str, budget: int | None) -> list:
        """Sub-batch sizes the proactive split would dispatch: the halving
        rule of ``_dispatch``, run on the plans alone."""
        queries = list(queries)
        if (budget is None or len(queries) < 2
                or self.predict_dispatch_bytes(queries, eng) <= budget):
            return [len(queries)]
        mid = (len(queries) + 1) // 2
        return (self._split_layout(queries[:mid], eng, budget)
                + self._split_layout(queries[mid:], eng, budget))

    def explain(self, queries, engine: str = "auto",
                policy: guard.GuardPolicy | None = None) -> dict:
        """A JSON-serializable report of what ``execute`` would do with a
        batch, without dispatching it (the JAX package's keys).

        Per query: its bucket, pow2 operand rung and form.  Per bucket: the
        padded (q, r_pad, k_pad) shape, its share of the predicted bytes
        and its roofline time estimate (``obs.cost.estimate_seconds`` at the
        card's peak row, or at the observed rates once dispatches have
        calibrated it).  Then the resolved engine and its chain, the plan
        and program caches as they stood before this call planned, the
        resident set's footprint, the predicted peak against the budget
        with the split schedule, the expression sections node by node, and
        the sequential floor (host pairwise ops; the mean observed landing
        when there has been one)."""
        queries = list(queries)
        policy = policy or guard.GuardPolicy.from_env()
        budget = guard.resolve_hbm_budget(policy, self.device)
        self._sync_with_ds()
        plan_hit = self.plan_key(queries) in self._plans
        plan = self.plan(queries)
        start = resolve_query_engine(engine, queries, self.device)
        eng = self._bucket_engine(plan, start, note=False)
        kind = self._resident_kind()
        layout = (None if plan.point is None or not (plan or plan.fused)
                  else self._pack(plan, eng).layout)
        prog_hit = self._program_key(plan, eng, layout) in self._programs
        predicted = insights.predict_batch_dispatch_bytes(
            [b.signature for b in plan], kind, self._ds._n_rows, eng)
        if plan.exprs:
            predicted = dict(predicted)
            predicted["expr_bytes"] = insights.predict_expr_dispatch_bytes(
                plan.expr_signature, eng)["peak_bytes"]
            predicted["peak_bytes"] += predicted["expr_bytes"]
        buckets, q_rows = [], [None] * len(queries)
        est_total_s = 0.0
        for bi, b in enumerate(plan):
            # a bucket's share leaves out the stream set's densify, which is
            # batch-wide and reported once (``densify_bytes``)
            share = insights.predict_batch_dispatch_bytes(
                [b.signature], "dense", 0, eng)
            word_ops = insights.predict_batch_dispatch_word_ops(
                [b.signature], "dense", 0, eng)
            est_s = obs_cost.estimate_seconds(word_ops, share["peak_bytes"],
                                              SITE, eng)
            est_total_s += est_s
            buckets.append({
                "op": b.op, "queries": [int(q) for q in b.qids],
                "q_padded": b.q, "r_pad": b.r_pad, "k_pad": b.k_pad,
                "n_steps": b.n_steps, "needs_words": b.needs_words,
                "predicted_bytes": share["peak_bytes"],
                "est_word_ops": word_ops,
                "est_device_ms": round(est_s * 1e3, 4)})
            for pid in b.qids:
                qid = plan.owner.get(pid)
                if qid is None or isinstance(queries[qid],
                                             expr_mod.ExprQuery):
                    continue        # expression rows are below
                q = queries[qid]
                n_ops = len(set(q.operands))
                q_rows[qid] = {"op": q.op, "form": q.form, "operands": n_ops,
                               "rung": packing.next_pow2(max(1, n_ops)),
                               "bucket": bi}
        expr_rows = []
        for sec in plan.exprs:
            sig = sec.signature
            expr_rows.append({
                "qid": sec.qid, "kind": sec.kind, "form": sec.form,
                "nodes": sec.n_nodes, "reduce_nodes": sec.n_reduce,
                "combine_nodes": sec.n_combine, "depth": sec.depth,
                "cse_saved": sec.cse_saved,
                "predicted_bytes": insights.predict_expr_dispatch_bytes(
                    [sig], eng)["peak_bytes"],
                "est_word_ops": insights.predict_expr_word_ops([sig], eng),
                "per_node": insights.expr_node_report(sig)})
            q_rows[sec.qid] = {"op": "expr", "form": sec.form,
                               "nodes": sec.n_nodes, "depth": sec.depth,
                               "kind": sec.kind}
        floor = {"host_pairwise_ops": sum(
            expr_mod.host_op_count(q.expr)
            if isinstance(q, expr_mod.ExprQuery)
            else max(0, len(set(q.operands)) - 1) for q in queries),
            "observed_mean_seconds": None}
        for name, labels, inst in obs_metrics.REGISTRY.instruments():
            # read-only scan: explain never creates an instrument
            if (name == "rb_execute_latency_seconds"
                    and labels.get("site") == SITE
                    and labels.get("engine") == guard.SEQUENTIAL
                    and inst.count):
                floor["observed_mean_seconds"] = round(
                    inst.sum / inst.count, 6)
        split_sizes = self._split_layout(queries, eng, budget)
        densify_s = obs_cost.estimate_seconds(
            insights.predict_batch_dispatch_word_ops(
                [], kind, self._ds._n_rows, eng),
            predicted["densify_bytes"], SITE, eng)
        return {
            "site": SITE, "q": len(queries),
            "engine_requested": engine, "engine": eng,
            "engine_chain": list(guard.chain_from(start, ENGINES,
                                                  self.device)),
            "layout": self._ds.layout, "source_kind": kind,
            "plan_cache_hit": plan_hit,
            "program_cache_hit": prog_hit,
            "resident": {
                "hbm_bytes": self.hbm_bytes(),
                "components": {k: int(v) for k, v in
                               insights.resident_set_bytes(
                                   self._ds).items()}},
            "buckets": buckets, "queries": q_rows, "exprs": expr_rows,
            "predicted": {k: int(v) for k, v in predicted.items()},
            "hbm_budget_bytes": budget,
            "proactive_split": {"would_split": len(split_sizes) > 1,
                                "dispatches": split_sizes},
            "sequential_floor": floor,
            "cost": {
                "peaks": obs_cost.device_peaks(),
                "per_bucket_est_device_ms": [b["est_device_ms"]
                                             for b in buckets],
                "densify_est_device_ms": round(densify_s * 1e3, 4),
                "est_device_total_ms": round(
                    (est_total_s + densify_s) * 1e3, 4),
                "observed": obs_cost.TRACKER.observed_rates(SITE, eng)},
        }

    def chained_cardinality(self, queries, reps: int, engine: str = "auto"):
        """A callable running the whole flat batch ``reps`` times in turn on
        the resident image, every query's cards summed into an int64 device
        total; it returns the total mod 2^32 as a 0-d device tensor (callers
        check it against ``(reps * expected) % 2**32``).  On the card each
        repetition is a gather and a B1 launch per bucket (B3 first for a
        stream set).  PyTorch runs eagerly and never elides a repeated call,
        so JAX's optimization_barrier has no counterpart."""
        queries = list(queries)
        if any(isinstance(q, expr_mod.ExprQuery) for q in queries):
            raise ValueError(
                "chained_cardinality probes flat batches only; time "
                "expression pools with repeated execute() calls")
        if engine not in ("auto",) + ENGINES:
            raise ValueError(f"unknown engine {engine!r}; expected one of "
                             f"{('auto',) + ENGINES}")
        plan = self.plan(queries)
        eng = self._bucket_engine(
            plan, resolve_query_engine(engine, queries, self.device),
            note=False)
        sigs = [b.signature for b in plan]
        arrays = [b.device_arrays(self.device) for b in plan]

        def run():
            total = torch.zeros((), dtype=torch.int64, device=self.device)
            for _ in range(reps):
                words = self._words(eng)
                for sig, arr in zip(sigs, arrays):
                    total += bucket_body(words, sig, arr, eng)[1].sum(
                        dtype=torch.int64)
            return total % (1 << 32)

        return run

    def hbm_bytes(self) -> int:
        """Device bytes the set keeps resident (``DeviceBitmapSet.hbm_bytes``)."""
        return self._ds.hbm_bytes()


def analytics_rung_queries(columns: dict, depth: int,
                           n_residents: int) -> list:
    """Representative one-query batches of one lattice ``bsi`` shape-class
    (the JAX package's): per attached column whose padded depth the rung
    covers, one batch per predicate class (cmp / range / filter fused with
    set algebra) and the aggregate roots over them.  Predicate values sit
    mid-domain, so that min/max pruning cannot collapse the scan away."""
    out = []
    for name, col in sorted(columns.items()):
        if col.depth_pad > depth or not col.keys.size:
            continue
        mn, mx = col.min_value, col.max_value
        if mx > mn:
            mid = mn + (mx - mn) // 2
            out.append([expr_mod.ExprQuery(expr_mod.cmp(name, "le", mid))])
            out.append([expr_mod.ExprQuery(
                expr_mod.range_(name, mn + 1, mx))])
            if n_residents:
                # a ref leaf lowers as a "leaf" gather step, a set reduce as
                # a "reduce" step: both found-set spellings are warmed
                founds = [expr_mod.and_(
                    expr_mod.ref(0), expr_mod.range_(name, mn + 1, mx))]
                if n_residents >= 2:
                    founds.append(expr_mod.and_(
                        expr_mod.or_(0, 1),
                        expr_mod.range_(name, mn + 1, mx)))
                for found in founds:
                    out.append([expr_mod.ExprQuery(found)])
                    out.append([expr_mod.ExprQuery(
                        expr_mod.sum_(name, found=found))])
                    out.append([expr_mod.ExprQuery(
                        expr_mod.top_k(name, 1, found=found),
                        form="bitmap")])
        # the min/max-pruned "all" path is its own leaner program shape
        out.append([expr_mod.ExprQuery(expr_mod.cmp(name, "ge", 0))])
        if n_residents:
            out.append([expr_mod.ExprQuery(expr_mod.and_(
                expr_mod.ref(0), expr_mod.cmp(name, "ge", 0)))])
            out.append([expr_mod.ExprQuery(
                expr_mod.sum_(name, found=expr_mod.ref(0)))])
            out.append([expr_mod.ExprQuery(
                expr_mod.top_k(name, 1, found=expr_mod.ref(0)),
                form="bitmap")])
        out.append([expr_mod.ExprQuery(expr_mod.sum_(name))])
        out.append([expr_mod.ExprQuery(expr_mod.top_k(name, 1),
                                       form="bitmap")])
    return out


def execute_batch(ds: DeviceBitmapSet, queries, engine: str = "auto"
                  ) -> list[BatchResult]:
    """One-shot convenience: plan + run a batch against a resident set."""
    return BatchEngine(ds).execute(queries, engine=engine)


def random_query_pool(n_bitmaps: int, q: int, seed: int = 0xBA7C,
                      max_operands: int = 16) -> list[BatchQuery]:
    """Deterministic mixed-op query pool over ``n_bitmaps`` residents (the
    JAX package's generator: the same seed gives the same pool).  Cycles
    or/xor/and/andnot with random subset sizes in [2, max_operands]."""
    if n_bitmaps < 2:
        raise ValueError("query pool needs at least 2 resident bitmaps")
    rng = np.random.default_rng(seed)
    hi = max(3, min(max_operands + 1, n_bitmaps))
    pool = []
    for i in range(q):
        op = ("or", "xor", "and", "andnot")[i % 4]
        k = int(rng.integers(2, hi))
        pool.append(BatchQuery(op=op, operands=tuple(
            int(x) for x in rng.choice(n_bitmaps, size=k, replace=False))))
    return pool
