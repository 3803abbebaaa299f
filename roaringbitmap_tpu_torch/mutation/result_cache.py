"""Materialized expression-result cache keyed by (DAG hash x leaf versions)
(``roaringbitmap_tpu.mutation.result_cache``).

The expression compiler canonicalizes every query into a structural DAG;
appending each leaf's ``(set uid, source index, source version)`` token
turns that structure into a result key.  An unchanged canonical (sub)tree
over unchanged data is then a dictionary hit instead of a re-run reduce:

- **root-level serving**: the engines' ``execute`` probes the cache per
  query before planning (``serve_and_fill``); a hit returns the stored
  result, a miss dispatches as before and fills the cache on the way out;
- **subtree injection**: ``BatchEngine.plan`` hands the expression compiler
  a probe; an interior node whose key holds materialized rows lowers as a
  pre-computed operand (an ``("adhoc", K)`` step) and its reduce is pruned
  from the plan.

A materialized entry keeps its rows on the result's device as an
``int32[K, 2048]`` tensor, so an injected operand goes into the plan as it
is, with no copy through the host.  Entries are never written after they
are made: plans read the rows (a megakernel plan copies them into its
ad-hoc bank), and nothing masks them in place.

Correctness leans on the delta versions (``mutation.delta``): a leaf token
embeds ``source_versions[i]``, so a bumped leaf never hits a stale entry,
and the leaf -> entry index drops exactly the dependent entries on a bump
(``notify_version_bump``).  The cache is an LRU under a BYTE budget, with
the JAX package's entry size formula.  Until the HBM ledger is ported,
``stats()["bytes"]`` is the account of the device bytes it holds.
"""

from __future__ import annotations

import os
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..ops import packing
from ..ops.words import WORDS32, as_i32, resolve_device
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

ENV_RESULT_CACHE = "ROARING_TPU_RESULT_CACHE"

#: fixed per-entry bookkeeping estimate (key tuple, index rows, slots)
ENTRY_OVERHEAD_BYTES = 128

#: live caches, notified on every set's version bump
_CACHES: "weakref.WeakSet" = weakref.WeakSet()


# ------------------------------------------------------------------ keys

def _leaf_token(leaf, leaf_token_of):
    tok = leaf_token_of(int(leaf.index))
    if tok is None:
        return None
    uid, src, ver = tok
    return ("ref", int(uid), int(src), int(ver)), (int(uid), int(src))


def _col_token(name, col_token_of, leaves: set):
    """Column leaf token, ``(uid, version)`` from the engine's column
    resolver; the ``(uid, -1)`` leaf makes a column delta invalidate exactly
    its dependent entries."""
    if col_token_of is None:
        return None
    tok = col_token_of(str(name))
    if tok is None:
        return None
    uid, ver = tok
    leaves.add((int(uid), -1))
    return int(uid), int(ver)


def _tokenize(e, leaf_token_of, leaves: set, col_token_of=None):
    """Structural token of an already canonical expression node, or None
    when the node is uncacheable (ad-hoc leaves key by object identity,
    which a cross-request cache must not trust)."""
    from ..parallel import expr as expr_mod

    if isinstance(e, expr_mod.Ref):
        got = _leaf_token(e, leaf_token_of)
        if got is None:
            return None
        tok, leaf = got
        leaves.add(leaf)
        return tok
    if isinstance(e, expr_mod.AdHoc):
        return None
    if isinstance(e, expr_mod.ValuePred):
        ct = _col_token(e.col, col_token_of, leaves)
        if ct is None:
            return None
        return ("vpred", *ct, e.op, int(e.lo), int(e.hi))
    if isinstance(e, expr_mod.Agg):
        ct = _col_token(e.col, col_token_of, leaves)
        if ct is None:
            return None
        if e.found is None:
            ftok = ("all",)
        else:
            ftok = _tokenize(e.found, leaf_token_of, leaves, col_token_of)
            if ftok is None:
                return None
        return ("agg", e.kind, int(e.k), *ct, ftok)
    if e.op == "empty":
        return ("empty",)
    kids = []
    for c in e.children:
        t = _tokenize(c, leaf_token_of, leaves, col_token_of)
        if t is None:
            return None
        kids.append(t)
    return (e.op, tuple(kids))


def node_key(node, leaf_token_of, col_token_of=None):
    """``(key, leaves)`` of one canonical expression node; ``(None, None)``
    when uncacheable.  ``leaf_token_of(index) -> (uid, source, version) |
    None`` is the engine's resident-set resolver; ``col_token_of(name) ->
    (uid, version) | None`` resolves attached columns."""
    leaves: set = set()
    tok = _tokenize(node, leaf_token_of, leaves, col_token_of)
    if tok is None:
        return None, None
    return tok, frozenset(leaves)


def query_key(q, leaf_token_of, col_token_of=None):
    """``(key, leaves, form)`` of one ``BatchQuery`` / ``ExprQuery``.

    Flat queries normalize through the same canonicalization as expressions
    (operands as a set, andnot = head minus the rest's union), so
    ``BatchQuery("or", (0, 1))`` and ``ExprQuery(or_(0, 1))`` share one
    entry.  Uncacheable queries (ad-hoc leaves, out-of-range refs, shapes
    canonicalization rejects) give ``(None, None, form)``: the planner
    still raises its own typed error where it would have."""
    from ..parallel import expr as expr_mod
    from ..parallel.batch_engine import BatchQuery

    if isinstance(q, BatchQuery):
        ops = sorted({int(i) for i in q.operands})
        if not ops:
            return None, None, q.form
        if q.op == "andnot":
            head = int(q.operands[0])
            rest = sorted({int(i) for i in q.operands[1:]})
            e = expr_mod.Node("andnot", (expr_mod.Ref(head),
                                         *(expr_mod.Ref(i) for i in rest)))
        else:
            e = (expr_mod.Ref(ops[0]) if len(ops) == 1 else
                 expr_mod.Node(q.op, tuple(expr_mod.Ref(i) for i in ops)))
    elif isinstance(q, expr_mod.ExprQuery):
        e = q.expr
    else:
        return None, None, getattr(q, "form", "cardinality")
    try:
        e = expr_mod.canonicalize(e)
    except (ValueError, TypeError):
        return None, None, q.form
    key, leaves = node_key(e, leaf_token_of, col_token_of)
    return key, leaves, q.form


def subtree_probe(cache, leaf_token_of, col_token_of=None):
    """The plan-time probe an engine hands ``expr.compile_query``: a
    canonical interior node whose key holds materialized rows in ``cache``
    returns ``(keys, words)``, the entry's device rows, which the plan only
    reads; None otherwise."""
    def probe(node):
        k, _leaves = node_key(node, leaf_token_of, col_token_of)
        got = None if k is None else cache.peek_rows(k)
        return None if got is None else got[:2]

    return probe


# ----------------------------------------------------------------- cache

class _Entry:
    __slots__ = ("cardinality", "keys", "words", "cards", "bitmap",
                 "leaves", "nbytes", "value")

    def __init__(self, cardinality, keys, words, cards, bitmap, leaves,
                 value=None):
        self.cardinality = int(cardinality)
        self.keys = keys          # root keys (None: card-only)
        self.words = words        # int32[K, 2048] device rows (None: card-only)
        self.cards = cards        # i32[K] per-key cards (None: card-only)
        self.bitmap = bitmap      # host materialization (None: card-only)
        self.leaves = leaves      # frozenset of (uid, source)
        self.value = value        # aggregate payload (sum_ totals)
        nbytes = ENTRY_OVERHEAD_BYTES
        if words is not None:
            nbytes += int(words.numel()) * 4 + int(keys.size) * 2 \
                + int(cards.size) * 4
        self.nbytes = nbytes


class ResultCache:
    """Byte-budgeted LRU of materialized query results.

    Not thread-safe (the engines dispatch from one thread each).  One cache
    may back any number of engines: keys embed each resident set's
    process-unique ``uid``, so tenants never collide."""

    def __init__(self, max_bytes: int = 64 << 20, name: str = "result"):
        if max_bytes < 1:
            raise ValueError(f"max_bytes must be >= 1, got {max_bytes}")
        self.max_bytes = int(max_bytes)
        self.name = name
        self._data: OrderedDict = OrderedDict()
        self._by_leaf: dict = {}       # (uid, source) -> set of keys
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        self._ledger_handle = obs_memory.LEDGER.register(
            "result_cache", "device", 0, owner=self)
        _CACHES.add(self)

    # ---------------------------------------------------------- probing

    def probe(self, key, form: str = "cardinality"):
        """The stored ``BatchResult`` for ``key``, or None.  A cardinality
        query hits any entry; a bitmap query needs a materialized one.
        Counts hits and misses."""
        from ..parallel.batch_engine import BatchResult

        e = self._data.get(key)
        if e is None or (form == "bitmap" and e.bitmap is None):
            self.misses += 1
            obs_metrics.counter("rb_result_cache_misses").inc()
            return None
        self._data.move_to_end(key)
        self.hits += 1
        obs_metrics.counter("rb_result_cache_hits").inc()
        return BatchResult(
            cardinality=e.cardinality,
            bitmap=e.bitmap.clone() if form == "bitmap" else None,
            value=e.value)

    def would_hit(self, key, form: str = "cardinality") -> bool:
        """Count-free peek: a predictor may ask it for every pool member
        without skewing the counts."""
        if key is None:
            return False
        e = self._data.get(key)
        return e is not None and not (form == "bitmap" and e.bitmap is None)

    def peek_rows(self, key):
        """``(keys, words, cards)`` of a materialized entry for the
        plan-time subtree probe, or None.  ``words`` is the entry's device
        tensor: the caller only reads it.  Counts hits only (a pruned
        reduce is a served result; a miss on one of a plan's interior nodes
        is not a query miss)."""
        e = self._data.get(key)
        if e is None or e.words is None:
            return None
        self._data.move_to_end(key)
        self.hits += 1
        obs_metrics.counter("rb_result_cache_hits").inc()
        return e.keys, e.words, e.cards

    # ---------------------------------------------------------- filling

    def put(self, key, leaves, result, device=None) -> None:
        """Fill one entry from a dispatched ``BatchResult``.  A bitmap
        result keeps its rows on ``device`` (the subtree-injectable form)
        beside the host bitmap; a cardinality result keeps the count alone
        (``ENTRY_OVERHEAD_BYTES``).  An entry larger than the whole budget
        is refused rather than evicting everything else."""
        if key is None or result is None:
            return
        keys = words = cards = bitmap = None
        if result.bitmap is not None:
            # the size gate comes first: an entry that can never fit must
            # not pay the row pack and upload on every execution
            k = result.bitmap.container_count()
            if ENTRY_OVERHEAD_BYTES + k * (WORDS32 * 4 + 2 + 4) \
                    > self.max_bytes:
                return
            dev = resolve_device(device)
            bitmap = result.bitmap.clone()
            keys = packing._keys_of(bitmap).copy()
            if keys.size:
                words_np = np.stack([packing.container_words_u32(c)
                                     for c in bitmap.containers])
                cards = np.array([c.cardinality
                                  for c in bitmap.containers], np.int32)
                words = as_i32(words_np.astype(np.uint32), dev)
            else:
                words = torch.zeros((0, WORDS32), dtype=torch.int32,
                                    device=dev)
                cards = np.zeros(0, np.int32)
        entry = _Entry(result.cardinality, keys, words, cards, bitmap,
                       leaves or frozenset(), value=result.value)
        if entry.nbytes > self.max_bytes:
            return
        old = self._data.pop(key, None)
        if old is not None:
            self._drop_index(key, old)
            self.nbytes -= old.nbytes
        self._data[key] = entry
        self.nbytes += entry.nbytes
        for leaf in entry.leaves:
            self._by_leaf.setdefault(leaf, set()).add(key)
        while self.nbytes > self.max_bytes and len(self._data) > 1:
            k, e = self._data.popitem(last=False)
            self._drop_index(k, e)
            self.nbytes -= e.nbytes
            self.evictions += 1
            obs_metrics.counter("rb_result_cache_evictions").inc()
        self._account()

    # ----------------------------------------------------- invalidation

    def invalidate(self, uid: int, sources=None) -> int:
        """Drop every entry depending on set (or column) ``uid``, all of it
        or only the given source indices: exact invalidation, entries whose
        leaves miss every bumped leaf survive.  Returns the number
        dropped."""
        if sources is None:
            leafset = [lf for lf in list(self._by_leaf) if lf[0] == uid]
        else:
            leafset = [(uid, int(s)) for s in sources]
        doomed: set = set()
        for leaf in leafset:
            doomed |= self._by_leaf.get(leaf, set())
        for key in doomed:
            e = self._data.pop(key, None)
            if e is None:
                continue
            self._drop_index(key, e)
            self.nbytes -= e.nbytes
            self.invalidations += 1
        if doomed:
            self._account()
        return len(doomed)

    def _drop_index(self, key, entry) -> None:
        for leaf in entry.leaves:
            keys = self._by_leaf.get(leaf)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_leaf[leaf]

    # ------------------------------------------------------- accounting

    def _account(self) -> None:
        obs_metrics.gauge("rb_result_cache_bytes").set(self.nbytes)
        obs_memory.LEDGER.update(self._ledger_handle, self.nbytes)

    def clear(self) -> None:
        self._data.clear()
        self._by_leaf.clear()
        self.nbytes = 0
        self._account()

    def __len__(self) -> int:
        return len(self._data)

    def stats(self) -> dict:
        return {"entries": len(self._data), "bytes": self.nbytes,
                "max_bytes": self.max_bytes, "hits": self.hits,
                "misses": self.misses, "evictions": self.evictions,
                "invalidations": self.invalidations}


def notify_version_bump(uid: int, sources=None) -> int:
    """The delta hook (``mutation.delta``, column deltas): drop the
    dependent entries of a bumped set from every live cache.  Version-keyed
    keys already make a stale hit impossible; this reclaims the bytes."""
    return sum(cache.invalidate(uid, sources) for cache in list(_CACHES))


# -------------------------------------------------------------- serving

def serve_and_fill(cache, items, key_of, run, site: str, device=None):
    """The probe / dispatch / fill loop the engines share.

    ``items`` are opaque query carriers, ``key_of(item) -> (key, leaves,
    form)``, ``run(miss_items) -> results`` runs the misses through the
    engine's guarded path, and filled rows go to ``device``.  Returns
    ``(results, hits)``, results in item order, and attaches an
    ``expr.cache`` event (tagged with ``site``) to the current span."""
    keyed = [key_of(it) for it in items]
    results: list = [None] * len(items)
    miss: list = []
    for i, (key, _leaves, form) in enumerate(keyed):
        got = cache.probe(key, form) if key is not None else None
        if got is None:
            miss.append(i)
        else:
            results[i] = got
    obs_trace.current().event("expr.cache", site=site,
                              hits=len(items) - len(miss), misses=len(miss))
    if miss:
        out = run([items[i] for i in miss])
        for i, r in zip(miss, out):
            results[i] = r
            key, leaves, _form = keyed[i]
            if key is not None:
                cache.put(key, leaves, r, device=device)
    return results, len(items) - len(miss)


# ------------------------------------------------------------ env knob

_env_cache: ResultCache | None = None
_env_spec: str | None = None


def from_env():
    """The process-shared cache sized by ``ROARING_TPU_RESULT_CACHE``
    (bytes, K/M/G-suffixed), or None when unset or 0: the engines' default,
    so a deployment opts in without code."""
    global _env_cache, _env_spec
    spec = os.environ.get(ENV_RESULT_CACHE)
    if spec != _env_spec:
        _env_spec = spec
        if not spec:
            _env_cache = None
        else:
            from ..runtime import guard

            nbytes = guard.parse_bytes(spec)
            _env_cache = (ResultCache(nbytes, name="env")
                          if nbytes > 0 else None)
    return _env_cache
