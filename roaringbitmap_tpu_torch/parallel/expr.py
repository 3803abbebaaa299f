"""Expression-DAG query compiler: compositional set algebra and value
queries in one batch (``roaringbitmap_tpu.parallel.expr``).

IR
--
Leaves: :func:`ref` (an index into the resident set), :func:`bitmap` (an
ad-hoc host RoaringBitmap, shipped with the plan) and the value predicates
:func:`range_` / :func:`cmp` over a column attached to the set
(``DeviceBitmapSet.attach_column``).  Ops: :func:`or_`, :func:`and_`,
:func:`xor`, :func:`andnot`, :func:`not_`.  Aggregate roots :func:`sum_` and
:func:`top_k` consume a bitmap-valued found set.  An :class:`ExprQuery`
wraps a root expression with a result ``form`` ("cardinality" or "bitmap")
and is accepted by ``BatchEngine.execute`` anywhere a ``BatchQuery`` is.

Compilation (:func:`compile_query`):

1. **canonicalize + CSE** (:func:`canonicalize`): associative chains
   flatten, or/and operands dedupe, xor operands cancel pairwise,
   commutative children sort, double negation drops, and
   ``and(x..., not(y)...)`` rewrites to ``andnot(and(x...), y...)`` (a
   ``not_`` surviving canonicalization is an unbounded complement and
   raises).  Equal canonical subtrees are one DAG node.  An aggregate
   stays at the root; nested anywhere else it raises.
2. **reduce extraction**: every maximal all-leaf op node becomes a pseudo
   ``BatchQuery`` riding the batch engine's bucketing, so wide chains stay
   segmented reduces.
3. **fused steps**: interior nodes become elementwise bitwise passes over
   key-aligned ``int32[K, 2048]`` blocks; alignment gathers are plan-time
   host arrays, an absent child key contributes the identity.  A value
   predicate becomes one ``vscan`` step over its column's slice planes
   (min/max pruning at plan time, shared with the host oracle), an
   aggregate root one ``vagg`` step over its found step.
4. **short circuits**: a cardinality-only root never materializes its
   words; an empty key space (disjoint AND, cancelled XOR, a pruned
   predicate) is pruned at plan time, and a pruned root never touches the
   device.

The sections run two ways: the multi-op rungs run ``eval_sections`` (plain
PyTorch combines and plane scans, as they were XLA in the JAX package) after
the buckets' segmented reduces, and the megakernel rung (``ops.megakernel``)
assembles the same sections into one instruction stream.
"""

from __future__ import annotations

import dataclasses
import operator

import numpy as np
import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops import dense, packing
from ..ops.words import WORDS32, to_u32, upload

#: ops the IR accepts; "not" only survives until canonicalization
OPS = ("or", "and", "xor", "andnot")


# ------------------------------------------------------------------- IR

class Expr:
    """Base marker for expression nodes (never instantiated directly)."""

    __slots__ = ()


@dataclasses.dataclass(frozen=True)
class Ref(Expr):
    """Leaf: index of a bitmap in the resident DeviceBitmapSet."""

    index: int


class AdHoc(Expr):
    """Leaf: an ad-hoc host bitmap (not resident) shipped with the plan.

    The input is snapshotted (cloned) at construction, so a cached plan
    never replays a bitmap the caller mutated later.  Two leaves are equal
    only when they share one snapshot."""

    __slots__ = ("bm",)

    def __init__(self, bm):
        object.__setattr__(self, "bm", bm.clone())

    def __setattr__(self, *a):
        raise AttributeError("AdHoc is immutable")

    def __eq__(self, o):
        return isinstance(o, AdHoc) and o.bm is self.bm

    def __hash__(self):
        return id(self.bm)

    def __repr__(self):
        return f"AdHoc(<bitmap {id(self.bm):#x}>)"


class Node(Expr):
    """Interior op node over child expressions.  Structural equality and
    hash, cached per node so walks over a shared DAG stay O(dag)."""

    __slots__ = ("op", "children", "_hash", "_skey_c")

    def __init__(self, op: str, children: tuple):
        self.op = op
        self.children = tuple(children)
        self._hash = None
        self._skey_c = None

    def __eq__(self, o):
        if self is o:
            return True
        return (isinstance(o, Node) and self.op == o.op
                and self.children == o.children)

    def __hash__(self):
        h = self._hash
        if h is None:
            h = self._hash = hash((self.op, self.children))
        return h

    def __repr__(self):
        return f"Node({self.op!r}, {self.children!r})"


#: the canonical empty result (e.g. a fully-cancelled xor)
EMPTY = Node("empty", ())


@dataclasses.dataclass(frozen=True)
class ValuePred(Expr):
    """Leaf: the rows of an attached column whose value satisfies ``op``
    against ``lo`` (and ``hi`` for ``range``).  It evaluates over the
    column's existence plane and composes with or/and/xor/andnot like any
    bitmap leaf."""

    col: str
    op: str
    lo: int
    hi: int = 0


@dataclasses.dataclass(frozen=True)
class Agg(Expr):
    """Aggregate root over a column: ``sum`` (the total and member count of
    the found set's stored values) or ``topk`` (the rows holding the k
    largest values).  ``found`` is any bitmap-valued expression (None = the
    column's whole stored domain)."""

    kind: str
    col: str
    k: int
    found: object = None


def range_(col, lo: int, hi: int) -> ValuePred:
    """Rows with ``lo <= value(col) <= hi``."""
    return ValuePred(str(col), "range", int(lo), int(hi))


def cmp(col, op: str, value: int) -> ValuePred:
    """Rows with ``value(col) <op> value``; op in eq/neq/lt/le/gt/ge."""
    op = str(op).lower()
    if op not in ("eq", "neq", "lt", "le", "gt", "ge"):
        raise ValueError(f"unsupported value predicate op {op!r} "
                         f"(range predicates spell range_(col, lo, hi))")
    return ValuePred(str(col), op, int(value))


def sum_(col, found=None) -> Agg:
    """Aggregate root: (sum of column values over the found set, member
    count)."""
    return Agg("sum", str(col), 0,
               None if found is None else _as_expr(found))


def top_k(col, k: int, found=None) -> Agg:
    """Aggregate root: the rows holding the k largest column values within
    the found set (k clamped to the found set's stored rows; ties trimmed
    by dropping the smallest row ids)."""
    if int(k) < 0:
        raise ValueError(f"top_k needs k >= 0, got {k}")
    return Agg("topk", str(col), int(k),
               None if found is None else _as_expr(found))


def _as_expr(x) -> Expr:
    if isinstance(x, Expr):
        return x
    if isinstance(x, (int, np.integer)):
        return Ref(int(x))
    raise TypeError(
        f"expression operand must be an Expr or a resident index, got "
        f"{type(x).__name__}")


def ref(i: int) -> Ref:
    return Ref(int(i))


def bitmap(bm) -> AdHoc:
    """Ad-hoc leaf over a host bitmap not resident in the set."""
    return AdHoc(bm)


def or_(*xs) -> Expr:
    return Node("or", tuple(_as_expr(x) for x in xs))


def and_(*xs) -> Expr:
    return Node("and", tuple(_as_expr(x) for x in xs))


def xor(*xs) -> Expr:
    return Node("xor", tuple(_as_expr(x) for x in xs))


def andnot(head, *rest) -> Expr:
    """head minus the union of ``rest`` (the BatchQuery andnot shape)."""
    return Node("andnot", (_as_expr(head),)
                + tuple(_as_expr(x) for x in rest))


def not_(x) -> Expr:
    """Complement: bounded only inside an ``and_`` (where it rewrites to
    ``andnot``); anywhere else canonicalization raises."""
    return Node("not", (_as_expr(x),))


@dataclasses.dataclass(frozen=True)
class ExprQuery:
    """One compositional request against a resident set: the DAG
    generalization of ``batch_engine.BatchQuery``."""

    expr: Expr
    form: str = "cardinality"

    def __post_init__(self):
        if not isinstance(self.expr, Expr):
            object.__setattr__(self, "expr", _as_expr(self.expr))
        if self.form not in ("cardinality", "bitmap"):
            raise ValueError(f"unsupported result form {self.form!r}")
        if isinstance(self.expr, Agg) and self.expr.kind == "sum" \
                and self.form == "bitmap":
            raise ValueError(
                "sum_ roots have no bitmap form (the result is a "
                "scalar total + count)")


# --------------------------------------------------- canonicalize + CSE

_ASSOC = ("or", "and", "xor")


def _skey(e: Expr):
    """Deterministic structural sort key for commutative child ordering
    (AdHoc keys by object identity, stable within a process)."""
    if isinstance(e, Ref):
        return (0, e.index)
    if isinstance(e, AdHoc):
        return (1, id(e.bm))
    if isinstance(e, ValuePred):
        return (3, e.col, e.op, e.lo, e.hi)
    k = e._skey_c
    if k is None:
        k = e._skey_c = (2, e.op, tuple(_skey(c) for c in e.children))
    return k


def canonicalize(e) -> Expr:
    """Canonical DAG form: flattened associative chains, deduped/sorted
    commutative operands, pairwise-cancelled xor, ``not`` absorbed into
    ``andnot`` (or rejected as unbounded), structural sharing for CSE.
    Raises ValueError on an unbounded complement or an empty ``and``."""
    e = _as_expr(e)
    if isinstance(e, Agg):
        f = e.found
        if f is None:
            return e
        f_c = _canon(_as_expr(f), {}, {})
        if isinstance(f_c, Node) and f_c.op == "not":
            raise ValueError(
                "unbounded complement: an aggregate's found set is a "
                "bare not_ (complements are bounded only inside and_)")
        return Agg(e.kind, e.col, e.k, f_c)
    out = _canon(e, {}, {})
    if isinstance(out, Node) and out.op == "not":
        raise ValueError(
            "unbounded complement: a bare not_ root spans the whole "
            "2^32 universe (complements are bounded only inside and_)")
    return out


def is_agg(e) -> bool:
    """True when ``e`` is an aggregate-rooted expression."""
    return isinstance(e, Agg)


def _canon(e: Expr, memo: dict, intern: dict) -> Expr:
    got = memo.get(e)
    if got is not None:
        return got
    out = _canon_uncached(e, memo, intern)
    # equal canonical results from different branches unify to one object
    out = intern.setdefault(out, out)
    memo[e] = out
    return out


def _canon_uncached(e: Expr, memo: dict, intern: dict) -> Expr:
    if isinstance(e, (Ref, AdHoc, ValuePred)):
        return e
    if isinstance(e, Agg):
        raise ValueError(
            "aggregate roots (sum_/top_k) cannot nest inside an "
            "expression — they consume a bitmap-valued found set and "
            "produce a scalar/top-k result, not a combinable bitmap")
    if e.op == "empty":
        return EMPTY
    if e.op == "not":
        c = _canon(e.children[0], memo, intern)
        if isinstance(c, Node) and c.op == "not":
            return c.children[0]            # double negation
        return Node("not", (c,))
    if e.op == "andnot":
        if not e.children:
            return EMPTY
        head = _canon(e.children[0], memo, intern)
        rest: list = []
        for r in e.children[1:]:
            r = _canon(r, memo, intern)
            if isinstance(r, Node) and r.op == "empty":
                continue                    # x & ~0 == x
            if isinstance(r, Node) and r.op == "or":
                rest.extend(r.children)     # ~(a|b|c): rests ARE a union
            else:
                rest.append(r)
        if isinstance(head, Node):
            if head.op == "empty":
                return EMPTY
            if head.op == "not":
                raise ValueError(
                    "unbounded complement: andnot head is a not_ node "
                    "(complements are bounded only inside and_)")
            if head.op == "andnot":
                # andnot(andnot(h, s...), r...) == andnot(h, s..., r...)
                rest = list(head.children[1:]) + rest
                head = head.children[0]
        if any(isinstance(r, Node) and r.op == "not" for r in rest):
            raise ValueError(
                "unbounded complement: not_ inside an andnot rest")
        seen, uniq = set(), []
        for r in sorted(rest, key=_skey):
            if r not in seen:
                seen.add(r)
                uniq.append(r)
        if head in seen:
            return EMPTY                    # h & ~(h | ...) == 0
        if not uniq:
            return head
        return Node("andnot", (head, *uniq))
    if e.op in _ASSOC:
        flat: list = []
        for c in e.children:
            c = _canon(c, memo, intern)
            if isinstance(c, Node) and c.op == e.op:
                flat.extend(c.children)     # associative flatten
            else:
                flat.append(c)
        if e.op == "and":
            if any(isinstance(c, Node) and c.op == "empty" for c in flat):
                return EMPTY
            neg = [c for c in flat
                   if isinstance(c, Node) and c.op == "not"]
            pos = [c for c in flat if c not in neg]
            if neg:
                if not pos:
                    raise ValueError(
                        "unbounded complement: and_ of only not_ nodes")
                base = _canon(Node("and", tuple(pos)), memo, intern)
                return _canon(
                    Node("andnot",
                         (base, *(n.children[0] for n in neg))), memo,
                    intern)
        else:
            flat = [c for c in flat
                    if not (isinstance(c, Node) and c.op == "empty")]
        if any(isinstance(c, Node) and c.op == "not" for c in flat):
            raise ValueError(
                f"unbounded complement: not_ under {e.op}_ (complements "
                "are bounded only inside and_)")
        flat.sort(key=_skey)
        if e.op == "xor":
            uniq: list = []                 # pairwise cancellation
            for c in flat:
                if uniq and uniq[-1] == c:
                    uniq.pop()
                else:
                    uniq.append(c)
        else:
            uniq = []
            for c in flat:                  # idempotent dedupe
                if not uniq or uniq[-1] != c:
                    uniq.append(c)
        if not uniq:
            if e.op == "and":
                raise ValueError("and_ needs at least one operand")
            return EMPTY
        if len(uniq) == 1:
            return uniq[0]
        return Node(e.op, tuple(uniq))
    raise ValueError(f"unknown expression op {e.op!r}")


def dag_stats(e: Expr) -> dict:
    """Canonical-DAG shape report: unique op-node count, depth, and the
    CSE saving (tree op nodes minus DAG op nodes)."""
    return _dag_stats_canonical(canonicalize(e))


def _dag_stats_canonical(e: Expr) -> dict:
    """`dag_stats` over an already-canonical node, memoized per node (the
    tree size of a shared DAG is exponential in its depth)."""
    uniq: set = set()
    info: dict = {}          # node -> (tree_nodes, depth)

    def walk(n):
        if not isinstance(n, Node) or n.op == "empty":
            return 0, 0
        got = info.get(n)
        if got is not None:
            return got
        uniq.add(n)
        t, d = 1, 1
        for c in n.children:
            ct, cd = walk(c)
            t += ct
            d = max(d, cd + 1)
        info[n] = (t, d)
        return t, d

    tree_nodes, depth = walk(e)
    return {"nodes": len(uniq), "tree_nodes": tree_nodes,
            "cse_saved": tree_nodes - len(uniq), "depth": depth}


def host_op_count(e: Expr) -> int:
    """Pairwise host container ops a sequential evaluation pays: the
    expression analog of ``len(operands) - 1`` in the explain floor."""
    try:
        return _host_op_count_canonical(canonicalize(e))
    except ValueError:
        return 0


def _host_op_count_canonical(e: Expr) -> int:
    return sum(max(0, len(n.children) - 1) for n in _dag_nodes(e)
               if isinstance(n, Node) and n.op != "empty")


def _dag_nodes(e: Expr) -> list:
    """Unique nodes of the canonical DAG, children first."""
    seen: set = set()
    order: list = []

    def walk(n):
        if n in seen:
            return
        seen.add(n)
        if isinstance(n, Node):
            for c in n.children:
                walk(c)
        order.append(n)

    walk(e)
    return order


# ------------------------------------------------- host reference rung

def _host_column(columns, name: str):
    """A column by name, for the host evaluator and the oracle rung."""
    col = (columns or {}).get(name)
    if col is None:
        raise KeyError(
            f"no column {name!r} attached to the resident set "
            f"(DeviceBitmapSet.attach_column)")
    return col


def evaluate_host(e, sources, columns=None) -> object:
    """Bit-exact host evaluation of an expression over ``sources`` (host
    RoaringBitmaps): the reference every device rung is held against.
    ``columns`` maps names to attached columns, whose host oracles answer
    the value predicates."""
    from ..core.bitmap import RoaringBitmap

    e = canonicalize(e)
    if isinstance(e, Agg):
        raise ValueError(
            "aggregate roots evaluate through evaluate_host_agg (the "
            "result is (cardinality, value, bitmap), not a bitmap)")
    memo: dict = {}

    def ev(n):
        got = memo.get(n)
        if got is not None:
            return got
        if isinstance(n, Ref):
            if n.index < 0 or n.index >= len(sources):
                raise IndexError(
                    f"expression ref out of range 0..{len(sources) - 1}: "
                    f"{n.index}")
            v = sources[n.index]
        elif isinstance(n, AdHoc):
            v = n.bm
        elif isinstance(n, ValuePred):
            v = _host_column(columns, n.col).host_filter(n.op, n.lo, n.hi)
        elif n.op == "empty":
            # an empty set of the sources' tier (32- or 64-bit)
            v = type(sources[0])() if sources else RoaringBitmap()
        elif n.op == "andnot":
            v = ev(n.children[0]).clone()
            for r in n.children[1:]:
                v = v - ev(r)
        else:
            fn = {"or": operator.or_, "and": operator.and_,
                  "xor": operator.xor}[n.op]
            parts = [ev(c) for c in n.children]
            v = parts[0]
            for p in parts[1:]:
                v = fn(v, p)
        memo[n] = v
        return v

    out = ev(e)
    if isinstance(e, (Ref, AdHoc)):
        # a bare-leaf root must not alias the caller's source
        return out.clone()
    return out


def evaluate_host_agg(e, sources, columns=None):
    """Host-oracle evaluation of an aggregate-rooted expression ->
    ``(cardinality, value, bitmap | None)``: ``sum`` gives (found count,
    total, None), ``topk`` (k_eff, None, rows) by the Kaser scan over the
    found set's stored rows (k clamped, smallest-id tie trim)."""
    e = canonicalize(e)
    if not isinstance(e, Agg):
        raise ValueError("evaluate_host_agg needs an aggregate root")
    col = _host_column(columns, e.col)
    found = (None if e.found is None
             else evaluate_host(e.found, sources, columns))
    if e.kind == "sum":
        total, count = col.host_sum(found)
        return int(count), int(total), None
    bm = col.host_top_k(e.k, found)
    return bm.cardinality, None, bm


# ----------------------------------------------------- compiled section

def _upload(host: dict, device) -> dict:
    """Host plan arrays -> device tensors: masks as bool, index arrays and
    words as int32 (u32 words by their bits), queued through pinned memory
    on a card (``ops.words.upload``), so an upload never waits for the
    stream."""
    return {k: upload(v, device) for k, v in host.items()}


@dataclasses.dataclass
class ExprSection:
    """One compiled expression of a batch plan.

    ``kind``: "fused" (combine steps run on the device), "flat" (the root
    lowered to a bare pseudo-query), "empty" (root pruned at plan time) or
    "adhoc" (the root is an ad-hoc bitmap; resolved on the host).

    Steps (fused sections), each a tuple:
      ("leaf", K)                  value = image[host[g{i}]]
      ("adhoc", K)                 value = host[w{i}] (an ad-hoc leaf's
                                   rows, or a cached subtree's device rows)
      ("reduce", bi, slot, kq)     value = bucket_heads[bi][slot, :kq]
      ("combine", op, children, K) children = ((step, aligned), ...);
                                   non-aligned children gather through
                                   host[i{i}_{k}] masked by host[o{i}_{k}]
      ("vscan", ci, tag, S, K)     value predicate over column slot ci:
                                   predicate bits host[b{i}], host[b2{i}]
      ("vagg", kind, found, aligned, ci, S, K)
                                   aggregate root over column slot ci; the
                                   found step aligns through host[i{i}] /
                                   host[o{i}]; top-k's k is host[k{i}]
    """

    qid: int
    form: str
    kind: str
    steps: list = dataclasses.field(default_factory=list)
    root: int = -1
    root_keys: np.ndarray = None
    host: dict | None = None
    adhoc_bm: object = None
    n_nodes: int = 0
    n_reduce: int = 0
    n_combine: int = 0
    #: interior nodes served from the result cache (pre-computed operands)
    n_cached: int = 0
    depth: int = 0
    cse_saved: int = 0
    #: columns the section's vscan/vagg steps read, in column-slot order
    cols: list = dataclasses.field(default_factory=list)
    #: (kind, k) of an aggregate-rooted section (sum_/top_k), else None
    agg: tuple | None = None
    _arrays: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def signature(self):
        return (self.kind, self.form == "bitmap",
                tuple(tuple(s) for s in self.steps), self.root,
                0 if self.root_keys is None else int(self.root_keys.size))

    def device_arrays(self, device) -> dict:
        """The host arrays as device tensors, uploaded once per device."""
        key = str(device)
        if key not in self._arrays:
            self._arrays[key] = _upload(self.host, device)
        return self._arrays[key]


def _pack_adhoc(bm) -> tuple:
    """Host bitmap -> (u16 keys, u32[K, 2048] dense rows) for plan-time
    shipping of an ad-hoc leaf."""
    keys = packing._keys_of(bm)
    if keys.size == 0:
        return keys, np.zeros((0, WORDS32), np.uint32)
    words = np.stack([packing.container_words_u32(c)
                      for c in bm.containers])
    return keys, words.astype(np.uint32)


def _is_reduce(n: Expr) -> bool:
    return (isinstance(n, Node) and n.op in OPS
            and all(isinstance(c, Ref) for c in n.children))


def _align(host: dict, name: str, ck: np.ndarray, node_keys: np.ndarray
           ) -> bool:
    """Plan-time alignment of a child over keys ``ck`` onto ``node_keys``:
    True when they are equal, else host[i{name}] (gather index) and
    host[o{name}] (key present) are set."""
    if ck.size == node_keys.size and bool(np.array_equal(ck, node_keys)):
        return True
    idx = np.searchsorted(ck, node_keys).clip(
        0, max(0, ck.size - 1)).astype(np.int32)
    host[f"i{name}"] = idx
    host[f"o{name}"] = (ck[idx] == node_keys) if ck.size else \
        np.zeros(node_keys.size, bool)
    return False


def compile_query(q: ExprQuery, qid: int, plan_reduce,
                  plan_leaf, cache_probe=None,
                  col_resolve=None) -> ExprSection:
    """Compile one :class:`ExprQuery` against an engine's planner, inside an
    ``expr.compile`` span (the JAX package's tags: ``nodes`` / ``depth`` /
    ``cse_saved`` / ``kind``, and on a fused section its node and step
    counts); see :func:`_compile_query`."""
    if not obs_trace.enabled():
        return _compile_query(q, qid, plan_reduce, plan_leaf, cache_probe,
                              col_resolve)
    e = canonicalize(q.expr)
    core = e.found if isinstance(e, Agg) else e
    stats = (_dag_stats_canonical(core) if core is not None
             else {"nodes": 0, "cse_saved": 0, "depth": 0})
    with obs_trace.span("expr.compile", qid=qid, form=q.form,
                        nodes=stats["nodes"], depth=stats["depth"],
                        cse_saved=stats["cse_saved"]) as sp:
        sec = _compile_query(q, qid, plan_reduce, plan_leaf, cache_probe,
                             col_resolve)
        sp.tag(kind=sec.kind)
        if sec.kind == "fused":
            sp.tag(reduce_nodes=sec.n_reduce, combine_nodes=sec.n_combine,
                   steps=len(sec.steps),
                   root_keys=int(sec.root_keys.size),
                   cached_nodes=sec.n_cached, depth=sec.depth)
            n_value = sum(1 for st in sec.steps
                          if st[0] in ("vscan", "vagg"))
            if n_value:
                sp.tag(value_steps=n_value,
                       bsi_depth=value_depth_of([sec]),
                       agg=(sec.agg[0] if sec.agg is not None else None))
    return sec


def _compile_query(q: ExprQuery, qid: int, plan_reduce,
                  plan_leaf, cache_probe=None,
                  col_resolve=None) -> ExprSection:
    """Compile one :class:`ExprQuery` against an engine's planner.

    ``plan_reduce(batch_query, owner)`` registers a pseudo flat query in the
    engine's bucketing and returns ``(pid, keys)``; ``owner`` is the query id
    when the pseudo IS the root (read back from its bucket) and None for
    internal reduce nodes.  ``plan_leaf(index)`` returns ``(gather_rows,
    keys)`` of a resident leaf.  ``cache_probe(node)``, when given, returns
    ``(keys, words)`` of a materialized cached result for a canonical
    interior node (``mutation.result_cache``): the node then lowers as a
    pre-computed ``adhoc`` operand whose ``words`` (a device tensor) the
    plan only reads, its reduce is pruned, and ``n_cached`` counts it.
    ``col_resolve(name)`` resolves an attached
    column: value predicates lower to ``vscan`` steps over it and an
    aggregate root appends one ``vagg`` step over its found set; without a
    resolver either raises ``ValueError``.
    """
    from .batch_engine import BatchQuery

    e = canonicalize(q.expr)
    agg = e if isinstance(e, Agg) else None
    core = e.found if agg is not None else e
    stats = (_dag_stats_canonical(core) if core is not None
             else {"nodes": 0, "cse_saved": 0, "depth": 0})
    sec = ExprSection(qid=qid, form=q.form, kind="fused",
                      n_nodes=max(1, stats["nodes"] + (agg is not None)),
                      depth=stats["depth"], cse_saved=stats["cse_saved"])
    if agg is not None:
        sec.agg = (agg.kind, agg.k)
    elif isinstance(e, Node) and e.op == "empty":
        sec.kind = "empty"
        return sec
    elif isinstance(e, AdHoc):
        sec.kind, sec.adhoc_bm = "adhoc", e.bm
        return sec
    elif isinstance(e, Ref):
        plan_reduce(BatchQuery("or", (e.index,), form=q.form), qid)
        sec.kind, sec.n_reduce = "flat", 1
        return sec
    elif _is_reduce(e):
        # flat root, but prune an empty key space first (disjoint AND,
        # all-empty operands): such a query never touches the device
        leaf_keys = [plan_leaf(c.index)[1] for c in e.children]
        if e.op == "and":
            inter = leaf_keys[0]
            for k in leaf_keys[1:]:
                inter = np.intersect1d(inter, k, assume_unique=True)
            dead = inter.size == 0
        elif e.op == "andnot":
            dead = leaf_keys[0].size == 0
        else:
            dead = all(k.size == 0 for k in leaf_keys)
        if dead:
            sec.kind = "empty"
            return sec
        # child order already matches BatchQuery semantics (andnot keeps
        # its head first through canonicalization)
        ops = tuple(c.index for c in e.children)
        plan_reduce(BatchQuery(e.op, ops, form=q.form), qid)
        sec.kind, sec.n_reduce = "flat", 1
        return sec

    steps: list = []
    host: dict = {}
    keyof: dict = {}          # step idx -> np u16 key array
    memo: dict = {}           # canonical node -> step idx | None

    def add_reduce(bq) -> int | None:
        # internal pseudos stay cardinality-form: their heads are consumed
        # on the device and never read back
        pid, keys = plan_reduce(bq, None)
        if keys.size == 0:
            return None
        sec.n_reduce += 1
        si = len(steps)
        steps.append(("reduce", pid, 0, int(keys.size)))
        keyof[si] = keys
        return si

    def resolve_col(name: str):
        if col_resolve is None:
            raise ValueError(
                f"value predicate over column {name!r} but this "
                f"engine path has no column resolver (attach "
                f"columns via DeviceBitmapSet.attach_column)")
        return col_resolve(name)

    def col_slot(col) -> int:
        for i, c in enumerate(sec.cols):
            if c is col:
                return i
        sec.cols.append(col)
        return len(sec.cols) - 1

    def emit_scan(col, scan) -> int | None:
        """One value-predicate step: nothing ("empty"), the existence plane
        ("all"), or a slice-plane scan whose predicate bits ride as host
        arrays."""
        if scan[0] == "empty":
            return None
        si = len(steps)
        ci = col_slot(col)
        if scan[0] == "all":
            steps.append(("vscan", ci, "col:all", col.depth_pad,
                          int(col.keys.size)))
        else:
            _, tag, bits, bits2 = scan
            steps.append(("vscan", ci, tag, col.depth_pad,
                          int(col.keys.size)))
            host[f"b{si}"] = np.asarray(bits, np.int32)
            host[f"b2{si}"] = np.asarray(bits2, np.int32)
        keyof[si] = col.keys
        return si

    def emit_agg(col, found_si: int) -> int:
        """The aggregate head over the found step, aligned onto the
        column's keys: one ``vagg`` step (sum's per-slice popcounts or
        top-k's Kaser scan)."""
        si = len(steps)
        ci = col_slot(col)
        ck = col.keys
        aligned = _align(host, str(si), keyof[found_si], ck)
        if agg.kind == "topk":
            host[f"k{si}"] = np.asarray(agg.k, np.int32)
        steps.append(("vagg", agg.kind, found_si, aligned, ci,
                      col.depth_pad, int(ck.size)))
        keyof[si] = ck
        return si

    def emit(n) -> int | None:
        if n not in memo:
            si = emit_cached(n)
            memo[n] = _emit(n) if si is _MISS else si
        return memo[n]

    _MISS = object()

    def emit_cached(n):
        """Cached-subtree injection: an interior node with materialized
        cached rows lowers as a pre-computed operand step, served instead
        of planned; ``_MISS`` when the cache has nothing."""
        if cache_probe is None or not isinstance(n, Node) or n.op == "empty":
            return _MISS
        hit = cache_probe(n)
        if hit is None:
            return _MISS
        keys_c, words_c = hit
        sec.n_cached += 1
        if keys_c.size == 0:
            # a cached empty result prunes like any empty operand
            return None
        si = len(steps)
        steps.append(("adhoc", int(keys_c.size)))
        host[f"w{si}"] = words_c
        keyof[si] = keys_c
        return si

    def _emit(n) -> int | None:
        if isinstance(n, ValuePred):
            col = resolve_col(n.col)
            return emit_scan(col, col.scan_plan(n.op, n.lo, n.hi))
        if isinstance(n, Ref):
            rows, keys = plan_leaf(n.index)
            if keys.size == 0:
                return None
            si = len(steps)
            steps.append(("leaf", int(keys.size)))
            host[f"g{si}"] = np.asarray(rows, np.int32)
            keyof[si] = keys
            return si
        if isinstance(n, AdHoc):
            keys, words = _pack_adhoc(n.bm)
            if keys.size == 0:
                return None
            si = len(steps)
            steps.append(("adhoc", int(keys.size)))
            host[f"w{si}"] = words
            keyof[si] = keys
            return si
        if n.op == "empty":
            return None
        if _is_reduce(n):
            return add_reduce(BatchQuery(
                n.op, tuple(c.index for c in n.children),
                form="cardinality"))
        # interior combine node: sibling leaf runs of or/and/xor become
        # synthetic reduces (>= 2 refs)
        children = list(n.children)
        if n.op in _ASSOC:
            refs = [c for c in children if isinstance(c, Ref)]
            if len(refs) >= 2 and len(refs) < len(children):
                rest = [c for c in children if not isinstance(c, Ref)]
                if n.op == "or":
                    run = add_reduce(BatchQuery(
                        "or", tuple(r.index for r in refs),
                        form="cardinality"))
                    return _combine("or", [run] + [emit(c) for c in rest])
                # and/xor leaf runs stay reduce nodes of their own op
                sub = Node(n.op, tuple(refs))
                return _combine(n.op, [emit(sub)] + [emit(c) for c in rest])
        if n.op == "andnot":
            head_ci = emit(children[0])
            rest_cis = [emit(c) for c in children[1:]]
            return _combine("andnot", [head_ci] + rest_cis)
        return _combine(n.op, [emit(c) for c in children])

    def _combine(op: str, cis: list) -> int | None:
        if op == "andnot":
            head = cis[0]
            if head is None:
                return None             # 0 & ~x == 0
            rest = [c for c in cis[1:] if c is not None]
            if not rest:
                return head             # x & ~0 == x
            cis = [head] + rest
            node_keys = keyof[head]
        elif op == "and":
            if any(c is None for c in cis):
                return None             # empty annihilates
            node_keys = keyof[cis[0]]
            for c in cis[1:]:
                node_keys = np.intersect1d(node_keys, keyof[c],
                                           assume_unique=True)
            if node_keys.size == 0:
                return None             # disjoint key spaces
        else:                           # or / xor
            cis = [c for c in cis if c is not None]
            if not cis:
                return None
            if len(cis) == 1:
                return cis[0]
            node_keys = keyof[cis[0]]
            for c in cis[1:]:
                node_keys = np.union1d(node_keys, keyof[c])
        # node keys keep the set's key dtype: a u16 cast would fold the
        # 64-bit tier's u48 keys onto each other
        sec.n_combine += 1
        si = len(steps)
        spec = [(ci, _align(host, f"{si}_{k}", keyof[ci], node_keys))
                for k, ci in enumerate(cis)]
        steps.append(("combine", op, tuple(spec), int(node_keys.size)))
        keyof[si] = node_keys
        return si

    if agg is not None:
        agg_col = resolve_col(agg.col)
        if core is None:
            # found=None: the column's whole stored domain, the existence
            # plane as the found step
            found_si = emit_scan(agg_col, ("all",) if agg_col.keys.size
                                 else ("empty",))
        else:
            found_si = emit(core)
        root = None if found_si is None else emit_agg(agg_col, found_si)
    else:
        root = emit(e)
    if root is None:
        sec.kind = "empty"
        return sec
    sec.steps, sec.root = steps, root
    sec.root_keys = keyof[root]
    sec.host = host
    return sec


def fused_of(sections) -> list:
    """The sections whose combine steps run on the device."""
    return [s for s in sections if s.kind == "fused"]


def signature_of(sections) -> tuple:
    """The expression half of a plan signature."""
    return tuple(s.signature for s in sections)


def finalize_sections(sections, buckets) -> None:
    """Resolve reduce steps' pseudo-query ids to their bucket slots, after
    ``plan_bucket`` assigned them (bucket ``qids`` carry the pids)."""
    loc = {pid: (bi, slot, b.keys[slot].size)
           for bi, b in enumerate(buckets)
           for slot, pid in enumerate(b.qids)}
    for sec in fused_of(sections):
        for si, st in enumerate(sec.steps):
            if st[0] == "reduce":
                bi, slot, kq = loc[st[1]]
                sec.steps[si] = ("reduce", bi, slot, kq)


def expr_bucket_ids(sections) -> frozenset:
    """Bucket indices whose heads fused combine steps consume."""
    return frozenset(
        st[1] for sec in fused_of(sections)
        for st in sec.steps if st[0] == "reduce")


# ------------------------------------------------------ device combines

def _gather(v, arrs: dict, name: str, n: int):
    """``v`` aligned through host[i{name}] and masked by host[o{name}]."""
    if not v.shape[0]:
        return v.new_zeros((n, WORDS32))
    return torch.where(arrs[f"o{name}"][:, None], v[arrs[f"i{name}"]], 0)


def traced_bucket_heads(buckets, op_groups, group_outs,
                        live_ok: bool) -> list:
    """Per-op group flat heads (``parallel.multiset``) sliced back into
    per-bucket ``[q, k_pad, 2048]`` blocks on the device, so that fused
    combine steps read reduce nodes without a readback.  ``live_ok`` follows
    the pooled engine's layout rule: a regular group's outputs hold one live
    slot per query on the plain rung ("torch"), the padded ``k_pad + 1``
    slots on the kernel rungs."""
    out: list = [None] * len(buckets)
    for grp, (heads_f, _cards) in zip(op_groups, group_outs):
        if heads_f is None:
            continue
        live = live_ok and grp.regular
        for bi, s0 in zip(grp.bucket_idx, grp.seg_offs):
            b = buckets[bi]
            if live:
                s0l = s0 // 2
                out[bi] = heads_f[s0l:s0l + b.q].view(b.q, 1, WORDS32)
            else:
                n = b.q * (b.k_pad + 1)
                out[bi] = heads_f[s0:s0 + n].view(
                    b.q, b.k_pad + 1, WORDS32)[:, :b.k_pad]
    return out


def eval_section(sec: ExprSection, arrs: dict, words, bucket_heads,
                 cols=(), device_scalars: bool = False):
    """Fused evaluation of one section on the device: walk the compiled
    steps bottom-up with plain PyTorch combines and plane scans.  ``cols``
    holds the section's column ``(slices, ebm)`` operands in slot order.
    ``device_scalars`` reads the predicate bits and top-k's k from ``arrs``
    (device tensors; the scans are then branch-free) instead of the plan's
    host arrays: a captured program replays other plans of its signature,
    whose predicate values differ.
    Returns ``(heads | None, cards)``, heads int32[K_root, 2048] only for
    bitmap-form roots; an aggregate root returns its own pair: sum
    ``(int32[S, K] per-(slice, key) cards, int32[K_found] found cards)``,
    top-k ``(int32[K, 2048] words, int32[K] cards)``."""
    from ..analytics import plane

    vals: list = [None] * len(sec.steps)
    for si, st in enumerate(sec.steps):
        kind = st[0]
        if kind == "leaf":
            v = words[arrs[f"g{si}"]]
        elif kind == "adhoc":
            v = arrs[f"w{si}"]
        elif kind == "reduce":
            _, bi, slot, kq = st
            v = bucket_heads[bi][slot, :kq]
        elif kind == "vscan":
            _, ci, tag, _depth, _kc = st
            slices, ebm = cols[ci]
            src = arrs if device_scalars else sec.host
            v = plane.scan_words(tag, slices, ebm, src.get(f"b{si}"),
                                 src.get(f"b2{si}"))
        elif kind == "vagg":
            _, akind, fi, aligned, ci, _depth, kc = st
            slices, ebm = cols[ci]
            f = vals[fi]
            fc = f if aligned else _gather(f, arrs, str(si), kc)
            if akind == "sum":
                v = (plane.sum_cards(slices, fc), dense.popcount(f))
            else:
                k = (arrs[f"k{si}"] if device_scalars
                     else int(sec.host[f"k{si}"]))
                res = plane.topk_words(slices, fc & ebm, k)
                v = (res, dense.popcount(res))
        else:
            _, op, children, kn = st
            parts = [vals[ci] if aligned else
                     _gather(vals[ci], arrs, f"{si}_{k}", kn)
                     for k, (ci, aligned) in enumerate(children)]
            if op == "andnot":
                rest = parts[1]
                for p in parts[2:]:
                    rest = rest | p
                v = parts[0] & ~rest
            else:
                fn = dense.OPS[op]
                v = parts[0]
                for p in parts[1:]:
                    v = fn(v, p)
        vals[si] = v
    rootv = vals[sec.root]
    if sec.agg is not None:
        return rootv
    return (rootv if sec.form == "bitmap" else None), dense.popcount(rootv)


def eval_sections(sections, words, bucket_heads, arrays=None,
                  cols=None) -> list:
    """Every fused section on the device.  ``arrays`` / ``cols`` (per
    section: its operand dict / its columns' ``(slices, ebm)``) default to
    the plan's own; a captured program passes its static ones, and the
    scans then read their predicates from them (``device_scalars``)."""
    static = arrays is not None
    if arrays is None:
        arrays = [sec.device_arrays(words.device) for sec in sections]
        cols = [[c.device_operands() for c in sec.cols] for sec in sections]
    return [eval_section(sec, arrs, words, bucket_heads, cs,
                         device_scalars=static)
            for sec, arrs, cs in zip(sections, arrays, cols)]


def value_depth_of(sections) -> int:
    """Max padded slice depth across the sections' value steps: the ``bsi``
    dimension of the lattice snap (0 = no value steps)."""
    depth = 0
    for s in fused_of(sections):
        for st in s.steps:
            if st[0] == "vscan":
                depth = max(depth, int(st[3]))
            elif st[0] == "vagg":
                depth = max(depth, int(st[5]))
    return depth


def assemble_section_result(sec: ExprSection, out, form: str,
                            empty_cls=None):
    """Host readback of one section -> (cardinality, bitmap | None,
    value | None).  ``out`` is the device pair of a fused section (the
    aggregate pair for an aggregate root), ignored for empty/adhoc
    ones.  ``empty_cls`` is the class of an empty result: the resident
    set's tier (``RoaringBitmap`` by default)."""
    from ..core.bitmap import RoaringBitmap

    empty_cls = empty_cls or RoaringBitmap
    if sec.agg is not None:
        return _assemble_agg(sec, out, form)
    if sec.kind == "empty":
        return 0, (empty_cls() if form == "bitmap" else None), None
    if sec.kind == "adhoc":
        bm = sec.adhoc_bm
        return (bm.cardinality, bm.clone() if form == "bitmap" else None,
                None)
    heads, cards = out
    cards = cards.cpu().numpy()
    bm = None
    if form == "bitmap":
        bm = packing.unpack_result(sec.root_keys, to_u32(heads), cards)
    return int(cards.sum()), bm, None


def _assemble_agg(sec: ExprSection, out, form: str):
    """Aggregate readback: sum weights the per-slice popcounts by 2^i in
    Python ints (exact past 64 bits); top-k unpacks its rows and applies
    the smallest-id tie trim."""
    from ..bsi.slice_index import trim_smallest
    from ..core.bitmap import RoaringBitmap

    akind, k = sec.agg
    if sec.kind == "empty":
        if akind == "sum":
            return 0, None, 0
        return 0, (RoaringBitmap() if form == "bitmap" else None), None
    if akind == "sum":
        slice_cards, found_cards = out
        per_slice = slice_cards.sum(dim=1, dtype=torch.int64).cpu().numpy()
        total = sum((1 << i) * int(c) for i, c in enumerate(per_slice))
        return int(found_cards.sum(dtype=torch.int64)), None, total
    words, cards = out
    bm = trim_smallest(packing.unpack_result(
        sec.root_keys, to_u32(words), cards.cpu().numpy()), k)
    return bm.cardinality, (bm if form == "bitmap" else None), None


def assemble_section_results(sections, expr_outs, results, form_of,
                             empty_cls=None) -> list:
    """Fill ``results`` in place for every non-flat section (flat roots were
    read back from their buckets).  ``expr_outs`` aligns with the fused
    subset, in order; ``empty_cls`` as in ``assemble_section_result``."""
    from .batch_engine import BatchResult

    fi = 0
    for sec in sections:
        if sec.kind == "flat":
            continue
        out = None
        if sec.kind == "fused":
            out = expr_outs[fi]
            fi += 1
        card, bm, value = assemble_section_result(sec, out,
                                                  form_of(sec.qid), empty_cls)
        results[sec.qid] = BatchResult(cardinality=card, bitmap=bm,
                                       value=value)
    return results


# ------------------------------------------------- workload generator

def execute_node_at_a_time(engine, queries) -> list:
    """The unfused baseline the fused B5 path is compared with: every
    reduce node of every expression is its own one-query
    ``BatchEngine.execute`` (one B1 launch on the card, after B3 for a
    compact set), its bitmap read back, and the combines run on the host.
    ``Agg`` roots go through ``analytics.two_phase_execute``.  Bit-exact
    with the fused path by construction."""
    from .batch_engine import BatchQuery, BatchResult

    out = []
    for q in queries:
        if isinstance(q, BatchQuery):
            out.append(engine.execute([q])[0])
            continue
        e = canonicalize(q.expr)
        if isinstance(e, Agg):
            from ..analytics.two_phase import two_phase_execute

            out.extend(two_phase_execute(engine, [q]))
            continue
        memo: dict = {}

        def ev(n):
            got = memo.get(n)
            if got is not None:
                return got
            if isinstance(n, Ref):
                v = engine._ds.host_bitmaps()[n.index]
            elif isinstance(n, AdHoc):
                v = n.bm
            elif isinstance(n, ValuePred):
                v = engine._column(n.col).host_filter(n.op, n.lo, n.hi)
            elif n.op == "empty":
                v = engine._empty_cls()
            elif _is_reduce(n):
                ops = tuple(c.index for c in n.children)
                v = engine.execute(
                    [BatchQuery(n.op, ops, form="bitmap")])[0].bitmap
            elif n.op == "andnot":
                v = ev(n.children[0]).clone()
                for r in n.children[1:]:
                    v = v - ev(r)
            else:
                fn = {"or": operator.or_, "and": operator.and_,
                      "xor": operator.xor}[n.op]
                parts = [ev(c) for c in n.children]
                v = parts[0]
                for p in parts[1:]:
                    v = fn(v, p)
            memo[n] = v
            return v

        rb = ev(e)
        if isinstance(e, (Ref, AdHoc)):
            # a bare-leaf root must not alias the set's host copies or
            # the AdHoc snapshot
            rb = rb.clone()
        out.append(BatchResult(
            cardinality=rb.cardinality,
            bitmap=rb if q.form == "bitmap" else None))
    return out


def random_expr_pool(n_bitmaps: int, q: int, depth: int = 2,
                     seed: int = 0xDA6, form: str = "cardinality",
                     max_fan: int = 3) -> list:
    """Deterministic depth-``depth`` expression pool over ``n_bitmaps``
    residents (the JAX package's generator: the same seed gives the same
    pool).  Mixes or/and/xor/andnot interior nodes with leaf-level reduce
    chains; one query in four carries a ``not_`` term."""
    if n_bitmaps < 2:
        raise ValueError("expression pool needs at least 2 residents")
    rng = np.random.default_rng(seed)

    def leaf_chain():
        k = int(rng.integers(2, min(5, n_bitmaps + 1)))
        refs = [int(x) for x in rng.choice(n_bitmaps, size=k,
                                           replace=False)]
        op = ("or", "xor", "and")[int(rng.integers(3))]
        return Node(op, tuple(Ref(r) for r in refs))

    def build(d):
        if d <= 1:
            return leaf_chain()
        fan = int(rng.integers(2, max_fan + 1))
        kids = tuple(build(d - 1) for _ in range(fan))
        op = ("or", "and", "xor", "andnot")[int(rng.integers(4))]
        return Node(op, kids)

    pool = []
    for i in range(q):
        e = build(depth)
        if i % 4 == 3:
            e = Node("and", (e, Node("not", (Ref(int(
                rng.integers(n_bitmaps))),))))
        pool.append(ExprQuery(e, form=form))
    return pool


def rung_expressions(depth: int, n_residents: int,
                     form: str = "cardinality") -> list:
    """Representative depth-``depth`` op-mix shapes for warmup (the JAX
    package's DAGs): deterministic, so a warmed engine's first matching
    execute hits its plan and program caches."""
    r = [Ref(i % n_residents) for i in range(4)]
    base = [Node("or", (r[0], r[1])), Node("xor", (r[2], r[3])),
            Node("and", (r[0], r[2]))]
    exprs = [Node("and", (base[0], base[1])),
             Node("or", (base[1], base[2])),
             Node("andnot", (base[0], r[2])),
             Node("and", (base[0], Node("not", (r[3],))))]
    for _ in range(max(0, depth - 2)):
        exprs = [Node("or", (exprs[0], exprs[1])),
                 Node("and", (exprs[1], exprs[2])),
                 Node("andnot", (exprs[2], exprs[3].children[0])),
                 Node("xor", (exprs[3], exprs[0]))]
    return [ExprQuery(e, form=form) for e in exprs]


def parse_warmup_rung(r):
    """The warmup rung vocabulary of the engines: an int is a pow2 operand
    rung (flat shapes); ``"expr"``, ``"expr:3"`` or ``("expr", 3)`` an
    expression rung at that depth; ``"delta:8"`` / ``("delta", 8)`` a
    mutation patch rung of that many rows."""
    if isinstance(r, str) and r.startswith("expr"):
        _, _, d = r.partition(":")
        return "expr", int(d) if d else 2
    if isinstance(r, str) and r.startswith("delta"):
        _, _, d = r.partition(":")
        return "delta", int(d) if d else 8
    if isinstance(r, tuple) and len(r) == 2 and r[0] in ("expr", "delta"):
        return r[0], int(r[1])
    return "flat", int(r)


# ---------------------------------------------------------- accounting

def record_fused_dispatch(site: str, sections) -> None:
    """Metric bump at a device-dispatch site carrying expressions:
    ``rb_expr_nodes_fused`` counts DAG op nodes executed fused;
    ``rb_expr_launches_saved_total`` credits the launches a
    node-at-a-time evaluator (one launch per op node) would have paid
    beyond the expression's share of this one dispatch."""
    sections = [s for s in sections if s is not None]
    if not sections:
        return
    nodes = sum(s.n_nodes for s in sections)
    obs_metrics.counter("rb_expr_nodes_fused", site=site).inc(nodes)
    saved = sum(max(0, s.n_nodes - 1) for s in sections)
    if saved:
        obs_metrics.counter("rb_expr_launches_saved_total",
                            site=site).inc(saved)


def record_analytics_dispatch(site: str, sections, span) -> None:
    """Analytics accounting at a device-dispatch site: count the fused
    vscan/vagg steps (``rb_analytics_scans_total`` /
    ``rb_analytics_aggs_total``) and attach the ``analytics.scan``
    event."""
    scans = aggs = 0
    for s in sections:
        if s is None or s.kind != "fused":
            continue
        for st in s.steps:
            if st[0] == "vscan":
                scans += 1
            elif st[0] == "vagg":
                aggs += 1
    if not scans and not aggs:
        return
    obs_metrics.counter("rb_analytics_scans_total", site=site).inc(scans)
    if aggs:
        obs_metrics.counter("rb_analytics_aggs_total",
                            site=site).inc(aggs)
    span.event("analytics.scan", site=site, scans=scans, aggs=aggs,
               bsi_depth=value_depth_of(sections))
