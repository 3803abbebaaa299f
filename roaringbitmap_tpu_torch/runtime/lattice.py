"""Closed program-signature lattice: a bounded vocabulary of device programs
(``roaringbitmap_tpu.runtime.lattice``).

Every engine runs one device program per *plan signature*: the padded
bucket shapes, the op mix, the pooled row selection, the expression
sections.  The pow2 bucketing bounds each dimension locally, but the cross
product of what traffic can request is unbounded.  This module closes the
signature space one level above ``plan_bucket``:

- a :class:`Lattice` is a small per-dimension rung vocabulary (op set x
  pow2 Q x pow2 rows x pow2 key slots x heads plane x expression
  shape-class x pow2 pooled rows x engine rung x placement x delta rung x
  analytics depth);
- :meth:`Lattice.snap` pads any concrete plan shape UP to its covering
  lattice point (dead queries, dead rows, identity padding);
- :meth:`Lattice.enumerate_points` materializes the finite vocabulary, so
  that ``warmup(profile=...)`` can build every program of it at boot;
- after :meth:`Lattice.seal` (the end of warmup) any new program is an
  *escape*: counted by site, and recorded with its point.

On the card a program is a captured CUDA graph (``runtime.programs``); its
"compile" time is the capture time.  Escapes and padding go to the obs
registry as in the JAX package (``rb_lattice_escapes_total{site}``,
``rb_lattice_padding_bytes{site}``, ``rb_lattice_padding_fraction{site}``),
and each escape is a ``lattice.escape`` event on the current span.
``ROARING_TPU_WARMUP_PROFILE`` activates a lattice from the environment.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

_log = logging.getLogger("roaringbitmap_tpu_torch.runtime")

ENV_PROFILE = "ROARING_TPU_WARMUP_PROFILE"

#: canonical op order (sorted; ``plan()`` iterates groups sorted by op)
OPS = ("and", "andnot", "or", "xor")


def _pow2_ladder(n: int) -> tuple:
    """(1, 2, 4, ..., next_pow2(n)): the rungs of a numeric dimension given
    only its ceiling."""
    out, v = [], 1
    n = max(1, int(n))
    while v < n:
        out.append(v)
        v *= 2
    out.append(v)
    return tuple(out)


def _cover(value: int, rungs: tuple) -> int | None:
    """Smallest rung >= value, or None past the lattice maximum."""
    for r in rungs:
        if r >= value:
            return r
    return None


@dataclasses.dataclass(frozen=True)
class ProgramSignature:
    """One lattice point.  ``ops`` is the (sorted) op set the plan carries
    one bucket per; ``q``/``rows``/``keys`` the shared padded bucket shape;
    ``heads`` whether the bitmap output plane is built; ``expr`` the
    expression shape-class depth (0 = flat only); ``pool`` the per-tenant
    pooled row-selection rung (0 = single set); ``delta`` the mutation
    patch rung (0 = a query program); ``bsi`` the padded slice depth of the
    plan's value scans (0 = none)."""

    ops: tuple = OPS
    q: int = 1
    rows: int = 1
    keys: int = 1
    heads: bool = False
    expr: int = 0
    pool: int = 0
    engine: str = "auto"
    placement: str = "auto"
    delta: int = 0
    bsi: int = 0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ops"] = list(self.ops)
        return d


@dataclasses.dataclass
class Lattice:
    """The closed vocabulary.  Dimension fields are ascending tuples; the
    lifecycle (seal state, escape count, warmed expression signatures, the
    warmup pin) is left out of equality, so the profile round trip
    compares vocabularies."""

    q: tuple = _pow2_ladder(64)
    rows: tuple = _pow2_ladder(64)
    keys: tuple = _pow2_ladder(8)
    pool: tuple = _pow2_ladder(256)
    op_sets: tuple = (OPS,)
    heads: tuple = (False, True)
    expr: tuple = (0,)
    engines: tuple = ("auto",)
    placements: tuple = ("auto",)
    delta: tuple = ()
    #: analytics slice-depth rungs; empty = value traffic is out of the
    #: vocabulary
    bsi: tuple = ()
    sealed: bool = dataclasses.field(default=False, compare=False)
    escapes: int = dataclasses.field(default=0, compare=False)
    _pin: object = dataclasses.field(default=None, compare=False,
                                     repr=False)
    #: expression signatures the warmup built (a novel DAG at a warmed
    #: depth is still a new program, so still an escape)
    _expr_sigs: set = dataclasses.field(default_factory=set,
                                        compare=False, repr=False)

    def __post_init__(self):
        for name in ("q", "rows", "keys", "pool", "expr", "delta", "bsi"):
            setattr(self, name, tuple(sorted(
                {int(v) for v in getattr(self, name)})))
        self.op_sets = tuple(sorted(
            {tuple(sorted(s)) for s in self.op_sets}))
        self.heads = tuple(sorted(bool(h) for h in self.heads))
        self.engines = tuple(sorted(str(e) for e in self.engines))
        self.placements = tuple(sorted(str(p) for p in self.placements))
        if 0 not in self.expr:
            self.expr = (0,) + self.expr
        for s in self.op_sets:
            bad = [op for op in s if op not in OPS]
            if bad:
                raise ValueError(f"unknown ops in lattice op set: {bad}")

    # ------------------------------------------------------------ snapping

    def _dim(self, value: int, rungs: tuple, pinned: int | None):
        got = _cover(value, rungs)
        if got is None:
            return None
        if pinned is not None and pinned >= value and pinned in rungs:
            return max(got, pinned)
        return got

    def snap_ops(self, present) -> tuple | None:
        """Smallest covering op set in the vocabulary (ties toward fewer dead
        buckets), or None when nothing covers."""
        need = frozenset(present)
        best = None
        pin = self._pin.ops if self._pin is not None else None
        if pin is not None and need <= frozenset(pin) \
                and tuple(sorted(pin)) in self.op_sets:
            return tuple(sorted(pin))
        for s in self.op_sets:
            if need <= frozenset(s) and (best is None or len(s) < len(best)):
                best = s
        return best

    def snap(self, *, ops, q: int, rows: int, keys: int, heads: bool,
             expr: int = 0, pool: int = 0, placement: str = "auto",
             bsi: int = 0) -> ProgramSignature | None:
        """The covering lattice point of a concrete plan shape, or None when
        any dimension is beyond the vocabulary (the plan then keeps its
        exact pow2 shapes and its first program is an escape).  Inside a
        warmup ``pin`` the pinned point wins wherever it covers the need."""
        p = self._pin
        ops_s = self.snap_ops(ops)
        q_s = self._dim(max(1, q), self.q, p.q if p else None)
        r_s = self._dim(max(1, rows), self.rows, p.rows if p else None)
        k_s = self._dim(max(1, keys), self.keys, p.keys if p else None)
        pool_s = 0
        if pool:
            pool_s = self._dim(pool, self.pool, p.pool if p else None)
        expr_s = 0
        if expr:
            expr_s = _cover(expr, tuple(d for d in self.expr if d))
        bsi_s = 0
        if bsi:
            bsi_s = _cover(bsi, self.bsi)
            if bsi_s is None:
                return None     # analytics depth beyond the vocabulary
        heads_s = bool(heads)
        if p is not None and p.heads and not heads_s:
            heads_s = True
        if heads_s not in self.heads:
            if True in self.heads and not heads_s:
                heads_s = True      # widen: a heads plane covers both
            else:
                return None
        if (ops_s is None or q_s is None or r_s is None or k_s is None
                or (pool and pool_s is None) or (expr and not expr_s)):
            return None
        if placement not in self.placements \
                and "auto" not in self.placements:
            return None
        return ProgramSignature(ops=ops_s, q=q_s, rows=r_s, keys=k_s,
                                heads=heads_s, expr=expr_s, pool=pool_s,
                                placement=placement, bsi=bsi_s)

    def contains(self, point: ProgramSignature | None) -> bool:
        """Vocabulary membership of a point (``engine`` and ``placement``
        treat a vocabulary ``"auto"`` as a wildcard)."""
        if point is None:
            return False
        if point.delta:
            return point.delta in self.delta
        if point.bsi and point.bsi not in self.bsi:
            return False
        return (tuple(sorted(point.ops)) in self.op_sets
                and point.q in self.q and point.rows in self.rows
                and point.keys in self.keys
                and point.heads in self.heads
                and point.expr in self.expr
                and (point.pool == 0 or point.pool in self.pool)
                and (point.engine in self.engines or "auto" in self.engines)
                and (point.placement in self.placements
                     or "auto" in self.placements))

    @contextlib.contextmanager
    def pin(self, point: ProgramSignature):
        """Warmup context: ``snap`` prefers ``point`` wherever it covers the
        need, so a representative mini-batch builds the program of the
        TARGET point instead of its own minimal covering shape."""
        prev, self._pin = self._pin, point
        try:
            yield self
        finally:
            self._pin = prev

    # --------------------------------------------------------- enumeration

    def enumerate_points(self, pooled: bool = False) -> list:
        """The finite vocabulary: flat points are the cross product of the
        shape dimensions (pooled engines add the pooled-row rung);
        expression depths, analytics depths and delta rungs one point each."""
        pts = []
        pools = self.pool if pooled else (0,)
        for ops in self.op_sets:
            for q in self.q:
                for rows in self.rows:
                    for keys in self.keys:
                        for heads in self.heads:
                            for pool in pools:
                                pts.append(ProgramSignature(
                                    ops=ops, q=q, rows=rows, keys=keys,
                                    heads=bool(heads), pool=pool))
        for d in self.expr:
            if d:
                pts.append(ProgramSignature(expr=d))
        for d in self.bsi:
            pts.append(ProgramSignature(bsi=d))
        for d in self.delta:
            pts.append(ProgramSignature(ops=(), delta=d))
        return pts

    def n_points(self, pooled: bool = False) -> int:
        """Vocabulary size, computed without materializing it."""
        flat = (len(self.op_sets) * len(self.q) * len(self.rows)
                * len(self.keys) * len(self.heads)
                * (len(self.pool) if pooled else 1))
        return (flat + sum(1 for d in self.expr if d)
                + len(self.bsi) + len(self.delta))

    # ------------------------------------------------------------ lifecycle

    def seal(self) -> None:
        """End of warmup: every later new program counts as an escape."""
        self.sealed = True

    def note_expr(self, sig) -> None:
        self._expr_sigs.add(sig)

    def expr_known(self, sig) -> bool:
        return sig in self._expr_sigs

    # --------------------------------------------------------- serialization

    def to_profile(self) -> str:
        """Canonical profile string; ``from_profile`` round-trips it."""
        def num(vals):
            # a single rung keeps its trailing comma so the parse stays an
            # explicit list, not a bare-ceiling pow2 ladder
            return (",".join(str(v) for v in vals)
                    + ("," if len(vals) == 1 else ""))

        dims = [
            "q=" + num(self.q),
            "rows=" + num(self.rows),
            "keys=" + num(self.keys),
            "pool=" + num(self.pool),
            "ops=" + "|".join(",".join(s) for s in self.op_sets),
            "heads=" + ("both" if len(self.heads) == 2
                        else ("bitmap" if self.heads[0] else
                              "cardinality")),
            "expr=" + ",".join(str(v) for v in self.expr),
            "engines=" + ",".join(self.engines),
            "placements=" + ",".join(self.placements),
        ]
        if self.bsi:
            dims.append("bsi=" + num(self.bsi))
        if self.delta:
            dims.append("delta=" + num(self.delta))
        return ";".join(dims)

    @classmethod
    def from_profile(cls, spec) -> "Lattice":
        """A lattice from a traffic profile: a Lattice (passed through), a
        dict of dimension overrides, or the ``ROARING_TPU_WARMUP_PROFILE``
        grammar::

            q=64;rows=256;keys=16;ops=or,and,xor,andnot;heads=both;
            expr=2;pool=512;delta=8

        A numeric dimension takes one ceiling (the full pow2 ladder up to
        it) or an explicit comma list of rungs ("q=8,64", or "q=64," for one
        rung): sparse lists bound the vocabulary while still covering all
        traffic under the maxima."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            spec = parse_profile(spec)
        kw = dict(spec)
        for name in ("q", "rows", "keys", "pool"):
            v = kw.get(name)
            if isinstance(v, int):
                kw[name] = _pow2_ladder(v)
        if isinstance(kw.get("delta"), int):
            kw["delta"] = (kw["delta"],)
        if isinstance(kw.get("bsi"), int):
            kw["bsi"] = (kw["bsi"],)
        if isinstance(kw.get("expr"), int):
            kw["expr"] = (0, kw["expr"]) if kw["expr"] else (0,)
        return cls(**kw)


def parse_profile(s: str) -> dict:
    """``ROARING_TPU_WARMUP_PROFILE`` grammar -> Lattice kwargs."""
    out: dict = {}
    for part in s.split(";"):
        part = part.strip()
        if not part:
            continue
        key, _, val = part.partition("=")
        key, val = key.strip(), val.strip()
        if key in ("q", "rows", "keys", "pool", "expr", "delta", "bsi"):
            vals = tuple(int(v) for v in val.split(",") if v != "")
            out[key] = vals[0] if ("," not in val
                                   and key not in ("expr",)) else vals
        elif key == "ops":
            out["op_sets"] = tuple(
                tuple(sorted(op.strip() for op in group.split(",")))
                for group in val.split("|"))
        elif key == "heads":
            out["heads"] = {"both": (False, True), "bitmap": (True,),
                            "cardinality": (False,)}[val]
        elif key == "engines":
            out["engines"] = tuple(v.strip() for v in val.split(","))
        elif key == "placements":
            out["placements"] = tuple(v.strip() for v in val.split(","))
        else:
            raise ValueError(
                f"unknown lattice profile dimension {key!r} in {s!r}")
    return out


# ----------------------------------------------------------- module state

_active: Lattice | None = None
_generation = 0


def activate(lat: Lattice | str | dict) -> Lattice:
    """Make ``lat`` THE process lattice: every engine's planner snaps
    through it from the next plan on (plan caches key on the lattice
    generation, so a stale unsnapped plan never replays)."""
    global _active, _generation
    _active = Lattice.from_profile(lat)
    _generation += 1
    return _active


def deactivate() -> None:
    global _active, _generation
    _active = None
    _generation += 1


def active() -> Lattice | None:
    return _active


def refresh_from_env() -> Lattice | None:
    """Re-read ``ROARING_TPU_WARMUP_PROFILE``: set -> activate a lattice
    from it (idempotent per value), unset -> leave the programmatic state
    alone.  Called at import.  A malformed profile logs one warning and
    activates nothing; the explicit ``warmup(profile=...)`` and
    ``activate()`` paths still raise."""
    spec = os.environ.get(ENV_PROFILE)
    if spec:
        try:
            lat = Lattice.from_profile(spec)
        except (ValueError, KeyError, TypeError) as exc:
            _log.warning("%s=%r is not a valid lattice profile, no "
                         "lattice activated: %s", ENV_PROFILE, spec, exc)
            return _active
        if _active is None or _active != lat:
            return activate(lat)
        return _active
    return _active


def plan_token():
    """The lattice part of every plan-cache key: None while no lattice is
    active, else (generation, warmup pin)."""
    if _active is None:
        return None
    return (_generation, _active._pin)


def note_compile(site: str, engine: str, point, compile_s: float) -> bool:
    """Called by every engine's program-cache miss.  Before the seal a new
    program is the expected cold path; after it, any new program is an
    escape: counted in ``rb_lattice_escapes_total{site}`` and traced as a
    ``lattice.escape`` event (``site``, ``engine``, ``in_vocabulary``,
    ``compile_ms`` and ``point``).  Returns True when an escape was
    recorded."""
    lat = _active
    if lat is None or not lat.sealed:
        return False
    lat.escapes += 1
    obs_metrics.counter("rb_lattice_escapes_total", site=site).inc()
    ev = {"site": site, "engine": engine,
          "in_vocabulary": lat.contains(point),
          "compile_ms": round(compile_s * 1e3, 3)}
    if point is not None:
        ev["point"] = point.as_dict()
    obs_trace.current().event("lattice.escape", **ev)
    return True


def record_padding(site: str, padding_bytes: int, fraction: float) -> None:
    """Per-dispatch padding: the bytes the snapped shapes stream beyond the
    exact plan (``rb_lattice_padding_bytes``), and the padded fraction of
    the latest dispatch (``rb_lattice_padding_fraction``)."""
    if padding_bytes:
        obs_metrics.counter("rb_lattice_padding_bytes",
                            site=site).inc(padding_bytes)
    obs_metrics.gauge("rb_lattice_padding_fraction",
                      site=site).set(round(fraction, 6))


def escape_total() -> int:
    lat = _active
    return int(lat.escapes) if lat is not None else 0


def sealed_active() -> bool:
    """True when a sealed lattice governs the process."""
    lat = _active
    return lat is not None and lat.sealed


refresh_from_env()
