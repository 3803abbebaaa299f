"""Deterministic fault injection at the engine dispatch boundary (the port's
own copy of ``roaringbitmap_tpu.runtime.faults``).

The guard's retry / demote / split / shadow machinery (``runtime.guard``) is
only trustworthy if it runs, and real device faults are rare, so this
harness injects synthetic ones at the seam where real ones surface (just
before an engine executes), driven by one environment variable:

    ROARING_TPU_FAULTS = "<entry>[,<entry>...]:<seed>"
    entry              = <kind>[@<scope>][=<rate>]

kind   ``transient`` (retryable device hiccup), ``oom`` (allocator
       failure), ``lowering`` (a rung that cannot run the shape),
       ``corrupt`` (corrupt serialized input), ``coordinator``
       (distributed barrier timeout), ``silent`` (a result corrupted with
       no exception: only the shadow check catches it), ``slow`` (the fault
       clock below jumps by SLOW_LATENCY_S before a dispatch; nothing
       sleeps), ``crash`` (a simulated process death at a journal seam:
       ``maybe_crash``) and ``wire`` (an RPC-boundary fault shape:
       ``maybe_wire``).
scope  a dispatch site ("aggregation", "batch_engine", "sharding",
       "sharded_engine", "multihost", "pod") or an engine rung of the port
       ("megakernel", "cuda", "torch", "torch-vmap", "sequential", the
       sharded ladder's "mesh" and "single", a pod host "host<N>", the
       bootstrap's "coordinator": ``coordinator@multihost`` kills the
       handshake);
       omitted means everywhere.
rate   probability per dispatch in (0, 1]; omitted means 1.0.

Examples::

    ROARING_TPU_FAULTS="lowering@cuda=1.0:7"          # kill the kernel rung
    ROARING_TPU_FAULTS="transient=0.05,oom=0.02:1337" # background noise

Determinism: every draw comes from numpy's counter-keyed Philox stream,
seeded by (seed, rule index, site hash, call ordinal) exactly as in the JAX
package, so a fixed seed and call sequence reproduce the same schedule in
any process.  The site hash names the port's rungs by the JAX rungs they
stand for ("cuda" as "pallas", "torch" as "xla", "torch-vmap" as
"xla-vmap"), so a spec gives the port the same schedule as the JAX package
over the same calls.  Injected
exceptions take the raw shapes real faults arrive in (status-text
``RuntimeError``, ``torch.OutOfMemoryError``, ``NotImplementedError``), so
``errors.classify`` runs end to end.

The fault clock: ``clock()`` is ``time.monotonic()`` plus an injected
offset.  A firing ``slow`` rule and ``advance_clock`` move the offset
forward without sleeping, so deadline expiry (``guard.Deadline`` reads
this clock) is testable in microseconds.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import zlib

import numpy as np
import torch

from . import errors

ENV_VAR = "ROARING_TPU_FAULTS"

KINDS = ("transient", "oom", "lowering", "corrupt", "coordinator", "silent",
         "slow", "crash", "wire")
#: kinds that raise at the engine boundary (maybe_fail)
RAISING_KINDS = KINDS[:5]

#: scopes a ``wire`` rule must name, as in the JAX grammar
WIRE_SCOPES = ("conn_drop", "slow_peer", "garbage")

#: virtual latency one firing ``slow`` rule injects, seconds
SLOW_LATENCY_S = 0.05

#: the JAX rung each port rung stands for, in the draw's site hash
_DRAW_ENGINE = {"cuda": "pallas", "torch": "xla", "torch-vmap": "xla-vmap"}


@dataclasses.dataclass(frozen=True)
class FaultRule:
    kind: str
    scope: str | None   # site or engine name; None matches everywhere
    rate: float


class FaultPlan:
    """A parsed spec plus the per-(rule, site) draw counters that make the
    schedule deterministic under a fixed call order."""

    def __init__(self, rules: list[FaultRule], seed: int):
        self.rules = list(rules)
        self.seed = int(seed)
        self._counters: dict = {}

    @classmethod
    def from_spec(cls, spec: str) -> "FaultPlan":
        body, sep, seed_s = spec.rpartition(":")
        if not sep:
            raise ValueError(
                f"{ENV_VAR} needs a ':<seed>' suffix, got {spec!r}")
        try:
            seed = int(seed_s, 0)
        except ValueError:
            raise ValueError(
                f"{ENV_VAR} seed must be an integer, got {seed_s!r}") from None
        rules = []
        for entry in body.split(","):
            entry = entry.strip()
            if not entry:
                continue
            kind, rate = entry, 1.0
            if "=" in entry:
                kind, rate_s = entry.split("=", 1)
                try:
                    rate = float(rate_s)
                except ValueError:
                    raise ValueError(
                        f"bad fault rate {rate_s!r} in {entry!r}") from None
            scope = None
            if "@" in kind:
                kind, scope = kind.split("@", 1)
            if kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {kind!r} (one of {KINDS})")
            if kind == "wire" and scope not in WIRE_SCOPES:
                raise ValueError(
                    f"wire faults need a scope in {WIRE_SCOPES}, got "
                    f"{scope!r} in {entry!r}")
            if not 0.0 < rate <= 1.0:
                raise ValueError(
                    f"fault rate must be in (0, 1], got {rate} in {entry!r}")
            rules.append(FaultRule(kind, scope or None, rate))
        if not rules:
            raise ValueError(f"{ENV_VAR} spec {spec!r} has no fault entries")
        return cls(rules, seed)

    def _draw(self, rule_index: int, site_key: str) -> float:
        key = (rule_index, site_key)
        n = self._counters.get(key, 0)
        self._counters[key] = n + 1
        rng = np.random.default_rng(
            (self.seed, rule_index, zlib.crc32(site_key.encode()), n))
        return float(rng.random())

    def pick(self, site: str, engine: str | None,
             kinds: tuple = RAISING_KINDS) -> str | None:
        """First matching rule whose deterministic draw fires, else None."""
        drawn = _DRAW_ENGINE.get(engine, engine)
        for i, r in enumerate(self.rules):
            if r.kind not in kinds:
                continue
            if r.scope is not None and r.scope not in (site, engine):
                continue
            if self._draw(i, f"{site}/{drawn}") < r.rate:
                return r.kind
        return None


# --------------------------------------------------------------- activation

#: plans cached per spec string, so environment activation keeps one
#: counter state per process
_env_plans: dict = {}
#: the ``inject`` override stack, which wins over the environment
_override: list = []


def active() -> FaultPlan | None:
    if _override:
        return _override[-1]
    spec = os.environ.get(ENV_VAR)
    if not spec:
        return None
    plan = _env_plans.get(spec)
    if plan is None:
        plan = _env_plans[spec] = FaultPlan.from_spec(spec)
    return plan


@contextlib.contextmanager
def inject(spec: str):
    """Scoped activation with a fresh schedule (counters restart)."""
    plan = FaultPlan.from_spec(spec)
    _override.append(plan)
    try:
        yield plan
    finally:
        _override.pop()


# -------------------------------------------------------------- fault clock

_clock_offset = 0.0


def clock() -> float:
    """``time.monotonic()`` plus every injected or advanced offset."""
    return time.monotonic() + _clock_offset


def advance_clock(seconds: float) -> None:
    """Move the fault clock forward (never backward)."""
    global _clock_offset
    _clock_offset += max(0.0, float(seconds))


def reset_clock() -> None:
    """Zero the injected offset (between scenarios, never inside one)."""
    global _clock_offset
    _clock_offset = 0.0


def maybe_delay(site: str, engine: str | None = None) -> float:
    """The pre-dispatch latency hook: when a ``slow`` rule fires, advance
    the fault clock by SLOW_LATENCY_S and return it (else 0.0)."""
    plan = active()
    if plan is None:
        return 0.0
    if plan.pick(site, engine, kinds=("slow",)) is not None:
        advance_clock(SLOW_LATENCY_S)
        return SLOW_LATENCY_S
    return 0.0


# ---------------------------------------------------------------- injection

def maybe_fail(site: str, engine: str | None = None) -> None:
    """The engine-boundary hook: raise an injected raw-shaped fault when the
    active plan fires for (site, engine).  No active plan costs nothing."""
    plan = active()
    if plan is None:
        return
    kind = plan.pick(site, engine)
    if kind is not None:
        raise_fault(kind, site, engine)


def maybe_crash(site: str, point: str | None = None,
                tearable: bool = False) -> str | None:
    """The durability-seam hook: when a ``crash`` rule fires for (site,
    point), return the crash mode, ``"clean"`` (the journal record hit the
    disk whole before the process died) or ``"torn"`` (the process died
    mid-``write``, leaving the last record cut mid-frame); None when no
    rule fires.  The caller (``mutation.durability``) tears the journal
    tail for ``"torn"``, then raises ``errors.InjectedCrash`` for either
    mode, and nothing between the crash point and the recovery entry point
    may catch it.

    Grammar: ``crash[@scope][=rate]`` where scope is a site or point name
    (``durability``, ``pre_append``, ``pre_apply``, ``post_apply``) or the
    special scope ``torn``, which switches the mode to a torn write and so
    matches only calls with ``tearable=True`` (the one point where a frame
    write is in flight).  Draws are keyed as in the JAX package."""
    plan = active()
    if plan is None:
        return None
    for i, r in enumerate(plan.rules):
        if r.kind != "crash":
            continue
        mode = "torn" if r.scope == "torn" else "clean"
        if mode == "torn" and not tearable:
            continue
        if r.scope not in (None, "torn", site, point):
            continue
        if plan._draw(i, f"{site}/{point}") < r.rate:
            return mode
    return None


def maybe_wire(site: str) -> str | None:
    """The RPC-boundary hook (``wire.server``, ``wire.client``): when a
    ``wire`` rule fires for ``site``, return its scope, the fault shape the
    caller enacts: ``"conn_drop"`` (close the socket mid-pipeline, no
    goodbye frame), ``"slow_peer"`` (the fault clock jumps by
    SLOW_LATENCY_S before the write; nothing sleeps) or ``"garbage"``
    (corrupt the outgoing frame's payload; the receiver must die typed
    ``CorruptInput``).  None when no rule fires.  ``site`` keys the draw
    only, so server and client schedules are independent streams of one
    seed."""
    plan = active()
    if plan is None:
        return None
    for i, r in enumerate(plan.rules):
        if r.kind != "wire":
            continue
        if plan._draw(i, f"{site}/{r.scope}") < r.rate:
            if r.scope == "slow_peer":
                advance_clock(SLOW_LATENCY_S)
            return r.scope
    return None


def should_corrupt(site: str, engine: str | None = None) -> bool:
    """True when a ``silent`` rule fires: the caller perturbs its own
    result."""
    plan = active()
    return (plan is not None
            and plan.pick(site, engine, kinds=("silent",)) is not None)


def raise_fault(kind: str, site: str, engine: str | None):
    tag = f"(injected fault at {site}/{engine or '-'})"
    if kind == "transient":
        raise RuntimeError(f"UNAVAILABLE: device connection dropped {tag}")
    if kind == "oom":
        raise torch.OutOfMemoryError(
            f"CUDA out of memory allocating a device buffer {tag}")
    if kind == "lowering":
        raise NotImplementedError(f"kernel lowering failed {tag}")
    if kind == "corrupt":
        raise errors.CorruptInput(f"corrupt serialized input {tag}")
    if kind == "coordinator":
        raise RuntimeError(
            f"DEADLINE_EXCEEDED: coordination service barrier timed "
            f"out {tag}")
    raise ValueError(f"unknown fault kind {kind!r}")
