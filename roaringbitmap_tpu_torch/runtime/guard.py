"""Guarded dispatch: bounded retry, the engine ladder, deadline, shadow (the
port's own copy of ``roaringbitmap_tpu.runtime.guard``).

Every guarded entry point (``parallel.aggregation``'s wide calls and
``BatchEngine.execute``) runs its engine through ``run_with_fallback``:

- **Transient faults** (``errors.retryable``) get bounded retries with
  exponential backoff on the same rung; exhausted retries demote.
- **Lowering faults** demote at once: the same shape on the same rung
  fails the same way.
- **ResourceExhausted** first offers the call site a split (the batch
  engine halves the batch), then demotes.
- **CorruptInput** is the input's fault: fatal at once.
- On the CPU every chain ends at the call site's **sequential host
  rung**, the container-algebra fold every engine is held bit-exact
  against, so a demotion changes throughput, never results.
- On a CUDA device a chain holds the requested rung and the hand-written
  kernel rungs below it, never the plain versions ("torch", "torch-vmap")
  or the host unless asked for by name: a
  fault the last rung cannot retry or split away re-raises, typed.
- An expired **deadline** stops the ladder and re-raises the last fault,
  typed.
- What ``errors.classify`` cannot type (a programming error, a failed
  kernel build or launch) propagates untouched.

Two knobs belong to the pooled engine (``parallel.multiset``): the
pipeline depth (``ROARING_TPU_PIPELINE_DEPTH``) and the per-dispatch
device-memory budget (``ROARING_TPU_HBM_BUDGET``, ``resolve_hbm_budget``),
against which the batch and pooled engines halve a batch whose predicted
footprint passes it before it touches the device.

The opt-in **shadow check** (``ROARING_TPU_SHADOW=<rate>[:<seed>]`` or
``GuardPolicy.shadow_rate``) re-runs a sampled share of queries on the
sequential rung after a successful dispatch and raises ``ShadowMismatch``
on any divergence.

Nothing here is silent: every retry, demotion and sequential landing is
counted in the obs registry (``rb_dispatch_events_total{site,event}``;
``dispatch_stats`` is the JAX package's per-site view over it), logged,
recorded as an event on the ``guard.dispatch`` span, and — demotions,
landings and fatal faults — in the flight recorder.  Each served attempt
observes ``rb_execute_latency_seconds{site,engine}``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
import zlib
from typing import Callable

import numpy as np
import torch

from ..obs import flight as obs_flight
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from . import errors, faults

_log = logging.getLogger("roaringbitmap_tpu_torch.runtime")

#: the terminal rung of every chain off the card: the sequential host fold
SEQUENTIAL = "sequential"
#: the rung that runs the kernels' plain PyTorch versions
PLAIN = "torch"
#: the batch ladder's per-query cross-check rung: plain PyTorch run query
#: by query (the JAX package's "xla-vmap")
PLAIN_VMAP = "torch-vmap"
#: the rungs a chain on the card leaves out unless they are asked for
PLAIN_RUNGS = (PLAIN, PLAIN_VMAP)

#: the mesh-sharded engine's ladder (``parallel.sharded_engine``): a sharded
#: dispatch demotes MESH -> SINGLE_DEVICE (the un-sharded pooled engine on
#: its kernel rungs) -> SEQUENTIAL off the card; on the card the chain
#: holds the two kernel rungs alone, as every other ladder of the port
MESH = "mesh"
SINGLE_DEVICE = "single"

#: the pod front door's top rung, above the mesh ladder
#: (``serving.frontdoor``): a classified host-loss fault (CoordinatorTimeout
#: / HostLost) first RE-ROUTES the affected tenants to an alive replica,
#: and tenants with no replica demote to single-host mode.  The pod ladder
#: reads reroute -> mesh -> single -> sequential, every rung bit-exact.
REROUTE = "reroute"

#: sentinel a ResourceExhausted splitter returns to decline (fall through
#: to demotion)
NO_SPLIT = object()

ENV_MAX_ATTEMPTS = "ROARING_TPU_MAX_ATTEMPTS"
ENV_BACKOFF = "ROARING_TPU_BACKOFF_S"
ENV_DEADLINE = "ROARING_TPU_DEADLINE_S"
ENV_SHADOW = "ROARING_TPU_SHADOW"
ENV_HBM_BUDGET = "ROARING_TPU_HBM_BUDGET"
ENV_PIPELINE_DEPTH = "ROARING_TPU_PIPELINE_DEPTH"
ENV_SLO_MS = obs_slo.ENV_SLO_MS


def parse_bytes(spec: str) -> int:
    """``ROARING_TPU_HBM_BUDGET`` value: plain bytes or K/M/G-suffixed
    (binary units: "64M" = 64 MiB).  0 or negative = unlimited."""
    s = spec.strip()
    mult = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30}.get(s[-1:].lower())
    if mult is not None:
        s = s[:-1]
    try:
        return int(float(s) * (mult or 1))
    except ValueError:
        raise ValueError(
            f"{ENV_HBM_BUDGET} must be bytes with an optional K/M/G "
            f"suffix, got {spec!r}") from None


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    """Knobs for one guarded dispatch; ``from_env`` is the default.  The
    fields and environment names are the JAX package's."""

    max_attempts: int = 3          # per rung, transient faults only
    backoff_base: float = 0.02     # seconds; doubles per retry
    backoff_factor: float = 2.0
    backoff_max: float = 1.0
    deadline: float | None = None  # whole-dispatch wall budget, seconds
    shadow_rate: float = 0.0       # share of queries cross-checked
    shadow_seed: int = 0x5AD0
    #: predicted-peak device-memory ceiling per dispatch, bytes: a batch
    #: predicted past it is halved before dispatch (the proactive split).
    #: None = the card's free memory (``resolve_hbm_budget``); <= 0 =
    #: explicitly unlimited
    hbm_budget: int | None = None
    #: in-flight launch window of the pooled engine's pipelined dispatcher
    #: (``parallel.multiset``): launch k+1 is planned on the host while up
    #: to depth - 1 earlier launches run on the card; 1 is strictly serial
    pipeline_depth: int = 2
    #: per-query latency objective, milliseconds (``ROARING_TPU_SLO_MS``);
    #: the serving loop clamps it to each pool's remaining deadline
    #: (``for_remaining``) and counts every served request attained or
    #: missed (``count_outcome``).  None disables it.  An SLO miss is
    #: recorded, never raised: ``deadline`` is the enforcing knob
    slo_deadline_ms: float | None = None
    sleep: Callable[[float], None] = time.sleep

    @classmethod
    def from_env(cls, **overrides) -> "GuardPolicy":
        env: dict = {}
        if ENV_MAX_ATTEMPTS in os.environ:
            env["max_attempts"] = max(1, int(os.environ[ENV_MAX_ATTEMPTS]))
        if ENV_BACKOFF in os.environ:
            env["backoff_base"] = float(os.environ[ENV_BACKOFF])
        if ENV_DEADLINE in os.environ:
            env["deadline"] = float(os.environ[ENV_DEADLINE])
        if ENV_SHADOW in os.environ:
            rate, _, seed = os.environ[ENV_SHADOW].partition(":")
            env["shadow_rate"] = float(rate)
            if seed:
                env["shadow_seed"] = int(seed, 0)
        if ENV_HBM_BUDGET in os.environ:
            env["hbm_budget"] = parse_bytes(os.environ[ENV_HBM_BUDGET])
        if ENV_PIPELINE_DEPTH in os.environ:
            env["pipeline_depth"] = max(
                1, int(os.environ[ENV_PIPELINE_DEPTH]))
        if ENV_SLO_MS in os.environ:
            env["slo_deadline_ms"] = float(os.environ[ENV_SLO_MS])
        env.update(overrides)
        return cls(**env)

    def for_remaining(self, remaining_s: float) -> "GuardPolicy":
        """The per-dispatch policy of an admitted request's REMAINING
        deadline: the hard guard ``deadline`` (which bounds retries and
        backoff inside ``run_with_fallback``) and the SLO deadline are both
        clamped to ``remaining_s``, so a retry storm can never spend more
        wall than the query has left (the serving loop's deadline
        propagation)."""
        remaining_s = max(0.0, float(remaining_s))
        dl = (remaining_s if self.deadline is None
              else min(self.deadline, remaining_s))
        slo = remaining_s * 1e3
        if self.slo_deadline_ms is not None:
            slo = min(self.slo_deadline_ms, slo)
        return dataclasses.replace(self, deadline=dl, slo_deadline_ms=slo)


class Deadline:
    """Monotonic wall budget shared across retries, rungs and batch splits
    (a split must not reset the clock), read on the fault clock so that
    injected ``slow`` latency expires it."""

    def __init__(self, seconds: float | None, clock=faults.clock):
        self.seconds = seconds
        self._clock = clock
        self._t0 = clock()

    def expired(self) -> bool:
        return (self.seconds is not None
                and self._clock() - self._t0 >= self.seconds)

    def remaining(self) -> float:
        if self.seconds is None:
            return float("inf")
        return max(0.0, self.seconds - (self._clock() - self._t0))


#: free-memory budget cache: (monotonic deadline, device, value).  The
#: default budget costs an allocator query, which must not ride every
#: dispatch; free memory moves slowly next to the query rate
_FREE_BUDGET_TTL_S = 1.0
_free_budget_cache: tuple | None = None


def resolve_hbm_budget(policy: GuardPolicy | None = None,
                       device=None) -> int | None:
    """Effective per-dispatch device-memory budget in bytes, or None for
    unlimited.  An explicit policy or environment value wins (<= 0 means
    unlimited); otherwise, on a CUDA ``device``, the card's free memory
    (``torch.cuda.mem_get_info``, cached for ``_FREE_BUDGET_TTL_S``); on the
    CPU None, as the JAX package's CPU backend reports no free memory."""
    global _free_budget_cache
    policy = policy or GuardPolicy.from_env()
    if policy.hbm_budget is not None:
        return policy.hbm_budget if policy.hbm_budget > 0 else None
    if device is None or torch.device(device).type != "cuda":
        return None
    dev = torch.device(device)
    now = time.monotonic()
    cached = _free_budget_cache
    if cached is not None and now < cached[0] and cached[1] == dev:
        return cached[2]
    free = obs_memory.backend_free_bytes(dev)
    _free_budget_cache = (now + _FREE_BUDGET_TTL_S, dev, free)
    return free


def chain_from(engine: str, ladder: tuple, device=None) -> tuple:
    """The fallback chain starting at ``engine``'s rung of ``ladder`` (an
    engine outside the ladder gets itself alone).  Off the card it ends at
    the sequential rung.  On a CUDA ``device`` it keeps the requested rung
    and the kernel rungs below it, without the plain rungs or the host."""
    chain = (tuple(ladder[ladder.index(engine):]) if engine in ladder
             else (engine,))
    if device is not None and torch.device(device).type == "cuda":
        return chain[:1] + tuple(r for r in chain[1:]
                                 if r not in PLAIN_RUNGS)
    return chain + (SEQUENTIAL,)


# --------------------------------------------------------- dispatch stats

_EVENTS = ("retries", "demotions", "sequential")
_EVENT_METRIC = "rb_dispatch_events_total"


def _bump(site: str, key: str) -> None:
    obs_metrics.counter(_EVENT_METRIC, site=site, event=key).inc()


def dispatch_stats(site: str | None = None) -> dict:
    """Per-site retry / demotion / sequential-landing counts: a view over
    the registry's ``rb_dispatch_events_total{site,event}`` counters."""
    rows: dict = {}
    for name, labels, inst in obs_metrics.REGISTRY.instruments():
        if name == _EVENT_METRIC and labels.get("event") in _EVENTS:
            row = rows.setdefault(labels["site"], dict.fromkeys(_EVENTS, 0))
            row[labels["event"]] += int(inst.value)
    if site is not None:
        return rows.get(site, dict.fromkeys(_EVENTS, 0))
    return rows


def reset_dispatch_stats() -> None:
    """Zero the ``rb_dispatch_events_total`` counters (``obs.reset()``
    drops them with the rest of the registry)."""
    for name, _labels, inst in obs_metrics.REGISTRY.instruments():
        if name == _EVENT_METRIC:
            inst.value = 0.0


def _deadline_error(site: str, dl: Deadline, last):
    msg = f"{site}: dispatch deadline of {dl.seconds}s exhausted"
    if last is None:
        return errors.TransientDeviceError(msg)
    err = type(last)(f"{msg}; last fault: {last}")
    err.__cause__ = last
    return err


def _log_transition(level: int, site: str, event: str, engine_from: str,
                    engine_to: str | None, fault, span=None,
                    **fields) -> None:
    """One guard decision, emitted through ONE schema on two surfaces: a
    structured log record (``extra=`` fields, ``rb_`` prefixed) and an
    event on the enclosing trace span; demotions, landings and fatal
    faults also enter the flight recorder's ring."""
    error_class = type(fault).__name__ if fault is not None else None
    _log.log(level, "%s: %s %s -> %s: %s", site, event, engine_from,
             engine_to or "-", fault,
             extra={"rb_site": site, "rb_event": event,
                    "rb_engine_from": engine_from,
                    "rb_engine_to": engine_to,
                    "rb_error_class": error_class,
                    **{f"rb_{k}": v for k, v in fields.items()}})
    (span if span is not None else obs_trace.current()).event(
        event, site=site, engine_from=engine_from, engine_to=engine_to,
        error_class=error_class, **fields)
    if level >= logging.WARNING:
        obs_flight.record("guard", event=event, site=site,
                          engine_from=engine_from, engine_to=engine_to,
                          error_class=error_class)


def _observe_latency(site: str, engine: str, seconds: float) -> None:
    """Per-(site, engine) execute-latency histogram."""
    obs_metrics.histogram("rb_execute_latency_seconds", site=site,
                          engine=engine).observe(seconds)


def run_with_fallback(site: str, chain, attempt, *, policy=None,
                      sequential=None, on_resource_exhausted=None,
                      deadline: Deadline | None = None):
    """Run ``attempt(rung)`` down the fallback chain; returns
    ``(result, rung_used)``.

    ``sequential()`` (no arguments) runs the chain's sequential rung; a
    chain without one (``chain_from`` on a card) has no host rung, and a
    fault its last rung cannot retry away re-raises, typed and not counted
    as a demotion.  ``on_resource_exhausted(rung, fault, deadline)`` may
    return a recovered result (a split batch) or NO_SPLIT to decline.
    """
    policy = policy or GuardPolicy.from_env()
    dl = deadline or Deadline(policy.deadline)
    rungs = list(chain)
    if not rungs:
        raise ValueError(f"{site}: empty fallback chain")
    if SEQUENTIAL in rungs[:-1] or (SEQUENTIAL in rungs
                                    and sequential is None):
        raise ValueError(f"{site}: the sequential rung must come last and "
                         f"needs sequential=")
    last = None
    # the span is the OUTER context manager so the query context closes
    # first and its SLO-miss event lands on the still-open guard.dispatch
    with obs_trace.span("guard.dispatch", site=site) as sp, \
            obs_slo.query(site, deadline_ms=policy.slo_deadline_ms):
        demotion_chain: list = []   # "cuda->torch"-style hops, in order
        retries = 0

        def done(res, rung, **tags):
            obs_slo.note_engine(rung)
            sp.tag(rung_used=rung, retries=retries,
                   demotions=len(demotion_chain),
                   demotion_chain=demotion_chain, **tags)
            return res, rung

        def demote(rung, next_rung, fault, **fields):
            if next_rung is None:      # the chain's last rung: re-raise
                _log_transition(logging.ERROR, site, "exhausted", rung,
                                None, fault, span=sp, **fields)
                return
            _bump(site, "demotions")
            demotion_chain.append(f"{rung}->{next_rung}")
            _log_transition(logging.WARNING, site, "demote", rung,
                            next_rung, fault, span=sp, **fields)

        for ri, rung in enumerate(rungs):
            next_rung = rungs[ri + 1] if ri + 1 < len(rungs) else None
            backoff = policy.backoff_base
            for att in range(policy.max_attempts):
                # injected latency lands before the expiry check, so a
                # slowed attempt can exhaust the deadline deterministically
                faults.maybe_delay(site, rung)
                if dl.expired():
                    raise _deadline_error(site, dl, last)
                try:
                    if rung == SEQUENTIAL:
                        _bump(site, "sequential")
                        _log_transition(logging.WARNING, site, "sequential",
                                        rungs[ri - 1] if ri else SEQUENTIAL,
                                        SEQUENTIAL, last, span=sp)
                        t0 = time.perf_counter()
                        res = sequential()
                        _observe_latency(site, SEQUENTIAL,
                                         time.perf_counter() - t0)
                        return done(res, SEQUENTIAL)
                    t0 = time.perf_counter()
                    res = attempt(rung)
                    _observe_latency(site, rung, time.perf_counter() - t0)
                    return done(res, rung)
                except Exception as exc:
                    fault = errors.classify(exc)
                    if fault is None or isinstance(fault,
                                                   errors.ShadowMismatch):
                        raise      # programming error / proven corruption
                    last = fault
                    if isinstance(fault, errors.CorruptInput):
                        _log_transition(logging.ERROR, site, "fatal", rung,
                                        None, fault, span=sp)
                        if fault is exc:
                            raise
                        raise fault from exc
                    if isinstance(fault, errors.ResourceExhausted):
                        if on_resource_exhausted is not None:
                            res = on_resource_exhausted(rung, fault, dl)
                            if res is not NO_SPLIT:
                                return done(res, rung, split=True)
                        demote(rung, next_rung, fault)  # same shape OOMs
                        break
                    if isinstance(fault, errors.EngineLoweringError):
                        demote(rung, next_rung, fault)
                        break
                    # retryable (transient / coordinator): bounded backoff
                    if att + 1 >= policy.max_attempts:
                        demote(rung, next_rung, fault,
                               reason="retries_exhausted")
                        break
                    _bump(site, "retries")
                    retries += 1
                    _log_transition(logging.DEBUG, site, "retry", rung, rung,
                                    fault, span=sp, attempt=att + 1)
                    policy.sleep(min(backoff, dl.remaining()))
                    backoff = min(backoff * policy.backoff_factor,
                                  policy.backoff_max)
        assert last is not None  # a rung leaves its loop only via a fault
        raise last


# ------------------------------------------------------------ shadow checks

_shadow_counters: dict = {}


def shadow_sample(n: int, rate: float, seed: int, site: str) -> list[int]:
    """Deterministic sample of query indices to cross-check: a rate-sized
    Bernoulli draw per index, keyed by a per-site call counter so repeated
    batches sample different (but reproducible) subsets."""
    if rate <= 0.0 or n == 0:
        return []
    if rate >= 1.0:
        return list(range(n))
    call = _shadow_counters.get(site, 0)
    _shadow_counters[site] = call + 1
    rng = np.random.default_rng((seed, zlib.crc32(site.encode()), call))
    return [i for i in range(n) if rng.random() < rate]
