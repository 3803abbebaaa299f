"""Per-host serving front door of the pod data plane
(``roaringbitmap_tpu.serving.frontdoor``).

``parallel.podmesh`` decides where tenants live; a :class:`PodFrontDoor`
moves the traffic: one :class:`~.loop.ServingLoop` per pod host (each over
the tenants placed there), consistent rendezvous routing of every
arrival, forwarding of mis-routed arrivals, the weighted fair share kept
across hosts through a small state gossip, and typed degradation when a
host drops: the ``reroute`` rung of the pod ladder (``reroute -> mesh ->
single -> sequential``, ``runtime.guard.REROUTE``).

- **local / replicated-N tenants** serve from per-host pooled engines
  (``MultiSetBatchEngine``, or a per-host-mesh ``ShardedBatchEngine`` with
  ``host_engine="sharded"``); a replica is a full per-host copy, restored
  from the authoritative set's portable state, so its attached columns
  come along (the JAX package's replica drops them).
- **sharded (capacity) tenants** serve from ONE pod-spanning
  ``ShardedBatchEngine`` (``placement="sharded"`` over
  ``PodMesh.pod_mesh()``); in a detected pod every rank holds only its own
  row shards and the combine crosses processes.

Routing is ``rendezvous(set_id, alive placement hosts)``: every host
computes the same answer, and a host loss re-routes only that host's
tenants.  An arrival at the wrong host (``submit(via_host=...)``) is
forwarded and counted (``rb_pod_forwards_total``), never dropped.

Cross-host fair share: each pump gossips the loops' per-tenant virtual
times (element-wise max: monotone, idempotent, order-free), so a tenant
keeps one global share however many hosts its traffic lands on.  In a
detected pod the board, the forwarded trace contexts and the statusz docs
ride the process group's ``torch.distributed`` store (``Store.set`` /
``get`` under the JAX package's keys, ``rb/pod/vtime/<host>``,
``rb/pod/trace/<sid>``, ``rb/pod/statusz/<host>``, as JSON), best-effort.

Host loss: a classified ``CoordinatorTimeout`` / ``HostLost`` (the fault
seam ``coordinator@host<N>`` at site ``pod``, a failed dispatch, or
``fail_host()``) marks the host down; every affected ticket (queued and
just-failed) re-routes to an alive replica, or demotes to single-host mode
(the authoritative pooled engine over every tenant) when no replica
exists.  Every hop is a ``pod.reroute`` span and ``rb_pod_reroutes_total``.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import logging
import threading

from ..mutation import durability
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import statusz as obs_statusz
from ..obs import trace as obs_trace
from ..parallel import podmesh
from ..parallel.aggregation import DeviceBitmapSet
from ..parallel.batch_engine import BatchEngine
from ..parallel.multiset import MultiSetBatchEngine
from ..parallel.sharded_engine import ShardedBatchEngine
from ..runtime import errors, faults, guard
from .loop import ServingLoop, ServingPolicy, Ticket

_log = logging.getLogger("roaringbitmap_tpu_torch.serving")

#: the trace/metric/fault site of pod routing
SITE = podmesh.SITE

#: pseudo-host id of the pod-spanning capacity engine's loop
CAPACITY = "capacity"
#: pseudo-host id of the single-host demotion loop
SINGLE = guard.SINGLE_DEVICE

#: how long a store read of a gossip key may wait, seconds
KV_TIMEOUT_S = 0.05


class PodFrontDoor:
    """Route and serve an arrival stream over a pod of per-host loops.

    ``sets`` is the tenant universe (``DeviceBitmapSet`` / ``BatchEngine``
    / raw bitmap lists, built on ``device``), indexed by global
    ``set_id``.  ``pod`` defaults to ``PodMesh.detect()`` (``n_hosts`` sizes
    a simulated pod); ``plan`` defaults to ``podmesh.place`` over the
    footprint model and optional ``qps`` rates.  One front door runs per
    host process; in a simulated pod it owns every host's loop."""

    def __init__(self, sets, pod: podmesh.PodMesh | None = None,
                 n_hosts: int | None = None,
                 policy: ServingPolicy | None = None,
                 plan: podmesh.PlacementPlan | None = None,
                 qps=None, host_engine: str = "multiset",
                 result_cache="env", device=None):
        if host_engine not in ("multiset", "sharded"):
            raise ValueError(f"unknown host_engine {host_engine!r}")
        self._device = device
        self._sets = [self._as_set(s) for s in sets]
        self.pod = pod or podmesh.PodMesh.detect(n_hosts)
        self.policy = policy or ServingPolicy.from_env()
        self.plan = plan or podmesh.place(self._sets, self.pod, qps=qps)
        self._host_engine = host_engine
        self._result_cache = result_cache
        self._lock = threading.RLock()
        #: the pod-global stride state (the gossip board)
        self._vtime_board: dict = {}
        self._loops: dict = {}        # host_id -> ServingLoop
        self._local_sid: dict = {}    # (host_id, global sid) -> local sid
        self._cap_loop: ServingLoop | None = None
        self._cap_sid: dict = {}
        self._single_loop: ServingLoop | None = None
        self._route_counts: dict = {}
        #: the live-migration flip map (podmesh.route overrides)
        self._route_overrides: dict = {}
        #: sid -> active MigrationSession (the dual-write window)
        self._dual_writes: dict = {}
        self._rate_t0 = faults.clock()
        self.stats = {"routed": 0, "forwarded": 0, "reroutes": 0,
                      "host_drops": 0, "single_demotions": 0}
        self._completion_listeners: list = []
        self._build()
        obs_statusz.register_provider(f"pod_frontdoor_{id(self)}",
                                      self._statusz_docs)

    def _as_set(self, s) -> DeviceBitmapSet:
        if isinstance(s, DeviceBitmapSet):
            return s
        if isinstance(s, BatchEngine):
            return s._ds
        return DeviceBitmapSet(s, layout="auto", device=self._device)

    @property
    def device(self):
        return self._sets[0].device

    # ------------------------------------------------------------ assembly

    def _build(self) -> None:
        cap_sids = self.plan.sharded_sids()
        if cap_sids:
            eng = ShardedBatchEngine(
                [self._sets[s] for s in cap_sids], mesh=self.pod.pod_mesh(),
                placement="sharded", result_cache=self._result_cache)
            self._cap_loop = ServingLoop(eng, self.policy)
            self._cap_sid = {sid: i for i, sid in enumerate(cap_sids)}
        for h in (hi.host_id for hi in self.pod.hosts if hi.local):
            self._build_host(h)

    def _build_host(self, h) -> None:
        """(Re)build ONE host's loop from the current plan and set table:
        live migration touches only the source and target hosts."""
        self._loops.pop(h, None)
        for key in [k for k in self._local_sid if k[0] == h]:
            del self._local_sid[key]
        sids = [s for s in range(self.plan.n_tenants)
                if self.plan.regime(s) != "sharded"
                and h in self.plan.hosts_of(s)]
        if not sids:
            return
        local_sets = []
        for s in sids:
            ds = self._sets[s]
            if self.plan.hosts_of(s)[0] == h:
                local_sets.append(ds)       # the authoritative copy
            else:
                # a replica: a full per-host copy of the authoritative set,
                # its columns and version lineage included (the portable
                # state the durable path persists)
                local_sets.append(durability.restore_state(
                    durability.capture_state(ds), device=ds.device))
        if self._host_engine == "sharded":
            eng = ShardedBatchEngine(
                local_sets, mesh=self.pod.host_mesh(h), placement="auto",
                result_cache=self._result_cache)
        else:
            eng = MultiSetBatchEngine(local_sets,
                                      result_cache=self._result_cache)
        self._loops[h] = ServingLoop(eng, self.policy)
        self._local_sid.update({(h, s): i for i, s in enumerate(sids)})

    # ------------------------------------------------------------- routing

    def owner_host(self, set_id: int):
        """The host this tenant's requests route to now: ``CAPACITY`` for a
        sharded-regime tenant, else the rendezvous winner among its alive
        placement hosts, None when none is alive."""
        if self.plan.regime(set_id) == "sharded":
            return CAPACITY
        return podmesh.route(self.plan, set_id, self.pod.alive(),
                             overrides=self._route_overrides)

    def routes_local(self, set_id: int) -> bool:
        """Whether this process serves the tenant's routed host."""
        h = self.owner_host(set_id)
        if h == CAPACITY:
            return self._cap_loop is not None
        return h in self._loops or h is None

    def submit(self, request, via_host=None, arrival: float | None = None,
               context: dict | None = None) -> Ticket:
        """Route and admit one request.  ``via_host`` is the arrival host:
        when it differs from the routed host the request is forwarded
        (counted, traced, served identically).  ``context`` is the
        forwarded envelope's trace context; in a detected pod a missing
        one is read from the store.  A request routed to another process's
        host raises ``AdmissionRejected(reason="remote_host")`` after
        publishing its trace context for the owner."""
        with self._lock:
            sid = int(request.set_id)
            if not 0 <= sid < len(self._sets):
                raise IndexError(f"set_id out of range 0..{len(self._sets) - 1}"
                                 f": {sid}")
            h = self.owner_host(sid)
            regime = self.plan.regime(sid)
            forwarded = via_host is not None and via_host != h
            if context is None and forwarded:
                context = self._trace_kv_get(sid)
            with obs_trace.span_from(
                    context, "pod.route", site=SITE, set_id=sid,
                    tenant=request.tenant, host=str(h), regime=regime,
                    forwarded=forwarded) as sp:
                self.stats["routed"] += 1
                self._route_counts[sid] = self._route_counts.get(sid, 0) + 1
                obs_metrics.counter("rb_pod_routes_total", host=str(h)).inc()
                if forwarded:
                    self.stats["forwarded"] += 1
                    obs_metrics.counter("rb_pod_forwards_total").inc()
                if h is None:
                    sp.tag(demoted=SINGLE)
                    t = self._single(request, arrival)
                elif h == CAPACITY:
                    local = dataclasses.replace(
                        request, set_id=self._cap_sid[sid])
                    t = self._cap_loop.submit(local, arrival=arrival)
                else:
                    loop = self._loops.get(h)
                    if loop is None:
                        from .loop import AdmissionRejected

                        self._trace_kv_put(sid, obs_trace.inject(sp))
                        raise AdmissionRejected(
                            f"{SITE}: request for tenant {sid} routes to "
                            f"host {h}, owned by another process",
                            "remote_host", host=h)
                    local = dataclasses.replace(
                        request, set_id=self._local_sid[(h, sid)])
                    t = loop.submit(local, arrival=arrival)
            if getattr(t, "pod_host", None) is None:
                t.pod_host = h
            t.pod_sid = sid
            t.pod_forwarded = forwarded
            t.pod_rerouted = getattr(t, "pod_rerouted", False)
            return t

    def _single(self, request, arrival, ticket: Ticket | None = None):
        """Single-host mode: the authoritative pooled engine over EVERY
        tenant (global set ids), built at the first demotion."""
        if self._single_loop is None:
            self._single_loop = ServingLoop(
                MultiSetBatchEngine(self._sets,
                                    result_cache=self._result_cache),
                self.policy)
        self.stats["single_demotions"] += 1
        obs_metrics.counter("rb_pod_reroutes_total", to=SINGLE).inc()
        if ticket is not None:
            ticket.request = dataclasses.replace(ticket.request,
                                                 set_id=ticket.pod_sid)
            return self._single_loop.adopt(ticket)
        t = self._single_loop.submit(request, arrival=arrival)
        t.pod_host = SINGLE
        return t

    # ------------------------------------------------------------- pumping

    def _local_hosts(self):
        return [h for h in self._loops if self.pod.is_alive(h)]

    def pump(self, force: bool = False) -> list:
        """Gossip, then pump every alive local loop (and the capacity and
        single-host loops); returns completed tickets.  The host-loss seam
        sits here: a ``coordinator`` rule at scope ``pod`` / ``host<N>``
        marks that host down and the reroute rung serves its tickets."""
        with self._lock:
            self._gossip()
            out: list = []
            fplan = faults.active()
            for h in self._local_hosts():
                if fplan is not None and fplan.pick(
                        SITE, f"host{h}", kinds=("coordinator",)) is not None:
                    self._host_down(h, errors.HostLost(
                        f"{SITE}: injected host loss at host{h} "
                        f"(ROARING_TPU_FAULTS)"))
                    continue
                out.extend(self._after_pump(h, self._loops[h].pump(force)))
            if self._cap_loop is not None:
                out.extend(self._after_pump(CAPACITY,
                                            self._cap_loop.pump(force)))
            if self._single_loop is not None:
                out.extend(self._single_loop.pump(force))
            self._push_gauges()
            if out:
                for fn in list(self._completion_listeners):
                    try:
                        fn(out)
                    except Exception:
                        _log.exception("%s: completion listener failed", SITE)
            return out

    def add_completion_listener(self, fn) -> None:
        with self._lock:
            self._completion_listeners.append(fn)

    def remove_completion_listener(self, fn) -> None:
        with self._lock:
            if fn in self._completion_listeners:
                self._completion_listeners.remove(fn)

    def drain(self) -> list:
        """Force every queued request out (the stream-end flush)."""
        with self._lock:
            out: list = []
            for _ in range(64):      # reroutes requeue; bound the walk
                if not self.backlog():
                    break
                got = self.pump(force=True)
                out.extend(got)
                if not got:
                    break
            return out

    def replay(self, arrivals) -> list:
        """Timed arrival replay on the fault clock (``loop.replay_stream``)."""
        from .loop import replay_stream

        return replay_stream(self, arrivals)

    def _all_loops(self) -> list:
        loops = list(self._loops.values())
        if self._cap_loop is not None:
            loops.append(self._cap_loop)
        if self._single_loop is not None:
            loops.append(self._single_loop)
        return loops

    def backlog(self) -> int:
        return sum(lp._backlog() for lp in self._all_loops())

    def _after_pump(self, h, completed: list) -> list:
        """A pool failure typed as host loss drops the host (the reroute
        rung re-serves its tickets); everything else passes through."""
        out, lost = [], []
        for t in completed:
            if (t.status == "failed"
                    and isinstance(t.error, errors.CoordinatorTimeout)
                    and not getattr(t, "pod_rerouted", False)):
                lost.append(t)
            else:
                out.append(t)
        if lost:
            fault = lost[0].error
            if h == CAPACITY:
                for t in lost:
                    self._reroute(t, h, "capacity_host_loss")
            else:
                self._host_down(h, fault, failed=lost)
        return out

    # ----------------------------------------------------------- host loss

    def fail_host(self, host_id: int, fault=None) -> None:
        """Mark a host lost (operator/test hook): its queued and failed
        tickets walk the reroute rung now."""
        with self._lock:
            self._host_down(host_id, fault or errors.HostLost(
                f"{SITE}: host {host_id} marked lost"))

    def _host_down(self, h, fault, failed=()) -> None:
        if self.pod.is_alive(h):
            self.pod.mark_down(h)
            self.stats["host_drops"] += 1
            obs_metrics.counter("rb_pod_host_drops_total").inc()
            obs_trace.current().event(
                "pod.host_down", site=SITE, host=h,
                error_class=type(fault).__name__)
            _log.warning("%s: host %s down (%s); rerouting", SITE, h, fault)
            obs_flight.record("host_down", site=SITE, host=str(h),
                              error_class=type(fault).__name__)
            obs_flight.trigger("host_lost", site=SITE, host=str(h),
                               error_class=type(fault).__name__)
        loop = self._loops.get(h)
        stranded = list(failed)
        if loop is not None:
            stranded.extend(loop.evict_queued())
        for t in stranded:
            self._reroute(t, h, "host_down")

    def _reroute(self, t: Ticket, from_h, reason: str) -> None:
        """One ticket up the ``reroute`` rung: an alive replica first,
        single-host mode second; it keeps its arrival stamp and deadline.
        A second host loss sends a still-queued ticket straight to
        single-host mode; a rerouted ticket that failed again keeps its
        typed failure."""
        sid = getattr(t, "pod_sid", None)
        if sid is None:
            return
        if getattr(t, "pod_rerouted", False):
            if t.status != "queued":
                return
            with obs_trace.span_from(
                    t.trace_ctx, "pod.reroute", site=SITE, set_id=sid,
                    from_host=str(from_h), to=SINGLE, reason=reason,
                    rung=guard.REROUTE) as sp:
                t.trace_ctx = obs_trace.inject(sp) or t.trace_ctx
                self.stats["reroutes"] += 1
                self._single(None, None, ticket=t)
                t.pod_host = SINGLE
            return
        t.pod_rerouted = True
        to = podmesh.route(self.plan, sid, self.pod.alive(),
                           overrides=self._route_overrides)
        with obs_trace.span_from(
                t.trace_ctx, "pod.reroute", site=SITE, set_id=sid,
                from_host=str(from_h),
                to=(str(to) if to is not None else SINGLE),
                reason=reason, rung=guard.REROUTE) as sp:
            t.trace_ctx = obs_trace.inject(sp) or t.trace_ctx
            self.stats["reroutes"] += 1
            t.status = "queued"
            t.error = None
            t.result = None
            if to is not None and (to, sid) in self._local_sid:
                obs_metrics.counter("rb_pod_reroutes_total",
                                    to="replica").inc()
                t.request = dataclasses.replace(
                    t.request, set_id=self._local_sid[(to, sid)])
                t.pod_host = to
                self._loops[to].adopt(t)
            else:
                self._single(None, None, ticket=t)
                t.pod_host = SINGLE

    # -------------------------------------------------------------- gossip

    def _gossip(self) -> dict:
        """Element-wise max of every loop's per-tenant virtual time
        through the pod board, written back so every host schedules
        against the global share; in a detected pod the board also rides
        the store, best-effort."""
        board = self._vtime_board
        loops = self._all_loops()
        for lp in loops:
            for tenant, v in lp._vtime.items():
                if v > board.get(tenant, 0.0):
                    board[tenant] = v
        board = self._gossip_kv(board)
        for lp in loops:
            for tenant, v in board.items():
                if tenant in lp._vtime and v > lp._vtime[tenant]:
                    lp._vtime[tenant] = v
        self._vtime_board = board
        return board

    def _kv_store(self):
        """The process group's store, or None (a simulated pod, no group,
        anything broken: the gossip channels are best-effort)."""
        if not self.pod.multi_process:
            return None
        try:
            import torch.distributed as dist

            if not dist.is_initialized():
                return None
            from torch.distributed import distributed_c10d

            return distributed_c10d._get_default_store()
        except Exception:
            return None

    def _kv_get(self, store, key: str):
        """The JSON value of ``key``, or None when it is missing."""
        try:
            if not store.check([key]):
                return None
            store.set_timeout(datetime.timedelta(seconds=KV_TIMEOUT_S))
            return json.loads(store.get(key).decode())
        except Exception:
            return None

    def _kv_set(self, store, key: str, value) -> None:
        try:
            store.set(key, json.dumps(value, sort_keys=True, default=str))
        except Exception:
            pass

    def _peers(self) -> list:
        return [h.host_id for h in self.pod.hosts
                if h.host_id != self.pod.local_host]

    def _gossip_kv(self, board: dict) -> dict:
        """Publish this host's board on the store and merge the peers'."""
        store = self._kv_store()
        if store is None:
            return board
        self._kv_set(store, f"rb/pod/vtime/{self.pod.local_host}", board)
        for h in self._peers():
            other = self._kv_get(store, f"rb/pod/vtime/{h}")
            if not isinstance(other, dict):
                continue
            for tenant, v in other.items():
                try:
                    if float(v) > board.get(tenant, 0.0):
                        board[tenant] = float(v)
                except (TypeError, ValueError):
                    continue
        return board

    def _trace_kv_put(self, sid: int, ctx: dict | None) -> None:
        """Publish a request's trace context for the owner process."""
        store = self._kv_store()
        if store is None or ctx is None:
            return
        self._kv_set(store, f"rb/pod/trace/{sid}", ctx)

    def _trace_kv_get(self, sid: int) -> dict | None:
        """A forwarded request's trace context from the arrival process,
        or None (the request then roots a fresh trace)."""
        store = self._kv_store()
        if store is None:
            return None
        got = self._kv_get(store, f"rb/pod/trace/{sid}")
        return got if isinstance(got, dict) else None

    # ------------------------------------------------------------- statusz

    def _statusz_docs(self) -> list:
        """One statusz doc per local serving loop (the per-host sections)."""
        with self._lock:
            hosts = [(str(h), lp) for h, lp in sorted(self._loops.items())]
            if self._cap_loop is not None:
                hosts.append((CAPACITY, self._cap_loop))
            if self._single_loop is not None:
                hosts.append((SINGLE, self._single_loop))
            return [obs_statusz.local_doc(
                host=h, sections={"serving": lp.snapshot()})
                for h, lp in hosts]

    def statusz(self) -> dict:
        """The fleet statusz: every local host's doc and every detected-pod
        peer's docs (through the store), merged with the monotone counter
        discipline, plus the placement map and front-door stats."""
        docs = self._statusz_docs()
        docs.extend(self._statusz_kv(docs))
        with self._lock:
            return obs_statusz.merge(
                docs, pod=self.pod.snapshot(),
                placement=self.plan.table(),
                regimes=self.plan.regime_counts(),
                stats=dict(self.stats),
                vtime_board=dict(self._vtime_board))

    def _statusz_kv(self, docs: list) -> list:
        store = self._kv_store()
        if store is None:
            return []
        self._kv_set(store, f"rb/pod/statusz/{self.pod.local_host}", docs)
        out: list = []
        for h in self._peers():
            other = self._kv_get(store, f"rb/pod/statusz/{h}")
            if isinstance(other, list):
                out.extend(d for d in other if isinstance(d, dict))
        return out

    # ----------------------------------------------------------- mutation

    def apply_delta(self, set_id: int, adds=None, removes=None,
                    repack: str = "auto", worker=None) -> list:
        """The pod write path: one delta to the authoritative set and every
        placed replica (the capacity pool syncs through its journal); in a
        migration's dual-write window the in-flight copy sees it too."""
        with self._lock:
            sid = int(set_id)
            reports = [self._sets[sid].apply_delta(
                adds, removes, repack=repack, worker=worker)]
            if self.plan.regime(sid) != "sharded":
                for h in self.plan.hosts_of(sid)[1:]:
                    loop = self._loops.get(h)
                    if loop is None:
                        continue
                    replica = loop._engine._engines[
                        self._local_sid[(h, sid)]]._ds
                    reports.append(replica.apply_delta(
                        adds, removes, repack=repack, worker=worker))
            session = self._dual_writes.get(sid)
            if session is not None:
                session.on_delta(adds, removes, repack=repack)
            return reports

    # ----------------------------------------------- warmup / rebalance

    def warmup(self, profile=None, rungs=None, **kw) -> dict:
        """Warm every host loop (and the capacity loop) on its own
        vocabulary (``profile=`` runs the closed-lattice boot on each)."""
        reports: dict = {}
        for h, lp in self._loops.items():
            reports[str(h)] = lp.warmup(profile=profile, rungs=rungs, **kw)
        if self._cap_loop is not None:
            reports[CAPACITY] = self._cap_loop.warmup(profile=profile,
                                                      rungs=rungs, **kw)
        return reports

    def tenant_rates(self) -> list:
        """Admitted requests a second per tenant since the last reset: the
        placement planner's ``replicated-N`` feed."""
        dt = max(1e-9, faults.clock() - self._rate_t0)
        return [self._route_counts.get(s, 0) / dt
                for s in range(len(self._sets))]

    def rebalance(self, qps=None) -> dict:
        """Re-plan placement from observed (or given) rates and rebuild the
        host loops when the plan changed; queued tickets re-route through
        the fresh plan.  Returns ``{"changed", "plan"}``."""
        with self._lock:
            qps = qps if qps is not None else self.tenant_rates()
            new = podmesh.place(self._sets, self.pod, qps=qps)
            changed = (new.regimes != self.plan.regimes
                       or new.hosts != self.plan.hosts)
            if changed:
                stranded = [t for lp in self._loops.values()
                            for t in lp.evict_queued()]
                if self._cap_loop is not None:
                    stranded.extend(self._cap_loop.evict_queued())
                self.plan = new
                self._loops.clear()
                self._local_sid.clear()
                self._cap_loop = None
                self._cap_sid = {}
                self._build()
                for t in stranded:
                    t.pod_rerouted = False
                    self._reroute(t, getattr(t, "pod_host", None),
                                  "rebalance")
            self._route_counts.clear()
            self._rate_t0 = faults.clock()
            return {"changed": changed, "plan": new.table()}

    # -------------------------------------------------------------- health

    def _push_gauges(self) -> None:
        for h, lp in self._loops.items():
            obs_metrics.gauge("rb_pod_queue_depth",
                              host=str(h)).set(lp._backlog())
        if self._cap_loop is not None:
            obs_metrics.gauge("rb_pod_queue_depth", host=CAPACITY).set(
                self._cap_loop._backlog())

    def start_pump(self, interval_s: float | None = None):
        """The threaded always-on driver over the whole front door."""
        from .loop import PumpDriver

        return PumpDriver(self, interval_s=interval_s).start()

    def snapshot(self) -> dict:
        """Pod health as plain JSON: topology, placement, routing stats
        and every loop's own snapshot."""
        out = {
            "pod": self.pod.snapshot(),
            "placement": self.plan.table(),
            "regimes": self.plan.regime_counts(),
            "stats": dict(self.stats),
            "backlog": self.backlog(),
            "hosts": {str(h): lp.snapshot() for h, lp in self._loops.items()},
        }
        if self._cap_loop is not None:
            out["hosts"][CAPACITY] = self._cap_loop.snapshot()
        if self._single_loop is not None:
            out["hosts"][SINGLE] = self._single_loop.snapshot()
        return out
