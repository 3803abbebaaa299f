"""Live tenant migration and pod elasticity over the durability seam
(``roaringbitmap_tpu.serving.migration``).

A tenant moves by streaming the bytes the durable write path persists
(``mutation.durability``): a spec-portable snapshot of the tenant and the
delta tail it accrues while the copy is in flight.

Protocol (``MigrationSession`` / :func:`migrate_tenant`)::

    begin   under the front-door lock: capture the tenant's portable state
            (``durability.capture_state``) and open the dual-write window;
            the source keeps serving.
    copy    outside the lock: rebuild the tenant from the snapshot on the
            source set's device (``durability.restore_state``); deltas that
            arrive meanwhile buffer, then apply to both copies.
    flip    under the lock, timed (the migration blip): drain the buffered
            deltas onto the target, swap the set table, flip the route with
            one ``podmesh.route`` override write, rewrite the plan, rebuild
            only the source and target host loops; stranded queued tickets
            re-route.  Queries before, during and after the flip return the
            same bits.

The move is one ``pod.migrate`` span (set_id, from / to hosts, bytes
streamed, catch-up records, blip_ms) and ``rb_migration_*`` metrics.
Sharded-regime tenants refuse typed: they already span every host.

On top: :func:`host_join` (grow the pod, rebalance, migrate onto the new
host), :func:`host_leave` (drain a host by migrating its tenants, then mark
it down) and :func:`restore_host_tenants` (rebuild a lost host's
single-copy tenants from their durable state and re-home them).
"""

from __future__ import annotations

import dataclasses
import time

from ..mutation import durability
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..parallel import podmesh

#: migration traces/metrics ride the pod site (they are pod data-plane
#: moves), with durability.* spans nested for the streamed state
SITE = podmesh.SITE


class MigrationError(ValueError):
    """Typed refusal: the tenant or target cannot migrate (sharded regime,
    dead or unknown target host, a migration already in flight)."""


class MigrationSession:
    """One in-flight tenant move; see the module docstring protocol.

    Create via :func:`begin_migration` (it registers the dual-write
    window under the front-door lock), then call :meth:`finish` for the
    catch-up + route flip.  ``on_delta`` is called by
    ``PodFrontDoor.apply_delta`` for every delta the source applies
    during the window."""

    def __init__(self, fd, sid: int, to_host: int):
        self.fd = fd
        self.sid = int(sid)
        self.from_host = fd.owner_host(sid)
        self.to_host = int(to_host)
        self.state: dict | None = None
        self.target_ds = None
        self._pending: list = []    # deltas seen before the copy lands
        self._applied = 0
        self.bytes_streamed = 0
        #: the enclosing pod.migrate span's context, captured at
        #: begin_migration: dual-writes arrive later from mutation
        #: callers with no contextvar link to the migration, so each
        #: one parents into this explicitly
        self.trace_ctx = obs_trace.inject()

    # -- dual-write window ------------------------------------------
    def on_delta(self, adds, removes, repack: str = "auto") -> None:
        """Every source-side delta during the window lands here (under
        the front-door lock): buffered until the target copy exists,
        applied directly once it does — the dual-write half.  Each
        delta closes a ``pod.dual_write`` span parented into the
        migration's trace (remote form: the mutation caller's stack has
        no contextvar tie to ``pod.migrate``)."""
        with obs_trace.span_from(
                self.trace_ctx, "pod.dual_write", site=SITE,
                set_id=self.sid, to=str(self.to_host),
                buffered=self.target_ds is None):
            if self.target_ds is None:
                self._pending.append((adds, removes, repack))
            else:
                self.target_ds.apply_delta(adds, removes, repack=repack)
                self._applied += 1

    def _drain_pending(self) -> None:
        while self._pending:
            adds, removes, repack = self._pending.pop(0)
            self.target_ds.apply_delta(adds, removes, repack=repack)
            self._applied += 1

    # -- protocol phases --------------------------------------------
    def copy(self) -> None:
        """Stream the captured snapshot to the target and rebuild the
        tenant there (outside the lock — the source serves on), then
        catch up the deltas that arrived while copying."""
        ds = durability.restore_state(self.state,
                                      device=self.fd._sets[self.sid].device)
        self.bytes_streamed = durability.state_bytes(self.state)
        obs_metrics.counter("rb_migration_bytes_total").inc(
            self.bytes_streamed)
        with self.fd._lock:
            self.target_ds = ds
            self._drain_pending()

    def finish(self) -> dict:
        """Catch-up + route flip under the lock; returns the migration
        report.  The blip — the only window the tenant's admissions
        wait — covers the final delta drain, the route-override write,
        the plan rewrite, and the two scoped host rebuilds."""
        fd, sid = self.fd, self.sid
        if self.target_ds is None:
            self.copy()
        t0 = time.perf_counter()
        with fd._lock:
            self._drain_pending()
            fd._dual_writes.pop(sid, None)
            fd._sets[sid] = self.target_ds
            # the flip: one dict write makes every later owner_host()
            # answer the target (podmesh.route override map)
            fd._route_overrides[sid] = self.to_host
            hosts = list(fd.plan.hosts)
            old = tuple(hosts[sid])
            hosts[sid] = (self.to_host,) + tuple(
                h for h in old if h != self.to_host)[1:]
            fd.plan = dataclasses.replace(fd.plan, hosts=tuple(hosts))
            stranded: list = []
            for h in {*old, self.to_host}:
                loop = fd._loops.get(h)
                if loop is not None:
                    stranded.extend(loop.evict_queued())
                fd._build_host(h)
            for t in stranded:
                t.pod_rerouted = False
                fd._reroute(t, getattr(t, "pod_host", None), "migrate")
        blip_ms = (time.perf_counter() - t0) * 1e3
        obs_metrics.histogram("rb_migration_blip_seconds").observe(
            blip_ms / 1e3)
        return {"set_id": sid, "from": self.from_host,
                "to": self.to_host, "bytes": self.bytes_streamed,
                "catch_up_records": self._applied,
                "blip_ms": round(blip_ms, 3)}


def begin_migration(fd, sid: int, to_host: int) -> MigrationSession:
    """Open the dual-write window and capture the tenant (phase 1).
    Typed refusals: sharded tenants, unknown/dead targets, double
    migrations."""
    sid = int(sid)
    to_host = int(to_host)
    if fd.plan.regime(sid) == "sharded":
        raise MigrationError(
            f"tenant {sid} is sharded-regime: it already spans every "
            f"pod host — rebalance the capacity pool instead")
    if to_host not in (h.host_id for h in fd.pod.hosts):
        raise MigrationError(f"unknown migration target host {to_host}")
    if not fd.pod.is_alive(to_host):
        raise MigrationError(f"migration target host {to_host} is down")
    with fd._lock:
        if sid in fd._dual_writes:
            raise MigrationError(
                f"tenant {sid} is already migrating")
        session = MigrationSession(fd, sid, to_host)
        session.state = durability.capture_state(
            fd._sets[sid], tenant=f"sid{sid}")
        fd._dual_writes[sid] = session
    return session


def migrate_tenant(fd, sid: int, to_host: int | None = None,
                   during=None, via=None, tenant: str | None = None
                   ) -> dict:
    """One-shot live migration: begin -> copy -> [``during(fd)`` — the
    test/bench hook that drives traffic and deltas inside the dual-write
    window] -> finish.  Serves bit-exactly throughout; the whole move is
    one ``pod.migrate`` span.

    ``via`` (a ``wire.WireClient``) switches the transport: when source
    and destination are separate OS processes, the snapshot + journal
    tail ship as wire frames to whatever server the client points at
    (``to_host`` is then unused — the destination process installs the
    tenant).  Same dual-write window, same
    zero-non-expired-failure property, and the commit ACK's per-source
    CRCs are verified against the source's own post-drain state."""
    if via is not None:
        from ..wire.migrate import migrate_tenant_wire

        return migrate_tenant_wire(fd, sid, via, during=during,
                                   tenant=tenant)
    if to_host is None:
        raise MigrationError(
            "in-process migration needs to_host= (via= is the "
            "cross-process transport)")
    with obs_trace.span("pod.migrate", site=SITE, set_id=int(sid),
                        to=str(int(to_host))) as sp:
        session = begin_migration(fd, sid, to_host)
        sp.tag(from_host=str(session.from_host))
        try:
            session.copy()
            if during is not None:
                during(fd)
            report = session.finish()
        except BaseException:
            # typed or not, a failed migration must not leave the
            # tenant half-moved: drop the window, keep the source
            with fd._lock:
                fd._dual_writes.pop(int(sid), None)
            obs_metrics.counter("rb_migration_total",
                                status="failed").inc()
            raise
        sp.tag(bytes=report["bytes"], blip_ms=report["blip_ms"],
               records=report["catch_up_records"])
        obs_metrics.counter("rb_migration_total", status="ok").inc()
    return report


# -------------------------------------------------------------- elasticity

def host_join(fd, devices=None, qps=None) -> dict:
    """Grow the pod live: add a host (``PodMesh.join_host``), re-run the
    placement planner over the grown pod (``fd.rebalance`` ->
    ``insights.plan_pod_placement``), and migrate every tenant whose new
    plan homes it on the fresh host — no restart, queued tickets
    survive.  Returns ``{"host", "moved", "plan"}``."""
    new_host = fd.pod.join_host(devices)
    with fd._lock:
        # overrides pin tenants to their pre-join routes; the rebalance
        # below recomputes from scratch
        fd._route_overrides.clear()
    rep = fd.rebalance(qps=qps)
    moved = [s for s in range(fd.plan.n_tenants)
             if fd.owner_host(s) == new_host]
    obs_metrics.counter("rb_pod_host_joins_total").inc()
    return {"host": new_host, "moved": moved, "plan": rep["plan"],
            "changed": rep["changed"]}


def host_leave(fd, host_id: int, qps=None) -> dict:
    """Gracefully drain a host: live-migrate every tenant it serves to
    the rendezvous winner among the OTHER alive hosts, then mark it
    down.  Unlike a crash, nothing walks the reroute rung and nothing
    is lost — the orderly half of elasticity."""
    host_id = int(host_id)
    survivors = [h for h in fd.pod.alive() if h != host_id]
    if not survivors:
        raise MigrationError(
            f"cannot drain host {host_id}: it is the last alive host")
    moved = []
    for sid in range(fd.plan.n_tenants):
        if fd.plan.regime(sid) == "sharded":
            continue
        if fd.owner_host(sid) != host_id:
            continue
        to = podmesh.route(
            dataclasses.replace(fd.plan,
                                hosts=tuple((tuple(survivors),)
                                            * fd.plan.n_tenants)),
            sid, survivors)
        migrate_tenant(fd, sid, to)
        moved.append(sid)
    with fd._lock:
        fd.pod.mark_down(host_id)
        # retire the drained host's loop; any still-queued ticket (a
        # replica reader, say) walks the normal reroute rung
        loop = fd._loops.pop(host_id, None)
        for key in [k for k in fd._local_sid if k[0] == host_id]:
            del fd._local_sid[key]
        if loop is not None:
            for t in loop.evict_queued():
                t.pod_rerouted = False
                fd._reroute(t, host_id, "host_leave")
    obs_metrics.counter("rb_pod_host_leaves_total").inc()
    return {"host": host_id, "moved": moved}


def restore_host_tenants(fd, host_id: int, root: str,
                         tenants: dict) -> dict:
    """The host-loss recovery rung beyond reroute-to-replica: rebuild a
    DEAD host's single-copy tenants from their durable state and re-home
    them on the survivors.

    ``tenants`` maps set_id -> durable tenant name under ``root``
    (``durability.recover_tenant``'s coordinates).  For each tenant the
    dead host authoritatively owned, recovery loads snapshot + journal
    tail (bit-exact vs the lost memory by the durability invariant),
    swaps the set table, re-homes the tenant on the rendezvous winner
    among alive hosts, and rebuilds the touched loops.  Replicated
    tenants are skipped — the reroute rung already serves them."""
    host_id = int(host_id)
    if fd.pod.is_alive(host_id):
        raise MigrationError(
            f"host {host_id} is alive — restore is the LOSS rung; use "
            f"host_leave for a graceful drain")
    survivors = list(fd.pod.alive())
    if not survivors:
        raise MigrationError("no alive host to restore tenants onto")
    restored, reports, live = [], {}, {}
    for sid, name in sorted(tenants.items()):
        sid = int(sid)
        placed = fd.plan.hosts_of(sid)
        if host_id not in placed:
            continue
        if any(fd.pod.is_alive(h) for h in placed):
            continue        # a replica survives: reroute already serves
        with obs_trace.span("pod.migrate", site=SITE, set_id=sid,
                            from_host=str(host_id), restore=True) as sp:
            t0 = time.perf_counter()
            tenant, rep = durability.recover_tenant(
                root=root, tenant=name, device=fd.device)
            to = podmesh.route(
                dataclasses.replace(
                    fd.plan, hosts=tuple((tuple(survivors),)
                                         * fd.plan.n_tenants)),
                sid, survivors)
            with fd._lock:
                fd._sets[sid] = tenant.ds
                fd._route_overrides[sid] = to
                hosts = list(fd.plan.hosts)
                hosts[sid] = (to,)
                fd.plan = dataclasses.replace(fd.plan,
                                              hosts=tuple(hosts))
                fd._build_host(to)
            blip_ms = (time.perf_counter() - t0) * 1e3
            sp.tag(to=str(to), records=rep["replayed"],
                   bytes=0, blip_ms=round(blip_ms, 3))
            obs_metrics.counter("rb_migration_total",
                                status="restored").inc()
            reports[sid] = dict(rep, to=to)
            live[sid] = tenant       # keep journaling from here on
            restored.append(sid)
    return {"host": host_id, "restored": restored, "reports": reports,
            "tenants": live}
