"""Pod topology and tenant placement (``roaringbitmap_tpu.parallel
.podmesh``): where tenants live on a pod of hosts.

A :class:`PodMesh` is an ordered list of hosts, each owning a device group:

- **detected** (``PodMesh.detect()`` after ``multihost.initialize``): one
  host per ``torch.distributed`` rank, its devices gathered from every
  rank; only the local host's devices hold this process's shards, and
  :func:`global_put` places only those.
- **simulated** (``PodMesh.simulate(n, devices=...)``): a device list,
  which may repeat a device, cut into ``n`` host groups, all in this
  process; ``ROARING_TPU_POD_HOSTS`` sets the default host count.

``host_mesh(h)`` is one host's (rows x data) mesh, ``pod_mesh()`` spans
every alive host (the capacity regime's mesh, across processes in a
detected pod).  The port's gloo and NCCL groups both run a pod-spanning
dispatch, so :func:`supports_pod_dispatch` is True where the JAX
package's CPU backend says False.

Placement (:func:`place`, the pure math in
``insights.plan_pod_placement``): a tenant is ``sharded`` (capacity: its
rows across every host), ``replicated-N`` (a hot small tenant copied to N
hosts) or ``local`` (one host, least-loaded by bytes).  Routing
(:func:`route`) rendezvous-hashes a tenant over its alive placement hosts
with ``zlib.crc32``, so every host, of either package, computes the same
route, and losing a host moves only that host's tenants.

Observability: the ``pod.place`` span, ``rb_pod_tenants{regime}``,
``rb_pod_placement_bytes{host}`` and ``rb_pod_hosts{state}``.
"""

from __future__ import annotations

import dataclasses
import os
import zlib

import numpy as np
import torch

from ..insights import analysis as insights
from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace

#: the trace/metric site of pod placement and routing
SITE = "pod"

ENV_POD_HOSTS = "ROARING_TPU_POD_HOSTS"
ENV_REPLICATE_MAX = "ROARING_TPU_POD_REPLICATE_MAX"
ENV_HOT_SHARE = "ROARING_TPU_POD_HOT_SHARE"

#: tenants larger than this never replicate; also the capacity threshold
#: when no per-host budget resolves (64 MiB)
REPLICATE_MAX_BYTES = 64 << 20

#: a tenant whose query-rate share is >= HOT_SHARE_X times the uniform
#: share reads hot (a replication candidate)
HOT_SHARE_X = 2.0


@dataclasses.dataclass(frozen=True)
class HostInfo:
    """One pod host: a device group owned by one process (detected) or one
    slice of a device list (simulated)."""

    host_id: int
    process_index: int
    devices: tuple
    #: True when this process holds the host's shards (every host of a
    #: simulated pod; exactly one host of a detected pod)
    local: bool


def _default_devices() -> list:
    from .multihost import local_devices

    return local_devices()


class PodMesh:
    """Ordered host list and liveness: the pod's topology handle.
    Liveness is advisory (the front door marks hosts down on host-loss
    faults, routing skips them); meshes are built from the current alive
    set."""

    def __init__(self, hosts: list, local_host: int = 0):
        if not hosts:
            raise ValueError("a pod needs at least one host")
        self.hosts = list(hosts)
        self.local_host = int(local_host)
        self._down: set = set()

    @classmethod
    def detect(cls, n_hosts: int | None = None, devices=None) -> "PodMesh":
        """The runtime's pod: one host per rank when a process group of
        more than one rank is up (``devices``: this rank's devices), else a
        simulated pod over ``devices`` (``n_hosts``, default
        ``ROARING_TPU_POD_HOSTS`` or 2)."""
        from . import multihost

        if multihost.process_count() > 1:
            me = multihost.process_index()
            by_proc: dict = {}
            for d in multihost.global_devices(devices):
                by_proc.setdefault(d.process_index, []).append(d.device)
            hosts = [HostInfo(h, pid, tuple(by_proc[pid]),
                              local=(pid == me))
                     for h, pid in enumerate(sorted(by_proc))]
            local = next(h.host_id for h in hosts if h.local)
            return cls(hosts, local_host=local)
        if n_hosts is None:
            n_hosts = int(os.environ.get(ENV_POD_HOSTS, "2"))
        return cls.simulate(n_hosts, devices=devices)

    @classmethod
    def simulate(cls, n_hosts: int, devices=None) -> "PodMesh":
        """An in-process pod: ``devices`` (default: the visible cards; a
        device may repeat) cut into ``n_hosts`` contiguous groups."""
        devices = [torch.device(d) for d in
                   (devices if devices is not None else _default_devices())]
        n_hosts = int(n_hosts)
        if n_hosts < 1 or n_hosts > len(devices):
            raise ValueError(f"cannot simulate {n_hosts} hosts over "
                             f"{len(devices)} devices")
        per = len(devices) // n_hosts
        hosts = [HostInfo(h, 0, tuple(devices[h * per:(h + 1) * per]),
                          local=True)
                 for h in range(n_hosts)]
        return cls(hosts, local_host=0)

    # ------------------------------------------------------------ liveness

    @property
    def n_hosts(self) -> int:
        return len(self.hosts)

    @property
    def multi_process(self) -> bool:
        return any(not h.local for h in self.hosts)

    def alive(self) -> tuple:
        return tuple(h.host_id for h in self.hosts
                     if h.host_id not in self._down)

    def is_alive(self, host_id: int) -> bool:
        return host_id not in self._down

    def mark_down(self, host_id: int) -> None:
        self._down.add(int(host_id))
        obs_flight.record("host_down", site=SITE, host=str(host_id),
                          alive=len(self.alive()))
        self._push_gauges()

    def mark_up(self, host_id: int) -> None:
        self._down.discard(int(host_id))
        self._push_gauges()

    def join_host(self, devices=None) -> int:
        """Add one host to a simulated pod (sharing the last host's
        devices unless ``devices`` is given) and return its id.  A
        detected pod's process set is fixed at ``initialize``: joining
        there raises."""
        if self.multi_process:
            raise ValueError(
                "cannot join_host into a detected multi-process pod: the "
                "process group is fixed at initialize() — restart the pod "
                "with the new host enrolled")
        if devices is None:
            devices = self.hosts[-1].devices
        new_id = max(h.host_id for h in self.hosts) + 1
        self.hosts.append(HostInfo(new_id, 0,
                                   tuple(torch.device(d) for d in devices),
                                   local=True))
        self._push_gauges()
        return new_id

    def _push_gauges(self) -> None:
        obs_metrics.gauge("rb_pod_hosts", state="alive").set(
            len(self.alive()))
        obs_metrics.gauge("rb_pod_hosts", state="down").set(len(self._down))

    # -------------------------------------------------------------- meshes

    def host_mesh(self, host_id: int, specs=None, data: int = 1):
        """One host's (rows x data) mesh over its own devices."""
        from .sharded_engine import default_mesh

        h = self.hosts[host_id]
        return default_mesh(list(h.devices), data=data,
                            ranks=[h.process_index] * len(h.devices),
                            **({"specs": specs} if specs else {}))

    def pod_mesh(self, specs=None, data: int = 1):
        """The pod-spanning (rows x data) mesh over every alive host's
        devices, host-major, each shard owned by its host's process."""
        from .sharded_engine import default_mesh

        devs, ranks = [], []
        for h in self.hosts:
            if h.host_id in self._down:
                continue
            devs.extend(h.devices)
            ranks.extend([h.process_index] * len(h.devices))
        return default_mesh(devs, data=data, ranks=ranks,
                            **({"specs": specs} if specs else {}))

    def snapshot(self) -> dict:
        return {"n_hosts": self.n_hosts,
                "alive": list(self.alive()),
                "down": sorted(self._down),
                "local_host": self.local_host,
                "devices_per_host": [len(h.devices) for h in self.hosts],
                "multi_process": self.multi_process}


def supports_pod_dispatch() -> bool:
    """Whether a computation over a multi-process mesh can run.  The port
    dispatches over any ``torch.distributed`` group: NCCL on cards, and
    gloo (a CPU group, or ranks sharing a card, staging through host
    memory), so this is True; the JAX package's CPU backend cannot, and
    demotes the capacity regime there."""
    return True


def global_put(arr, mesh, spec) -> dict:
    """A host array placed under partition ``spec`` (``sharding.P``) over
    ``mesh``: {local shard: its block on the shard's device}.  Each
    process places only its own shards; nothing of another process's
    block goes to a device."""
    from ..ops.words import upload

    arr = np.asarray(arr)
    out = {}
    for i in mesh.local():
        sl = []
        for dim in range(arr.ndim):
            axes = spec[dim] if dim < len(spec) else None
            if axes is None:
                sl.append(slice(None))
                continue
            axes = axes if isinstance(axes, tuple) else (axes,)
            n, c = 1, 0
            for a in axes:
                c = c * mesh.shape[a] + mesh.coord(i, a)
                n *= mesh.shape[a]
            step = arr.shape[dim] // n
            sl.append(slice(c * step, (c + 1) * step))
        out[i] = upload(np.ascontiguousarray(arr[tuple(sl)]),
                        mesh.device_of(i))
    return out


# ------------------------------------------------------------- placement

@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """One deterministic tenant -> host assignment: ``regimes[sid]`` is
    ``"sharded"`` / ``"replicated-N"`` / ``"local"``, ``hosts[sid]`` the
    hosts holding that tenant (all hosts for the sharded regime)."""

    regimes: tuple
    hosts: tuple
    bytes_per_host: tuple
    over_budget: bool = False
    capacity_threshold: int = 0
    #: capacity tenants demoted to local because the backend cannot
    #: dispatch over a multi-process mesh (never, in the port)
    demoted_capacity: tuple = ()

    @property
    def n_tenants(self) -> int:
        return len(self.regimes)

    def hosts_of(self, sid: int) -> tuple:
        return self.hosts[sid]

    def regime(self, sid: int) -> str:
        return self.regimes[sid]

    def sharded_sids(self) -> tuple:
        return tuple(s for s, r in enumerate(self.regimes) if r == "sharded")

    def regime_counts(self) -> dict:
        out: dict = {}
        for r in self.regimes:
            key = r.split("-")[0]
            out[key] = out.get(key, 0) + 1
        return out

    def table(self) -> dict:
        """The routing table as plain JSON."""
        return {str(s): {"regime": self.regimes[s],
                         "hosts": list(self.hosts[s])}
                for s in range(self.n_tenants)}


def tenant_bytes_of(sets) -> list:
    """Per-tenant resident bytes (``insights.resident_set_bytes`` over
    each ``DeviceBitmapSet`` / ``BatchEngine``)."""
    out = []
    for s in sets:
        ds = getattr(s, "_ds", s)
        out.append(int(sum(insights.resident_set_bytes(ds).values())))
    return out


def place(sets, pod: PodMesh, budget_per_host: int | None = None,
          qps=None, replicate_max_bytes: int | None = None,
          hot_share_x: float | None = None) -> PlacementPlan:
    """Plan tenant placement over ``pod`` from the footprint model, the
    per-host budget (default: the guard's budget for the first set's
    device: ``ROARING_TPU_HBM_BUDGET``, else the card's free memory, none
    on the CPU) and optional per-tenant query rates."""
    from ..runtime import guard

    if budget_per_host is None:
        dev = getattr(getattr(sets[0], "_ds", sets[0]), "device", None) \
            if sets else None
        budget_per_host = guard.resolve_hbm_budget(None, dev)
    if replicate_max_bytes is None:
        replicate_max_bytes = int(os.environ.get(ENV_REPLICATE_MAX,
                                                 REPLICATE_MAX_BYTES))
    if hot_share_x is None:
        hot_share_x = float(os.environ.get(ENV_HOT_SHARE, HOT_SHARE_X))
    t_bytes = tenant_bytes_of(sets)
    with obs_trace.span("pod.place", site=SITE, hosts=pod.n_hosts,
                        tenants=len(t_bytes)) as sp:
        raw = insights.plan_pod_placement(
            t_bytes, pod.n_hosts, budget_per_host=budget_per_host,
            qps=qps, replicate_max_bytes=replicate_max_bytes,
            hot_share_x=hot_share_x)
        regimes = list(raw["regimes"])
        hosts = [tuple(h) for h in raw["hosts"]]
        loads = [int(b) for b in raw["bytes_per_host"]]
        demoted = []
        if "sharded" in regimes and not supports_pod_dispatch():
            for sid, r in enumerate(regimes):
                if r != "sharded":
                    continue
                share = t_bytes[sid] // pod.n_hosts
                loads = [b - share for b in loads]
                anchor = min(range(pod.n_hosts), key=lambda h: loads[h])
                loads[anchor] += t_bytes[sid]
                regimes[sid] = "local"
                hosts[sid] = (anchor,)
                demoted.append(sid)
        plan = PlacementPlan(
            regimes=tuple(regimes), hosts=tuple(hosts),
            bytes_per_host=tuple(loads),
            over_budget=bool(raw["over_budget"]),
            capacity_threshold=int(raw["capacity_threshold"]),
            demoted_capacity=tuple(demoted))
        counts = plan.regime_counts()
        for regime in ("sharded", "replicated", "local"):
            obs_metrics.gauge("rb_pod_tenants", regime=regime).set(
                counts.get(regime, 0))
        for h, b in enumerate(plan.bytes_per_host):
            obs_metrics.gauge("rb_pod_placement_bytes", host=str(h)).set(b)
        pod._push_gauges()
        sp.tag(regimes=counts, over_budget=plan.over_budget,
               capacity_threshold=plan.capacity_threshold,
               bytes_per_host=list(plan.bytes_per_host),
               demoted_capacity=len(demoted))
    return plan


# --------------------------------------------------------------- routing

def route(plan: PlacementPlan, sid: int, alive, salt: int = 0,
          overrides: dict | None = None) -> int | None:
    """Consistent tenant routing: the rendezvous winner among the tenant's
    alive placement hosts (``crc32(f"{sid}/{host}/{salt}")``, ties to the
    lower host id), None when none is alive.  ``overrides`` (sid ->
    host) is the live-migration flip map: an alive override wins, a dead
    one falls back to the rendezvous draw."""
    if overrides:
        ov = overrides.get(sid)
        if ov is not None and ov in set(alive):
            return ov
    alive = set(alive)
    candidates = [h for h in plan.hosts_of(sid) if h in alive]
    if not candidates:
        return None
    return max(candidates,
               key=lambda h: (zlib.crc32(f"{sid}/{h}/{salt}".encode()), -h))
