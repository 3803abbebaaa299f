"""Multi-host bootstrap for the sharded engine
(``roaringbitmap_tpu.parallel.multihost``).

- ``initialize()`` wraps ``torch.distributed.init_process_group``: one
  process per host (or per card), a coordinator address, a rank.  The
  caller names the backend, ``nccl`` for the card and ``gloo`` for the CPU
  (or a card shared by two ranks, which NCCL refuses); it is never switched
  on failure.
- ``global_mesh()`` is a (rows, lanes) mesh over every process's devices,
  each column host-pure, so the row axis (the butterfly's
  accumulator-sized traffic) stays inside a host and the lane axis is the
  one that crosses hosts.

With one process both degenerate to the local mesh, so the same program
runs from one card to several hosts.
"""

from __future__ import annotations

import datetime
import os
import socket
import time

import numpy as np

#: default bound on the coordinator handshake, seconds (overridable per
#: call): a missing peer becomes a typed CoordinatorTimeout, not a hang
ENV_COORD_TIMEOUT = "ROARING_TPU_COORD_TIMEOUT_S"
DEFAULT_COORD_TIMEOUT = 120.0

#: the last bootstrap's observable state (``obs.snapshot()["multihost"]``)
_STATE: dict = {}


def snapshot() -> dict:
    """The last ``initialize`` attempt as plain JSON ({} when never
    called): coordinator, process_id, probe_ms (the pre-flight TCP probe's
    latency, the slow-coordinator early warning), timeout_s, backend,
    status ("probing" / "initializing" / "initialized" / "failed"), and
    process_count once joined."""
    return dict(_STATE)


def _init_method(address: str) -> str:
    if "://" in address:
        return address
    return f"tcp://{address}"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout: float | None = None,
               backend: str = "nccl") -> None:
    """Join (or bootstrap) the process group.

    ``coordinator_address`` is ``host:port`` (a TCP store on the rank-0
    process) or an init method URL (``file:///path/store`` for processes
    of one machine); None reads ``torch.distributed``'s ``env://``
    variables.  ``timeout`` (default ``ROARING_TPU_COORD_TIMEOUT_S``, 120 s)
    is ONE budget shared by the pre-flight TCP probe (ranks other than 0
    with a TCP address) and the group's own handshake.  An unreachable
    coordinator raises ``runtime.errors.CoordinatorTimeout`` naming the
    address and the process id; other failures (bad arguments, a second
    initialization) propagate unchanged."""
    from ..obs import trace as obs_trace
    from ..runtime import errors, faults

    if timeout is None:
        timeout = float(os.environ.get(ENV_COORD_TIMEOUT,
                                       DEFAULT_COORD_TIMEOUT))

    def describe() -> str:
        return (f"coordinator {coordinator_address or '<auto-detected>'}, "
                f"process_id {process_id if process_id is not None else '<auto>'}")

    deadline = time.monotonic() + timeout
    _STATE.clear()
    _STATE.update(coordinator=coordinator_address or "<auto-detected>",
                  process_id=process_id, timeout_s=timeout, probe_ms=None,
                  backend=backend, status="probing")
    with obs_trace.span(
            "multihost.initialize",
            coordinator=coordinator_address or "<auto-detected>",
            process_id=process_id if process_id is not None else "<auto>",
            timeout_s=timeout):
        try:
            faults.maybe_fail("multihost", "coordinator")
            if (coordinator_address and "://" not in coordinator_address
                    and process_id not in (None, 0)):
                # a peer that cannot reach the coordinator must fail typed
                # BEFORE the store client is entered
                _probe_coordinator(coordinator_address, timeout, deadline,
                                   describe, errors)
            import torch.distributed as dist

            _STATE["status"] = "initializing"
            remaining = max(deadline - time.monotonic(), 1.0)
            kw = {"timeout": datetime.timedelta(seconds=remaining)}
            if coordinator_address is not None:
                kw["init_method"] = _init_method(coordinator_address)
            if num_processes is not None:
                kw["world_size"] = int(num_processes)
            if process_id is not None:
                kw["rank"] = int(process_id)
            dist.init_process_group(backend, **kw)
            _STATE.update(status="initialized",
                          process_count=int(dist.get_world_size()))
        except errors.CoordinatorTimeout:
            _STATE["status"] = "failed"
            raise
        except Exception as exc:
            _STATE["status"] = "failed"
            if _is_handshake_failure(exc, errors):
                raise errors.CoordinatorTimeout(
                    f"multihost.initialize: {describe()} unreachable "
                    f"within {timeout:g}s: {exc}") from exc
            raise


def _is_handshake_failure(exc: BaseException, errors) -> bool:
    """A store or network failure of the handshake (torch.distributed's
    ``DistError`` family, or a message the taxonomy types as a
    coordinator or transient fault, or a timeout)."""
    try:
        import torch.distributed as dist

        if isinstance(exc, dist.DistError):
            return True
    except (ImportError, AttributeError):
        pass
    fault = errors.classify(exc)
    if isinstance(fault, (errors.CoordinatorTimeout,
                          errors.TransientDeviceError)):
        return True
    return "timed out" in str(exc).lower() or "timeout" in str(exc).lower()


def _probe_coordinator(address: str, timeout: float, deadline: float,
                       describe, errors) -> None:
    """Block until a TCP connection to the coordinator succeeds or the
    deadline passes (then a typed CoordinatorTimeout), retrying with
    backoff: the coordinator may bind a moment after its peers start."""
    host, _, port_s = address.rpartition(":")
    host = host.strip("[]")
    if not host or not port_s.isdigit():
        return
    from ..obs import metrics as obs_metrics

    t0 = time.monotonic()
    delay = 0.1
    while True:
        budget = deadline - time.monotonic()
        try:
            with socket.create_connection((host, int(port_s)),
                                          timeout=max(0.1, min(2.0, budget))):
                probe_s = time.monotonic() - t0
                _STATE["probe_ms"] = round(probe_s * 1e3, 3)
                obs_metrics.gauge("rb_multihost_probe_seconds").set(probe_s)
                return
        except OSError as exc:
            if time.monotonic() >= deadline:
                _STATE["probe_ms"] = round(
                    (time.monotonic() - t0) * 1e3, 3)
                raise errors.CoordinatorTimeout(
                    f"multihost.initialize: {describe()} unreachable "
                    f"within {timeout:g}s: {exc}") from exc
            time.sleep(min(delay, max(0.0, deadline - time.monotonic())))
            delay = min(delay * 2.0, 2.0)


class _Dev:
    """One device of the global view: its ``torch.device`` and owner."""

    __slots__ = ("device", "process_index")

    def __init__(self, device, process_index: int):
        self.device = device
        self.process_index = process_index

    def __repr__(self) -> str:
        return f"{self.device}@p{self.process_index}"


def local_devices(devices=None) -> list:
    """This process's devices: ``devices`` as given, else every visible
    card (one card a rank when a process group spans the cards)."""
    import torch

    if devices is not None:
        return [torch.device(d) for d in devices]
    from ..ops.words import resolve_device

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if not n:
        return [resolve_device(None)]
    if process_count() > 1:
        import torch.distributed as dist

        return [torch.device("cuda", dist.get_rank() % n)]
    return [torch.device("cuda", i) for i in range(n)]


def process_count() -> int:
    import torch.distributed as dist

    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def process_index() -> int:
    import torch.distributed as dist

    return (dist.get_rank()
            if dist.is_available() and dist.is_initialized() else 0)


def global_devices(devices=None) -> list:
    """Every process's devices in rank order, as ``_Dev`` records (one
    ``all_gather_object`` across a process group)."""
    import torch

    mine = [str(d) for d in local_devices(devices)]
    if process_count() <= 1:
        return [_Dev(torch.device(d), 0) for d in mine]
    import torch.distributed as dist

    allp: list = [None] * dist.get_world_size()
    dist.all_gather_object(allp, mine)
    return [_Dev(torch.device(d), rank) for rank, ds in enumerate(allp)
            for d in ds]


def global_mesh(lanes: int | None = None, row_axis: str = "rows",
                lane_axis: str = "lanes", devices=None):
    """A (rows, lanes) mesh over every device of every process.  Each
    column is filled with devices of one process wherever the
    factorization allows (the row length is the largest power of two that
    divides every process's device count); an explicit ``lanes`` that
    forces rows across processes is honored in process order.  The row
    length must be a power of two (the butterfly pairs by XOR).
    ``devices`` are this process's devices (default: its cards).  Inside
    a process group the mesh's communicator is the group's (``DistComm``),
    a group of one included.""" 
    import torch.distributed as dist

    from .sharding import DistComm, Mesh

    arr = _arrange(global_devices(devices), lanes)
    devs = np.empty(arr.shape, dtype=object)
    ranks = np.zeros(arr.shape, np.int64)
    for i, d in enumerate(arr.flat):
        devs.flat[i] = d.device
        ranks.flat[i] = d.process_index
    # inside a process group the mesh's sums and exchanges go through the
    # group's backend, a group of one included
    comm = (DistComm() if dist.is_available() and dist.is_initialized()
            else None)
    return Mesh(devs, (row_axis, lane_axis), ranks=ranks, comm=comm)


def _arrange(devices, lanes: int | None) -> np.ndarray:
    """Pure placement: the (rows, lanes) object array of global_mesh's
    contract, host-pure columns whenever the factorization allows."""
    n = len(devices)
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(getattr(d, "process_index", 0), []).append(d)
    local_counts = [len(v) for v in by_proc.values()]
    if lanes is None:
        rows = 1 << (min(local_counts).bit_length() - 1)
        while rows > 1 and any(lc % rows for lc in local_counts):
            rows >>= 1
        lanes = n // rows
    if lanes < 1 or n % lanes:
        raise ValueError(
            f"lane axis {lanes} does not divide the {n} global devices")
    rows = n // lanes
    if rows & (rows - 1):
        raise ValueError(
            f"row axis {rows} (= {n} devices / {lanes} lanes) must be a "
            "power of two: the bitwise reduce butterfly pairs partners by "
            "XOR; pick a different lane count")
    if all(lc % rows == 0 for lc in local_counts):
        cols = []
        for pid in sorted(by_proc):
            ds = by_proc[pid]
            cols.extend(ds[i:i + rows] for i in range(0, len(ds), rows))
        arr = np.empty((lanes, rows), dtype=object)
        for j, col in enumerate(cols):
            arr[j, :] = col
        return arr.T
    ordered = [d for pid in sorted(by_proc) for d in by_proc[pid]]
    arr = np.empty((lanes, rows), dtype=object)
    for j in range(lanes):
        arr[j, :] = ordered[j * rows:(j + 1) * rows]
    return arr.T
