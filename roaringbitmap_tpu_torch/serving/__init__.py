"""The serving front end over the pooled engines
(``roaringbitmap_tpu.serving``).

- ``ServingLoop`` admits :class:`ServingRequest`\\ s (a ``BatchQuery`` or
  ``ExprQuery``, a tenant and a per-request deadline), coalesces them into
  ``MultiSetBatchEngine`` / ``ShardedBatchEngine`` pools and dispatches
  when a pool fills or the oldest request's deadline, less the pool's
  predicted execute time, nears;
- **admission control** rejects (typed :class:`AdmissionRejected`) when the
  resident bytes plus the pending footprint would pass the device-memory
  headroom, or a tenant queue is full;
- **load shedding** drops (typed :class:`RequestShed`) or degrades (bitmap
  to cardinality-only, per tenant) what cannot meet its deadline;
- **graceful degradation** under sustained overload walks a ladder and
  recovers symmetrically;
- the **resident lane** (``ServingPolicy(resident=True)``) serves pools of
  a sealed vocabulary through a descriptor ring whose consumer replays
  their captured graphs;
- the **pod front door** (:class:`PodFrontDoor`) routes a stream over one
  loop per pod host, forwards, reroutes on host loss and demotes to
  single-host mode; **live migration** (:mod:`.migration`) moves a tenant
  between hosts while it serves, and grows or drains hosts;
- :mod:`.replay` is the deterministic workload generator and its two
  replay arms.
"""

from .frontdoor import PodFrontDoor
from .loop import (AdmissionRejected, PumpDriver, RequestShed,
                   ServingLoop, ServingPolicy, ServingRequest,
                   TenantPolicy, Ticket)
from .migration import (MigrationError, MigrationSession,
                        begin_migration, host_join, host_leave,
                        migrate_tenant, restore_host_tenants)
from .replay import (ReplayProfile, build_dataset, generate,
                     run_inproc, run_wire, sustained)
from .resident import (DescriptorRing, ResidentEscape, ResidentQueue,
                       RingBackpressure)

__all__ = ["ServingLoop", "ServingPolicy", "ServingRequest",
           "TenantPolicy", "Ticket", "AdmissionRejected", "RequestShed",
           "PodFrontDoor", "MigrationSession", "MigrationError",
           "begin_migration", "migrate_tenant", "host_join", "host_leave",
           "restore_host_tenants", "PumpDriver", "ResidentQueue", "DescriptorRing",
           "ResidentEscape", "RingBackpressure", "ReplayProfile",
           "build_dataset", "generate", "run_inproc", "run_wire",
           "sustained"]
