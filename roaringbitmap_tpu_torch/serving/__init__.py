"""The serving front end over the pooled engine
(``roaringbitmap_tpu.serving``, without the pod front door and live
migration).

- ``ServingLoop`` admits :class:`ServingRequest`\\ s (a ``BatchQuery`` or
  ``ExprQuery``, a tenant and a per-request deadline), coalesces them into
  ``MultiSetBatchEngine`` pools and dispatches when a pool fills or the
  oldest request's deadline, less the pool's predicted execute time, nears;
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
- :mod:`.replay` is the deterministic workload generator and its two
  replay arms.
"""

from .loop import (AdmissionRejected, PumpDriver, RequestShed,
                   ServingLoop, ServingPolicy, ServingRequest,
                   TenantPolicy, Ticket)
from .replay import (ReplayProfile, build_dataset, generate,
                     run_inproc, run_wire, sustained)
from .resident import (DescriptorRing, ResidentEscape, ResidentQueue,
                       RingBackpressure)

__all__ = ["ServingLoop", "ServingPolicy", "ServingRequest",
           "TenantPolicy", "Ticket", "AdmissionRejected", "RequestShed",
           "PumpDriver", "ResidentQueue", "DescriptorRing",
           "ResidentEscape", "RingBackpressure", "ReplayProfile",
           "build_dataset", "generate", "run_inproc", "run_wire",
           "sustained"]
