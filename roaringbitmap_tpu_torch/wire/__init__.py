"""Binary RPC data plane: the network boundary of the serving stack
(``roaringbitmap_tpu.wire``).

A length+CRC framed, versioned binary protocol over TCP whose bitmap
payloads are the portable ``format/spec.py`` bytes verbatim, with
per-connection pipelining and frame coalescing, typed error frames for
every outcome, and auth checked at the boundary.  Frames are byte-equal
to the JAX package's, so either package's client talks to either
package's server.

- :mod:`.protocol`: frame grammar and codecs (transport-free);
- :mod:`.server`: threaded front door over a ``ServingLoop`` or a
  ``PodFrontDoor``, including the receiving half of a tenant migration;
- :mod:`.client`: the pipelining client;
- :mod:`.migrate`: a captured tenant state as frames, and the sending half
  of a migration (``migrate_tenant_wire``);
- :mod:`.bootstrap`: ``python -m roaringbitmap_tpu_torch.wire.bootstrap``,
  a deterministic second-process server.
"""

from .client import WireClient, WireTicket
from .migrate import WireMigrationSession, migrate_tenant_wire
from .protocol import MAX_FRAME_BYTES, WIRE_MAGIC, WIRE_VERSION, WireResult
from .server import WireServer

__all__ = ["WireServer", "WireClient", "WireTicket", "WireResult",
           "WireMigrationSession", "migrate_tenant_wire", "WIRE_MAGIC", "WIRE_VERSION", "MAX_FRAME_BYTES"]
