"""Typed error taxonomy of the guarded runtime (the port's own copy of
``roaringbitmap_tpu.runtime.errors``).

Raw failures arrive as exceptions with status text (a CUDA error, a torch
allocator failure, a status token in a message) or as format errors of a
serialized input.  ``classify`` maps them onto a small taxonomy that the
guard (``runtime.guard``) acts on mechanically:

  retryable              -> TransientDeviceError, CoordinatorTimeout
                            (HostLost, its host-granular form)
  demote / split         -> ResourceExhausted
  demote (deterministic) -> EngineLoweringError
  fatal (input's fault)  -> CorruptInput (== format.spec.InvalidRoaringFormat)
  fatal (engine's fault) -> ShadowMismatch

``classify`` returns ``None`` for what looks like a programming error, and
the guard re-raises those untouched.  A failed kernel build or launch
(``ops.build.KernelBuildError``, ``ops.kernels.KernelLaunchError``), and a
failed graph capture or replay (``GraphCaptureError``), is one:
it is checked before any phrase match, so a launch that failed with
"out of memory" in its status text re-raises as it is and never demotes to
a plain rung that would hide the kernel.  ``torch.OutOfMemoryError`` (the
caching allocator's failure) is a ``ResourceExhausted``.
"""

from __future__ import annotations

import torch

from ..format.spec import InvalidRoaringFormat
from ..ops.build import KernelBuildError
from ..ops.kernels import KernelLaunchError

CorruptInput = InvalidRoaringFormat


class GraphCaptureError(RuntimeError):
    """Capturing or replaying a program's CUDA graph failed
    (``runtime.programs``).  Like a failed kernel launch it is never
    classified: nothing runs the eager path in its place."""


class RoaringRuntimeError(Exception):
    """Base of the runtime taxonomy (CorruptInput subclasses ValueError
    via InvalidRoaringFormat instead: the parse layers that raise it never
    import the runtime)."""

    #: bounded retry on the same engine rung can plausibly succeed
    retryable = False
    #: falling to the next engine rung can plausibly succeed
    demotable = False


class TransientDeviceError(RoaringRuntimeError):
    """Device/runtime hiccup (UNAVAILABLE, ABORTED, connection drop):
    retry with backoff; exhausted retries demote."""

    retryable = True
    demotable = True


class ResourceExhausted(RoaringRuntimeError):
    """Device OOM / allocator failure: halve the batch (less peak HBM)
    or demote to a cheaper engine; retrying the same shape cannot help."""

    demotable = True


class EngineLoweringError(RoaringRuntimeError):
    """Compiler/lowering failure (Mosaic rejection, unsupported primitive):
    deterministic for a given (engine, shape) — demote immediately."""

    demotable = True


class CoordinatorTimeout(RoaringRuntimeError):
    """Distributed coordinator unreachable / barrier timed out.  Message
    names the coordinator address and process id (multihost.initialize)."""

    retryable = True
    demotable = True


class HostLost(CoordinatorTimeout):
    """A pod host stopped answering (process death, network partition,
    preemption): the host-granular form of :class:`CoordinatorTimeout`.
    Raised typed by the pod front door (``serving.frontdoor``) when it
    marks a host down; the message names the host id.  Retryable and
    demotable like its base: the pod ladder's ``reroute`` rung serves the
    affected tenants from a replica or the single-host loop."""


class ShadowMismatch(RoaringRuntimeError):
    """Shadow cross-check found an engine result diverging from the CPU
    sequential reference: silent corruption — always fatal, never retried
    (a retry that happens to pass would hide a miscompiling engine)."""


class GraphPoolBudgetError(ResourceExhausted):
    """A lattice warmup whose predicted graph pool passes the device-memory
    budget (``guard.resolve_hbm_budget``): the vocabulary is refused, never
    shrunk in silence."""


class InjectedCrash(RoaringRuntimeError):
    """A ``crash`` fault rule fired (runtime.faults): the process is
    simulating its own death between a journal append and the in-memory
    apply.  Deliberately NOT retryable/demotable — nothing above the
    durability layer may catch-and-continue past a crash point; the only
    legal continuation is a fresh recovery (durability.recover_tenant),
    which is exactly what the crash-recovery property tests drive."""


class WireError(RoaringRuntimeError):
    """Base of the wire-boundary taxonomy (``wire``).  Everything the
    binary RPC front door can do to a caller surfaces as one of these (or
    as a re-hydrated serving/runtime type carried inside a typed error
    frame): raw ``socket`` / ``struct`` / ``json`` errors never cross the
    boundary in either direction.  ``code`` is the error-frame code the
    class round-trips through."""

    code = "wire"

    def __init__(self, msg: str = "", **context):
        super().__init__(msg)
        #: JSON-able detail that rode the error frame (reason, tenant, ...)
        self.context = dict(context)


class WireHelloMismatch(WireError):
    """The versioned hello failed: wrong magic, wrong protocol version, or
    a non-hello first frame.  Connection-fatal, but still delivered as a
    typed error frame before the close."""

    code = "hello_mismatch"


class AuthRejected(WireError):
    """The boundary check refused the caller before any bytes reached a
    ServingLoop: an unknown token at hello (connection-fatal) or a submit
    naming a tenant outside the token's grant (per request)."""

    code = "auth"


class WireBackpressure(WireError):
    """The per-connection pipelining window is full: the server refuses
    the submit with a typed frame instead of buffering without bound.
    Retryable: drain some responses and resubmit."""

    code = "backpressure"
    retryable = True


class PeerClosed(WireError):
    """The peer vanished mid-pipeline: every in-flight request on the
    connection fails with this, typed, instead of a raw
    ``ConnectionResetError``.  Retryable on a fresh connection."""

    code = "peer_closed"
    retryable = True


class RemoteFailed(WireError):
    """A server-side ticket failed with an exception class the client
    could not re-hydrate into a local type: the catch-all that keeps the
    no-raw-escapes contract total."""

    code = "failed"


class TornJournalTail(CorruptInput):
    """The LAST record of a write-ahead journal is incomplete or fails its
    CRC: the torn-write shape a crash mid-append leaves.  A torn tail is
    recoverable (truncate it: the record never committed); corruption
    anywhere before the tail is not and stays plain :class:`CorruptInput`,
    which this subclasses."""


#: message fragments -> taxonomy, checked in order (first hit wins), the
#: JAX package's tables unchanged.  OOM before transient: an exhausted-
#: resource status often also carries noise the transient patterns catch.
#: Two pattern tiers per class, both deliberately NARROW — a genuine bug
#: whose message merely brushes a keyword must stay unclassified (the
#: guard re-raises it raw): uppercase absl/gRPC status tokens matched
#: case-SENSITIVELY against the raw message, and multi-word lowercase
#: phrases no plausible programming error emits.  Bare short words
#: ("oom", "aborted", "coordinator") are excluded on purpose — "zoom",
#: "scan aborted: invalid plan state" etc. must not become retryable.
_OOM_TOKENS = ("RESOURCE_EXHAUSTED",)
_OOM_PHRASES = (
    "out of memory", "memory allocation failed", "exceeds the hbm",
    "exceeds available memory",
)
_LOWERING_PHRASES = (
    # "mosaic" is the TPU kernel compiler's name, kept so a message gets
    # the same class in both packages; a bare kernel name is not here, since
    # a TypeError naming a kernel function is a programming error
    "mosaic", "lowering failed", "unsupported primitive", "cannot lower",
    "unimplemented primitive", "not implemented for platform",
    "mlir translation rule",
)
_COORDINATOR_PHRASES = (
    "coordination service", "barrier timed out", "preemption notice",
    "heartbeat timeout",
)
_TRANSIENT_TOKENS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED",
                     "CANCELLED")
_TRANSIENT_PHRASES = (
    "deadline exceeded", "connection reset", "socket closed",
    "failed to connect", "network error", "transient",
)


def classify(exc: BaseException):
    """Raw exception -> taxonomy instance, or None for a programming error.

    Already-typed exceptions pass through unchanged (identity), so
    classification is idempotent and injected typed faults keep their
    class.  A kernel build or launch failure is never classified.  Then
    ``torch.OutOfMemoryError`` is a ResourceExhausted, and everything else
    is matched on its message text with the JAX package's phrase tables,
    so the same message gets the same class in both packages.
    """
    if isinstance(exc, (RoaringRuntimeError, InvalidRoaringFormat)):
        return exc
    if isinstance(exc, (KernelBuildError, KernelLaunchError,
                        GraphCaptureError)):
        return None
    msg = f"{type(exc).__name__}: {exc}"
    if isinstance(exc, torch.OutOfMemoryError):
        return ResourceExhausted(msg)
    low = msg.lower()
    if any(t in msg for t in _OOM_TOKENS) \
            or any(p in low for p in _OOM_PHRASES):
        return ResourceExhausted(msg)
    # not a blanket NotImplementedError match: a stubbed host method is a
    # programming error and must propagate raw, not demote engines; only
    # compiler-flavored messages classify as lowering failures
    if any(p in low for p in _LOWERING_PHRASES):
        return EngineLoweringError(msg)
    if any(p in low for p in _COORDINATOR_PHRASES):
        return CoordinatorTimeout(msg)
    if any(t in msg for t in _TRANSIENT_TOKENS) \
            or any(p in low for p in _TRANSIENT_PHRASES):
        return TransientDeviceError(msg)
    return None
