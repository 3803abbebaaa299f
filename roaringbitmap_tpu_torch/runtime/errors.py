"""Typed error taxonomy of the guarded runtime (the port's own copy of
``roaringbitmap_tpu.runtime.errors``).

Raw failures arrive as exceptions with status text (a CUDA error, a torch
allocator failure, a status token in a message) or as format errors of a
serialized input.  ``classify`` maps them onto a small taxonomy that the
guard (``runtime.guard``) acts on mechanically:

  retryable              -> TransientDeviceError, CoordinatorTimeout
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
