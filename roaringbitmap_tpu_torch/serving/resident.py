"""The resident pool lane: a descriptor ring between the serving pump and
a consumer that replays sealed programs (``roaringbitmap_tpu.serving.resident``).

Steady-state serving pays a per-pool host dispatch: the pump plans the
pool, resolves a program and launches it, even when the sealed lattice
guarantees the program exists and the operands are resident.  This module
takes that path out for vocabulary traffic:

- :class:`DescriptorRing` is the work ring the pump writes into:
  fixed-capacity slots of ``(sig_id, seq, payload)`` descriptors and a
  completion-stamp array the consumer writes back, held in pinned host
  tensors on a card.  ``sig_id`` is a CLOSED enum over the sealed
  lattice's points (a mixed-radix index over its dimensions): a pool
  whose snapped point is outside the vocabulary cannot be described, so
  it demotes before it touches the ring.
- :class:`ResidentQueue` owns the ring and the consumer.  The consumer is
  the port's counterpart of the JAX package's interpreted twin: it pops
  the descriptor, replays the plan's sealed CUDA graph through the pooled
  engine's ``runtime.programs.ProgramCache`` (B5, with B1 and B3 inside
  the graph as the plan needs them) on the pump's stream, waits for an
  event recorded after the replay and its output copies, and only then
  stamps the completion.  The pump writes descriptors and polls stamps:
  ``engine.execute`` is never taken for a ring-served pool, which
  ``rb_serving_dispatches_total`` staying flat pins.  A persistent kernel
  polling the ring is not part of either package.
- Every exit from the lane is TYPED: :class:`ResidentEscape` with a
  ``reason`` in :data:`ESCAPE_REASONS` drops the pool back to the one-shot
  dispatch, counted (``rb_serving_resident_demotions_total{reason}``),
  never a silent fallback.
"""

from __future__ import annotations

import dataclasses

import torch

from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops.words import resolve_device
from ..runtime import errors, faults
from ..runtime import lattice as rt_lattice

#: the fault site of the resident lane
SITE = "resident"

#: every way a pool can leave the resident lane: ``vocabulary`` (the
#: pool's snapped point is outside the sealed lattice, or the plan cannot
#: take the megakernel rung), ``wedged`` (the ring is wedged or full),
#: ``backend`` (the engine cannot host the consumer), ``inactive`` (no
#: sealed vocabulary yet)
ESCAPE_REASONS = ("vocabulary", "wedged", "backend", "inactive")


class RingBackpressure(errors.RoaringRuntimeError):
    """Typed ring refusal: the descriptor was NOT written.  ``reason`` is
    ``"full"`` (capacity descriptors in flight) or ``"wedged"``."""

    def __init__(self, msg: str, reason: str, **context):
        super().__init__(msg)
        self.reason = reason
        self.context = dict(context)


class ResidentEscape(errors.RoaringRuntimeError):
    """Typed demotion out of the resident lane: the pool must be served by
    the one-shot dispatch.  ``reason`` is one of :data:`ESCAPE_REASONS`."""

    def __init__(self, reason: str, msg: str | None = None, **context):
        if reason not in ESCAPE_REASONS:
            raise ValueError(f"unknown resident escape reason {reason!r}")
        super().__init__(msg or f"resident escape: {reason}")
        self.reason = reason
        self.context = dict(context)


@dataclasses.dataclass(frozen=True)
class Descriptor:
    """One ring slot's content as the consumer sees it."""

    slot: int
    seq: int          # 1-based global push sequence number
    sig_id: int       # closed-enum lattice point id
    payload: object   # host-side pool handle


class DescriptorRing:
    """Fixed-capacity single-producer / single-consumer work ring.

    ``sig_id``, ``seq`` and ``stamp`` are host tensors, pinned when the
    ring serves a card (``device``; the card unless the caller asks for
    the CPU), written through NumPy views:

    - ``push`` writes a descriptor at ``head % capacity`` and advances
      ``head``: typed :class:`RingBackpressure` when the ring is full or
      wedged, never an overwrite;
    - ``pop`` hands the consumer the descriptor at ``tail % capacity``;
    - ``complete`` stamps a finished descriptor; stamps are FIFO, and one
      out of push order wedges the ring;
    - ``poll`` answers "has sequence number ``seq`` completed";
    - ``drain_barrier`` waits (on the fault clock) until everything pushed
      has stamped.
    """

    def __init__(self, capacity: int = 64, device=None):
        capacity = int(capacity)
        if capacity < 2 or capacity & (capacity - 1):
            raise ValueError(
                f"ring capacity must be a power of two >= 2: {capacity}")
        self.capacity = capacity
        self.device = resolve_device(device)
        pin = self.device.type == "cuda"
        self.sig_id = torch.full((capacity,), -1, dtype=torch.int32,
                                 pin_memory=pin)
        self.seq = torch.zeros(capacity, dtype=torch.int64, pin_memory=pin)
        self.stamp = torch.zeros(capacity, dtype=torch.int64,
                                 pin_memory=pin)
        self._sig_np = self.sig_id.numpy()
        self._seq_np = self.seq.numpy()
        self._stamp_np = self.stamp.numpy()
        self._payload: list = [None] * capacity
        self.head = 0        # total pushes (producer cursor)
        self.tail = 0        # total pops (consumer cursor)
        self.completed = 0   # highest FIFO-contiguous stamped seq
        self.wedged = False

    def depth(self) -> int:
        """Descriptors pushed but not yet popped."""
        return self.head - self.tail

    def in_flight(self) -> int:
        """Descriptors pushed but not yet stamped complete."""
        return self.head - self.completed

    def push(self, sig_id: int, payload: object) -> tuple:
        """Write one descriptor; returns ``(slot, seq)``."""
        if self.wedged:
            raise RingBackpressure("descriptor ring is wedged",
                                   reason="wedged", head=self.head,
                                   completed=self.completed)
        if self.in_flight() >= self.capacity:
            raise RingBackpressure(
                f"descriptor ring full: {self.capacity} in flight",
                reason="full", capacity=self.capacity,
                head=self.head, completed=self.completed)
        slot = self.head % self.capacity
        seq = self.head + 1
        self._sig_np[slot] = int(sig_id)
        self._seq_np[slot] = seq
        self._stamp_np[slot] = 0
        self._payload[slot] = payload
        self.head = seq
        return slot, seq

    def pop(self) -> Descriptor:
        if self.tail >= self.head:
            raise IndexError("pop on an empty descriptor ring")
        slot = self.tail % self.capacity
        d = Descriptor(slot=slot, seq=int(self._seq_np[slot]),
                       sig_id=int(self._sig_np[slot]),
                       payload=self._payload[slot])
        self._payload[slot] = None
        self.tail += 1
        return d

    def complete(self, slot: int, seq: int) -> None:
        """Stamp descriptor ``seq`` complete at ``slot`` (FIFO: anything
        but ``completed + 1`` wedges)."""
        if seq != self.completed + 1 or int(self._seq_np[slot]) != seq:
            self.wedged = True
            raise RingBackpressure(
                f"out-of-order completion stamp: seq {seq} at slot "
                f"{slot}, expected {self.completed + 1}",
                reason="wedged", seq=seq, slot=slot,
                completed=self.completed)
        self._stamp_np[slot] = seq
        self.completed = seq

    def poll(self, seq: int) -> bool:
        return self.completed >= int(seq)

    def wedge(self) -> None:
        """Mark the ring wedged: every later push is typed backpressure
        until ``reset``."""
        self.wedged = True

    def reset(self) -> None:
        """Drop all state (the recovery path after a wedge)."""
        self._sig_np[:] = -1
        self._seq_np[:] = 0
        self._stamp_np[:] = 0
        self._payload = [None] * self.capacity
        self.head = self.tail = self.completed = 0
        self.wedged = False

    def drain_barrier(self, timeout_s: float = 5.0) -> None:
        """Wait (fault clock) until every pushed descriptor stamped.  A
        wedged ring cannot drain: typed backpressure, not a hang."""
        t0 = faults.clock()
        while self.completed < self.head:
            if self.wedged:
                raise RingBackpressure("drain barrier on a wedged ring",
                                       reason="wedged",
                                       completed=self.completed,
                                       head=self.head)
            if faults.clock() - t0 > timeout_s:
                self.wedged = True
                raise RingBackpressure(
                    f"drain barrier timed out after {timeout_s}s",
                    reason="wedged", completed=self.completed,
                    head=self.head)
            faults.advance_clock(1e-4)

    def state_event(self) -> dict:
        """The ring's cursors as plain JSON."""
        return {"capacity": self.capacity, "depth": self.depth(),
                "in_flight": self.in_flight(), "head": self.head,
                "tail": self.tail, "completed": self.completed,
                "wedged": self.wedged}


def signature_id(lat, point) -> int | None:
    """The closed-enum descriptor id of a snapped lattice point: a
    mixed-radix index over the sealed vocabulary's dimension tuples (the
    JAX package's order, so both packages give each point the same id).
    None when the point is outside the vocabulary."""
    if point is None or point.delta or not lat.contains(point):
        return None
    dims = ((tuple(sorted(point.ops)), lat.op_sets),
            (point.q, lat.q), (point.rows, lat.rows),
            (point.keys, lat.keys), (bool(point.heads), lat.heads),
            (point.expr, lat.expr),
            (point.pool, (0,) + tuple(lat.pool)),
            (point.bsi, (0,) + tuple(lat.bsi)))
    sig = 0
    for val, rungs in dims:
        rungs = tuple(rungs)
        if val not in rungs:
            return None
        sig = sig * len(rungs) + rungs.index(val)
    return sig


class ResidentQueue:
    """The resident lane over one pooled engine: seal the vocabulary, then
    ``serve(groups)`` pushes a descriptor and polls its stamp instead of
    dispatching.  Built for ``MultiSetBatchEngine``; any engine without
    its plan and program internals is a typed ``backend`` escape."""

    #: engine internals the consumer requires, resolved by duck type
    _ENGINE_ATTRS = ("_flatten", "_plan_pool", "_pool_engine", "_program",
                     "_readback", "_regroup")

    def __init__(self, engine, capacity: int = 64):
        self._engine = engine
        self.ring = DescriptorRing(
            capacity, device=getattr(engine, "device", "cpu"))
        self._lat = None
        self.stats = {"served": 0, "demoted": 0, "pushed": 0}

    @property
    def active(self) -> bool:
        return self._lat is not None

    def seal_vocab(self) -> bool:
        """Adopt the process's SEALED lattice as the descriptor vocabulary;
        False (every serve an ``inactive`` escape) without one."""
        lat = rt_lattice.active()
        if lat is None or not lat.sealed:
            self._lat = None
            return False
        self._lat = lat
        return True

    def drain(self, timeout_s: float = 5.0) -> None:
        if self.ring.head:
            self.ring.drain_barrier(timeout_s)

    def serve(self, groups) -> list:
        """Serve one pool through the ring; returns per-group result lists
        like ``engine.execute``.  Typed :class:`ResidentEscape` on ANY exit
        from the lane."""
        if self._lat is None:
            raise ResidentEscape("inactive")
        eng = self._engine
        for attr in self._ENGINE_ATTRS:
            if not hasattr(eng, attr):
                raise ResidentEscape("backend", engine=type(eng).__name__)
        pooled, lengths = eng._flatten(groups)
        if not pooled:
            return [[] for _ in groups]
        pooled = tuple(pooled)
        plan = eng._plan_pool(pooled)
        rung = eng._pool_engine(plan, "megakernel",
                                note=plan.mega is not None)
        if rung != "megakernel":
            # no one-kernel program for this pool (no fused section, or
            # past B5's capacity): outside the lane's vocabulary
            raise ResidentEscape("vocabulary", rung=rung)
        sig_id = signature_id(self._lat, plan.point)
        if sig_id is None:
            raise ResidentEscape("vocabulary",
                                 point=None if plan.point is None
                                 else plan.point.as_dict())
        try:
            slot, seq = self.ring.push(sig_id, (plan.signature,
                                                len(pooled)))
        except RingBackpressure as exc:
            self.stats["demoted"] += 1
            raise ResidentEscape("wedged", str(exc),
                                 **exc.context) from exc
        self.stats["pushed"] += 1
        faults.maybe_delay(SITE)
        flat = self._consume(plan, pooled, slot, seq)
        if not self.ring.poll(seq):
            raise ResidentEscape("wedged", "completion stamp missing",
                                 seq=seq)
        self.stats["served"] += 1
        obs_metrics.counter("rb_serving_resident_pools_total",
                            site=SITE).inc()
        cur = obs_trace.current()
        cur.event("expr.megakernel", **plan.mega.stats_event())
        cur.event("mega.resident", site=SITE, outcome="served",
                  sig_id=int(sig_id), seq=int(seq), slot=int(slot),
                  pool=len(pooled))
        cur.event("mega.queue", site=SITE, **self.ring.state_event())
        return eng._regroup(flat, lengths)

    def _consume(self, plan, pooled, slot: int, seq: int) -> list:
        """The consumer: pop the descriptor, replay the plan's sealed
        program (its CUDA graph on the card, through the engine's program
        cache, on the current stream), wait for the event recorded after
        the replay and the copies of its outputs, stamp, read back."""
        eng = self._engine
        d = self.ring.pop()
        if (d.slot, d.seq) != (slot, seq):
            self.ring.wedge()
            raise ResidentEscape("wedged", "descriptor out of order",
                                 slot=d.slot, seq=d.seq)
        outs = eng._program(plan, "megakernel")
        if self.ring.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
            done.synchronize()
        self.ring.complete(d.slot, d.seq)
        return eng._readback(plan, outs, pooled, "megakernel", False)

