"""Pipelining wire client: many in-flight submits, typed errors only
(``roaringbitmap_tpu.wire.client``).

``WireClient`` holds a blocking socket and one reader thread resolving
responses OUT OF ORDER by req_id.  ``submit`` returns a
:class:`WireTicket` future at once; ``submit_many`` coalesces a batch into
one ``sendall``; ``call`` is one request per round trip.  A dead peer fails
every in-flight ticket with typed :class:`PeerClosed`, a garbled stream
with typed :class:`CorruptInput`: raw ``socket`` / ``struct`` errors never
reach the caller.  It speaks the JAX package's frames byte for byte, so it
talks to either package's server.
"""

from __future__ import annotations

import socket
import threading
import time

from ..obs import trace as obs_trace
from ..runtime import errors, faults
from . import protocol as wp

SITE = "wire"


class WireTicket:
    """One in-flight request's caller handle (the wire twin of
    ``serving.Ticket``): ``status`` pending -> done | failed;
    ``result`` a :class:`protocol.WireResult` when done, ``error`` the
    rehydrated typed exception when failed."""

    __slots__ = ("req_id", "request", "status", "result", "error",
                 "sent_at", "done_at", "_event")

    def __init__(self, req_id: int, request=None):
        self.req_id = req_id
        self.request = request
        self.status = "pending"
        self.result = None
        self.error = None
        #: perf_counter stamps (send / response-landed) — the replay
        #: harness's client-observed latency, wire time included
        self.sent_at: float | None = None
        self.done_at: float | None = None
        self._event = threading.Event()

    @property
    def ok(self) -> bool:
        return self.status == "done"

    def wait(self, timeout: float | None = None) -> "WireTicket":
        if not self._event.wait(timeout):
            raise errors.CoordinatorTimeout(
                f"{SITE}: no response for req {self.req_id} within "
                f"{timeout}s (peer wedged?)")
        return self

    def value(self, timeout: float | None = None):
        """Result or typed raise — the blocking accessor."""
        self.wait(timeout)
        if self.error is not None:
            raise self.error
        return self.result


class WireClient:
    """Connect, speak the versioned hello, then pipeline requests."""

    def __init__(self, address, token: str | None = None,
                 client: str = "rb-wire-client", timeout: float = 30.0,
                 connect_timeout: float = 10.0):
        self.address = tuple(address)
        self.timeout = float(timeout)
        self._sock = socket.create_connection(self.address,
                                              timeout=connect_timeout)
        self._sock.settimeout(None)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict = {}
        self._next_id = 0
        self._dead: BaseException | None = None
        #: req_ids in the order their responses LANDED — the
        #: out-of-order pipelining evidence the tests read
        self.completion_order: list = []
        self.stats = {"submits": 0, "results": 0, "errors": 0,
                      "coalesced_writes": 0}
        self._sock.sendall(wp.WIRE_MAGIC + wp.encode_frame(
            wp.T_HELLO, 0, {"version": wp.WIRE_VERSION,
                            "client": str(client),
                            **({"token": token} if token is not None
                               else {})}))
        ftype, _, h, _ = wp.read_frame(self._sock)
        if ftype == wp.T_ERROR:
            self._sock.close()
            raise wp.rehydrate_error(h)
        if ftype != wp.T_WELCOME:
            self._sock.close()
            raise errors.WireHelloMismatch(
                f"{SITE}: expected welcome, got frame type {ftype}")
        self.server = dict(h)
        self._reader = threading.Thread(target=self._read_loop,
                                        name="wire-client-reader",
                                        daemon=True)
        self._reader.start()

    # ------------------------------------------------------------ plumbing

    def close(self) -> None:
        self._fail_all(errors.PeerClosed(
            f"{SITE}: connection closed locally"))

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            if self._dead is None:
                self._dead = exc
            pending, self._pending = self._pending, {}
        try:
            self._sock.close()
        except OSError:
            pass
        for t in pending.values():
            t.status = "failed"
            t.error = exc
            t._event.set()

    def _read_loop(self) -> None:
        try:
            while True:
                ftype, req_id, h, blobs = wp.read_frame(self._sock)
                if ftype == wp.T_ERROR and req_id == 0:
                    # connection-level typed error: hello/auth refusal
                    # or a garbled-inbound verdict — everything in
                    # flight fails with the server's reason
                    self._fail_all(wp.rehydrate_error(h))
                    return
                with self._lock:
                    t = self._pending.pop(req_id, None)
                    if t is not None:
                        self.completion_order.append(req_id)
                if t is None:
                    continue                    # pong / late duplicate
                t.done_at = time.perf_counter()
                if ftype == wp.T_RESULT:
                    t.result = wp.WireResult(h, blobs)
                    t.status = "done"
                    self.stats["results"] += 1
                elif ftype == wp.T_PONG:
                    t.status = "done"
                elif ftype == wp.T_MIG_ACK:
                    t.result = dict(h)
                    t.status = "done"
                else:
                    t.error = wp.rehydrate_error(h)
                    t.status = "failed"
                    self.stats["errors"] += 1
                t._event.set()
        except errors.CorruptInput as exc:
            self._fail_all(exc)
        except (ConnectionError, OSError) as exc:
            self._fail_all(errors.PeerClosed(
                f"{SITE}: peer vanished mid-pipeline "
                f"({type(exc).__name__}: {exc})"))

    def _write(self, frames: list) -> None:
        if self._dead is not None:
            raise self._dead
        scope = faults.maybe_wire("wire.client")
        if scope == "conn_drop":
            self._fail_all(errors.PeerClosed(
                f"{SITE}: injected conn_drop mid-pipeline "
                f"(ROARING_TPU_FAULTS)"))
            raise self._dead
        if scope == "garbage":
            frames = [wp.garble(frames[0])] + frames[1:]
        try:
            with self._wlock:
                self._sock.sendall(b"".join(frames))
        except OSError as exc:
            self._fail_all(errors.PeerClosed(
                f"{SITE}: send failed ({type(exc).__name__}: {exc})"))
            raise self._dead from None
        self.stats["coalesced_writes"] += 1

    def _reserve(self, request=None) -> WireTicket:
        with self._lock:
            self._next_id += 1
            t = WireTicket(self._next_id, request)
            self._pending[t.req_id] = t
        return t

    # ------------------------------------------------------------- queries

    def _submit_frame(self, t: WireTicket, request) -> bytes:
        qh, blobs = wp.encode_query(request.query)
        # the call's span context rides the header: the server's
        # rpc.submit parents into it (None with tracing off)
        with obs_trace.span("rpc.call", site=SITE, req_id=t.req_id,
                            tenant=request.tenant,
                            set_id=request.set_id) as sp:
            header = {"set_id": request.set_id,
                      "tenant": request.tenant, "query": qh,
                      "trace": obs_trace.inject(sp)}
            if request.deadline_ms is not None:
                header["deadline_ms"] = request.deadline_ms
            frame = wp.encode_frame(wp.T_SUBMIT, t.req_id, header,
                                    tuple(blobs))
            sp.tag(frame_bytes=len(frame))
        return frame

    def submit(self, request) -> WireTicket:
        """Pipeline one ServingRequest; returns its future at once."""
        t = self._reserve(request)
        t.sent_at = time.perf_counter()
        self._write([self._submit_frame(t, request)])
        self.stats["submits"] += 1
        return t

    def submit_many(self, requests) -> list:
        """Frame-coalesced pipelined submission: every request encoded
        up front, ONE sendall — the syscall-floor amortization the
        pod_replay lane measures against ``call``."""
        tickets = [self._reserve(r) for r in requests]
        frames = [self._submit_frame(t, r)
                  for t, r in zip(tickets, requests)]
        now = time.perf_counter()
        for t in tickets:
            t.sent_at = now
        if frames:
            self._write(frames)
        self.stats["submits"] += len(tickets)
        return tickets

    def call(self, request, timeout: float | None = None):
        """One request per round trip (the unpipelined baseline):
        submit, block, return the WireResult or raise typed."""
        return self.submit(request).value(timeout or self.timeout)

    def ping(self) -> None:
        """One round trip with no serving work — the RTT floor."""
        t = self._reserve()
        self._write([wp.encode_frame(wp.T_PING, t.req_id, {})])
        t.wait(self.timeout)

    def apply_delta(self, set_id: int, adds=None, removes=None,
                    tenant: str = "default",
                    timeout: float | None = None):
        """Remote mutation: ship a delta, return the apply report."""
        t = self._reserve()
        h = {"set_id": int(set_id), "tenant": tenant}
        if adds:
            h["adds"] = {int(k): [int(x) for x in v]
                         for k, v in adds.items()}
        if removes:
            h["removes"] = {int(k): [int(x) for x in v]
                            for k, v in removes.items()}
        self._write([wp.encode_frame(wp.T_DELTA, t.req_id, h)])
        res = t.value(timeout or self.timeout)
        return res.report if isinstance(res, wp.WireResult) else res

    # ----------------------------------------------------------- migration

    def migrate_frames(self, frames: list, timeout: float | None = None):
        """Send migration frames ``(ftype, header, blobs)`` pipelined, wait
        for each ACK in turn; returns the LAST ack header (the commit
        report)."""
        tickets = []
        out = []
        for ftype, header, blobs in frames:
            t = self._reserve()
            out.append(wp.encode_frame(ftype, t.req_id, dict(header),
                                       tuple(blobs)))
            tickets.append(t)
        self._write(out)
        acks = [t.value(timeout or self.timeout) for t in tickets]
        return acks[-1] if acks else None
