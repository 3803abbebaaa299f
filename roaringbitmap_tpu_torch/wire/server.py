"""Threaded binary RPC front door over a ServingLoop
(``roaringbitmap_tpu.wire.server``).

One ``WireServer`` owns a listening TCP socket, a reader thread per
connection and ONE pump thread driving the loop (the loop's own lock
arbitrates; its pump enters the loop's device and stream on that thread):

- **hello/auth first**: the 8-byte magic, the versioned HELLO frame and
  the token -> tenants grant are checked before any request reaches the
  loop;
- **pipelining**: many in-flight submits per connection, correlated by
  client-assigned req_id; responses complete OUT OF ORDER as pools finish,
  delivered through the loop's completion-listener seam;
- **frame coalescing**: all completions one pump produced for a
  connection go out as ONE ``sendall``;
- **typed outcomes only**: admission rejections, sheds, failures, auth
  refusals, decode garbage and backpressure all answer with a typed ERROR
  frame on the live connection; a dropped connection is never how an
  error is signalled;
- **migration, receiving half**: ``mig_begin`` / ``mig_state`` /
  ``mig_delta`` / ``mig_commit`` frames restore a captured tenant onto the
  server's device (``durability.restore_state`` + ``replay_record``) and
  answer with its per-source CRCs;
- **fault injection**: ``wire@{conn_drop,slow_peer,garbage}`` rules
  (``runtime.faults.maybe_wire``) fire on the response path.

The ``rpc.hello`` / ``rpc.submit`` / ``rpc.result`` spans are the JAX
package's: a submit's span parents into the client's ``rpc.call`` through
the trace context its header carries, so one request is one trace across
the socket.  Error frames count in ``rb_wire_error_frames_total{code}``,
received migrations in ``rb_wire_migrations_total``, and an exception on
the pump thread in ``rb_serving_pump_errors_total{site=wire}``.
"""

from __future__ import annotations

import logging
import select
import socket
import threading

from ..mutation import durability
from ..runtime import errors, faults
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..serving.loop import AdmissionRejected, ServingRequest
from . import protocol as wp

_log = logging.getLogger("roaringbitmap_tpu_torch.wire")

SITE = "wire"

#: per-connection in-flight ceiling: past it, submits answer typed
#: WireBackpressure frames instead of buffering unboundedly
DEFAULT_MAX_INFLIGHT = 256
#: how long the pump thread waits for MORE pipelined arrivals before
#: forcing a partial pool out — the wire-side batching window
COALESCE_S = 0.002
#: reader-side burst ceiling: at most this many already-buffered
#: SUBMIT frames are admitted under one loop-lock acquisition
SUBMIT_BATCH_MAX = 512


class _Conn:
    """One accepted connection's state: socket + write lock (the reader
    thread and the completion path both send), auth grant, in-flight
    req_id accounting."""

    def __init__(self, sock, addr):
        self.sock = sock
        self.addr = addr
        self.wlock = threading.Lock()
        self.alive = True
        self.tenants: tuple = ()      # granted tenants ("*" = all)
        self.inflight: set = set()    # outstanding req_ids
        self.mig: dict = {}           # mig_id -> in-progress migration

    def allows(self, tenant: str) -> bool:
        return "*" in self.tenants or tenant in self.tenants


class WireServer:
    """Serve a ``ServingLoop`` over TCP.

    ``auth=None`` runs open (every tenant granted); otherwise a dict
    ``{token: [tenant, ...]}`` (``"*"`` grants all tenants) checked at the
    boundary.  ``on_migrate(tenant, ds)`` receives a migrated tenant's
    restored DeviceBitmapSet, resident on the loop's device (default:
    parked in ``self.migrated``)."""

    def __init__(self, target, host: str = "127.0.0.1", port: int = 0,
                 auth: dict | None = None,
                 max_inflight: int = DEFAULT_MAX_INFLIGHT,
                 coalesce_s: float = COALESCE_S,
                 name: str = "server", on_migrate=None):
        self._target = target
        self._auth = None if auth is None else {
            str(k): tuple(str(t) for t in v) for k, v in auth.items()}
        self._max_inflight = int(max_inflight)
        self._coalesce_s = float(coalesce_s)
        self.name = str(name)
        self._on_migrate = on_migrate
        #: tenant -> restored DeviceBitmapSet (wire-migration landing
        #: zone when no ``on_migrate`` installer was given)
        self.migrated: dict = {}
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._alive = False
        self._conns: list = []
        self._lock = threading.Lock()
        #: ticket identity -> (conn, req_id): the pipelining correlator
        self._pending: dict = {}
        self._kick = threading.Event()
        self._threads: list = []
        self.stats = {"connections": 0, "submits": 0, "results": 0,
                      "errors": 0, "deltas": 0, "migrations": 0,
                      "coalesced_writes": 0, "frames_out": 0,
                      "pump_errors": 0}

    # ----------------------------------------------------------- lifecycle

    def start(self) -> "WireServer":
        self._alive = True
        self._target.add_completion_listener(self._on_complete)
        for fn, tag in ((self._accept_loop, "accept"),
                        (self._pump_loop, "pump")):
            th = threading.Thread(
                target=fn, name=f"wire-{self.name}-{tag}", daemon=True)
            th.start()
            self._threads.append(th)
        return self

    def stop(self) -> None:
        self._alive = False
        self._target.remove_completion_listener(self._on_complete)
        try:
            self._sock.close()
        except OSError:
            pass
        self._kick.set()
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            self._drop_conn(c)
        for th in self._threads:
            th.join(timeout=2.0)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # ----------------------------------------------------------- accepting

    def _accept_loop(self) -> None:
        while self._alive:
            try:
                sock, addr = self._sock.accept()
            except OSError:
                return                       # listener closed: shutdown
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn = _Conn(sock, addr)
            with self._lock:
                self._conns.append(conn)
            self.stats["connections"] += 1
            th = threading.Thread(target=self._conn_loop, args=(conn,),
                                  name=f"wire-{self.name}-conn", daemon=True)
            th.start()

    def _drop_conn(self, conn: _Conn) -> None:
        conn.alive = False
        try:
            conn.sock.close()
        except OSError:
            pass
        with self._lock:
            if conn in self._conns:
                self._conns.remove(conn)
            # orphan this connection's pending tickets: the loop will
            # still complete them (no cancellation mid-pool), but their
            # response frames have nowhere to go — the client sees
            # typed PeerClosed, never a silent drop of a LIVE socket
            for key in [k for k, (c, _) in self._pending.items()
                        if c is conn]:
                del self._pending[key]

    # ------------------------------------------------------------- serving

    def _send(self, conn: _Conn, frames: list) -> None:
        """Coalesced write of ``frames`` (already-encoded bytes) with
        the wire fault hook on the response path."""
        if not frames or not conn.alive:
            return
        scope = faults.maybe_wire("wire.server")
        if scope == "conn_drop":
            self._drop_conn(conn)
            return
        if scope == "garbage":
            frames = [wp.garble(frames[0])] + frames[1:]
        buf = b"".join(frames)
        try:
            with conn.wlock:
                conn.sock.sendall(buf)
        except OSError:
            self._drop_conn(conn)
            return
        self.stats["coalesced_writes"] += 1
        self.stats["frames_out"] += len(frames)

    def _send_error(self, conn: _Conn, req_id: int,
                    exc: BaseException) -> None:
        self.stats["errors"] += 1
        fields = wp.error_fields(exc)
        obs_metrics.counter("rb_wire_error_frames_total",
                            code=fields["code"]).inc()
        self._send(conn, [wp.encode_frame(wp.T_ERROR, req_id, fields)])

    def _conn_loop(self, conn: _Conn) -> None:
        try:
            if not self._handshake(conn):
                return
            while self._alive and conn.alive:
                ftype, req_id, header, blobs = wp.read_frame(conn.sock)
                if ftype != wp.T_SUBMIT:
                    self._handle(conn, ftype, req_id, header, blobs)
                    continue
                # pipelined burst: a submit_many lands as ONE TCP write,
                # so its sibling frames are already in the kernel buffer
                # — gather them and admit the whole batch under one
                # loop-lock acquisition.  Admitting one-at-a-time would
                # convoy with the pump (each lock-held pool dispatch
                # lets only ~1 admit through), collapsing pools toward
                # singletons and erasing the batching win the pipelining
                # exists for.
                batch = [(req_id, header, blobs)]
                tail = None
                while (len(batch) < SUBMIT_BATCH_MAX
                       and conn.alive
                       and select.select([conn.sock], [], [], 0)[0]):
                    nxt = wp.read_frame(conn.sock)
                    if nxt[0] != wp.T_SUBMIT:
                        tail = nxt       # first non-submit ends the burst
                        break
                    batch.append(nxt[1:])
                self._handle_submits(conn, batch)
                if tail is not None:
                    self._handle(conn, *tail)
        except errors.CorruptInput as exc:
            # garbled inbound stream: framing sync is lost — answer
            # with a connection-level typed error frame, then close
            self._send_error(conn, 0, exc)
            self._drop_conn(conn)
        except (ConnectionError, OSError):
            self._drop_conn(conn)
        except Exception:
            _log.exception("%s: connection handler died", SITE)
            self._drop_conn(conn)

    def _handshake(self, conn: _Conn) -> bool:
        magic = wp.recv_exact(conn.sock, len(wp.WIRE_MAGIC))
        if magic != wp.WIRE_MAGIC:
            self._send_error(conn, 0, errors.WireHelloMismatch(
                f"{SITE}: bad magic {magic!r} (want {wp.WIRE_MAGIC!r})"))
            self._drop_conn(conn)
            return False
        ftype, _, h, _ = wp.read_frame(conn.sock)
        with obs_trace.span("rpc.hello", site=SITE,
                            client=str(h.get("client", "?"))) as sp:
            if ftype != wp.T_HELLO or int(h.get("version", -1)) \
                    != wp.WIRE_VERSION:
                sp.tag(outcome="hello_mismatch")
                self._send_error(conn, 0, errors.WireHelloMismatch(
                    f"{SITE}: hello version "
                    f"{h.get('version')!r} != {wp.WIRE_VERSION} "
                    f"(frame type {ftype})"))
                self._drop_conn(conn)
                return False
            if self._auth is None:
                conn.tenants = ("*",)
            else:
                token = h.get("token")
                grant = self._auth.get(str(token)) \
                    if token is not None else None
                if grant is None:
                    sp.tag(outcome="auth_rejected")
                    self._send_error(conn, 0, errors.AuthRejected(
                        f"{SITE}: unknown or missing auth token",
                        reason="token"))
                    self._drop_conn(conn)
                    return False
                conn.tenants = grant
            sp.tag(outcome="accepted", version=wp.WIRE_VERSION)
        self._send(conn, [wp.encode_frame(
            wp.T_WELCOME, 0,
            {"version": wp.WIRE_VERSION, "server": self.name,
             "n_sets": getattr(self._target, "n_sets",
                               len(getattr(self._target, "_sets", ()))),
             "tenants": list(conn.tenants)})])
        return True

    def _handle(self, conn: _Conn, ftype: int, req_id: int,
                header: dict, blobs: list) -> None:
        if ftype == wp.T_PING:
            self._send(conn, [wp.encode_frame(wp.T_PONG, req_id, {})])
            return
        if ftype == wp.T_SUBMIT:
            self._handle_submit(conn, req_id, header, blobs)
            return
        if ftype == wp.T_DELTA:
            self._handle_delta(conn, req_id, header)
            return
        if ftype in (wp.T_MIG_BEGIN, wp.T_MIG_STATE, wp.T_MIG_DELTA,
                     wp.T_MIG_COMMIT):
            self._handle_migration(conn, ftype, req_id, header, blobs)
            return
        self._send_error(conn, req_id, errors.CorruptInput(
            f"{SITE}: unexpected frame type {ftype} "
            f"({wp.FRAME_NAMES.get(ftype, '?')})"))

    def _handle_submits(self, conn: _Conn, batch: list) -> None:
        """Admit a burst of SUBMIT frames under ONE loop-lock
        acquisition (RLock — the per-frame handler's own take nests).
        The pump cannot interleave a partial-pool dispatch between the
        batch's admits, so the assembled pools reflect the client's
        pipelining depth.  Per-frame semantics (auth, backpressure,
        decode, typed rejections) are unchanged."""
        if len(batch) == 1:
            self._handle_submit(conn, *batch[0])
            return
        with self._target._lock:
            for req_id, header, blobs in batch:
                self._handle_submit(conn, req_id, header, blobs)

    def _handle_submit(self, conn: _Conn, req_id: int, header: dict,
                       blobs: list) -> None:
        tenant = str(header.get("tenant", "default"))
        # boundary checks BEFORE any bytes reach the loop: grant, then the
        # pipelining window, then the decode
        with obs_trace.span_from(header.get("trace"), "rpc.submit",
                                 site=SITE, req_id=req_id,
                                 tenant=tenant) as sp:
            if not conn.allows(tenant):
                sp.tag(outcome="auth_rejected")
                self._send_error(conn, req_id, errors.AuthRejected(
                    f"{SITE}: tenant {tenant!r} outside this "
                    f"connection's grant", reason="tenant", tenant=tenant))
                return
            if len(conn.inflight) >= self._max_inflight:
                sp.tag(outcome="backpressure")
                self._send_error(conn, req_id, errors.WireBackpressure(
                    f"{SITE}: {len(conn.inflight)} requests in flight "
                    f"(cap {self._max_inflight}) — drain responses and "
                    f"resubmit", inflight=len(conn.inflight),
                    cap=self._max_inflight))
                return
            try:
                query = wp.decode_query(header.get("query") or {}, blobs)
                request = ServingRequest(
                    set_id=int(header.get("set_id", 0)), query=query,
                    tenant=tenant, deadline_ms=header.get("deadline_ms"))
                with self._target._lock:
                    ticket = self._target.submit(request)
                    with self._lock:
                        self._pending[id(ticket)] = (conn, req_id)
            except (AdmissionRejected, errors.RoaringRuntimeError,
                    errors.CorruptInput) as exc:
                sp.tag(outcome=wp.error_fields(exc)["code"])
                self._send_error(conn, req_id, exc)
                return
            except Exception as exc:
                sp.tag(outcome="corrupt_input")
                self._send_error(conn, req_id, errors.CorruptInput(
                    f"{SITE}: unserviceable submit: "
                    f"{type(exc).__name__}: {exc}"))
                return
            sp.tag(outcome="admitted", set_id=request.set_id)
        conn.inflight.add(req_id)
        self.stats["submits"] += 1
        self._kick.set()

    def _handle_delta(self, conn: _Conn, req_id: int,
                      header: dict) -> None:
        tenant = str(header.get("tenant", "default"))
        if not conn.allows(tenant):
            self._send_error(conn, req_id, errors.AuthRejected(
                f"{SITE}: tenant {tenant!r} outside this connection's "
                f"grant", reason="tenant", tenant=tenant))
            return
        try:
            sid = int(header.get("set_id", 0))
            adds = {int(k): v for k, v in
                    (header.get("adds") or {}).items()}
            removes = {int(k): v for k, v in
                       (header.get("removes") or {}).items()}
            # serialize with the pump: an escalated repack frees the
            # set's device buffers, and a dispatch mid-flight on the
            # OLD buffers would die unclassified ("buffer deleted"),
            # losing its pool's tickets — the loop lock is the same
            # RLock _pump_locked holds across assemble+dispatch
            with self._target._lock:
                if hasattr(self._target, "apply_delta"):
                    report = self._target.apply_delta(
                        sid, adds or None, removes or None)
                    report = report[0] if isinstance(report, list) \
                        else report
                else:
                    ds = self._target._engine._engines[sid]._ds
                    report = ds.apply_delta(adds or None,
                                            removes or None)
        except (errors.RoaringRuntimeError, errors.CorruptInput) as exc:
            self._send_error(conn, req_id, exc)
            return
        except Exception as exc:
            self._send_error(conn, req_id, errors.CorruptInput(
                f"{SITE}: unserviceable delta: "
                f"{type(exc).__name__}: {exc}"))
            return
        self.stats["deltas"] += 1
        h, bl = wp.encode_result({k: v for k, v in report.items()
                                  if isinstance(v, (int, float, str,
                                                    bool, type(None)))})
        self._send(conn, [wp.encode_frame(wp.T_RESULT, req_id, h,
                                          tuple(bl))])

    # ------------------------------------------------- completion delivery

    def _on_complete(self, tickets: list) -> None:
        """Completion-listener seam: map each completed ticket that a
        connection is waiting on to its response frame, coalesced into
        one write per connection."""
        per_conn: dict = {}
        with self._lock:
            routed = []
            for t in tickets:
                got = self._pending.pop(id(t), None)
                if got is not None:
                    routed.append((t, got[0], got[1]))
        for t, conn, req_id in routed:
            conn.inflight.discard(req_id)
            frame = self._ticket_frame(t, req_id)
            per_conn.setdefault(id(conn), (conn, []))[1].append(frame)
        for conn, frames in per_conn.values():
            self._send(conn, frames)

    def _ticket_frame(self, t, req_id: int) -> bytes:
        with obs_trace.span_from(t.trace_ctx, "rpc.result", site=SITE,
                                 req_id=req_id, outcome=t.status) as sp:
            if t.status == "done":
                self.stats["results"] += 1
                h, bl = wp.encode_result(t.result, degraded=t.degraded,
                                         wall_ms=t.wall_ms,
                                         missed=bool(t.missed))
                frame = wp.encode_frame(wp.T_RESULT, req_id, h, tuple(bl))
            else:
                self.stats["errors"] += 1
                exc = t.error if t.error is not None \
                    else errors.RemoteFailed(
                        f"{SITE}: ticket finished {t.status!r} with no "
                        f"error attached")
                fields = wp.error_fields(exc)
                obs_metrics.counter("rb_wire_error_frames_total",
                                    code=fields["code"]).inc()
                frame = wp.encode_frame(wp.T_ERROR, req_id, fields)
            sp.tag(frame_bytes=len(frame))
        return frame

    # ------------------------------------------------------------- pumping

    def _backlog(self) -> int:
        if hasattr(self._target, "backlog"):
            return self._target.backlog()
        return self._target._backlog()

    def _pump_loop(self) -> None:
        while self._alive:
            self._kick.wait(timeout=0.05)
            self._kick.clear()
            if not self._alive:
                return
            try:
                self._target.pump()
                # the wire batching window: wait a beat for more
                # pipelined arrivals, then force the partial pool out
                # so a lone request never waits for deadline pressure
                while self._alive and self._backlog() > 0:
                    if self._kick.wait(timeout=self._coalesce_s):
                        self._kick.clear()
                        self._target.pump()
                        continue
                    self._target.drain()
                    break
            except Exception as exc:   # keep pumping; stay visible
                self.stats["pump_errors"] += 1
                obs_metrics.counter("rb_serving_pump_errors_total",
                                    site=SITE,
                                    error_class=type(exc).__name__).inc()
                _log.exception("%s: pump thread error", SITE)

    # ----------------------------------------------------------- migration

    def _handle_migration(self, conn: _Conn, ftype: int, req_id: int,
                          header: dict, blobs: list) -> None:
        from . import migrate as wire_migrate

        mid = str(header.get("mig_id", "0"))
        tenant = str(header.get("tenant", "default"))
        if not conn.allows(tenant):
            self._send_error(conn, req_id, errors.AuthRejected(
                f"{SITE}: tenant {tenant!r} outside this connection's "
                f"grant", reason="tenant", tenant=tenant))
            return
        try:
            if ftype == wp.T_MIG_BEGIN:
                conn.mig[mid] = {"tenant": tenant,
                                 "meta": header.get("meta"),
                                 "blobs": [], "records": []}
                ack = {"phase": "begin"}
            elif ftype == wp.T_MIG_STATE:
                conn.mig[mid]["blobs"].extend(blobs)
                ack = {"phase": "state",
                       "got": len(conn.mig[mid]["blobs"])}
            elif ftype == wp.T_MIG_DELTA:
                conn.mig[mid]["records"].extend(
                    header.get("records") or [])
                ack = {"phase": "delta",
                       "got": len(conn.mig[mid]["records"])}
            else:                                      # T_MIG_COMMIT
                mig = conn.mig.pop(mid)
                state = wire_migrate.unflatten_state(
                    mig["meta"], mig["blobs"])
                ds = durability.restore_state(
                    state, device=getattr(self._target, "device", None))
                for rec in mig["records"]:
                    durability.replay_record(ds, rec)
                crcs = wire_migrate.source_crcs(ds)
                if self._on_migrate is not None:
                    self._on_migrate(mig["tenant"], ds)
                else:
                    self.migrated[mig["tenant"]] = ds
                self.stats["migrations"] += 1
                obs_metrics.counter("rb_wire_migrations_total").inc()
                ack = {"phase": "commit", "source_crcs": crcs,
                       "records": len(mig["records"]),
                       "bytes": sum(len(b) for b in mig["blobs"])}
        except KeyError:
            self._send_error(conn, req_id, errors.CorruptInput(
                f"{SITE}: migration frame for unknown stream {mid!r} "
                f"(begin never arrived?)"))
            return
        except (errors.RoaringRuntimeError, errors.CorruptInput) as exc:
            self._send_error(conn, req_id, exc)
            return
        except Exception as exc:
            self._send_error(conn, req_id, errors.CorruptInput(
                f"{SITE}: unserviceable migration frame: "
                f"{type(exc).__name__}: {exc}"))
            return
        self._send(conn, [wp.encode_frame(wp.T_MIG_ACK, req_id, ack)])
