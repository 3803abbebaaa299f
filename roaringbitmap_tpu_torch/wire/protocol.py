"""Binary wire protocol: frame grammar and codecs
(``roaringbitmap_tpu.wire.protocol``).

Frames are an interchange format: for the same request, result or error
the port writes the same bytes as the JAX package, so either package's
client talks to either package's server.  The data plane reuses two byte
disciplines the repo already trusts:

- every frame is length+CRC framed like a journal record: ``u32
  payload_len | u32 crc32(payload) | payload``; a torn or garbled frame
  fails the CRC and dies as typed :class:`CorruptInput`;
- bitmap payloads (ad-hoc expression leaves, bitmap-form results,
  migration snapshot sources) are the portable ``format/spec.py`` bytes
  verbatim.

Frame payload grammar::

    payload = u8 ftype | u64 req_id | u32 header_len
            | header_len bytes of UTF-8 JSON header
            | concatenated binary blobs (lengths in header["blobs"])

``req_id`` is the client-assigned pipelining correlator (0 is reserved for
connection-level frames).  The module is transport-free (bytes in, bytes
out), shared by the server, the client and the tests.
"""

from __future__ import annotations

import json
import struct
import zlib

from ..core.bitmap import RoaringBitmap
from ..parallel import expr as expr_mod
from ..parallel.batch_engine import BatchQuery
from ..runtime import errors

#: connection preamble: 8 raw bytes before the first frame, so a
#: non-protocol peer is rejected before any JSON is parsed
WIRE_MAGIC = b"RBWIRE01"
WIRE_VERSION = 1

_FRAME = struct.Struct("<II")     # payload length, crc32(payload)
_HDR = struct.Struct("<BQI")      # ftype, req_id, header_len
#: one frame's payload ceiling — matches the journal's record ceiling
#: (a migration snapshot source above this is chunked across frames)
MAX_FRAME_BYTES = 1 << 28

# frame types ------------------------------------------------------------
T_HELLO = 1        # client -> server: version + auth token
T_WELCOME = 2      # server -> client: hello accepted
T_SUBMIT = 3       # client -> server: one ServingRequest
T_RESULT = 4       # server -> client: a done ticket's result
T_ERROR = 5        # server -> client: typed error frame (never a drop)
T_PING = 6         # client -> server: RTT floor probe
T_PONG = 7         # server -> client
T_DELTA = 8        # client -> server: apply_delta on a resident set
T_MIG_BEGIN = 9    # migration: snapshot metadata
T_MIG_STATE = 10   # migration: snapshot blobs (chunked)
T_MIG_DELTA = 11   # migration: journal-tail / dual-write records
T_MIG_COMMIT = 12  # migration: restore + install on the destination
T_MIG_ACK = 13     # server -> client: migration phase acknowledged

FRAME_NAMES = {
    T_HELLO: "hello", T_WELCOME: "welcome", T_SUBMIT: "submit",
    T_RESULT: "result", T_ERROR: "error", T_PING: "ping",
    T_PONG: "pong", T_DELTA: "delta", T_MIG_BEGIN: "mig_begin",
    T_MIG_STATE: "mig_state", T_MIG_DELTA: "mig_delta",
    T_MIG_COMMIT: "mig_commit", T_MIG_ACK: "mig_ack",
}


# ------------------------------------------------------------- framing

def encode_frame(ftype: int, req_id: int, header: dict,
                 blobs: tuple = ()) -> bytes:
    """One wire frame as bytes (outer length+CRC included)."""
    h = dict(header)
    if blobs:
        h["blobs"] = [len(b) for b in blobs]
    hb = json.dumps(h, separators=(",", ":")).encode()
    payload = _HDR.pack(ftype, req_id, len(hb)) + hb + b"".join(blobs)
    if len(payload) > MAX_FRAME_BYTES:
        raise ValueError(
            f"wire frame payload {len(payload)} bytes exceeds "
            f"MAX_FRAME_BYTES ({MAX_FRAME_BYTES}) — chunk the blobs")
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


def decode_payload(payload: bytes) -> tuple:
    """Frame payload -> ``(ftype, req_id, header, blobs)``.  Every
    malformed shape dies typed :class:`CorruptInput` — json/struct
    errors never escape raw."""
    try:
        ftype, req_id, hlen = _HDR.unpack_from(payload, 0)
        off = _HDR.size
        if hlen > len(payload) - off:
            raise errors.CorruptInput(
                f"wire frame header length {hlen} overruns payload")
        header = json.loads(payload[off:off + hlen].decode())
        if not isinstance(header, dict):
            raise errors.CorruptInput("wire frame header is not an object")
        off += hlen
        blobs = []
        for n in header.get("blobs", ()):
            n = int(n)
            if n < 0 or n > len(payload) - off:
                raise errors.CorruptInput(
                    f"wire frame blob length {n} overruns payload")
            blobs.append(bytes(payload[off:off + n]))
            off += n
        if off != len(payload):
            raise errors.CorruptInput(
                f"wire frame has {len(payload) - off} trailing bytes")
        return ftype, req_id, header, blobs
    except errors.CorruptInput:
        raise
    except Exception as exc:
        raise errors.CorruptInput(
            f"undecodable wire frame: {type(exc).__name__}: {exc}") \
            from None


def recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ConnectionError on EOF (the
    caller maps socket-level failures to typed PeerClosed)."""
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed mid-frame")
        buf += chunk
    return bytes(buf)


def read_frame(sock) -> tuple:
    """Blocking read of one frame -> ``(ftype, req_id, header, blobs)``.
    A CRC mismatch or oversized length is a GARBLED stream: typed
    :class:`CorruptInput` (the connection is unrecoverable — framing
    sync is lost)."""
    head = recv_exact(sock, _FRAME.size)
    length, crc = _FRAME.unpack(head)
    if length > MAX_FRAME_BYTES:
        raise errors.CorruptInput(
            f"wire frame length {length} exceeds MAX_FRAME_BYTES "
            f"(garbled stream)")
    payload = recv_exact(sock, length)
    if zlib.crc32(payload) != crc:
        raise errors.CorruptInput(
            f"wire frame CRC mismatch over {length} bytes "
            f"(torn or garbled frame)")
    return decode_payload(payload)


def garble(frame: bytes) -> bytes:
    """Deterministically corrupt one payload byte of an encoded frame
    (length intact, CRC now wrong) — the ``wire@garbage`` fault shape.
    The receiver's CRC check must convert this to CorruptInput."""
    if len(frame) <= _FRAME.size:
        return frame
    i = _FRAME.size + (len(frame) - _FRAME.size) // 2
    out = bytearray(frame)
    out[i] ^= 0xFF
    return bytes(out)


# -------------------------------------------------------- query codec

def _encode_expr(e, blobs: list):
    if isinstance(e, expr_mod.Ref):
        return {"t": "ref", "i": e.index}
    if isinstance(e, expr_mod.AdHoc):
        blobs.append(e.bm.serialize())
        return {"t": "adhoc", "b": len(blobs) - 1}
    if isinstance(e, expr_mod.ValuePred):
        return {"t": "vp", "col": e.col, "op": e.op,
                "lo": e.lo, "hi": e.hi}
    if isinstance(e, expr_mod.Agg):
        return {"t": "agg", "kind": e.kind, "col": e.col, "k": e.k,
                "found": (None if e.found is None
                          else _encode_expr(e.found, blobs))}
    if isinstance(e, expr_mod.Node):
        return {"t": "op", "op": e.op,
                "c": [_encode_expr(c, blobs) for c in e.children]}
    raise TypeError(f"unencodable expression node {type(e).__name__}")


def _decode_expr(n, blobs: list):
    t = n["t"]
    if t == "ref":
        return expr_mod.Ref(int(n["i"]))
    if t == "adhoc":
        return expr_mod.AdHoc(RoaringBitmap.deserialize(blobs[int(n["b"])]))
    if t == "vp":
        return expr_mod.ValuePred(str(n["col"]), str(n["op"]),
                                  int(n["lo"]), int(n["hi"]))
    if t == "agg":
        found = n.get("found")
        return expr_mod.Agg(str(n["kind"]), str(n["col"]), int(n["k"]),
                            None if found is None
                            else _decode_expr(found, blobs))
    if t == "op":
        return expr_mod.Node(str(n["op"]),
                             tuple(_decode_expr(c, blobs)
                                   for c in n["c"]))
    raise errors.CorruptInput(f"unknown wire expression node type {t!r}")


def encode_query(q) -> tuple:
    """BatchQuery | ExprQuery -> ``(header_fragment, blobs)``.  AdHoc
    leaves ship their snapshot as spec.py bytes verbatim."""
    blobs: list = []
    if isinstance(q, BatchQuery):
        return ({"kind": "flat", "op": q.op,
                 "operands": list(q.operands), "form": q.form}, blobs)
    if isinstance(q, expr_mod.ExprQuery):
        return ({"kind": "expr", "form": q.form,
                 "expr": _encode_expr(q.expr, blobs)}, blobs)
    raise TypeError(f"unencodable query type {type(q).__name__}")


def decode_query(h: dict, blobs: list):
    """Inverse of :func:`encode_query`; malformed encodings die typed
    CorruptInput (the server maps that to a per-request error frame)."""
    try:
        kind = h["kind"]
        if kind == "flat":
            return BatchQuery(str(h["op"]),
                              tuple(int(i) for i in h["operands"]),
                              str(h["form"]))
        if kind == "expr":
            return expr_mod.ExprQuery(_decode_expr(h["expr"], blobs),
                                      str(h["form"]))
        raise errors.CorruptInput(f"unknown wire query kind {kind!r}")
    except (errors.CorruptInput, errors.RoaringRuntimeError):
        raise
    except Exception as exc:
        raise errors.CorruptInput(
            f"undecodable wire query: {type(exc).__name__}: {exc}") \
            from None


# ------------------------------------------------------- result codec

def encode_result(res, *, degraded=False, wall_ms=None,
                  missed=False) -> tuple:
    """BatchResult (or delta/migration report dict) -> header + blobs.
    Bitmap-form results ride as one spec.py blob."""
    blobs: list = []
    h = {"degraded": bool(degraded), "missed": bool(missed)}
    if wall_ms is not None:
        h["wall_ms"] = float(wall_ms)
    if isinstance(res, dict):
        h["report"] = res
        return h, blobs
    h["cardinality"] = int(res.cardinality)
    if res.value is not None:
        h["value"] = int(res.value)
    if res.bitmap is not None:
        blobs.append(res.bitmap.serialize())
        h["bitmap"] = 0
    return h, blobs


class WireResult:
    """Client-side view of a RESULT frame — quacks like BatchResult
    (cardinality / bitmap / value) plus the serving-outcome fields the
    replay harness reads (degraded, missed, wall_ms, report)."""

    __slots__ = ("cardinality", "bitmap", "value", "degraded", "missed",
                 "wall_ms", "report")

    def __init__(self, h: dict, blobs: list):
        self.cardinality = int(h.get("cardinality", 0))
        self.value = h.get("value")
        self.degraded = bool(h.get("degraded", False))
        self.missed = bool(h.get("missed", False))
        self.wall_ms = h.get("wall_ms")
        self.report = h.get("report")
        self.bitmap = None
        if h.get("bitmap") is not None:
            self.bitmap = RoaringBitmap.deserialize(
                blobs[int(h["bitmap"])])


# -------------------------------------------------------- error codec

def error_fields(exc: BaseException) -> dict:
    """Exception -> typed error-frame header.  Total: every exception
    shape maps to SOME code (``failed`` is the catch-all), so the
    server can always answer with a frame instead of dropping."""
    h = {"cls": type(exc).__name__, "message": str(exc)}
    context = getattr(exc, "context", None)
    if isinstance(context, dict):
        try:
            json.dumps(context)
            h["context"] = context
        except (TypeError, ValueError):
            h["context"] = {k: repr(v) for k, v in context.items()}
    reason = getattr(exc, "reason", None)
    if isinstance(reason, str):
        h["reason"] = reason
    if isinstance(exc, errors.WireError):
        h["code"] = exc.code
    elif type(exc).__name__ == "AdmissionRejected":
        h["code"] = "admission_rejected"
    elif type(exc).__name__ == "RequestShed":
        h["code"] = "shed"
    elif isinstance(exc, errors.CorruptInput):
        h["code"] = "corrupt_input"
    else:
        h["code"] = "failed"
    h["retryable"] = bool(getattr(exc, "retryable", False))
    return h


def rehydrate_error(h: dict) -> BaseException:
    """Typed error-frame header -> a LOCAL typed exception the caller can
    catch by class: the wire taxonomy round-trips.  Unknown shapes land on
    :class:`RemoteFailed`, never on an untyped error."""
    from ..serving.loop import AdmissionRejected, RequestShed
    code = h.get("code", "failed")
    msg = str(h.get("message", ""))
    context = h.get("context") if isinstance(h.get("context"), dict) else {}
    reason = h.get("reason", code)
    if code == "admission_rejected":
        return AdmissionRejected(msg, str(reason), **context)
    if code == "shed":
        return RequestShed(msg, str(reason), **context)
    if code == "auth":
        return errors.AuthRejected(msg, **context)
    if code == "backpressure":
        return errors.WireBackpressure(msg, **context)
    if code == "hello_mismatch":
        return errors.WireHelloMismatch(msg, **context)
    if code == "peer_closed":
        return errors.PeerClosed(msg, **context)
    if code == "corrupt_input":
        return errors.CorruptInput(msg)
    cls = getattr(errors, str(h.get("cls", "")), None)
    if isinstance(cls, type) and issubclass(cls, errors.RoaringRuntimeError):
        exc = cls(msg)
        exc.context = context
        return exc
    return errors.RemoteFailed(msg, remote_cls=h.get("cls"), **context)
