"""Tenant state as wire frames (``roaringbitmap_tpu.wire.migrate``, the
state half).

A migration ships ``durability.capture_state`` (spec bitmap bytes
verbatim) and the journal-tail records as frames::

    MIG_BEGIN  {mig_id, tenant, meta}       snapshot metadata, blob
                                            slots as {"__blob__": i}
    MIG_STATE  {mig_id} + blobs             snapshot bytes, chunked
    MIG_DELTA  {mig_id, records: [...]}     journal-vocabulary records
    MIG_COMMIT {mig_id}                     destination restores +
                                            replays + installs
    MIG_ACK    {source_crcs, bytes, ...}    bit-exactness evidence

The receiving half is ``WireServer``'s; this module holds what both ends
share (:func:`flatten_state` / :func:`unflatten_state`, the frames of one
captured state, :func:`state_frames`, and the per-source CRCs the commit
ACK carries, :func:`source_crcs`) and the sending half:
:class:`WireMigrationSession` rides a pod front door's dual-write window
and ships the snapshot and the catch-up tail to whatever server a
``WireClient`` points at; :func:`migrate_tenant_wire` is the one-shot
form (``serving.migrate_tenant(..., via=client)``).
"""

from __future__ import annotations

import time
import zlib

from ..mutation import delta as mut_delta
from ..mutation import durability
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime import errors
from . import protocol as wp

SITE = "wire"

#: blob bytes per MIG_STATE frame before a new frame starts
STATE_CHUNK_BYTES = 4 << 20
#: catch-up records per MIG_DELTA frame
DELTA_CHUNK_RECORDS = 64


# ------------------------------------------------------ state flattening

def flatten_state(state: dict) -> tuple:
    """Snapshot dict -> (pure-JSON meta, ordered blob list): every
    ``bytes`` value is replaced by ``{"__blob__": index}`` so the
    metadata rides a frame header and the bitmap bytes ride as frame
    blobs verbatim."""
    blobs: list = []

    def walk(v):
        if isinstance(v, (bytes, bytearray, memoryview)):
            blobs.append(bytes(v))
            return {"__blob__": len(blobs) - 1}
        if isinstance(v, dict):
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [walk(x) for x in v]
        return v

    return walk(dict(state)), blobs


def unflatten_state(meta, blobs: list) -> dict:
    """Inverse of :func:`flatten_state`; malformed slots die typed."""

    def walk(v):
        if isinstance(v, dict):
            if set(v.keys()) == {"__blob__"}:
                i = int(v["__blob__"])
                if not 0 <= i < len(blobs):
                    raise errors.CorruptInput(
                        f"{SITE}: migration blob slot {i} out of range "
                        f"(got {len(blobs)} blobs)")
                return blobs[i]
            return {k: walk(x) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        return v

    out = walk(meta)
    if not isinstance(out, dict):
        raise errors.CorruptInput(
            f"{SITE}: migration meta is not an object")
    return out


def source_crcs(ds) -> list:
    """Per-source CRC32 of the spec.py serialization — the bit-exact
    fingerprint both ends of a wire migration compare."""
    return [zlib.crc32(bm.serialize())
            for bm in mut_delta.host_bitmaps(ds)]


def state_frames(mig_id: str, tenant: str, state: dict,
                 records=()) -> list:
    """The ``(ftype, header, blobs)`` frames that move one captured state
    and its catch-up ``records``: BEGIN, STATE chunks of about
    ``STATE_CHUNK_BYTES``, DELTA chunks of ``DELTA_CHUNK_RECORDS``, COMMIT
    (``WireClient.migrate_frames`` sends them)."""
    meta, blobs = flatten_state(state)
    tag = {"mig_id": mig_id, "tenant": tenant}
    frames = [(wp.T_MIG_BEGIN, dict(tag, meta=meta), ())]
    chunk: list = []
    size = 0
    for b in blobs:
        chunk.append(b)
        size += len(b)
        if size >= STATE_CHUNK_BYTES:
            frames.append((wp.T_MIG_STATE, dict(tag), tuple(chunk)))
            chunk, size = [], 0
    if chunk:
        frames.append((wp.T_MIG_STATE, dict(tag), tuple(chunk)))
    records = list(records)
    for i in range(0, len(records), DELTA_CHUNK_RECORDS):
        frames.append((wp.T_MIG_DELTA, dict(
            tag, records=records[i:i + DELTA_CHUNK_RECORDS]), ()))
    frames.append((wp.T_MIG_COMMIT, dict(tag), ()))
    return frames


# --------------------------------------------------------- source session

class WireMigrationSession:
    """Source half of a cross-process migration: rides the front door's
    dual-write window (``fd._dual_writes``) like the in-process session,
    but buffers the catch-up tail as journal-vocabulary records and ships
    snapshot and tail as frames."""

    def __init__(self, fd, sid: int, client, tenant: str | None = None):
        self.fd = fd
        self.sid = int(sid)
        self.client = client
        self.tenant = tenant or f"sid{int(sid)}"
        self.mig_id = f"{self.tenant}-{id(self):x}"
        self.state: dict | None = None
        self.bytes_streamed = 0
        self._records: list = []
        self._seq = 0
        self.trace_ctx = obs_trace.inject()

    def on_delta(self, adds, removes, repack: str = "auto") -> None:
        """The dual-write hook (``PodFrontDoor.apply_delta``, under its
        lock): every source delta joins the catch-up tail."""
        with obs_trace.span_from(self.trace_ctx, "pod.dual_write",
                                 site="pod", set_id=self.sid, to="wire",
                                 buffered=True):
            self._seq += 1
            self._records.append({
                "kind": "delta", "seq": self._seq,
                "adds": durability._jsonable_delta(adds or {}),
                "removes": durability._jsonable_delta(removes or {})})

    def begin(self) -> None:
        from ..serving.migration import MigrationError

        fd, sid = self.fd, self.sid
        if fd.plan.regime(sid) == "sharded":
            raise MigrationError(
                f"tenant {sid} is sharded-regime: it already spans every "
                f"pod host — it has no single image to ship")
        with fd._lock:
            if sid in fd._dual_writes:
                raise MigrationError(f"tenant {sid} is already migrating")
            self.state = durability.capture_state(fd._sets[sid],
                                                  tenant=self.tenant)
            fd._dual_writes[sid] = self

    def copy(self) -> None:
        """Ship the snapshot (BEGIN and STATE frames, pipelined in one
        write), acked by the destination."""
        frames = state_frames(self.mig_id, self.tenant, self.state)[:-1]
        self.bytes_streamed = sum(len(b) for _f, _h, blobs in frames
                                  for b in blobs)
        obs_metrics.counter("rb_migration_bytes_total").inc(
            self.bytes_streamed)
        self.client.migrate_frames(frames)

    def finish(self) -> dict:
        """Ship the catch-up tail and COMMIT, check the per-source CRCs of
        the destination's copy against the source, close the window."""
        fd, sid = self.fd, self.sid
        t0 = time.perf_counter()
        with fd._lock:
            records, self._records = self._records, []
            fd._dual_writes.pop(sid, None)
            local_crcs = source_crcs(fd._sets[sid])
        tag = {"mig_id": self.mig_id, "tenant": self.tenant}
        frames = [(wp.T_MIG_DELTA, dict(
            tag, records=records[i:i + DELTA_CHUNK_RECORDS]), ())
            for i in range(0, len(records), DELTA_CHUNK_RECORDS)]
        frames.append((wp.T_MIG_COMMIT, dict(tag), ()))
        ack = self.client.migrate_frames(frames)
        blip_ms = (time.perf_counter() - t0) * 1e3
        remote_crcs = list(ack.get("source_crcs") or ())
        if remote_crcs != local_crcs:
            raise errors.ShadowMismatch(
                f"{SITE}: migrated tenant {self.tenant!r} diverged from "
                f"the source after catch-up: remote CRCs {remote_crcs} "
                f"!= local {local_crcs}")
        return {"set_id": sid, "tenant": self.tenant, "to": "wire",
                "bytes": self.bytes_streamed,
                "catch_up_records": len(records),
                "source_crcs": local_crcs,
                "blip_ms": round(blip_ms, 3)}


def migrate_tenant_wire(fd, sid: int, client, during=None,
                        tenant: str | None = None) -> dict:
    """One-shot cross-process migration: begin -> copy -> [``during(fd)``
    drives traffic and deltas inside the dual-write window] -> finish.
    The move is one ``pod.migrate`` span (``to="wire"``)."""
    with obs_trace.span("pod.migrate", site="pod", set_id=int(sid),
                        to="wire") as sp:
        session = WireMigrationSession(fd, sid, client, tenant=tenant)
        session.begin()
        try:
            session.copy()
            if during is not None:
                during(fd)
            report = session.finish()
        except BaseException:
            with fd._lock:
                fd._dual_writes.pop(int(sid), None)
            obs_metrics.counter("rb_migration_total", status="failed").inc()
            raise
        sp.tag(bytes=report["bytes"], blip_ms=report["blip_ms"],
               records=report["catch_up_records"])
        obs_metrics.counter("rb_migration_total", status="ok").inc()
    return report
