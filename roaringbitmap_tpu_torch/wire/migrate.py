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
share: :func:`flatten_state` / :func:`unflatten_state`, the frames of one
captured state (:func:`state_frames`, chunked as the JAX sender chunks
them) and the per-source CRCs the commit ACK carries
(:func:`source_crcs`).  The sender (``WireMigrationSession``) drives a
pod front door and waits for it.
"""

from __future__ import annotations

import zlib

from ..mutation import delta as mut_delta
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
