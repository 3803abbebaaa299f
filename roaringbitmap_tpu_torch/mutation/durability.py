"""Durable tenants: a write-ahead delta journal and crash-consistent
snapshots (``roaringbitmap_tpu.mutation.durability``).

Every mutable thing on the card lives in process memory: a crash loses
every delta ever applied.  This module is the durable write path, and its
files are an interchange format: a journal or a snapshot directory written
by either package is read by the other, record for record and byte for
byte.

**Write-ahead journal** (:class:`DeltaJournal`).  Append before apply: every
``apply_delta`` (set deltas and value-column deltas) first appends a
length+CRC framed record to the tenant's journal file, then mutates the
resident image.  Records reuse the ``apply_delta`` adds/removes vocabulary,
so replay is ``apply_delta``: the same code path, the same bit-exactness.
When a record reaches the platter is a :class:`FlushPolicy` (``always`` /
``batch`` / ``group`` / ``never``); ``group`` shares ONE fsync pass across
every tenant registered on a :class:`GroupCommitScheduler`.

**Snapshots.**  One ``format/spec.py`` file per tenant source (any Roaring
implementation reads them) plus ``MANIFEST.json`` with the version lineage,
the layout, per-file CRCs and the value columns' payloads (BSI existence and
slice planes as portable bitmaps, RangeColumn values as little-endian i64).
A snapshot reads the set's version-keyed host twin (``host_bitmaps``), not
the image on the card; the directory flips in through an atomically
replaced ``CURRENT`` pointer, so a crash mid-snapshot leaves the previous
one live.

**Recovery** (:func:`recover_tenant`).  Load the CURRENT snapshot onto the
requested device (the card unless the caller asks for the CPU), replay the
journal records past the manifest's sequence number.  A torn TAIL (the last
record cut mid-frame or failing its CRC: the shape a crash mid-append
leaves) is truncated, counted and recovery goes on: the record never
committed.  Corruption anywhere before the tail, or a corrupt snapshot,
raises :class:`~..runtime.errors.CorruptInput`.

Crash points.  The ``crash`` fault kind (``runtime.faults.maybe_crash``)
fires at the three seams every WAL must survive: ``pre_append`` (the record
is lost), ``pre_apply`` (the record is durable, memory lacks it; the
``@torn`` scope tears the just-written record instead, so replay must NOT
apply it) and ``post_apply`` (durable and applied; replay filters it by
sequence).  ``InjectedCrash`` is never caught between the crash point and
``recover_tenant``.

Env knobs: ``ROARING_TPU_JOURNAL_DIR`` (the default durable root),
``ROARING_TPU_SNAPSHOT_EVERY`` (auto-snapshot after N applies).  Journal
and snapshot work is counted in the obs registry under the JAX package's
names (``rb_journal_*``, ``rb_snapshot_*``), snapshots and recoveries are
the ``durability.snapshot`` / ``durability.replay`` spans, and an injected
crash is a flight-recorder record and a ``crash`` trigger.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import struct
import threading
import time
import weakref
import zlib

import numpy as np

from ..obs import flight as obs_flight
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..runtime import errors, faults
from . import delta as mut_delta

#: the fault site of everything durable
SITE = "durability"

ENV_JOURNAL_DIR = "ROARING_TPU_JOURNAL_DIR"
ENV_SNAPSHOT_EVERY = "ROARING_TPU_SNAPSHOT_EVERY"

#: journal file header: version-stamped, so a format change is a typed
#: error, not a misparse
JOURNAL_MAGIC = b"RBWAL001"
#: per-record frame: u32 payload length, u32 crc32(payload), payload
_FRAME = struct.Struct("<II")
#: a frame claiming more than this is corruption, not a record
MAX_RECORD_BYTES = 1 << 28

JOURNAL_FILE = "journal.wal"
CURRENT_FILE = "CURRENT"
MANIFEST_FILE = "MANIFEST.json"
SNAPSHOT_FORMAT = "roaring-tpu-snapshot-v1"

# ------------------------------------------------------------ flush policy

@dataclasses.dataclass(frozen=True)
class FlushPolicy:
    """When journal appends reach the platter.

    ``always``  fsync every append;
    ``batch``   fsync every ``every_n`` appends (up to ``every_n - 1``
                clean-crash records at risk);
    ``group``   appends stay OS-buffered until the shared
                :class:`GroupCommitScheduler` (``group=``) has seen
                ``every_n`` appends group-wide, then ONE pass fsyncs every
                dirty journal of the group;
    ``never``   OS-buffered writes only.
    """

    mode: str = "always"
    every_n: int = 8
    #: the shared scheduler (``group`` mode only)
    group: object = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.mode not in ("always", "batch", "never", "group"):
            raise ValueError(
                f"unknown flush mode {self.mode!r} (one of "
                f"'always', 'batch', 'group', 'never')")
        if self.mode in ("batch", "group") and int(self.every_n) < 1:
            raise ValueError(
                f"{self.mode} flush needs every_n >= 1, got "
                f"{self.every_n}")
        if self.mode == "group" and self.group is None:
            raise ValueError(
                "group flush needs group=GroupCommitScheduler(...) — "
                "the shared handle IS the commit group")


class GroupCommitScheduler:
    """The shared fsync across a group of journals: journals register on
    open, every append notes itself, and once ``every_n`` appends are
    pending group-wide one pass fsyncs every dirty journal.  An injected
    crash closes its own journal mid-group and the next pass skips it, so
    recovery sees the same torn or clean tails as ``batch``."""

    def __init__(self, every_n: int = 8):
        if int(every_n) < 1:
            raise ValueError(
                f"group commit needs every_n >= 1, got {every_n}")
        self.every_n = int(every_n)
        self._lock = threading.Lock()
        self._journals: list = []
        self._pending = 0
        self.stats = {"commits": 0, "fsyncs": 0, "appends": 0}

    def policy(self) -> "FlushPolicy":
        """The FlushPolicy that joins this group."""
        return FlushPolicy(mode="group", every_n=self.every_n, group=self)

    def register(self, journal) -> None:
        with self._lock:
            if journal not in self._journals:
                self._journals.append(journal)

    def unregister(self, journal) -> None:
        with self._lock:
            if journal in self._journals:
                self._journals.remove(journal)

    def note_append(self, journal) -> None:
        with self._lock:
            self._pending += 1
            self.stats["appends"] += 1
            if self._pending >= self.every_n:
                self._commit_locked()

    def commit(self) -> int:
        """Force a commit pass now; returns the journals fsynced."""
        with self._lock:
            return self._commit_locked()

    def _commit_locked(self) -> int:
        dirty = [j for j in self._journals
                 if not j._f.closed and j._since_fsync > 0]
        for j in dirty:
            j.flush(fsync=True)
        self._pending = 0
        if dirty:
            self.stats["commits"] += 1
            self.stats["fsyncs"] += len(dirty)
            obs_metrics.counter("rb_journal_group_commits_total").inc()
            obs_metrics.counter("rb_journal_group_fsyncs_total").inc(
                len(dirty))
        return len(dirty)


# ---------------------------------------------------------------- journal

def _jsonable_delta(spec: dict) -> dict:
    return {str(k): np.asarray(v).tolist() for k, v in spec.items()}


def _delta_from_json(spec: dict) -> dict:
    return {int(k): np.asarray(v, np.uint32) for k, v in spec.items()}


def _frame(record: dict) -> bytes:
    payload = json.dumps(record, separators=(",", ":")).encode()
    return _FRAME.pack(len(payload), zlib.crc32(payload)) + payload


class DeltaJournal:
    """Append-only, length+CRC framed, per-tenant write-ahead journal.  One
    JSON record per mutation, tagged by ``kind``: ``delta`` (set adds and
    removes), ``bsi`` (BsiColumn set/remove pairs), ``range`` (RangeColumn
    updates).  ``seq`` is the monotone record number snapshots and replay
    filter on."""

    def __init__(self, path: str, policy: FlushPolicy | None = None,
                 start_seq: int = 0):
        self.path = str(path)
        self.policy = policy or FlushPolicy()
        self.seq = int(start_seq)
        self._since_fsync = 0
        self._unflushed_bytes = 0
        self._last_frame: tuple | None = None   # (start offset, payload len)
        fresh = (not os.path.exists(self.path)
                 or os.path.getsize(self.path) == 0)
        self._f = open(self.path, "ab")
        if fresh:
            self._f.write(JOURNAL_MAGIC)
            self._f.flush()
            os.fsync(self._f.fileno())
        if self.policy.mode == "group":
            self.policy.group.register(self)

    def append(self, record: dict) -> int:
        """Frame and write one record (the policy decides when it syncs);
        returns its sequence number."""
        self.seq += 1
        frame = _frame(dict(record, seq=self.seq))
        if len(frame) - _FRAME.size > MAX_RECORD_BYTES:
            raise ValueError(
                f"journal record of {len(frame) - _FRAME.size} bytes "
                f"exceeds the {MAX_RECORD_BYTES}-byte frame ceiling")
        start = self._f.tell()
        self._f.write(frame)
        self._last_frame = (start, len(frame) - _FRAME.size)
        self._since_fsync += 1
        self._unflushed_bytes += len(frame)
        if self.policy.mode == "always":
            self.flush(fsync=True)
        elif (self.policy.mode == "batch"
              and self._since_fsync >= self.policy.every_n):
            self.flush(fsync=True)
        elif self.policy.mode == "group":
            self.policy.group.note_append(self)
        else:
            self._f.flush()
        obs_metrics.counter("rb_journal_appends_total").inc()
        obs_metrics.counter("rb_journal_bytes_total").inc(len(frame))
        return self.seq

    def flush(self, fsync: bool = True) -> None:
        self._f.flush()
        if fsync:
            os.fsync(self._f.fileno())
            self._since_fsync = 0
            self._unflushed_bytes = 0
            obs_metrics.counter("rb_journal_fsyncs_total").inc()

    def close(self) -> None:
        if self.policy.mode == "group":
            self.policy.group.unregister(self)
        if not self._f.closed:
            self._f.flush()
            self._f.close()

    def tear_tail(self) -> None:
        """Simulate a crash mid-``write``: cut the LAST record mid-frame
        (header whole, payload cut), the torn shape ``scan_journal``
        classifies as a recoverable tail."""
        if self._last_frame is None:
            return
        start, payload_len = self._last_frame
        self._f.flush()
        self._f.truncate(start + _FRAME.size + max(1, payload_len // 2))
        self._last_frame = None

    def _crash(self, point: str) -> None:
        # only pre_apply has a frame write in flight: torn rules match
        # there alone (tearing elsewhere would un-commit a durable record)
        mode = faults.maybe_crash(SITE, point,
                                  tearable=point == "pre_apply")
        if mode is None:
            return
        if mode == "torn":
            self.tear_tail()
        self.close()
        # black-box the crash before raising: the flight artifact is the
        # only observability this "process" leaves behind
        obs_flight.record("error", site=SITE, error_class="InjectedCrash",
                          point=point, mode=mode, seq=self.seq)
        obs_flight.trigger("crash", site=SITE, point=point, mode=mode,
                           seq=self.seq)
        raise errors.InjectedCrash(
            f"injected crash at {SITE}/{point} (mode={mode}, "
            f"seq={self.seq})")

    def wal_delta(self, adds: dict, removes: dict) -> int:
        """Append before apply for a set delta: a crash point before the
        append (record lost), the append, a crash point between append
        and apply (record durable, or torn)."""
        self._crash("pre_append")
        seq = self.append({"kind": "delta",
                           "adds": _jsonable_delta(adds),
                           "removes": _jsonable_delta(removes)})
        self._crash("pre_apply")
        return seq

    def wal_column(self, record: dict) -> int:
        self._crash("pre_append")
        seq = self.append(record)
        self._crash("pre_apply")
        return seq

    def compact(self, keep_after_seq: int) -> int:
        """Drop the records a durable snapshot holds (seq <=
        ``keep_after_seq``): rewrite to a temp file, fsync, atomic replace,
        reopen.  Returns the records kept."""
        self.close()
        records, _torn, _end = scan_journal(self.path)
        keep = [r for r in records if int(r["seq"]) > int(keep_after_seq)]
        tmp = self.path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(JOURNAL_MAGIC)
            for r in keep:
                f.write(_frame(r))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._last_frame = None
        self._since_fsync = 0
        self._unflushed_bytes = 0
        if self.policy.mode == "group":
            self.policy.group.register(self)
        return len(keep)


def scan_journal(path: str) -> tuple[list[dict], bool, int]:
    """Parse a journal file -> ``(records, torn, valid_end)``.

    A frame that runs past EOF, or whose LAST-position payload fails its
    CRC, is a torn tail: ``torn=True`` and ``valid_end`` is the offset
    recovery truncates to.  A CRC failure with more bytes following, a bad
    magic or an absurd frame length raises :class:`CorruptInput`."""
    try:
        with open(path, "rb") as f:
            buf = f.read()
    except FileNotFoundError:
        return [], False, 0
    if not buf:
        return [], False, 0
    if buf[:len(JOURNAL_MAGIC)] != JOURNAL_MAGIC:
        raise errors.CorruptInput(
            f"journal {path}: bad magic {buf[:8]!r} (want "
            f"{JOURNAL_MAGIC!r})")
    records: list[dict] = []
    pos, n = len(JOURNAL_MAGIC), len(buf)
    while pos < n:
        start = pos
        if n - pos < _FRAME.size:
            return records, True, start        # torn inside the header
        length, crc = _FRAME.unpack_from(buf, pos)
        if length > MAX_RECORD_BYTES:
            raise errors.CorruptInput(
                f"journal {path}: frame at byte {start} claims "
                f"{length} bytes (> {MAX_RECORD_BYTES}) — corrupt "
                f"header, not a torn tail")
        pos += _FRAME.size
        payload = buf[pos:pos + length]
        if len(payload) < length:
            return records, True, start        # torn inside the payload
        if zlib.crc32(payload) != crc:
            if pos + length >= n:
                return records, True, start    # tail record, bad CRC
            raise errors.CorruptInput(
                f"journal {path}: record at byte {start} fails CRC "
                f"with {n - pos - length} bytes following — "
                f"mid-journal corruption, unrecoverable")
        try:
            rec = json.loads(payload)
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            raise errors.CorruptInput(
                f"journal {path}: record at byte {start} passes CRC "
                f"but is not valid JSON ({e})") from None
        if not isinstance(rec, dict) or "seq" not in rec \
                or "kind" not in rec:
            raise errors.CorruptInput(
                f"journal {path}: record at byte {start} lacks "
                f"seq/kind: {rec!r}")
        records.append(rec)
        pos += length
    return records, False, n


# --------------------------------------------------------------- snapshots

def _capture_columns(ds) -> dict:
    """Portable per-column payloads, captured synchronously."""
    out: dict = {}
    for name, col in getattr(ds, "columns", {}).items():
        kind = getattr(col, "kind", None)
        if kind == "bsi_column":
            out[name] = {
                "kind": "bsi", "min_value": int(col.host.min_value),
                "max_value": int(col.host.max_value),
                "version": int(col.version),
                "structure_version": int(col.structure_version),
                "ebm": col.host.ebm.serialize(),
                "slices": [s.serialize() for s in col.host.slices],
            }
        elif kind == "range_column":
            out[name] = {
                "kind": "range", "version": int(col.version),
                "structure_version": int(col.structure_version),
                "values": np.asarray(col.values, "<i8").tobytes(),
            }
        else:
            raise ValueError(
                f"column {name!r} has unsnapshotable kind {kind!r}")
    return out


def capture_state(ds, seq: int = 0, tenant: str = "t0") -> dict:
    """Everything a snapshot writes, as bytes in memory: the spec-portable
    sources (from the set's host twin) and the manifest fields.  Wire
    migration streams exactly this payload."""
    sources = [bm.serialize() for bm in mut_delta.host_bitmaps(ds)]
    return {
        "tenant": str(tenant), "seq": int(seq),
        "layout": ds.layout, "version": int(ds.version),
        "structure_version": int(ds.structure_version),
        "source_versions": np.asarray(ds.source_versions).tolist(),
        "sources": sources,
        "columns": _capture_columns(ds),
    }


def state_bytes(state: dict) -> int:
    """Wire size of one captured state: its portable source and column
    payload bytes."""
    total = sum(len(b) for b in state["sources"])
    for col in state["columns"].values():
        if col["kind"] == "bsi":
            total += len(col["ebm"]) + sum(len(s) for s in col["slices"])
        else:
            total += len(col["values"])
    return total


def _bsi_column(name: str, cm: dict, blob, device):
    """A BsiColumn rebuilt from a snapshot's ebm and slice bytes."""
    from ..analytics.column import BsiColumn
    from ..bsi.slice_index import RoaringBitmapSliceIndex
    from ..core.bitmap import RoaringBitmap

    idx = RoaringBitmapSliceIndex()
    idx.ebm = RoaringBitmap.deserialize(blob("ebm"))
    idx.slices = [RoaringBitmap.deserialize(b) for b in blob("slices")]
    idx.min_value = int(cm.get("min_value", 0))
    idx.max_value = int(cm.get("max_value", 0))
    return BsiColumn.from_bsi(name, idx, device=device)


def _range_column(name: str, blob: bytes, device):
    from ..analytics.column import RangeColumn

    if len(blob) % 8:
        raise errors.CorruptInput(
            f"column {name} values payload is {len(blob)} "
            f"bytes — not a whole i64 vector")
    return RangeColumn(name, np.frombuffer(blob, "<i8"), device=device)


def _adopt_lineage(ds, version: int, structure_version: int,
                   source_versions) -> None:
    ds.version = int(version)
    ds.structure_version = int(structure_version)
    ds.source_versions = np.asarray(source_versions, np.int64)
    if ds.source_versions.size != ds.n:
        raise errors.CorruptInput(
            f"snapshot source_versions has {ds.source_versions.size} "
            f"entries for {ds.n} sources")
    ds.row_versions[:] = ds.version
    ds._host_cache = None


def restore_state(state: dict, device=None):
    """A :func:`capture_state` payload -> a fresh resident
    ``DeviceBitmapSet`` on ``device`` (the card unless the caller asks for
    the CPU), with its columns and the captured version lineage.  Corrupt
    portable bytes die typed (``CorruptInput``)."""
    from ..core.bitmap import RoaringBitmap
    from ..ops.words import resolve_device
    from ..parallel.aggregation import DeviceBitmapSet

    dev = resolve_device(device)
    bitmaps = [RoaringBitmap.deserialize(b) for b in state["sources"]]
    ds = DeviceBitmapSet(bitmaps, layout=state["layout"], device=dev)
    _adopt_lineage(ds, state["version"], state["structure_version"],
                   state["source_versions"])
    for name, cm in state["columns"].items():
        if cm["kind"] == "bsi":
            col = _bsi_column(name, cm, cm.get, dev)
        else:
            col = _range_column(name, cm["values"], dev)
        col.version = int(cm.get("version", 0))
        col.structure_version = int(cm.get("structure_version", 0))
        ds.attach_column(col)
    return ds


def _write_snapshot_dir(tenant_dir: str, state: dict) -> dict:
    """Write one snapshot directory and flip CURRENT atomically::

        <tenant>/snap-<seq>/src-<i>.rb       portable spec bytes
        <tenant>/snap-<seq>/col-<name>-*     column payloads
        <tenant>/snap-<seq>/MANIFEST.json    lineage + per-file CRCs
        <tenant>/CURRENT                     -> "snap-<seq>"

    The manifest is written last inside the directory and CURRENT is
    replaced after everything fsynced: a crash at any byte leaves the
    previous snapshot live."""
    name = f"snap-{state['seq']}"
    snap_dir = os.path.join(tenant_dir, name)
    tmp_dir = snap_dir + ".tmp"
    shutil.rmtree(tmp_dir, ignore_errors=True)
    os.makedirs(tmp_dir)
    total = 0

    def put(fname: str, blob: bytes) -> dict:
        nonlocal total
        with open(os.path.join(tmp_dir, fname), "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        total += len(blob)
        return {"file": fname, "bytes": len(blob),
                "crc32": zlib.crc32(blob)}

    manifest = {
        "format": SNAPSHOT_FORMAT, "tenant": state["tenant"],
        "seq": state["seq"], "layout": state["layout"],
        "version": state["version"],
        "structure_version": state["structure_version"],
        "source_versions": state["source_versions"],
        "sources": [put(f"src-{i}.rb", blob)
                    for i, blob in enumerate(state["sources"])],
        "columns": {},
    }
    for cname, col in state["columns"].items():
        if col["kind"] == "bsi":
            manifest["columns"][cname] = {
                "kind": "bsi", "min_value": col["min_value"],
                "max_value": col["max_value"],
                "version": col["version"],
                "structure_version": col["structure_version"],
                "ebm": put(f"col-{cname}-ebm.rb", col["ebm"]),
                "slices": [put(f"col-{cname}-s{k}.rb", blob)
                           for k, blob in enumerate(col["slices"])],
            }
        else:
            manifest["columns"][cname] = {
                "kind": "range", "version": col["version"],
                "structure_version": col["structure_version"],
                "values": put(f"col-{cname}.i64", col["values"]),
            }
    with open(os.path.join(tmp_dir, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    shutil.rmtree(snap_dir, ignore_errors=True)
    os.replace(tmp_dir, snap_dir)
    cur_tmp = os.path.join(tenant_dir, CURRENT_FILE + ".tmp")
    with open(cur_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(cur_tmp, os.path.join(tenant_dir, CURRENT_FILE))
    # dead snapshots go after the flip (never the one CURRENT names)
    for entry in os.listdir(tenant_dir):
        if entry.startswith("snap-") and entry != name:
            shutil.rmtree(os.path.join(tenant_dir, entry),
                          ignore_errors=True)
    manifest["_bytes"] = total
    return manifest


def _read_blob(snap_dir: str, ref, what: str) -> bytes:
    """One manifest-referenced file, CRC-checked; every failure typed."""
    if not isinstance(ref, dict) or "file" not in ref:
        raise errors.CorruptInput(
            f"snapshot manifest: malformed file reference for {what}: "
            f"{ref!r}")
    path = os.path.join(snap_dir, str(ref["file"]))
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise errors.CorruptInput(
            f"snapshot {what} unreadable: {e}") from None
    if len(blob) != int(ref.get("bytes", -1)) \
            or zlib.crc32(blob) != int(ref.get("crc32", -1)):
        raise errors.CorruptInput(
            f"snapshot {what} ({ref['file']}) fails its manifest "
            f"CRC/length check — corrupt snapshot")
    return blob


def load_snapshot(tenant_dir: str, device=None):
    """CURRENT snapshot -> ``(bitmaps, columns, manifest)``: host
    RoaringBitmaps from the portable source files and the value columns,
    rebuilt on ``device``.  Every corruption shape raises
    :class:`CorruptInput`."""
    from ..core.bitmap import RoaringBitmap
    from ..ops.words import resolve_device

    dev = resolve_device(device)
    cur_path = os.path.join(tenant_dir, CURRENT_FILE)
    try:
        with open(cur_path) as f:
            name = f.read().strip()
    except OSError as e:
        raise errors.CorruptInput(
            f"no CURRENT snapshot pointer under {tenant_dir}: "
            f"{e}") from None
    if not name or os.sep in name or name.startswith("."):
        raise errors.CorruptInput(
            f"CURRENT pointer is garbled: {name!r}")
    snap_dir = os.path.join(tenant_dir, name)
    try:
        with open(os.path.join(snap_dir, MANIFEST_FILE)) as f:
            manifest = json.load(f)
    except OSError as e:
        raise errors.CorruptInput(
            f"snapshot manifest unreadable: {e}") from None
    except json.JSONDecodeError as e:
        raise errors.CorruptInput(
            f"snapshot manifest is not valid JSON: {e}") from None
    if not isinstance(manifest, dict) \
            or manifest.get("format") != SNAPSHOT_FORMAT:
        got = (manifest.get("format") if isinstance(manifest, dict)
               else manifest)
        raise errors.CorruptInput(
            f"snapshot manifest format mismatch: {got!r} "
            f"(want {SNAPSHOT_FORMAT})")
    for field, typ in (("seq", int), ("version", int),
                       ("structure_version", int), ("layout", str),
                       ("sources", list), ("source_versions", list),
                       ("columns", dict)):
        if not isinstance(manifest.get(field), typ):
            raise errors.CorruptInput(
                f"snapshot manifest field {field!r} missing or "
                f"mistyped: {manifest.get(field)!r}")
    bitmaps = [RoaringBitmap.deserialize(
                   _read_blob(snap_dir, ref, f"source {i}"))
               for i, ref in enumerate(manifest["sources"])]
    columns: dict = {}
    for cname, cm in manifest["columns"].items():
        kind = cm.get("kind") if isinstance(cm, dict) else None
        if kind == "bsi":
            def blob(part, cm=cm, cname=cname):
                if part == "ebm":
                    return _read_blob(snap_dir, cm.get("ebm"),
                                      f"column {cname} ebm")
                return [_read_blob(snap_dir, ref,
                                   f"column {cname} slice {k}")
                        for k, ref in enumerate(cm.get("slices") or [])]
            col = _bsi_column(cname, cm, blob, dev)
        elif kind == "range":
            col = _range_column(cname, _read_blob(
                snap_dir, cm.get("values"), f"column {cname} values"), dev)
        else:
            raise errors.CorruptInput(
                f"snapshot column {cname!r} has unknown kind {kind!r}")
        col.version = int(cm.get("version", 0))
        col.structure_version = int(cm.get("structure_version", 0))
        columns[cname] = col
    return bitmaps, columns, manifest


# ---------------------------------------------------------- durable tenant

def _snapshot_every_default() -> int:
    raw = os.environ.get(ENV_SNAPSHOT_EVERY, "")
    if not raw:
        return 0
    try:
        n = int(raw)
    except ValueError:
        raise ValueError(
            f"{ENV_SNAPSHOT_EVERY} must be an integer, got "
            f"{raw!r}") from None
    return max(0, n)


class DurableTenant:
    """One mutable ``DeviceBitmapSet`` bound to its durable state.

    Construction writes the base snapshot synchronously (recovery is
    snapshot + journal tail) and opens the journal.  Every mutation goes
    through :meth:`apply_delta` / :meth:`apply_column_delta`: append before
    apply, crash points armed, auto-snapshot after ``snapshot_every``
    applies (``ROARING_TPU_SNAPSHOT_EVERY``)."""

    def __init__(self, ds, root: str | None = None, tenant: str = "t0",
                 policy: FlushPolicy | None = None,
                 snapshot_every: int | None = None,
                 worker=None, _recovered_seq: int | None = None):
        root = root or os.environ.get(ENV_JOURNAL_DIR)
        if not root:
            raise ValueError(
                f"DurableTenant needs a durable root: pass root= or "
                f"set {ENV_JOURNAL_DIR}")
        self.ds = ds
        self.tenant = str(tenant)
        self.dir = os.path.join(str(root), self.tenant)
        self.policy = policy or FlushPolicy()
        self.snapshot_every = (snapshot_every
                               if snapshot_every is not None
                               else _snapshot_every_default())
        self._worker = worker
        self._lock = threading.Lock()
        self._applies_since_snapshot = 0
        self._snapshot_t = time.time()
        os.makedirs(self.dir, exist_ok=True)
        if _recovered_seq is None:
            if os.path.exists(os.path.join(self.dir, CURRENT_FILE)):
                raise ValueError(
                    f"tenant dir {self.dir} already holds durable "
                    f"state — use recover_tenant() to attach to it")
            self.journal = DeltaJournal(
                os.path.join(self.dir, JOURNAL_FILE), self.policy)
            self.snapshot()
        else:
            self.journal = DeltaJournal(
                os.path.join(self.dir, JOURNAL_FILE), self.policy,
                start_seq=_recovered_seq)
        _TENANTS.add(self)

    def apply_delta(self, adds=None, removes=None, repack: str = "auto",
                    drift_limit: int | None = None, worker=None) -> dict:
        """``mutation.delta.apply_delta`` with the WAL armed: the
        normalized record is durable (per the flush policy) before the
        resident image mutates."""
        with self._lock:
            report = mut_delta.apply_delta(
                self.ds, adds, removes, repack=repack,
                drift_limit=drift_limit,
                worker=worker if worker is not None else self._worker,
                journal=self.journal)
            self.journal._crash("post_apply")
            self._applies_since_snapshot += 1
        self.maybe_snapshot()
        return report

    def apply_column_delta(self, name: str, set_values=None,
                           removes=(), updates=None) -> dict:
        """Journaled value-column mutation: BSI columns take
        ``set_values`` / ``removes``, Range columns take ``updates``."""
        col = self.ds.columns.get(name)
        if col is None:
            raise KeyError(f"no column {name!r} attached to tenant "
                           f"{self.tenant}")
        with self._lock:
            if col.kind == "bsi_column":
                if isinstance(set_values, dict):
                    pairs = sorted((int(k), int(v))
                                   for k, v in set_values.items())
                elif set_values:
                    ids, vals = set_values
                    pairs = list(zip(np.asarray(ids).tolist(),
                                     np.asarray(vals).tolist()))
                else:
                    pairs = []
                self.journal.wal_column({
                    "kind": "bsi", "col": name, "set": pairs,
                    "removes": np.asarray(list(removes)).tolist()})
                report = col.apply_delta(
                    set_values=dict(pairs) or None,
                    removes=list(removes))
            elif col.kind == "range_column":
                updates = {int(k): int(v)
                           for k, v in (updates or {}).items()}
                self.journal.wal_column({
                    "kind": "range", "col": name, "updates":
                    {str(k): v for k, v in updates.items()}})
                report = col.apply_delta(updates)
            else:
                raise ValueError(
                    f"column {name!r} kind {col.kind!r} is not "
                    f"journalable")
            self.journal._crash("post_apply")
            self._applies_since_snapshot += 1
        self.maybe_snapshot()
        return report

    def maybe_snapshot(self) -> dict | None:
        if (self.snapshot_every
                and self._applies_since_snapshot >= self.snapshot_every):
            return self.snapshot(worker=self._worker)
        return None

    def snapshot(self, worker=None) -> dict:
        """Capture now (later deltas never leak in), write now or on
        ``worker``.  Once the snapshot is durable the journal compacts to
        the records past it."""
        with self._lock:
            state = capture_state(self.ds, self.journal.seq, self.tenant)
        if worker is None:
            return self._write_snapshot(state)
        worker.submit(lambda: self._write_snapshot(state),
                      kind="snapshot",
                      desc=f"tenant={self.tenant} seq={state['seq']}")
        return {"queued": True, "seq": state["seq"]}

    def _write_snapshot(self, state: dict) -> dict:
        t0 = time.perf_counter()
        with obs_trace.span("durability.snapshot", site=SITE,
                            tenant=self.tenant, seq=state["seq"],
                            sources=len(state["sources"]),
                            columns=len(state["columns"])) as sp:
            manifest = _write_snapshot_dir(self.dir, state)
            with self._lock:
                kept = self.journal.compact(state["seq"])
                self._applies_since_snapshot = 0
            wall = time.perf_counter() - t0
            sp.tag(bytes=manifest["_bytes"], journal_kept=kept)
            obs_metrics.counter("rb_snapshot_total").inc()
            obs_metrics.counter("rb_snapshot_bytes_total").inc(
                manifest["_bytes"])
            obs_metrics.histogram("rb_snapshot_seconds").observe(wall)
        self._snapshot_t = time.time()
        return {"seq": state["seq"], "bytes": manifest["_bytes"],
                "journal_kept": kept, "wall_ms": round(wall * 1e3, 3)}

    def health(self) -> dict:
        """Durability lag: unflushed journal bytes, applies since the
        snapshot, and the snapshot's age."""
        return {
            "tenant": self.tenant, "seq": self.journal.seq,
            "unflushed_bytes": self.journal._unflushed_bytes,
            "applies_since_snapshot": self._applies_since_snapshot,
            "snapshot_age_s": round(time.time() - self._snapshot_t, 3),
        }

    def close(self) -> None:
        self.journal.close()


#: live DurableTenant instances (weak: a discarded tenant leaves the view)
_TENANTS: "weakref.WeakSet[DurableTenant]" = weakref.WeakSet()


def health() -> list:
    """Per-tenant durability health of every live DurableTenant, sorted by
    tenant id."""
    docs = []
    for t in list(_TENANTS):
        try:
            docs.append(t.health())
        except Exception:  # pragma: no cover - tenant mid-close
            continue
    return sorted(docs, key=lambda d: d["tenant"])


# ---------------------------------------------------------------- recovery

def replay_record(ds, rec: dict) -> None:
    """One journal record applied again through the SAME mutation paths
    the original apply took: replay is apply."""
    kind = rec.get("kind")
    if kind == "delta":
        mut_delta.apply_delta(ds, _delta_from_json(rec.get("adds") or {}),
                              _delta_from_json(rec.get("removes") or {}))
    elif kind == "bsi":
        col = ds.columns.get(rec.get("col"))
        if col is None:
            raise errors.CorruptInput(
                f"journal bsi record names unknown column "
                f"{rec.get('col')!r}")
        pairs = {int(i): int(v) for i, v in (rec.get("set") or [])}
        col.apply_delta(set_values=pairs or None,
                        removes=[int(r) for r in rec.get("removes") or []])
    elif kind == "range":
        col = ds.columns.get(rec.get("col"))
        if col is None:
            raise errors.CorruptInput(
                f"journal range record names unknown column "
                f"{rec.get('col')!r}")
        col.apply_delta({int(k): int(v)
                         for k, v in (rec.get("updates") or {}).items()})
    else:
        raise errors.CorruptInput(
            f"journal record kind {kind!r} is unknown to this build")


def recover_tenant(root: str | None = None, tenant: str = "t0",
                   policy: FlushPolicy | None = None,
                   snapshot_every: int | None = None,
                   worker=None, device=None) -> tuple:
    """Crash recovery: the CURRENT snapshot, restored on ``device`` (the
    card unless the caller asks for the CPU), plus the journal tail
    replayed -> ``(DurableTenant, report)``.

    A torn tail is truncated and counted; any other corruption raises
    :class:`CorruptInput`.  The report splits the wall into ``load_ms``
    (snapshot files to host bitmaps and columns), ``restore_ms`` (the
    resident set built on the device) and ``replay_ms``."""
    from ..ops.words import resolve_device
    from ..parallel.aggregation import DeviceBitmapSet

    root = root or os.environ.get(ENV_JOURNAL_DIR)
    if not root:
        raise ValueError(
            f"recover_tenant needs a durable root: pass root= or set "
            f"{ENV_JOURNAL_DIR}")
    dev = resolve_device(device)
    tenant_dir = os.path.join(str(root), str(tenant))
    t0 = time.perf_counter()
    with obs_trace.span("durability.replay", site=SITE,
                        tenant=str(tenant)) as sp:
        bitmaps, columns, manifest = load_snapshot(tenant_dir, device=dev)
        snap_seq = int(manifest["seq"])
        journal_path = os.path.join(tenant_dir, JOURNAL_FILE)
        records, torn, valid_end = scan_journal(journal_path)
        if torn:
            size = os.path.getsize(journal_path)
            with open(journal_path, "ab") as f:
                f.truncate(valid_end)
            obs_metrics.counter("rb_journal_torn_tails_total").inc()
            sp.event("torn_tail", truncated_bytes=size - valid_end,
                     valid_end=valid_end)
        tail = [r for r in records if int(r["seq"]) > snap_seq]
        t1 = time.perf_counter()
        ds = DeviceBitmapSet(bitmaps, layout=manifest["layout"], device=dev)
        _adopt_lineage(ds, manifest["version"], manifest["structure_version"],
                       manifest["source_versions"])
        for col in columns.values():
            ds.attach_column(col)
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        for rec in tail:
            replay_record(ds, rec)
        if dev.type == "cuda":
            import torch

            torch.cuda.synchronize(dev)
        t3 = time.perf_counter()
        obs_metrics.counter("rb_journal_replayed_records_total").inc(len(tail))
        last_seq = max([snap_seq] + [int(r["seq"]) for r in records])
        sp.tag(snapshot_seq=snap_seq, records=len(tail), torn=bool(torn),
               version=int(ds.version))
        dt = DurableTenant(ds, root=root, tenant=tenant, policy=policy,
                           snapshot_every=snapshot_every, worker=worker,
                           _recovered_seq=last_seq)
    wall = time.perf_counter() - t0
    return dt, {"snapshot_seq": snap_seq, "replayed": len(tail),
                "torn": bool(torn), "version": int(ds.version),
                "wall_ms": round(wall * 1e3, 3),
                "load_ms": round((t1 - t0) * 1e3, 3),
                "restore_ms": round((t2 - t1) * 1e3, 3),
                "replay_ms": round((t3 - t2) * 1e3, 3)}
