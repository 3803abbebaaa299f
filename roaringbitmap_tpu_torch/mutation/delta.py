"""Versioned delta ingest: in-place row patches and the escalation to a
repack (``roaringbitmap_tpu.mutation.delta``).

Roaring partitions the value space into 2^16-value containers so that a
point mutation touches ONE container, and the resident blocked layout keeps
one 8 KiB row per ``(source, key)``.  A delta that only changes values
inside existing containers is therefore a row patch of the resident int32
image, in place on the card::

    words.index_copy_(0, rows, (words.index_select(0, rows) | add) & ~rem)

The add and remove masks are built on the host as u32 rows, viewed as int32
and uploaded as ONE ``[P, 2, 2048]`` tensor through pinned memory
(``ops.words.upload``); the patch is queued on the set's current stream and
reads nothing back.  Rows are unique within a patch, so the scatter is
deterministic.  This is the JAX package's donated jitted program: XLA there,
three tensor ops here.  ``warmup_delta(n)`` prepares the "delta:N" rungs as
the JAX package compiles them: a patch pads to the next power of two with
neutral entries on the layout's padding row, and each rung is one CUDA
graph captured over a static operand buffer and the image
(``_PatchProgram``): an in-band patch of that rung is staged in a pinned
buffer, copied in and replayed.
A graph writes the image by address, so its key holds the image's address
and a repack drops every graph of the set before the old image is freed.
A cold rung runs the exact patch eagerly; on the CPU a warmed rung runs the
padded patch eagerly.

Escalation.  These take the full repack instead (``repack_in_place``):

- **structural** deltas: an add into a container the source does not hold;
- **layout**: the counts and compact layouts fold their streams at build
  time, so a delta rebuilds them;
- **drift**: mutated values since the last pack past ``drift_limit``
  (default ``max(DRIFT_MIN_VALUES, DRIFT_FRACTION x`` the pack-time value
  floor``)``); the repack re-resolves ``layout="auto"``;
- **requested**: ``repack="always"``.

``repack="never"`` raises ``ValueError`` on any of them and leaves the set
as it was.  A removal aimed only at containers the source lacks is a
``noop``: no patch, no version bump, no invalidation.

Version discipline (what the result cache and the engines' plan keys read):

- ``ds.version``: +1 per applied patch or repack;
- ``ds.source_versions[i]``: the version that last touched source i;
- ``ds.row_versions[r]``: the version that last patched row r (a repack
  stamps every row);
- ``ds.structure_version``: +1 per repack (the rows were laid out anew:
  engines re-read ``row_src``).

A patched set's bounded journal (``JOURNAL_DEPTH`` entries of ``(version,
rows, add, rem)``) is what a placed copy of the rows replays.  Every applied
delta notifies the live result caches (``result_cache.notify_version_bump``).

Stale handles.  The JAX package donates the image, so a handle to the
pre-delta image dies loudly.  Here the patch is in place: a handle aliases
the live image, and a launch already queued on the stream reads the rows it
was queued over.  A repack builds the new layout apart and swaps it in only
once its build completed on the stream (``repack_in_place``).

Until the observability layer is ported, the spans and metrics are module
counters: ``stats()`` returns ``rb_delta_rows_patched_total`` and the
applies by mode.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import trace as obs_trace
from ..ops import dense, packing
from ..ops.words import WORDS32, to_u32, upload

#: the site of every mutation
SITE = "mutation"

#: drift heuristic floor: deltas smaller than this never fire it
DRIFT_MIN_VALUES = 65536

#: drift fires past this fraction of the pack-time value floor
DRIFT_FRACTION = 0.5

#: per-set delta-journal depth; a replayer lagging further re-places
JOURNAL_DEPTH = 32



def _normalize_delta(n_sources: int, spec) -> dict:
    """{source index: sorted unique u32 values}; empty entries dropped."""
    out: dict = {}
    if not spec:
        return out
    items = spec.items() if isinstance(spec, dict) else spec
    for src, values in items:
        src = int(src)
        if src < 0 or src >= n_sources:
            raise IndexError(
                f"delta source index out of range 0..{n_sources - 1}: "
                f"{src}")
        v = np.unique(np.asarray(values, dtype=np.uint64))
        if v.size and int(v[-1]) > 0xFFFFFFFF:
            raise ValueError(
                f"delta value out of the u32 universe: {int(v[-1])}")
        if v.size:
            out[src] = v.astype(np.uint32)
    return out


def _row_of(ds, src: int, key: int) -> int:
    """Resident row of (source, key), or -1 when the source holds no
    container for the key (a structural add).  On the 64-bit tier the u16
    key searches the u48 keys numerically, as in the JAX package: u32
    values land in the high-32 bucket 0."""
    k = int(np.searchsorted(ds.keys, np.uint16(key)))
    if k >= ds.keys.size or int(ds.keys[k]) != int(key):
        return -1
    off = int(ds._seg_offsets[k])
    rows = np.arange(off, off + int(ds._seg_sizes[k]))
    hit = rows[ds.row_src[rows] == src]
    return int(hit[0]) if hit.size else -1


def _masks_of(rows_per_value: np.ndarray, low16: np.ndarray,
              n_rows: int) -> np.ndarray:
    """u32[n_rows, 2048] bit masks from (per-value local row, low 16 bits):
    one packbits pass."""
    out = np.zeros((n_rows, WORDS32), np.uint32)
    if low16.size:
        buf = np.zeros(n_rows << 16, np.uint8)
        buf[(rows_per_value.astype(np.int64) << 16)
            + low16.astype(np.int64)] = 1
        out[:] = np.packbits(buf, bitorder="little").view(
            np.uint32).reshape(n_rows, WORDS32)
    return out


def plan_patch(ds, adds: dict, removes: dict):
    """Resolve a normalized delta against the resident layout.

    Returns ``(rows, add_masks, rem_masks, structural, touched, n_add,
    n_rem)``: ``rows`` i32[P] resident rows in patch order (unique), masks
    u32[P, 2048]; ``structural`` is True when an add targets a (source,
    key) row the layout lacks (removals from absent containers never
    escalate).  ``touched`` holds the sources whose data can change: a
    removal aimed only at absent containers does not touch its source."""
    slot_of: dict = {}           # (src, key) -> patch slot
    rows: list = []
    add_rv, add_lo = [], []      # per-value (slot, low16) streams
    rem_rv, rem_lo = [], []
    structural = False
    touched: set = set()
    n_add = n_rem = 0
    for spec, rv, lo, is_add in ((adds, add_rv, add_lo, True),
                                 (removes, rem_rv, rem_lo, False)):
        for src, values in spec.items():
            if is_add:
                touched.add(src)
                n_add += int(values.size)
            else:
                n_rem += int(values.size)
            keys = (values >> np.uint32(16)).astype(np.uint16)
            for key in np.unique(keys):
                sub = values[keys == key]
                slot = slot_of.get((src, int(key)))
                if slot is None:
                    row = _row_of(ds, src, int(key))
                    if row < 0:
                        structural = structural or is_add
                        continue
                    slot = slot_of[(src, int(key))] = len(rows)
                    rows.append(row)
                touched.add(src)
                rv.append(np.full(sub.size, slot, np.int64))
                lo.append((sub & np.uint32(0xFFFF)).astype(np.uint32))
    p = len(rows)
    rows = np.asarray(rows, np.int32)

    def stack(rv_l, lo_l):
        if not rv_l:
            return np.zeros((p, WORDS32), np.uint32)
        return _masks_of(np.concatenate(rv_l), np.concatenate(lo_l),
                         max(p, 1))[:p]

    return (rows, stack(add_rv, add_lo), stack(rem_rv, rem_lo),
            structural, touched, n_add, n_rem)


def _pad_row(ds) -> int:
    """A padding row of the blocked layout (row_src == -1), or -1; found
    once a layout (a repack's new state starts without it)."""
    got = ds.__dict__.get("_pad_row_found")
    if got is None:
        pad = np.flatnonzero(ds.row_src < 0)
        got = ds._pad_row_found = int(pad[0]) if pad.size else -1
    return got


def _rung_of(ds, p: int) -> int:
    """The "delta:N" rung of a ``p``-row patch: the next power of two, or
    ``p`` itself when the layout has no padding row to aim extra entries
    at."""
    return packing.next_pow2(max(1, p)) if _pad_row(ds) >= 0 else max(1, p)


def _patch_body(words: torch.Tensor, rows: torch.Tensor,
                masks: torch.Tensor) -> None:
    """The in-place patch: rows i32[P] of ``words`` take ``(w | add) &
    ~rem``, masks int32[P, 2, 2048] holding add (plane 0) and rem."""
    idx = rows.long()
    cur = words.index_select(0, idx)
    cur.bitwise_or_(masks[:, 0]).bitwise_and_(masks[:, 1].bitwise_not())
    words.index_copy_(0, idx, cur)


class _PatchProgram:
    """One warmed "delta:N" rung: a static operand buffer (rows i32[p_pad],
    then masks int32[p_pad, 2, 2048]), the pinned host buffer a patch is
    staged in, and, on the card, the graph of ``_patch_body`` captured over
    the static buffer and the set's image.  A patch of p < p_pad rows pads
    with entries on the layout's padding row and zero masks: ``(w | 0) &
    ~0 == w``, and every duplicate writes the same value, so the scatter
    stays deterministic.  On the CPU the staged patch runs eagerly."""

    def __init__(self, ds, p_pad: int):
        dev = ds.device
        n = p_pad * (1 + 2 * WORDS32)
        self.p_pad = p_pad
        self.pad = max(_pad_row(ds), 0)
        self.buf = torch.zeros(n, dtype=torch.int32, device=dev)
        self.rows = self.buf[:p_pad]
        self.masks = self.buf[p_pad:].view(p_pad, 2, WORDS32)
        # zero masks over a valid row: the warm run and the capture leave
        # the image as it is
        self.rows.fill_(self.pad)
        self.graph = None
        #: the last copy out of the staging buffer, waited for before the
        #: next patch overwrites it
        self._staged = None
        if dev.type == "cuda":
            self.host = torch.zeros(n, dtype=torch.int32, pin_memory=True)
            self._capture(ds)
        else:
            self.host = self.buf

    def _capture(self, ds) -> None:
        from ..runtime import errors, programs

        if ds._delta_pool is None:
            ds._delta_pool = programs.GraphPool()
        pool = ds._delta_pool
        main = torch.cuda.current_stream(ds.device)
        side = pool.stream(ds.device)
        side.wait_stream(main)
        try:
            with torch.cuda.stream(side):
                _patch_body(ds.words, self.rows, self.masks)
                graph = torch.cuda.CUDAGraph()
                graph.capture_begin(pool=pool.handle())
                try:
                    _patch_body(ds.words, self.rows, self.masks)
                finally:
                    graph.capture_end()
            main.wait_stream(side)
        except torch.OutOfMemoryError:
            raise
        except Exception as exc:
            raise errors.GraphCaptureError(
                f"{SITE}: capturing the delta:{self.p_pad} patch failed: "
                f"{type(exc).__name__}: {exc}") from exc
        self.graph = graph

    def run(self, ds, rows, add_m, rem_m) -> None:
        """Stage one patch (rows, u32 add and remove masks of p <= p_pad
        rows), padded to the rung, copy it in and replay (eagerly on the
        CPU, over the same buffer)."""
        if self._staged is not None:
            self._staged.synchronize()
        p, pp = int(rows.size), self.p_pad
        h = self.host.numpy()
        h[:p] = rows
        h[p:pp] = self.pad
        m = h[pp:].reshape(pp, 2, WORDS32)
        m[:p, 0] = add_m.view(np.int32)
        m[:p, 1] = rem_m.view(np.int32)
        m[p:] = 0
        if self.graph is None:
            _patch_body(ds.words, self.rows, self.masks)
            return
        self.buf.copy_(self.host, non_blocking=True)
        self._staged = torch.cuda.Event()
        self._staged.record()
        self.graph.replay()


def _program_key(ds, p_pad: int) -> tuple:
    """A rung's program key: the image's shape and address, so a graph is
    never replayed over an image it was not captured on."""
    return (int(ds._n_rows), int(p_pad), ds.words.data_ptr())


def _patch_program(ds, p_pad: int, build: bool = True):
    """The warmed program of the ``p_pad`` rung, captured now when missing
    and ``build`` (else None).  Hits and misses are observed in
    ``rb_compile_seconds{site="mutation"}``, as the JAX package's
    compiles."""
    from ..obs import cost as obs_cost

    t0 = time.perf_counter()
    key = _program_key(ds, p_pad)
    prog = ds._delta_programs.get(key)
    if prog is not None:
        obs_cost.observe_compile(SITE, "hit", time.perf_counter() - t0)
        return prog
    if not build:
        return None
    prog = _PatchProgram(ds, p_pad)
    obs_cost.observe_compile(SITE, "miss", time.perf_counter() - t0)
    ds._delta_programs[key] = prog
    return prog


def drop_patch_programs(ds) -> int:
    """Drop every warmed patch program of the set (a repack replaces the
    image they write); returns how many were dropped."""
    n = len(ds._delta_programs)
    ds._delta_programs.clear()
    if ds._delta_pool is not None:
        torch.cuda.synchronize(ds.device)
        ds._delta_pool.release()
        ds._delta_pool = None
    return n


def warmup_delta(ds, n: int) -> dict:
    """Prepare the in-place patch program of every power-of-two "delta:N"
    rung up to ``n``'s (``n`` alone when the layout has no padding row), as
    the JAX package compiles them: on the card one captured CUDA graph per
    ``(rows, rung)`` over the set's image, on the CPU the rung's static
    buffer.  A delta pads to its own rung, so an in-band ``apply_delta`` of
    up to ``n`` rows replays a program.  Nothing is mutated."""
    if ds.layout != "dense":
        return {"site": SITE, "rung": int(n), "compiled": False,
                "why": f"{ds.layout} layout deltas repack (no patch "
                       "program to warm)"}
    top = _rung_of(ds, int(n))
    rungs = ([1 << i for i in range(top.bit_length())]
             if _pad_row(ds) >= 0 else [top])
    for p in rungs:
        _patch_program(ds, p)
    return {"site": SITE, "rung": int(n), "rungs": rungs, "compiled": True}


# ------------------------------------------------------------ host tier

#: rows a popcount pass takes at once: its int64 scratch is four times
#: their bytes (2 GiB here)
_CARD_ROWS = 1 << 16


def host_bitmaps(ds) -> list:
    """Host copies of the resident sources, rebuilt from what is resident
    (any layout, one copy of the image to the host) and cached per
    ``version``: the repack input, the sequential and shadow reference and
    the oracle's twin."""
    cache = ds._host_cache
    if cache is not None and cache[0] == ds.version:
        return cache[1]
    if ds.row_src is None:
        raise ValueError(
            "resident set lacks row_src metadata (repack required)")
    from ..parallel.aggregation import _engine

    # a stream layout rebuilds its image first (B3 on the card); the rows'
    # cards are counted where the image lies
    image = ds._resident_words(_engine("auto", ds.device))
    cards = torch.cat([dense.popcount(image[i:i + _CARD_ROWS])
                       for i in range(0, image.shape[0], _CARD_ROWS)]
                      ).cpu().numpy()
    words = to_u32(image)
    del image
    order = np.argsort(ds.row_src, kind="stable")
    bounds = np.searchsorted(ds.row_src[order], np.arange(ds.n + 1))
    hosts = []
    for i in range(ds.n):
        rows = order[bounds[i]:bounds[i + 1]]
        hosts.append(packing.unpack_result(ds.keys[ds.row_seg[rows]],
                                           words[rows], cards[rows]))
    ds._host_cache = (ds.version, hosts)
    return hosts


def _values_of(bm, values: np.ndarray):
    """``values`` as a bitmap of ``bm``'s class (32- or 64-bit tier)."""
    from ..core.bitmap import RoaringBitmap

    if isinstance(bm, RoaringBitmap):
        return RoaringBitmap.from_values(values.astype(np.uint32))
    return type(bm).from_values(values.astype(np.uint64))


def _host_apply(hosts: list, adds: dict, removes: dict) -> list:
    """The delta applied as host set algebra (adds first, removes win: the
    rule the device masks implement)."""
    out = list(hosts)
    for src in set(adds) | set(removes):
        bm = out[src].clone()
        if src in adds:
            bm = bm | _values_of(bm, adds[src])
        if src in removes:
            bm = bm - _values_of(bm, removes[src])
        out[src] = bm
    return out


# ------------------------------------------------------------- the API

def drift_report(ds, drift_limit: int | None = None) -> dict:
    """The drift heuristic's state: mutated values since the last pack
    against the escalation limit."""
    base = int(ds._mutation_base_values)
    mutated = int(ds._mutated_values)
    limit = (int(drift_limit) if drift_limit is not None
             else max(DRIFT_MIN_VALUES, int(DRIFT_FRACTION * base)))
    return {"mutated_values": mutated, "base_values": base,
            "limit": limit, "fired": mutated > limit}


def apply_delta(ds, adds=None, removes=None, repack: str = "auto",
                drift_limit: int | None = None, worker=None,
                journal=None) -> dict:
    """Mutate a resident ``DeviceBitmapSet`` at container granularity.

    ``adds`` / ``removes`` map source index -> u32 values (a value in both
    is removed).  ``repack``: ``"auto"`` patches in place and escalates by
    the module rules, ``"never"`` raises ``ValueError`` on a delta that
    needs a repack, ``"always"`` forces it.  Returns a report: ``mode``
    ("patch", "repack", "repack_queued" or "noop"), ``version``,
    ``rows_patched``, ``values_added``, ``values_removed``,
    ``repack_reason``, ``wall_ms`` and ``drift``.

    ``worker`` (a ``MaintenanceWorker``) takes an escalated repack off this
    thread: the call returns ``mode="repack_queued"`` and the set serves
    the pre-delta image, bit-exact at the old version, until the worker
    commits (the commit re-reads the then-current sources, so patches that
    land in between survive; ``worker.drain()`` is the barrier).  Patches
    never queue.

    ``journal`` is called as ``journal.wal_delta(adds, removes)`` with the
    normalized delta before any state moves (append before apply); a delta
    that normalizes to nothing is not journaled."""
    if repack not in ("auto", "never", "always"):
        raise ValueError(f"unknown repack policy {repack!r}")
    t0 = time.perf_counter()
    adds = _normalize_delta(ds.n, adds)
    removes = _normalize_delta(ds.n, removes)
    n_add = sum(int(v.size) for v in adds.values())
    n_rem = sum(int(v.size) for v in removes.values())
    with obs_trace.span("mutation.delta", site=SITE, uid=ds.uid,
                        values_added=n_add, values_removed=n_rem) as sp:
        if journal is not None and (adds or removes):
            sp.tag(journal_seq=journal.wal_delta(adds, removes))
        rep, dropped = _apply(ds, adds, removes, repack, drift_limit,
                              worker, t0, n_add, n_rem)
        if rep["mode"] == "noop":
            sp.tag(mode="noop", version=ds.version)
            return rep
        obs_metrics.histogram("rb_delta_apply_seconds",
                              mode=rep["mode"]).observe(
                                  rep["wall_ms"] / 1e3)
        obs_metrics.counter("rb_delta_rows_patched_total").inc(
            rep["rows_patched"])
        sp.tag(mode=rep["mode"], version=ds.version,
               rows=rep["rows_patched"], repack_reason=rep["repack_reason"],
               cache_dropped=dropped)
        return rep


def _apply(ds, adds, removes, repack, drift_limit, worker, t0, n_add,
           n_rem) -> tuple:
    """The body of :func:`apply_delta` after normalization and the journal
    append: ``(report, result-cache entries dropped)``."""
    if not adds and not removes:
        return {"mode": "noop", "version": ds.version, "rows_patched": 0,
                "values_added": 0, "values_removed": 0,
                "repack_reason": None, "wall_ms": 0.0,
                "drift": drift_report(ds, drift_limit)}, 0
    reason = None
    rows = add_m = rem_m = None
    touched = set(adds) | set(removes)
    if repack == "always":
        reason = "requested"
    elif ds.layout != "dense":
        reason = "layout"
    else:
        rows, add_m, rem_m, structural, touched, n_add, n_rem = \
            plan_patch(ds, adds, removes)
        if structural:
            reason = "structural"
        elif rows.size == 0:
            # every removal aimed at containers its source lacks
            return {"mode": "noop", "version": ds.version,
                    "rows_patched": 0, "values_added": 0,
                    "values_removed": n_rem, "repack_reason": None,
                    "wall_ms": round((time.perf_counter() - t0) * 1e3, 3),
                    "drift": drift_report(ds, drift_limit)}, 0
    # drift is judged on the prospective count but committed only when the
    # delta applies: a refusal must not count work never done
    mutated0 = int(ds._mutated_values)
    if reason is None:
        ds._mutated_values = mutated0 + n_add + n_rem
        drift = drift_report(ds, drift_limit)
        if drift["fired"]:
            reason = "drift"
    else:
        drift = drift_report(ds, drift_limit)
    if reason is not None and repack == "never":
        ds._mutated_values = mutated0
        raise ValueError(f"delta needs a full repack ({reason}) but "
                         f"repack='never' was requested")

    if reason is None:
        hosts0 = ds._host_cache
        ds.version += 1
        _patch_rows(ds, rows, add_m, rem_m)
        for src in touched:
            ds.source_versions[src] = ds.version
        ds.row_versions[rows] = ds.version
        # the host twin never lags the image: advanced when it exists
        if hosts0 is not None and hosts0[0] == ds.version - 1:
            ds._host_cache = (ds.version,
                              _host_apply(hosts0[1], adds, removes))
        else:
            ds._host_cache = None
        mode, rows_patched = "patch", int(rows.size)
    elif worker is not None:
        _queue_escalation(ds, worker, adds, removes, reason, set(touched))
        mode, rows_patched = "repack_queued", 0
    else:
        hosts = _host_apply(host_bitmaps(ds), adds, removes)
        repack_in_place(ds, hosts, reason=reason, touched=touched)
        mode, rows_patched = "repack", 0

    from . import result_cache

    dropped = (0 if mode == "repack_queued" else
               result_cache.notify_version_bump(ds.uid, touched))
    wall = time.perf_counter() - t0
    return {"mode": mode, "version": ds.version,
            "rows_patched": rows_patched, "values_added": n_add,
            "values_removed": n_rem, "repack_reason": reason,
            "wall_ms": round(wall * 1e3, 3), "drift": drift}, dropped


def _queue_escalation(ds, worker, adds, removes, reason, touched) -> None:
    """Add one escalated delta to the set's pending list and queue the
    commit job unless one is already riding: the job drains the whole list
    at commit time against the then-current host sources (deltas in
    arrival order), runs one repack and invalidates once."""
    pend = getattr(ds, "_pending_escalations", None)
    if pend is None:
        pend = ds._pending_escalations = []
        ds._pending_escalations_lock = threading.Lock()
    with ds._pending_escalations_lock:
        pend.append((adds, removes, reason, touched))
        first = len(pend) == 1
    if not first:
        return

    def _commit():
        from . import result_cache

        with ds._pending_escalations_lock:
            batch = list(ds._pending_escalations)
            ds._pending_escalations.clear()
        if not batch:
            return
        hosts = host_bitmaps(ds)
        t_all: set = set()
        for a, r, _why, t_set in batch:
            hosts = _host_apply(hosts, a, r)
            t_all |= t_set
        repack_in_place(ds, hosts, reason=batch[-1][2], touched=t_all)
        result_cache.notify_version_bump(ds.uid, t_all)

    worker.submit(_commit, kind="repack",
                  desc=f"uid={ds.uid} reason={reason}")


def _patch_rows(ds, rows, add_m, rem_m) -> None:
    """The in-place row patch of the dense image, queued on the current
    stream, plus its journal entry.  A warmed rung stages the patch padded
    and replays its program; a cold one runs the exact patch eagerly.  The
    patch writes the image alone: a dense set that kept its streams for
    its or/xor drops them and reads the image from here on."""
    ds._drop_streams()
    prog = _patch_program(ds, _rung_of(ds, int(rows.size)), build=False)
    if prog is not None:
        prog.run(ds, rows, add_m, rem_m)
    else:
        dev = ds.words.device
        _patch_body(ds.words, upload(rows, dev),
                    upload(np.stack((add_m, rem_m), axis=1), dev))
    journal = ds._delta_journal
    journal.append((ds.version, np.asarray(rows, np.int32).copy(),
                    add_m.copy(), rem_m.copy()))
    while len(journal) > JOURNAL_DEPTH:
        dropped = journal.pop(0)[0]
        ds._journal_dropped_version = max(ds._journal_dropped_version,
                                          dropped)


def repack_in_place(ds, bitmaps=None, reason: str = "requested",
                    touched=None) -> dict:
    """Full repack of a resident set: rebuild its layout from the current
    (or given) host sources with ``layout="auto"`` re-resolved, keeping the
    set's identity and version lineage.

    The new layout is built apart: ``__init__`` runs again on a shell that
    carries the set's lineage and columns (which ``_load`` keeps), the
    build is waited for on the card's current stream, and only then does
    the set take the shell's state in one assignment.  So a reader on
    another thread sees the old layout or the new one, never a half-built
    one, and launches already queued over the old tensors read them."""
    t0 = time.perf_counter()
    if bitmaps is None:
        bitmaps = host_bitmaps(ds)
    cls = type(ds)
    shell = cls.__new__(cls)
    for name in ("uid", "version", "structure_version", "columns",
                 "_journal_dropped_version"):
        setattr(shell, name, getattr(ds, name))
    shell.source_versions = ds.source_versions.copy()
    cls.__init__(shell, bitmaps, layout="auto", device=ds.device)
    shell.version = ds.version + 1
    shell.structure_version = ds.structure_version + 1
    for src in (touched or ()):
        shell.source_versions[src] = shell.version
    shell.row_versions = np.full(shell._n_rows, shell.version, np.int64)
    shell._host_cache = (shell.version, list(bitmaps))
    # the structure changed: a journal replay means nothing across it
    shell._delta_journal = []
    shell._journal_dropped_version = shell.version
    for name in ("_pending_escalations", "_pending_escalations_lock"):
        if hasattr(ds, name):
            setattr(shell, name, getattr(ds, name))
    if ds.device.type == "cuda":
        torch.cuda.current_stream(ds.device).synchronize()
    # the graphs write the old image by address: gone before it is freed
    drop_patch_programs(ds)
    obs_memory.LEDGER.release(ds._ledger_handle)
    ds.__dict__ = shell.__dict__
    obs_memory.LEDGER.release(shell._ledger_handle)
    ds._register_residency()
    wall = time.perf_counter() - t0
    obs_metrics.histogram("rb_delta_apply_seconds",
                          mode="repack").observe(wall)
    obs_trace.current().event(
        "mutation.repack", site=SITE, uid=ds.uid, reason=reason,
        version=ds.version, structure_version=ds.structure_version,
        wall_ms=round(wall * 1e3, 2))
    return {"mode": "repack", "reason": reason, "version": ds.version,
            "structure_version": ds.structure_version,
            "wall_ms": round(wall * 1e3, 3)}
