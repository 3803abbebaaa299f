"""Process-wide resident device bytes: the port's stand-in for the JAX
package's HBM ledger (``obs.memory.LEDGER.resident_bytes()``), which the
serving loop's admission control and assembly read.

It means what the JAX ledger means: everything the process keeps resident
on a device, released when its owner is collected.  The JAX ledger is
pushed to (each resident registers its bytes and updates them on a
resize); this registry holds a weak reference to each live resident and
pulls its bytes when asked, cached per resident until the resident's stamp
(its structure version, a cache's fill) moves.  Four kinds register:

- ``bitmap_set``: ``DeviceBitmapSet.hbm_bytes()``, at every layout load;
- ``bsi_column`` / ``range_column``: a value column's slice and existence
  planes (``hbm_bytes()``), as the JAX columns count them;
- ``result_cache``: a ``ResultCache``'s resident rows (``nbytes``);
- ``graph_pool``: the device bytes a captured-graph pool reserves
  (``runtime.programs.GraphPool``), which the JAX package, compiling XLA
  programs instead of capturing graphs, has no entry for.

A set's byte count differs from the JAX set's: the port keeps other
resident arrays beside the image (segment ids and head indices as int32
tensors, the compact streams' device copies, B3's chunk bounds), so the
same bitmaps count a few percent differently in the two packages.  A
budget compared with these bytes is therefore stated in the port's own
units.
"""

from __future__ import annotations

import threading
import weakref

_lock = threading.RLock()
#: id(owner) -> [weakref, kind, nbytes(owner), stamp(owner) | None,
#: last stamp, last bytes]
_entries: dict = {}
_UNSET = object()


def register(owner, kind: str, nbytes, stamp=None) -> None:
    """Count ``nbytes(owner)`` as resident while ``owner`` lives.  With a
    ``stamp(owner)`` function the bytes are recomputed only when the stamp
    moves; without one, at every read.  Registering an owner again
    replaces its entry."""
    key = id(owner)

    def gone(ref, key=key):
        with _lock:
            row = _entries.get(key)
            if row is not None and row[0] is ref:
                del _entries[key]

    with _lock:
        _entries[key] = [weakref.ref(owner, gone), str(kind), nbytes, stamp,
                         _UNSET, 0]


def _rows() -> list:
    out = []
    with _lock:
        rows = list(_entries.values())
    for row in rows:
        owner = row[0]()
        if owner is None:
            continue
        try:
            stamp = row[3](owner) if row[3] is not None else _UNSET
            if row[3] is None or stamp != row[4]:
                row[5] = int(row[2](owner))
                row[4] = stamp
        except AttributeError:
            # an owner still being built on another thread: nothing of it
            # counts yet, and the next read counts it again
            row[4], row[5] = _UNSET, 0
        out.append((row[1], row[5]))
    return out


def resident_bytes(kind: str | None = None) -> int:
    """Resident bytes of every live registered owner (of one kind)."""
    return sum(b for k, b in _rows() if kind is None or k == kind)


def snapshot() -> dict:
    """``{"total_bytes", "entries", "by_kind": {kind: bytes}}``, the shape
    of the JAX ledger's snapshot without its layout level."""
    rows = _rows()
    by_kind: dict = {}
    for k, b in rows:
        by_kind[k] = by_kind.get(k, 0) + b
    return {"total_bytes": sum(b for _, b in rows), "entries": len(rows),
            "by_kind": by_kind}
