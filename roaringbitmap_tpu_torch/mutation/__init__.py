"""Mutable tenants: versioned delta ingest, materialized result reuse and
durability (``roaringbitmap_tpu.mutation``).

- :mod:`.delta`: ``DeviceBitmapSet.apply_delta(adds, removes)`` patches
  the touched rows of the resident image in place, stamps the set's
  ``version``, per-source and per-row versions, and escalates structural
  deltas, non-dense layouts and layout drift to a repack;
- :mod:`.result_cache`: results keyed by the canonical DAG and the leaves'
  ``(set uid, source, version)``, served before planning and injected into
  plans as pre-computed operands, with exact invalidation;
- :mod:`.maintenance`: the worker that runs an escalated repack off the
  serving thread (deferred commit);
- :mod:`.durability`: the per-tenant write-ahead journal (append before
  apply, length+CRC framed, typed flush policy, group commit) and
  portable snapshots, so recovery is the snapshot plus the journal's tail,
  onto the card.  Journals and snapshots are the JAX package's files,
  byte for byte.
"""

from .delta import (apply_delta, drift_report, host_bitmaps, repack_in_place,
                    warmup_delta)
from .durability import (DeltaJournal, DurableTenant, FlushPolicy,
                         GroupCommitScheduler, load_snapshot, recover_tenant,
                         scan_journal)
from .maintenance import MaintenanceWorker
from .result_cache import (ENV_RESULT_CACHE, ResultCache, from_env, node_key,
                           notify_version_bump, query_key, serve_and_fill)

__all__ = [
    "apply_delta", "drift_report", "host_bitmaps", "repack_in_place",
    "warmup_delta", "DeltaJournal", "DurableTenant", "FlushPolicy",
    "GroupCommitScheduler", "load_snapshot", "recover_tenant",
    "scan_journal", "MaintenanceWorker",
    "ENV_RESULT_CACHE", "ResultCache", "from_env", "node_key",
    "notify_version_bump", "query_key", "serve_and_fill",
]
