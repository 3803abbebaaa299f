"""Mutable tenants: versioned delta ingest and materialized result reuse
(``roaringbitmap_tpu.mutation``, without its durability layer).

- :mod:`.delta`: ``DeviceBitmapSet.apply_delta(adds, removes)`` patches
  the touched rows of the resident image in place, stamps the set's
  ``version``, per-source and per-row versions, and escalates structural
  deltas, non-dense layouts and layout drift to a repack;
- :mod:`.result_cache`: results keyed by the canonical DAG and the leaves'
  ``(set uid, source, version)``, served before planning and injected into
  plans as pre-computed operands, with exact invalidation;
- :mod:`.maintenance`: the worker that runs an escalated repack off the
  serving thread (deferred commit).
"""

from .delta import (apply_delta, drift_report, host_bitmaps, repack_in_place,
                    warmup_delta)
from .maintenance import MaintenanceWorker
from .result_cache import (ENV_RESULT_CACHE, ResultCache, from_env, node_key,
                           notify_version_bump, query_key, serve_and_fill)

__all__ = [
    "apply_delta", "drift_report", "host_bitmaps", "repack_in_place",
    "warmup_delta", "MaintenanceWorker",
    "ENV_RESULT_CACHE", "ResultCache", "from_env", "node_key",
    "notify_version_bump", "query_key", "serve_and_fill",
]
