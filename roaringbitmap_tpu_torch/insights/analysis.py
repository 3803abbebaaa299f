"""Layout choice for resident sets, from host metadata alone.

The uscensus2000 shape (thousands of mostly-singleton containers) inflates a
few dozen KB of serialized bytes into a dense image tens of MB large, which
every query would stream.  ``choose_layout`` sends that shape to the counts
layout and everything else to the dense one, deciding exactly as
``roaringbitmap_tpu.insights.analysis.choose_layout`` does, so that
``DeviceBitmapSet(layout="auto")`` builds the same layout in both packages.
"""

from __future__ import annotations

import numpy as np

from ..core.containers import WORDS_PER_CONTAINER
from ..ops import packing

#: bytes of one densified container row: u32[2048] = 2^16 bits = 8 KiB
ROW_BYTES = WORDS_PER_CONTAINER * 8

#: "auto" picks counts only for mostly-singleton segments (median <= this)
#: AND a dense image that inflates the serialized bytes past this factor.
AUTO_COUNTS_MEDIAN_SEGMENT = 1.0
AUTO_COUNTS_INFLATION_X = 100.0


def dense_rows_bytes(n_rows: int) -> int:
    """Device bytes of ``n_rows`` densified container rows."""
    return int(n_rows) * ROW_BYTES


def _serialized_size_of(b) -> int | None:
    if isinstance(b, (bytes, bytearray, memoryview)):
        return len(b)
    end = getattr(b, "serialized_end", None)
    if end is not None:      # format.spec.SerializedView
        return int(end())
    fn = getattr(b, "serialized_size_in_bytes", None)
    return int(fn()) if fn is not None else None


def choose_layout(sources) -> dict:
    """Resolve the adaptive DeviceBitmapSet layout for ``sources`` from key
    counts and serialized sizes (nothing is packed or transferred)::

        {"layout": "dense"|"counts", "median_segment": float,
         "inflation_x": float, "dense_bytes": int, "serialized_bytes": int,
         "why": str[, "dense_block": int]}
    """
    sources = list(sources)
    if not sources:
        return {"layout": "dense", "median_segment": 0.0,
                "inflation_x": 1.0, "dense_bytes": 0, "serialized_bytes": 0,
                "why": "empty input: dense default"}
    ser_sizes = [_serialized_size_of(s) for s in sources]
    if any(s is None for s in ser_sizes):
        return {"layout": "dense", "median_segment": 0.0,
                "inflation_x": 1.0, "dense_bytes": 0,
                "serialized_bytes": 0,
                "why": "unsizeable source: dense default kept"}
    keys = [packing._keys_of(s) for s in sources]
    flat = np.concatenate(keys) if keys else np.empty(0, np.uint16)
    _, seg_sizes = np.unique(flat, return_counts=True)
    median = float(np.median(seg_sizes)) if seg_sizes.size else 0.0
    dense_b = dense_rows_bytes(int(flat.size))
    ser_b = int(sum(ser_sizes))
    inflation = dense_b / ser_b if ser_b else 1.0
    if (median <= AUTO_COUNTS_MEDIAN_SEGMENT
            and inflation > AUTO_COUNTS_INFLATION_X):
        layout, why = "counts", (
            "mostly-singleton segments inflating the dense image "
            f"{inflation:.0f}x past the serialized bytes: the counts layout "
            "halves the streamed image")
    else:
        layout, why = "dense", "dense image inflation within bounds"
    rep = {"layout": layout, "median_segment": median,
           "inflation_x": round(inflation, 1), "dense_bytes": dense_b,
           "serialized_bytes": ser_b, "why": why}
    if layout == "dense":
        # the block the dense layout would pick, from the same key scan
        rep["dense_block"] = int(packing.choose_block(seg_sizes, min_block=4))
    return rep
