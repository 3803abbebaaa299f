"""roaringbitmap_tpu_torch: the PyTorch / CUDA port of roaringbitmap_tpu.

The wide OR/XOR/AND over thousands of bitmaps with exact cardinalities (the
reference's FastAggregation / ParallelAggregation), and batches of flat and
expression queries over a resident set (``BatchEngine``, ``expr``) and pools
of them over many tenants' sets (``MultiSetBatchEngine``), run on an
NVIDIA H100 through hand-written CUDA kernels (``ops.kernels``,
``ops.megakernel``, sources in ``ops/csrc``).  The host tier (containers, bitmaps, the portable format) is
the port's own NumPy copy.  The package imports ``torch`` and ``numpy`` and
nothing of JAX or of ``roaringbitmap_tpu``.

The 64-bit tier (``Roaring64Bitmap``, ``aggregation.or64`` etc.) rides the
same engines.  Resident sets are mutable (``mutation``: in-place deltas,
repacks, the materialized result cache the engines serve from).  Wide calls and batches run under the guarded dispatch ladder
(``runtime.guard``), and inputs that are all serialized bytes pack through
the native C++ ingest engine (``native``).

The host tier also carries the JAX package's whole top-level surface:
``Roaring64NavigableMap``, ``RangeBitmap`` (with its serialized form),
``FastRankRoaringBitmap``, ``RoaringBitSet``, ``RoaringBitmapWriter`` and
the pairwise functions; ``buffer.ImmutableRoaringBitmap`` (bitmaps over
serialized bytes or an mmap) feeds the wide entry points and the resident
sets as it is.

Entry points run on the card: ``device=None`` means ``"cuda"``, and only an
explicit ``device="cpu"`` runs the plain PyTorch versions on the CPU.
"""

from .core.bitmap import (
    RoaringBitmap,
    and_,
    and_cardinality,
    andnot,
    andnot_cardinality,
    flip,
    or_,
    or_cardinality,
    or_not,
    xor,
    xor_cardinality,
)
from .core import containers

# the reference's camelCase names (andNot / andNotCardinality)
and_not = andnot
and_not_cardinality = andnot_cardinality

from .core.bitmap64 import Roaring64Bitmap, Roaring64NavigableMap
from .core.bitset import RoaringBitSet
from .core.fastrank import FastRankRoaringBitmap
from .core.rangebitmap import RangeBitmap
from .core.writer import RoaringBitmapWriter
from .format import spec
from .format.spec import InvalidRoaringFormat
from . import obs, runtime
from .parallel import (aggregation, batch_engine, expr, fast_aggregation,
                       multiset)
from .parallel.aggregation import DeviceBitmap, DeviceBitmapSet, DevicePairSet
from .parallel.batch_engine import BatchEngine, BatchQuery, BatchResult
from .parallel.expr import ExprQuery
from .parallel.multiset import BatchGroup, MultiSetBatchEngine

__all__ = [
    # the JAX package's top-level names
    "RoaringBitmap", "Roaring64Bitmap", "Roaring64NavigableMap",
    "RangeBitmap", "FastRankRoaringBitmap", "RoaringBitSet",
    "RoaringBitmapWriter",
    "and_", "or_", "xor", "andnot", "and_not", "or_not", "flip",
    "and_cardinality", "or_cardinality", "xor_cardinality",
    "andnot_cardinality", "and_not_cardinality",
    "containers", "spec", "InvalidRoaringFormat", "runtime", "obs",
    # the port's engines
    "aggregation", "batch_engine", "expr", "fast_aggregation", "multiset",
    "DeviceBitmap", "DeviceBitmapSet", "DevicePairSet", "BatchEngine",
    "BatchGroup", "BatchQuery", "BatchResult", "ExprQuery",
    "MultiSetBatchEngine",
]
