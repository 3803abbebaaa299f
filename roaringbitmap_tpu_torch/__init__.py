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

Entry points run on the card: ``device=None`` means ``"cuda"``, and only an
explicit ``device="cpu"`` runs the plain PyTorch versions on the CPU.
"""

from .core.bitmap import RoaringBitmap, and_, andnot, or_, xor
from .core.bitmap64 import Roaring64Bitmap
from .format.spec import InvalidRoaringFormat
from .parallel import (aggregation, batch_engine, expr, fast_aggregation,
                       multiset)
from .parallel.aggregation import DeviceBitmap, DeviceBitmapSet, DevicePairSet
from .parallel.batch_engine import BatchEngine, BatchQuery, BatchResult
from .parallel.expr import ExprQuery
from .parallel.multiset import BatchGroup, MultiSetBatchEngine

__all__ = ["RoaringBitmap", "Roaring64Bitmap", "InvalidRoaringFormat", "aggregation",
           "batch_engine", "expr", "fast_aggregation", "DeviceBitmap",
           "DeviceBitmapSet", "DevicePairSet",
           "BatchEngine", "BatchGroup", "BatchQuery", "BatchResult",
           "ExprQuery", "MultiSetBatchEngine", "multiset", "and_",
           "andnot", "or_", "xor"]
