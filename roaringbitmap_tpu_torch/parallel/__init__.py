from . import aggregation, batch_engine, expr, fast_aggregation, multiset
from .aggregation import DeviceBitmap, DeviceBitmapSet, DevicePairSet
from .batch_engine import (BatchEngine, BatchQuery, BatchResult,
                           random_query_pool)
from .expr import ExprQuery, random_expr_pool
from .multiset import BatchGroup, MultiSetBatchEngine, random_multiset_pool

__all__ = ["aggregation", "batch_engine", "expr", "fast_aggregation",
           "multiset", "BatchGroup", "MultiSetBatchEngine",
           "random_multiset_pool",
           "DeviceBitmap", "DeviceBitmapSet", "DevicePairSet",
           "BatchEngine", "BatchQuery", "BatchResult",
           "ExprQuery", "random_query_pool", "random_expr_pool"]
