from . import aggregation, batch_engine, expr, fast_aggregation
from .aggregation import DeviceBitmap, DeviceBitmapSet, DevicePairSet
from .batch_engine import (BatchEngine, BatchQuery, BatchResult,
                           random_query_pool)
from .expr import ExprQuery, random_expr_pool

__all__ = ["aggregation", "batch_engine", "expr", "fast_aggregation",
           "DeviceBitmap", "DeviceBitmapSet", "DevicePairSet",
           "BatchEngine", "BatchQuery", "BatchResult",
           "ExprQuery", "random_query_pool", "random_expr_pool"]
