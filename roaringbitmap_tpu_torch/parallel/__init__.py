from . import (aggregation, batch_engine, expr, fast_aggregation, multihost,
               multiset, podmesh, sharded_engine, sharding)
from .aggregation import DeviceBitmap, DeviceBitmapSet, DevicePairSet
from .batch_engine import (BatchEngine, BatchQuery, BatchResult,
                           random_query_pool)
from .expr import ExprQuery, random_expr_pool
from .multiset import BatchGroup, MultiSetBatchEngine, random_multiset_pool
from .podmesh import PlacementPlan, PodMesh
from .sharded_engine import ShardedBatchEngine, default_mesh
from .sharding import SPECS, Mesh, SpecLayout

__all__ = ["aggregation", "batch_engine", "expr", "fast_aggregation",
           "multihost", "multiset", "podmesh", "sharded_engine", "sharding",
           "BatchGroup", "MultiSetBatchEngine", "random_multiset_pool",
           "DeviceBitmap", "DeviceBitmapSet", "DevicePairSet",
           "BatchEngine", "BatchQuery", "BatchResult",
           "ExprQuery", "random_query_pool", "random_expr_pool",
           "ShardedBatchEngine", "default_mesh", "Mesh", "SPECS",
           "SpecLayout", "PodMesh", "PlacementPlan"]
