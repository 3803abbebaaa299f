from . import aggregation, fast_aggregation
from .aggregation import DeviceBitmapSet

__all__ = ["aggregation", "fast_aggregation", "DeviceBitmapSet"]
