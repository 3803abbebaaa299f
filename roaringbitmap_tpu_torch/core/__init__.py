from . import containers
from .bitmap import RoaringBitmap

__all__ = ["containers", "RoaringBitmap"]
