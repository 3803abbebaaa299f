from . import containers
from .bitmap import RoaringBitmap
from .bitmap64 import Roaring64Bitmap

__all__ = ["containers", "RoaringBitmap", "Roaring64Bitmap"]
