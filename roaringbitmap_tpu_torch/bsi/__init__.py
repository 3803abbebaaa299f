"""Bit-sliced index (BSI): one integer value per row id, held as an
existence bitmap plus base-2 slice bitmaps.  The host oracle
(``slice_index``), its read-only mapped form (``immutable``) and the
device tier (``device``) of the port; comparison
queries reduce to bulk bitmap algebra over the slices."""

from .device import DeviceBSI, DeviceRangeBitmap
from .immutable import ImmutableBitSliceIndex
from .slice_index import Operation, RoaringBitmapSliceIndex

__all__ = ["Operation", "RoaringBitmapSliceIndex", "DeviceBSI",
           "DeviceRangeBitmap", "ImmutableBitSliceIndex"]
