"""Immutable (memory-mappable) bit-sliced index: the reference's buffer BSI.

The port's own copy of ``roaringbitmap_tpu.bsi.immutable``: attach to a
serialized bit-sliced index without materializing it.  The header is parsed
once; the existence bitmap and every slice stay zero-copy
``buffer.ImmutableRoaringBitmap`` views whose containers decode lazily, and
the whole read-only query surface runs over them (compare / sum / top_k /
get_value / transpose / in_values).  The host query engine already works on
anything with ``.keys`` / ``.containers``, so this class is
``RoaringBitmapSliceIndex`` with buffer-backed storage and mutation
disabled.

A value column takes one as it is: ``analytics.BsiColumn.from_bsi`` packs
the device planes straight off the views.

The byte format is ``serialize_buffer``'s fixed-width layout: i32-BE
minValue, i32-BE maxValue, u8 runOptimized, the ebM portable stream, i32-BE
bitDepth, then the slices' portable streams.
"""

from __future__ import annotations

import mmap
import struct

from ..buffer.immutable import ImmutableRoaringBitmap
from ..format import spec
from .slice_index import RoaringBitmapSliceIndex


class ImmutableBitSliceIndex(RoaringBitmapSliceIndex):
    """Read-only BSI over a serialized buffer (ImmutableBitSliceIndex)."""

    def __init__(self, buf: bytes | memoryview):
        mv = memoryview(buf)
        if len(mv) < 9:
            raise spec.InvalidRoaringFormat("truncated BSI header")
        mn, mx = struct.unpack_from(">ii", mv, 0)
        # no super().__init__ (it allocates mutable slices): the same
        # attributes, as buffer-backed views
        self.min_value, self.max_value = mn, mx
        self.run_optimized = mv[8] == 1
        pos = 9
        self.ebm, pos = _wrap_bitmap(mv, pos)
        if pos + 4 > len(mv):
            raise spec.InvalidRoaringFormat("truncated BSI bit depth")
        (depth,) = struct.unpack_from(">i", mv, pos)
        pos += 4
        if depth < 0 or depth > 64:
            raise spec.InvalidRoaringFormat(f"bad BSI bit depth {depth}")
        self.slices = []
        for _ in range(depth):
            s, pos = _wrap_bitmap(mv, pos)
            self.slices.append(s)
        self._mv = mv  # keep the backing buffer alive

    @staticmethod
    def mapped(path: str) -> "ImmutableBitSliceIndex":
        """Memory-map a file written by ``serialize_buffer``."""
        with open(path, "rb") as f:
            mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        return ImmutableBitSliceIndex(memoryview(mm))

    def to_mutable(self) -> RoaringBitmapSliceIndex:
        """A heap-mutable copy (the MutableBitSliceIndex pairing)."""
        out = RoaringBitmapSliceIndex(self.min_value, self.max_value)
        out.run_optimized = self.run_optimized
        out.ebm = self.ebm.to_bitmap()
        out.slices = [s.to_bitmap() for s in self.slices]
        return out

    def clone(self) -> RoaringBitmapSliceIndex:
        return self.to_mutable()

    # ------------------------------------------------------- mutation guards
    def _immutable(self, name: str):
        raise TypeError(f"ImmutableBitSliceIndex is read-only ({name}); "
                        "use to_mutable() first")

    def set_value(self, column_id: int, value: int) -> None:
        self._immutable("set_value")

    def set_values(self, pairs) -> None:
        self._immutable("set_values")

    def add(self, other) -> None:
        self._immutable("add")

    def merge(self, other) -> None:
        self._immutable("merge")

    def merge_overwrite(self, other) -> None:
        self._immutable("merge_overwrite")

    def run_optimize(self) -> None:
        self._immutable("run_optimize")

    def add_digit(self, *a) -> None:
        self._immutable("add_digit")

    def to_mutable_bit_slice_index(self) -> RoaringBitmapSliceIndex:
        """toMutableBitSliceIndex: alias of to_mutable."""
        return self.to_mutable()


def _wrap_bitmap(mv: memoryview, pos: int) -> tuple[ImmutableRoaringBitmap, int]:
    """Zero-copy wrap of one embedded portable bitmap stream."""
    imm = ImmutableRoaringBitmap(mv[pos:])
    return imm, pos + imm.serialized_size_in_bytes()
