"""Buffer tier: bitmaps over serialized bytes (the reference's
``org.roaringbitmap.buffer`` package).

- ``ImmutableRoaringBitmap``: a read-only bitmap attached to serialized
  bytes (a ``bytes`` object, a ``memoryview`` slice, a real mmap); the
  header is parsed up front and container payloads are sliced zero-copy on
  demand.
- ``MutableRoaringBitmap``: the heap-mutable twin, the core
  ``RoaringBitmap`` with the immutable pairing conversions.

The wide entry points of ``roaringbitmap_tpu_torch.parallel`` and the
resident sets take immutables as they are: the compact packer reads their
payloads off the bytes, and the wide AND decodes only the containers its
key intersection keeps.
"""

from .immutable import ImmutableRoaringBitmap, MutableRoaringBitmap

__all__ = ["ImmutableRoaringBitmap", "MutableRoaringBitmap"]
