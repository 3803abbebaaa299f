"""32-bit RoaringBitmap: the host API subset the wide aggregation path and
the value-column oracles (``core.rangebitmap``, ``bsi.slice_index``) use.

Structure of arrays: ``keys`` is a sorted u16 NumPy array, ``containers`` the
matching list.  Bulk construction is vectorized (sort + unique on the high-16
axis).  The pairwise operators are the host fold that checks the device
engines: ``or_``/``xor``/``and_``/``andnot`` merge two bitmaps key by key
with the container algebra of ``core.containers``.
"""

from __future__ import annotations

import numpy as np

from . import containers as C
from .containers import Container
from ..format import spec


class RoaringBitmap:
    """Compressed bitmap over the unsigned 32-bit universe."""

    __slots__ = ("keys", "containers")

    def __init__(self, keys: np.ndarray | None = None,
                 containers: list[Container] | None = None):
        self.keys = keys if keys is not None else np.empty(0, dtype=np.uint16)
        self.containers = containers if containers is not None else []

    @staticmethod
    def bitmap_of(*values: int) -> "RoaringBitmap":
        return RoaringBitmap.from_values(np.array(values, dtype=np.uint32))

    @staticmethod
    def from_values(values: np.ndarray) -> "RoaringBitmap":
        """Vectorized bulk construction from an unsorted u32 array."""
        v = np.asarray(values, dtype=np.uint32)
        if v.size == 0:
            return RoaringBitmap()
        return RoaringBitmap.from_sorted(np.unique(v))

    @staticmethod
    def from_sorted(v: np.ndarray) -> "RoaringBitmap":
        """Bulk construction from ascending, duplicate-free u32 values."""
        if v.size == 0:
            return RoaringBitmap()
        hi = (v >> np.uint32(16)).astype(np.uint16)
        keys, starts = np.unique(hi, return_index=True)
        bounds = np.append(starts, v.size)
        conts: list[Container] = [
            C.from_values((v[bounds[i]:bounds[i + 1]] & np.uint32(0xFFFF)).astype(np.uint16))
            for i in range(keys.size)
        ]
        return RoaringBitmap(keys.astype(np.uint16), conts)

    @staticmethod
    def from_range(start: int, stop: int) -> "RoaringBitmap":
        """Every value in [start, stop): one range container a key.  Bounds
        outside [0, 2^32) raise ``ValueError``, as in the JAX package; an
        empty or reversed range is an empty bitmap."""
        keys, conts = [], []
        for lo, hi_excl, hb in _chunk_ranges(start, stop):
            keys.append(hb)
            conts.append(C.range_container(lo, hi_excl))
        return RoaringBitmap(np.array(keys, dtype=np.uint16), conts)

    def clone(self) -> "RoaringBitmap":
        return RoaringBitmap(self.keys.copy(), list(self.containers))

    def _set_member(self, x: int, present: bool) -> None:
        """Add (``present``) or remove one value, rebuilding its container."""
        key, low = x >> 16, np.uint16(x & 0xFFFF)
        i = int(np.searchsorted(self.keys, key))
        hit = i < self.keys.size and int(self.keys[i]) == key
        vals = self.containers[i].values() if hit else np.empty(0, np.uint16)
        vals = (np.union1d(vals, [low]) if present
                else vals[vals != low]).astype(np.uint16)
        if hit and vals.size:
            self.containers[i] = C.from_values(vals)
        elif hit:
            self.keys = np.delete(self.keys, i)
            del self.containers[i]
        elif vals.size:
            self.keys = np.insert(self.keys, i, np.uint16(key))
            self.containers.insert(i, C.from_values(vals))

    def add(self, x: int) -> None:
        self._set_member(int(x), True)

    def remove(self, x: int) -> None:
        self._set_member(int(x), False)

    @property
    def cardinality(self) -> int:
        return sum(c.cardinality for c in self.containers)

    def __len__(self) -> int:
        return self.cardinality

    def is_empty(self) -> bool:
        return not self.containers

    def container_count(self) -> int:
        return len(self.containers)

    def run_optimize(self) -> bool:
        """Re-encode each container in its smallest kind; True when a run
        container was chosen anywhere."""
        changed = False
        for i, c in enumerate(self.containers):
            o = c.run_optimize()
            if o is not c:
                self.containers[i] = o
                changed = changed or o.is_run()
        return changed

    def to_array(self) -> np.ndarray:
        """All members, ascending, as u32."""
        if not self.containers:
            return np.empty(0, dtype=np.uint32)
        return np.concatenate([
            np.uint32(int(k) << 16) | c.values().astype(np.uint32)
            for k, c in zip(self.keys, self.containers)])

    def contains(self, x: int) -> bool:
        if not 0 <= x < (1 << 32):
            return False
        i = int(np.searchsorted(self.keys, x >> 16))
        return (i < self.keys.size and int(self.keys[i]) == x >> 16
                and bool(np.isin(x & 0xFFFF, self.containers[i].values())))

    def range_cardinality(self, start: int, stop: int) -> int:
        """Members in [start, stop) (RoaringBitmap.rangeCardinality)."""
        a = self.to_array().astype(np.int64)
        lo, hi = (min(max(v, 0), 1 << 32) for v in (start, stop))
        return max(0, int(np.searchsorted(a, hi) - np.searchsorted(a, lo)))

    def __and__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return and_(self, o)

    def __or__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return or_(self, o)

    def __xor__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return xor(self, o)

    def __sub__(self, o: "RoaringBitmap") -> "RoaringBitmap":
        return andnot(self, o)

    def __eq__(self, o: object) -> bool:
        if not isinstance(o, RoaringBitmap):
            return NotImplemented
        if not np.array_equal(self.keys, o.keys):
            return False
        return all(C.container_equals(a, b)
                   for a, b in zip(self.containers, o.containers))

    def __hash__(self) -> int:
        return hash(self.to_array().tobytes())

    def __repr__(self) -> str:
        return (f"RoaringBitmap(card={self.cardinality}, "
                f"keys={self.keys.size})")

    def serialize(self) -> bytes:
        return spec.serialize(self.keys, self.containers)

    @staticmethod
    def deserialize(buf: bytes | memoryview) -> "RoaringBitmap":
        keys, conts = spec.deserialize(buf)
        return RoaringBitmap(keys, conts)

    def serialized_size_in_bytes(self) -> int:
        return spec.serialized_size_in_bytes(self.keys, self.containers)


# ---------------------------------------------------------------------------
# Pairwise static algebra: key merge vectorized with intersect1d/union1d.
# The result has type(a) and a's key dtype, so the same functions serve the
# 64-bit tier (core.bitmap64: u64 high-48 keys).
# ---------------------------------------------------------------------------

def _chunk_ranges(start: int, stop: int):
    """Split [start, stop) into per-chunk (lo, hi_excl, highbits) pieces."""
    if start >= stop:
        return
    if start < 0 or stop > (1 << 32):
        raise ValueError("range outside the 32-bit universe")
    hb_first, hb_last = start >> 16, (stop - 1) >> 16
    for hb in range(hb_first, hb_last + 1):
        lo = start & 0xFFFF if hb == hb_first else 0
        hi_excl = ((stop - 1) & 0xFFFF) + 1 if hb == hb_last else 0x10000
        yield lo, hi_excl, hb


def and_(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    common, ia, ib = np.intersect1d(a.keys, b.keys, assume_unique=True,
                                    return_indices=True)
    keys, conts = [], []
    for k, i, j in zip(common, ia, ib):
        c = C.container_and(a.containers[i], b.containers[j])
        if c.cardinality:
            keys.append(k)
            conts.append(c)
    return type(a)(np.array(keys, dtype=a.keys.dtype), conts)


def and_cardinality(a: RoaringBitmap, b: RoaringBitmap) -> int:
    return and_(a, b).cardinality


def or_(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    return _merge_union(a, b, C.container_or)


def xor(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    return _merge_union(a, b, C.container_xor, drop_empty=True)


def andnot(a: RoaringBitmap, b: RoaringBitmap) -> RoaringBitmap:
    keys, conts = [], []
    b_idx = {int(k): j for j, k in enumerate(b.keys)}
    for k, ca in zip(a.keys, a.containers):
        j = b_idx.get(int(k))
        c = ca if j is None else C.container_andnot(ca, b.containers[j])
        if c.cardinality:
            keys.append(k)
            conts.append(c)
    return type(a)(np.array(keys, dtype=a.keys.dtype), conts)


def _merge_union(a: RoaringBitmap, b: RoaringBitmap, op, drop_empty: bool = False):
    all_keys = np.union1d(a.keys, b.keys)
    a_idx = {int(k): i for i, k in enumerate(a.keys)}
    b_idx = {int(k): i for i, k in enumerate(b.keys)}
    keys, conts = [], []
    for k in all_keys:
        i, j = a_idx.get(int(k)), b_idx.get(int(k))
        if i is not None and j is not None:
            c = op(a.containers[i], b.containers[j])
        elif i is not None:
            c = a.containers[i]
        else:
            c = b.containers[j]
        if drop_empty and c.cardinality == 0:
            continue
        keys.append(k)
        conts.append(c)
    return type(a)(np.array(keys, dtype=a.keys.dtype), conts)
