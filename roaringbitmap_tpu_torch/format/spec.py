"""Portable RoaringFormatSpec serialization, byte-compatible with the reference.

Layout (all little-endian):

  with run containers:    u32 cookie = 12347 | ((size-1) << 16)
                          u8[(size+7)/8] run-marker bitset (LSB-first per byte)
  without run containers: u32 cookie = 12346, u32 size
  then per container:     u16 key, u16 cardinality-1
  then, unless (hasrun and size < 4):  u32 payload start offset per container
  then per container payload:
      array:  cardinality x u16
      bitmap: 1024 x u64
      run:    u16 n_runs, then n_runs x (u16 start, u16 length-1)

Container kind on read is derived, not stored: the run bit wins; otherwise
cardinality > 4096 means bitmap.  ``SerializedView`` parses the header into
NumPy arrays and leaves payloads in place, which is how ``ops.packing``
ingests byte-backed inputs without building container objects.
"""

from __future__ import annotations

import sys

import numpy as np

from ..core.containers import (
    ARRAY_MAX_SIZE,
    ArrayContainer,
    BitmapContainer,
    Container,
    RunContainer,
)

#: On little-endian hosts the wire layout is the in-memory layout, so decoded
#: payload arrays are read-only zero-copy views into the buffer.
_LITTLE_ENDIAN = sys.byteorder == "little"

SERIAL_COOKIE_NO_RUNCONTAINER = 12346
SERIAL_COOKIE = 12347
NO_OFFSET_THRESHOLD = 4


class InvalidRoaringFormat(ValueError):
    """Raised on cookie, bounds or payload-invariant violations."""


def validate_runs(runs: np.ndarray, i: int) -> tuple[np.ndarray, np.ndarray]:
    """Structural invariants of a run payload ((start, length-1) u16 pairs),
    shared by the container decoder and the packing ingest: runs sorted,
    non-overlapping, confined to the 2^16 chunk.  Returns (starts, inclusive
    ends) as int64."""
    starts = runs[0::2].astype(np.int64)
    ends = starts + runs[1::2].astype(np.int64)
    if ends.size and int(ends.max()) > 0xFFFF:
        raise InvalidRoaringFormat(
            f"container {i}: run extends past 65535")
    if starts.size > 1 and bool(np.any(starts[1:] <= ends[:-1])):
        raise InvalidRoaringFormat(
            f"container {i}: overlapping/unsorted runs")
    return starts, ends


def serialized_size_in_bytes(keys: np.ndarray, containers: list[Container]) -> int:
    size = len(containers)
    if any(c.is_run() for c in containers):
        header = 4 + (size + 7) // 8 + 4 * size
        if size >= NO_OFFSET_THRESHOLD:
            header += 4 * size
    else:
        header = 4 + 4 + 8 * size
    return header + sum(c.serialized_size_in_bytes() for c in containers)


def maximum_serialized_size(cardinality: int, universe_size: int) -> int:
    """Upper bound on the serialized bytes of any bitmap with ``cardinality``
    members below ``universe_size`` (the reference's
    ``RoaringBitmap.maximumSerializedSize``)."""
    contnbr = (universe_size + 65535) // 65536
    contnbr = min(contnbr, cardinality)  # no more containers than values
    headermax = max(8, 4 + (contnbr + 7) // 8) + 8 * contnbr
    valsbest = min(2 * cardinality, contnbr * 8192)
    return headermax + valsbest


def serialize(keys: np.ndarray, containers: list[Container]) -> bytes:
    """Serialize a (sorted keys, containers) pair to the portable format."""
    size = len(containers)
    out = bytearray()
    hasrun = any(c.is_run() for c in containers)
    if hasrun:
        out += np.uint32(SERIAL_COOKIE | ((size - 1) << 16)).astype("<u4").tobytes()
        marker = np.zeros((size + 7) // 8, dtype=np.uint8)
        for i, c in enumerate(containers):
            if c.is_run():
                marker[i >> 3] |= np.uint8(1 << (i & 7))
        out += marker.tobytes()
        start = 4 + len(marker) + (4 if size < NO_OFFSET_THRESHOLD else 8) * size
    else:
        out += np.uint32(SERIAL_COOKIE_NO_RUNCONTAINER).astype("<u4").tobytes()
        out += np.uint32(size).astype("<u4").tobytes()
        start = 4 + 4 + 8 * size
    desc = np.empty(2 * size, dtype="<u2")
    desc[0::2] = np.asarray(keys, dtype=np.uint32).astype("<u2")
    desc[1::2] = np.array([c.cardinality - 1 for c in containers], dtype=np.uint32).astype("<u2")
    out += desc.tobytes()
    if (not hasrun) or size >= NO_OFFSET_THRESHOLD:
        offsets = np.empty(size, dtype="<u4")
        for i, c in enumerate(containers):
            offsets[i] = start
            start += c.serialized_size_in_bytes()
        out += offsets.tobytes()
    for c in containers:
        c.write_payload(out)
    return bytes(out)


class SerializedView:
    """Zero-copy parse of a serialized bitmap: header arrays plus a payload
    locator.  Payload bytes stay in the buffer and are sliced on demand."""

    __slots__ = ("buf", "size", "keys", "cardinalities", "is_run", "is_bitmap",
                 "payload_offsets", "payload_sizes")

    def __init__(self, buf: bytes | memoryview):
        buf = memoryview(buf)
        if len(buf) < 8:
            raise InvalidRoaringFormat("buffer too small for a cookie")
        cookie = int(np.frombuffer(buf[:4], dtype="<u4")[0])
        if (cookie & 0xFFFF) == SERIAL_COOKIE:
            size = (cookie >> 16) + 1
            hasrun = True
            pos = 4
        elif cookie == SERIAL_COOKIE_NO_RUNCONTAINER:
            size = int(np.frombuffer(buf[4:8], dtype="<u4")[0])
            hasrun = False
            pos = 8
        else:
            raise InvalidRoaringFormat("I failed to find a valid cookie.")
        if size > (1 << 16):
            raise InvalidRoaringFormat("Size too large")
        self.buf = buf
        self.size = size
        if hasrun:
            nmarker = (size + 7) // 8
            marker = np.frombuffer(buf[pos:pos + nmarker], dtype=np.uint8)
            if marker.size != nmarker:
                raise InvalidRoaringFormat("truncated run marker")
            self.is_run = np.unpackbits(marker, bitorder="little")[:size].astype(bool)
            pos += nmarker
        else:
            self.is_run = np.zeros(size, dtype=bool)
        if len(buf) < pos + 4 * size:
            # check the length before frombuffer: an odd-length tail would
            # make numpy raise ValueError instead of the format error
            raise InvalidRoaringFormat("truncated descriptive header")
        desc = np.frombuffer(buf[pos:pos + 4 * size], dtype="<u2")
        self.keys = desc[0::2].astype(np.uint16)
        if size > 1 and bool(np.any(self.keys[1:] <= self.keys[:-1])):
            raise InvalidRoaringFormat("keys not strictly increasing")
        self.cardinalities = desc[1::2].astype(np.int64) + 1
        pos += 4 * size
        self.is_bitmap = (self.cardinalities > ARRAY_MAX_SIZE) & ~self.is_run
        if (not hasrun) or size >= NO_OFFSET_THRESHOLD:
            # offsets are redundant and recomputed, but the block must exist
            if len(buf) < pos + 4 * size:
                raise InvalidRoaringFormat("offset block past buffer end")
            pos += 4 * size
        sizes = np.zeros(size, dtype=np.int64)
        is_array = ~self.is_bitmap & ~self.is_run
        sizes[is_array] = 2 * self.cardinalities[is_array]
        sizes[self.is_bitmap] = 8192
        self.payload_offsets = np.zeros(size, dtype=np.int64)
        if not self.is_run.any():
            if size:
                self.payload_offsets = pos + np.concatenate(([0], np.cumsum(sizes[:-1])))
            end = pos + int(sizes.sum())
        else:
            # run payload sizes require reading each run count
            off = pos
            for i in range(size):
                self.payload_offsets[i] = off
                if self.is_run[i]:
                    if off + 2 > len(buf):
                        raise InvalidRoaringFormat("truncated run container")
                    nruns = int(np.frombuffer(buf[off:off + 2], dtype="<u2")[0])
                    sizes[i] = 2 + 4 * nruns
                off += int(sizes[i])
            end = off
        self.payload_sizes = sizes
        if end > len(buf):
            raise InvalidRoaringFormat("payload overruns buffer")

    def container_payload(self, i: int) -> memoryview:
        o = int(self.payload_offsets[i])
        return self.buf[o:o + int(self.payload_sizes[i])]

    def container(self, i: int) -> Container:
        """Decode container i.  Decoding is also the validation boundary for
        payload lies the header scan cannot see: a declared cardinality that
        disagrees with the payload, unsorted array values, and runs out of
        order, overlapping or past the chunk end all raise
        InvalidRoaringFormat."""
        payload = self.container_payload(i)
        if self.is_run[i]:
            nruns = int(np.frombuffer(payload[:2], dtype="<u2")[0])
            runs = np.frombuffer(payload[2:2 + 4 * nruns], dtype="<u2")
            if not _LITTLE_ENDIAN:
                runs = runs.astype(np.uint16)
            validate_runs(runs, i)
            c: Container = RunContainer(runs)
        elif self.is_bitmap[i]:
            words = np.frombuffer(payload, dtype="<u8")
            if not _LITTLE_ENDIAN:
                words = words.astype(np.uint64)
            # the constructor computes the real popcount, so a lying
            # declared cardinality fails the check below
            c = BitmapContainer(words)
        else:
            vals = np.frombuffer(payload, dtype="<u2")
            if not _LITTLE_ENDIAN:
                vals = vals.astype(np.uint16)
            if vals.size > 1 and bool(np.any(vals[1:] <= vals[:-1])):
                raise InvalidRoaringFormat(
                    f"container {i}: array values not strictly increasing")
            c = ArrayContainer(vals)
        if c.cardinality != int(self.cardinalities[i]):
            raise InvalidRoaringFormat(
                f"container {i}: declared cardinality {int(self.cardinalities[i])} "
                f"!= actual {c.cardinality}")
        return c

    def serialized_end(self) -> int:
        if self.size == 0:
            return 8
        return int(self.payload_offsets[-1] + self.payload_sizes[-1])


def deserialize_meta(buf: bytes | memoryview) -> SerializedView:
    """Zero-copy metadata parse: header arrays decoded, payloads left in
    place (the ingest seam of ``ops.packing``)."""
    return SerializedView(buf)


def deserialize(buf: bytes | memoryview) -> tuple[np.ndarray, list[Container]]:
    """Full eager parse -> (keys u16[K], containers)."""
    view = SerializedView(buf)
    return view.keys.copy(), [view.container(i) for i in range(view.size)]
