"""The work an op's inputs need, counted from the generated bytes alone.

Frozen in the benchmark: the counts never look at the layout, the plan or
the kernels the program chose, so a change to any of them moves only the
time in the denominator of a roofline share, and no share can pass 100%.

A wide OR / XOR over the whole set reads every resident bitmap once in its
portable serialized form and writes one 8 KiB head and one 4-byte
cardinality for each key of the result (every key the set holds).

The chip's peak is the NVIDIA H100 SXM data sheet's 3.35 TB/s of HBM3.
The INT32 peak in the program's ``obs/cost.py`` is not used: it is
assumed, and these ops are bound by bytes.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
HEAD_BYTES = 8192
CARD_BYTES = 4


def header_keys(buf: bytes) -> np.ndarray:
    """The container keys in one serialized bitmap's header."""
    cookie = int(np.frombuffer(buf, "<u4", 1, 0)[0])
    if cookie == 12346:
        n, pos = int(np.frombuffer(buf, "<u4", 1, 4)[0]), 8
    elif cookie & 0xFFFF == 12347:
        n = (cookie >> 16) + 1
        pos = 4 + (n + 7) // 8
    else:
        raise ValueError(f"unknown cookie {cookie}")
    return np.frombuffer(buf, "<u2", 2 * n, pos)[0::2]


def sizes(sources) -> np.ndarray:
    """i64[bitmaps] serialized bytes of each bitmap."""
    return np.fromiter((len(b) for b in sources), np.int64, len(sources))


def distinct_keys(sources) -> int:
    """How many distinct container keys the set holds."""
    return int(np.unique(np.concatenate(
        [header_keys(b) for b in sources])).size)


def wide_op_bytes(sources) -> int:
    """Bytes one wide OR / XOR over the whole set must move."""
    return (int(sizes(sources).sum())
            + distinct_keys(sources) * (HEAD_BYTES + CARD_BYTES))


def roofline_pct(work_bytes: float, busy_s: float) -> float | None:
    """The share of the chip's bandwidth bound in the device's busy time,
    in percent; None where the device did nothing."""
    if not busy_s or busy_s <= 0:
        return None
    return 100.0 * (work_bytes / HBM_BYTES_PER_S) / busy_s
