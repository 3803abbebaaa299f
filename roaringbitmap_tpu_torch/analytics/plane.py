"""Slice-plane scan cores of the analytics lane
(``roaringbitmap_tpu.analytics.plane``).

The expression compiler lowers a value predicate (``range_`` / ``cmp``) to
one ``vscan`` step whose body on the multi-op rungs is :func:`scan_words`: a
descending O'Neil pass over the column's padded slice planes giving an
``int32[K, 2048]`` block over the column's keys, which feeds the
or/and/xor/andnot combines of the same section.  Aggregate roots reuse the
sum contraction and the Kaser scan of the device BSI tier.  On the
megakernel rung the same steps are instruction-stream micro-ops
(``ops.megakernel``).

Scan tags are ``"<kind>:<op>"``: ``bsi`` is the O'Neil comparator
(EQ/NEQ/LT/LE/GT/GE/RANGE), ``range`` the RangeBitmap threshold family
(lte/gte/eq/neq/between); ``op == "all"`` is the existence plane itself.
Predicate values arrive as bit arrays.
"""

from __future__ import annotations

from ..bsi.device import (_compare_res, _range_res, _topk_res,
                          predicate_bits)
from ..ops.words import popcount

#: comparator-family ops a ``vscan`` step may carry (plus "all")
BSI_OPS = ("EQ", "NEQ", "LT", "LE", "GT", "GE", "RANGE")
RANGE_OPS = ("lte", "gte", "eq", "neq", "between")


def scan_words(tag: str, slices, ebm, bits, bits2):
    """Value-predicate scan over the padded slice planes -> int32[K, 2048]
    words over the column's keys.  Padded zero planes carry zero bits, so
    their state updates are the identity."""
    kind, _, op = tag.partition(":")
    if op == "all":
        return ebm
    if kind == "bsi":
        return _compare_res(op, slices, ebm, bits, bits2, ebm)
    if kind == "range":
        return _range_res(op, slices, ebm, bits, bits2, ebm)
    raise ValueError(f"unknown scan tag {tag!r}")


def sum_cards(slices, found_on_col):
    """Per-(slice, key) popcounts of slices ∩ found -> int32[S, K] (each at
    most 2^16); the 2^i weighting happens on the host in Python ints."""
    return popcount(slices & found_on_col[None])


def topk_words(slices, found, k):
    """The Kaser top-K scan over the found set; the tie trim happens on
    the host at readback."""
    return _topk_res(slices, found, k)


__all__ = ["scan_words", "sum_cards", "topk_words", "predicate_bits",
           "BSI_OPS", "RANGE_OPS"]
