"""The plain reference: NumPy alone, from the serialized bytes.

It imports nothing of the program and takes nothing the program made: it
parses the portable bytes with its own decoder (RoaringFormatSpec: the
cookie, the descriptive header, the offsets and the array, bitmap and run
payloads), lays every container out as its own 2^16-bit row, and computes
the wide OR / XOR and their exact cardinalities from those rows: per key,
the OR or XOR of the rows of that key, then the set bits.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses

import numpy as np

COOKIE_NO_RUNS = 12346
COOKIE_RUNS = 12347
ARRAY_MAX = 4096
WORDS32 = 2048
#: threads that decode at once (NumPy's bulk calls release the GIL)
WORKERS = 4
#: container rows gathered at once when combining
GATHER = 1 << 14


class FormatError(ValueError):
    """The bytes are not a bitmap in the portable format."""


def parse(buf) -> tuple:
    """One bitmap's header: (keys u32[n], cardinalities i64[n], payload
    offsets i64[n], run flags bool[n])."""
    cookie = int(np.frombuffer(buf, "<u4", 1, 0)[0])
    if cookie == COOKIE_NO_RUNS:
        n = int(np.frombuffer(buf, "<u4", 1, 4)[0])
        pos, runs = 8, np.zeros(n, bool)
    elif cookie & 0xFFFF == COOKIE_RUNS:
        n = (cookie >> 16) + 1
        nbytes = (n + 7) // 8
        runs = np.unpackbits(np.frombuffer(buf, np.uint8, nbytes, 4),
                             bitorder="little")[:n].astype(bool)
        pos = 4 + nbytes
    else:
        raise FormatError(f"unknown cookie {cookie}")
    desc = np.frombuffer(buf, "<u2", 2 * n, pos).reshape(n, 2)
    keys = desc[:, 0].astype(np.uint32)
    cards = desc[:, 1].astype(np.int64) + 1
    pos += 4 * n
    if cookie == COOKIE_NO_RUNS or n >= 4:
        offs = np.frombuffer(buf, "<u4", n, pos).astype(np.int64)
    else:
        # a run bitmap of under 4 containers has no offsets: payloads follow
        # one another
        offs, p = np.empty(n, np.int64), pos
        for i in range(n):
            offs[i] = p
            if runs[i]:
                p += 2 + 4 * int(np.frombuffer(buf, "<u2", 1, p)[0])
            else:
                p += 2 * cards[i] if cards[i] <= ARRAY_MAX else 8192
    return keys, cards, offs, runs


@dataclasses.dataclass
class Decoded:
    """Every container of a set of bitmaps, bitmap by bitmap: its key,
    and its 2^16 bits as 2,048 u32 words."""

    keys: np.ndarray       # u32[C]
    rows: np.ndarray       # u32[C, 2048]
    first: np.ndarray      # i64[bitmaps + 1]: bitmap b owns [first[b], first[b+1])

    def without(self, container: int) -> "Decoded":
        """The set with one container taken out."""
        keep = np.ones(self.keys.size, bool)
        keep[container] = False
        first = self.first - (self.first > container)
        return Decoded(self.keys[keep], self.rows[keep], first)


def _set_bits(rows: np.ndarray, row: np.ndarray, low: np.ndarray) -> None:
    """Set bit ``low`` of row ``row`` for each pair, the pairs sorted by row
    and then by ``low``, each row written by one call alone."""
    if not low.size:
        return
    wid = row * WORDS32 + (low >> 5)
    cut = np.concatenate(([0], np.flatnonzero(np.diff(wid)) + 1))
    bits = np.left_shift(np.uint32(1), (low & 31).astype(np.uint32))
    rows.reshape(-1)[wid[cut]] = np.bitwise_or.reduceat(bits, cut)


def decode_set(sources, chunk: int = 1 << 22,
               workers: int = WORKERS) -> Decoded:
    """Every container of every bitmap in ``sources`` (serialized bytes),
    with the array payloads set ``chunk`` members at a time, ``workers``
    chunks at once (each writes rows of its own), and the run payloads
    ``chunk`` runs at a time."""
    heads = [parse(b) for b in sources]
    counts = np.array([h[0].size for h in heads], np.int64)
    first = np.concatenate(([0], np.cumsum(counts)))
    n = int(first[-1])
    rows = np.zeros((n, WORDS32), np.uint32)
    if not n:
        return Decoded(np.empty(0, np.uint32), rows, first)
    lens = np.array([len(b) for b in sources], np.int64)
    base = np.concatenate(([0], np.cumsum(lens)[:-1]))
    blob = np.frombuffer(b"".join(sources), np.uint8)
    keys = np.concatenate([h[0] for h in heads])
    cards = np.concatenate([h[1] for h in heads])
    offs = np.concatenate([h[2] for h in heads]) + np.repeat(base, counts)
    runs = np.concatenate([h[3] for h in heads])
    arr = np.flatnonzero(~runs & (cards <= ARRAY_MAX))
    # payloads that all start on even bytes are read as u16 directly
    even = not np.any(offs[arr] & 1)
    u16 = blob[:blob.size & ~1].view("<u2")
    # containers [lo, hi) of the array ones, about ``chunk`` members each
    csum = np.cumsum(cards[arr])
    cuts = np.unique(np.concatenate((
        [0], np.searchsorted(csum, np.arange(chunk, csum[-1] if csum.size
                                             else 0, chunk)) + 1,
        [arr.size])))

    def fill(lo: int, hi: int) -> None:
        c, o = cards[arr[lo:hi]], offs[arr[lo:hi]]
        starts = np.repeat(o - 2 * np.concatenate(
            ([0], np.cumsum(c)[:-1])), c) + 2 * np.arange(int(c.sum()))
        if even:
            low = u16[starts >> 1].astype(np.int64)
        else:
            low = blob[starts].astype(np.int64) | (
                blob[starts + 1].astype(np.int64) << 8)
        _set_bits(rows, np.repeat(arr[lo:hi], c), low)

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        list(ex.map(fill, cuts[:-1].tolist(), cuts[1:].tolist()))
    for i in np.flatnonzero(~runs & (cards > ARRAY_MAX)).tolist():
        rows[i] = blob[offs[i]:offs[i] + 4 * WORDS32].view("<u4")
    _fill_runs(rows, blob, np.flatnonzero(runs), offs, chunk)
    return Decoded(keys, rows, first)


def _u16(blob: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """The little-endian u16 at each byte position ``pos`` of ``blob``."""
    return blob[pos].astype(np.int64) | (blob[pos + 1].astype(np.int64) << 8)


def _within(counts: np.ndarray) -> np.ndarray:
    """For groups of ``counts`` items laid end to end, each item's place in
    its group."""
    return np.arange(int(counts.sum())) - np.repeat(
        np.cumsum(counts) - counts, counts)


def _fill_runs(rows: np.ndarray, blob: np.ndarray, conts: np.ndarray,
               offs: np.ndarray, chunk: int) -> None:
    """Set the bits of the run containers ``conts`` (ascending), word by
    word, about ``chunk`` runs at a time: each run [start, start + length]
    covers the words from its first to its last, masked at both ends."""
    if not conts.size:
        return
    nr = _u16(blob, offs[conts])
    cuts = np.unique(np.concatenate((
        [0], np.searchsorted(np.cumsum(nr), np.arange(
            chunk, int(nr.sum()), chunk)) + 1, [conts.size])))
    flat = rows.reshape(-1)
    for lo, hi in zip(cuts[:-1].tolist(), cuts[1:].tolist()):
        n = nr[lo:hi]
        pos = np.repeat(offs[conts[lo:hi]] + 2, n) + 4 * _within(n)
        start = _u16(blob, pos)
        end = start + _u16(blob, pos + 2)
        nw = (end >> 5) - (start >> 5) + 1
        word = np.repeat(start >> 5, nw) + _within(nw)
        mask = np.full(word.size, 0xFFFFFFFF, np.int64)
        head = np.cumsum(nw) - nw
        mask[head] &= 0xFFFFFFFF << (start & 31)
        mask[head + nw - 1] &= 0xFFFFFFFF >> (31 - (end & 31))
        # runs of one container ascend, so equal words are neighbours
        idx = np.repeat(np.repeat(conts[lo:hi], n), nw) * WORDS32 + word
        cut = np.concatenate(([0], np.flatnonzero(np.diff(idx)) + 1))
        flat[idx[cut]] = np.bitwise_or.reduceat(mask, cut).astype(np.uint32)


def members(dec: Decoded, bitmap: int) -> np.ndarray:
    """The sorted u32 members of one decoded bitmap."""
    c = np.arange(dec.first[bitmap], dec.first[bitmap + 1])
    bits = np.unpackbits(dec.rows[c].view(np.uint8), axis=1,
                         bitorder="little")
    r, low = np.nonzero(bits)
    return (dec.keys[c][r] << np.uint32(16)) | low.astype(np.uint32)


def popcount(words: np.ndarray) -> np.ndarray:
    """Set bits of each row of u32 words."""
    w = np.ascontiguousarray(words, dtype=np.uint32)
    return np.bitwise_count(w).sum(axis=-1, dtype=np.int64)


def combine(op: str, dec: Decoded, containers: np.ndarray):
    """(keys u32[k], words u32[k, 2048], cards i64[k]): per key, the OR or
    XOR of the listed containers' rows."""
    if op not in ("or", "xor"):
        raise ValueError(f"unsupported op {op!r}")
    c = containers[np.argsort(dec.keys[containers], kind="stable")]
    if not c.size:
        return (np.empty(0, np.uint32), np.empty((0, WORDS32), np.uint32),
                np.empty(0, np.int64))
    k = dec.keys[c]
    cut = np.concatenate(([0], np.flatnonzero(np.diff(k)) + 1))
    n_per = np.diff(np.append(cut, c.size))
    ufunc = np.bitwise_or if op == "or" else np.bitwise_xor
    rows64 = dec.rows.view(np.uint64)
    words = np.empty((cut.size, WORDS32 // 2), np.uint64)
    # keys of one container count together, ``GATHER`` rows at a time
    for n in np.unique(n_per).tolist():
        g = np.flatnonzero(n_per == n)
        step = max(1, GATHER // n)
        for lo in range(0, g.size, step):
            gs = g[lo:lo + step]
            words[gs] = ufunc.reduce(
                rows64[c[cut[gs][:, None] + np.arange(n)]], axis=1)
    words = words.view(np.uint32)
    return k[cut], words, popcount(words)


def wide(op: str, dec: Decoded):
    """The wide OR or XOR of every bitmap of the set, over the keys where
    the result is not empty."""
    k, w, c = combine(op, dec, np.arange(dec.keys.size))
    nz = c > 0
    if nz.all():
        return k, w, c
    return k[nz], w[nz], c[nz]
