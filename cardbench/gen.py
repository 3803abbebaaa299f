"""Inputs of a cell, made from the seed: the resident set's bitmaps as
portable serialized bytes.

Frozen in the benchmark, so that no change to the program moves what is
measured.  The shapes of a configuration (which keys each bitmap holds, how
many values each container has, which containers are bitmaps) are drawn
from the configuration's fixed ``shape_seed``, so every ``--seed`` gives
the same sizes and the same work; ``--seed`` draws the members of every
container.  Each segment has generators of its own, keyed by the seeds
and its number.

Portable format written here (RoaringFormatSpec, no run containers):
u32 cookie 12346, u32 container count, per container u16 key and u16
cardinality - 1, per container u32 payload offset, then the payloads:
an array container's sorted u16 values, a bitmap container's 1,024 u64
words.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COOKIE_NO_RUNS = 12346
WORDS32 = 2048
#: u16 slots of a bitmap container's payload
BITMAP_U16 = 2 * WORDS32


def _rng(*parts: int) -> np.random.Generator:
    """A generator keyed by whole numbers of any size and sign."""
    return np.random.default_rng(
        np.random.SeedSequence([int(p) % (1 << 64) for p in parts]))


@dataclasses.dataclass
class SegmentShape:
    """Sizes of one segment's bitmaps, in bitmap order and, within a
    bitmap, in key order: ``n_cont[b]`` containers for bitmap ``b``, each
    with its local key, its kind (True: bitmap container) and, for an
    array container, its cardinality."""

    n_cont: np.ndarray      # i64[attributes]
    keys: np.ndarray        # i64[containers] local key within the segment
    is_bitmap: np.ndarray   # bool[containers]
    card: np.ndarray        # i64[containers] (arrays; 0 for bitmaps)


def _draw(rng: np.random.Generator, spec: dict, n: int) -> np.ndarray:
    """``n`` whole numbers in [lo, hi] from a distribution of the
    configuration: "loguniform" (log-uniform over [lo, hi]), "geometric"
    (1 + a geometric count with the given mean, capped) or "split" (1 with
    the probability ``single``, else uniform over [lo, hi])."""
    lo, hi = int(spec["lo"]), int(spec["hi"])
    if spec["dist"] == "loguniform":
        x = np.exp(rng.uniform(np.log(lo), np.log(hi + 1), n))
        return np.clip(np.floor(x).astype(np.int64), lo, hi)
    if spec["dist"] == "geometric":
        p = 1.0 / float(spec["mean"])
        return np.clip(rng.geometric(p, n).astype(np.int64) + lo - 1, lo, hi)
    if spec["dist"] == "split":
        many = rng.integers(lo, hi + 1, n)
        return np.where(rng.random(n) < float(spec["single"]), 1, many)
    raise ValueError(f"unknown distribution {spec['dist']!r}")


def _window_keys(rng, cfg: dict, n_attr: int, universe: int):
    """Each bitmap's containers on a contiguous run of keys: the values of
    one attribute value cluster in rows near each other."""
    n_cont = np.minimum(_draw(rng, cfg["containers_per_bitmap"], n_attr),
                        universe)
    start = np.floor(rng.uniform(0, 1, n_attr)
                     * (universe - n_cont + 1)).astype(np.int64)
    keys = np.concatenate([s + np.arange(c) for s, c in
                           zip(start.tolist(), n_cont.tolist())])
    return n_cont, keys


def _by_key(rng, cfg: dict, n_attr: int, universe: int):
    """Key first: every key of the segment holds ``containers_per_key``
    containers, on that many distinct bitmaps drawn with weights falling
    as rank ** -``attribute_skew`` (a few attribute values are common);
    a bitmap left with none gets one on a key drawn uniformly."""
    per_key = np.minimum(_draw(rng, cfg["containers_per_key"], universe),
                         n_attr)
    logw = -float(cfg["attribute_skew"]) * np.log(np.arange(1, n_attr + 1))
    # the Gumbel top-k draw: per key, distinct bitmaps by weight
    order = np.argsort(-(logw + rng.gumbel(size=(universe, n_attr))), axis=1)
    attr = order[np.arange(n_attr)[None, :] < per_key[:, None]]
    key = np.repeat(np.arange(universe), per_key)
    missing = np.setdiff1d(np.arange(n_attr), attr)
    attr = np.concatenate([attr, missing])
    key = np.concatenate([key, rng.integers(0, universe, missing.size)])
    o = np.lexsort((key, attr))
    return np.bincount(attr, minlength=n_attr), key[o].astype(np.int64)


def segment_shape(cfg: dict, segment: int) -> SegmentShape:
    """The fixed shape of segment ``segment`` (from ``shape_seed``)."""
    rng = _rng(cfg["shape_seed"], segment)
    n_attr, universe = int(cfg["attributes"]), int(cfg["universe_keys"])
    place = {"window": _window_keys, "by_key": _by_key}.get(
        cfg["key_placement"])
    if place is None:
        raise ValueError(f"unknown key placement {cfg['key_placement']!r}")
    n_cont, keys = place(rng, cfg, n_attr, universe)
    total = int(n_cont.sum())
    is_bitmap = rng.random(total) < float(cfg["bitmap_share"])
    card = np.where(is_bitmap, 0, _draw(rng, cfg["array_card"], total))
    return SegmentShape(n_cont=n_cont, keys=keys, is_bitmap=is_bitmap,
                        card=card)


def _array_values(rng: np.random.Generator, card: np.ndarray) -> np.ndarray:
    """Strictly increasing u16 values, ``card[i]`` for container ``i``,
    concatenated: gaps of 1 to 65535 // card drawn uniformly, then a start
    drawn so that the last value stays under 65536.  The sums run in u16:
    each container spans under 2^16, so their wrap-around is exact."""
    total = int(card.sum())
    if total == 0:
        return np.empty(0, np.uint16)
    gmax = (65535 // np.maximum(card, 1)).astype(np.uint32)
    # a 16-bit draw scaled to [0, gmax): the product stays under 2^32
    r = rng.integers(0, 1 << 16, total, dtype=np.uint32)
    r *= np.repeat(gmax, card)
    r >>= 16
    csum = np.cumsum(r.astype(np.uint16) + np.uint16(1), dtype=np.uint16)
    ends = np.cumsum(card) - 1
    before = np.concatenate((np.zeros(1, np.uint16), csum[ends[:-1]]))
    span = (csum[ends] - before).astype(np.int64)   # each container's last
    start = np.floor(rng.random(card.size) * (65536 - span)).astype(np.int64)
    off = ((start - 1 - before.astype(np.int64)) & 0xFFFF).astype(np.uint16)
    csum += np.repeat(off, card)
    return csum


def _bitmap_words(rng: np.random.Generator, n: int, densities) -> np.ndarray:
    """``n`` bitmap containers' words (u32[n, 2048]) at densities drawn
    from ``densities`` (each 1/4, 1/2 or 3/4: one or two random words
    combined by AND or OR)."""
    a = rng.integers(0, 1 << 32, (n, WORDS32), dtype=np.uint32)
    b = rng.integers(0, 1 << 32, (n, WORDS32), dtype=np.uint32)
    d = np.asarray(densities, dtype=np.float64)[
        rng.integers(0, len(densities), n)][:, None]
    return np.where(d < 0.375, a & b, np.where(d > 0.625, a | b, a))


def segment_bytes(cfg: dict, segment: int, seed: int) -> tuple:
    """One segment's serialized bitmaps, in attribute order, as one u8
    array and each bitmap's length in it.  Keys are global: segment ``s``
    holds keys [s * span, (s + 1) * span)."""
    shape = segment_shape(cfg, segment)
    rng = _rng(seed, segment, 0xB17)
    nb = shape.n_cont
    bm = np.flatnonzero(shape.is_bitmap)
    vals = _array_values(rng, shape.card[~shape.is_bitmap])
    words = _bitmap_words(rng, bm.size, cfg["bitmap_density"])
    card = shape.card.copy()
    card[bm] = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    # every container's payload in container order, as one u16 stream:
    # the array values, with each bitmap container's words spliced in
    psize = np.where(shape.is_bitmap, BITMAP_U16, card)
    pend = np.cumsum(psize)
    pstart = pend - psize
    vpos = pstart[bm] - BITMAP_U16 * np.arange(bm.size)   # in ``vals``
    pieces, v0 = [], 0
    for k, v in enumerate(vpos.tolist()):
        pieces += [vals[v0:v], words[k].view(np.uint16)]
        v0 = v
    stream = np.concatenate(pieces + [vals[v0:]])
    # the headers, all bitmaps' one after another (u16 slots)
    hlen = 4 + 4 * nb
    hstart = np.cumsum(hlen) - hlen
    cb = np.repeat(np.arange(nb.size), nb)          # bitmap of a container
    first = np.cumsum(nb) - nb
    j = np.arange(cb.size) - first[cb]
    head = np.empty(int(hlen.sum()), np.uint16)
    head[hstart] = COOKIE_NO_RUNS
    head[hstart + 1] = 0
    head[hstart + 2] = nb & 0xFFFF
    head[hstart + 3] = nb >> 16
    base = hstart[cb]
    head[base + 4 + 2 * j] = shape.keys + segment * int(
        cfg["segment_span_keys"])
    head[base + 5 + 2 * j] = card - 1
    plen = np.bincount(cb, weights=psize, minlength=nb.size).astype(np.int64)
    pa = np.cumsum(plen) - plen                     # a bitmap's payloads
    off = 2 * hlen[cb] + 2 * (pstart - pa[cb])
    head[base + 4 + 2 * nb[cb] + 2 * j] = off & 0xFFFF
    head[base + 5 + 2 * nb[cb] + 2 * j] = off >> 16
    parts = []
    for h0, h1, p0, p1 in zip(hstart.tolist(), (hstart + hlen).tolist(),
                              pa.tolist(), (pa + plen).tolist()):
        parts += [head[h0:h1], stream[p0:p1]]
    blob = np.concatenate(parts).view(np.uint8)
    return blob, 2 * (hlen + plen)


def dataset_bytes(cfg: dict, seed: int) -> list:
    """Every bitmap of the set, segment by segment, attribute by attribute
    (bitmap ``s * attributes + a`` is attribute ``a`` of segment ``s``), as
    read-only views over one buffer, as a server holding its index in a
    mapped file hands them on."""
    made = [segment_bytes(cfg, s, seed) for s in range(int(cfg["segments"]))]
    buf = memoryview(b"".join(b.data for b, _ in made))
    lens = np.concatenate([n for _, n in made])
    ends = np.cumsum(lens)
    return [buf[e - n:e] for n, e in zip(lens.tolist(), ends.tolist())]


def wide_ops(mix: dict, seed: int, n: int) -> list[str]:
    """The first ``n`` ops of a wide mix, drawn from ``seed`` by the mix's
    weights."""
    rng = _rng(seed, 0x01D)
    ops = sorted(mix["ops"])
    w = np.array([mix["ops"][o] for o in ops], np.float64)
    return [ops[i] for i in rng.choice(len(ops), size=n, p=w / w.sum())]
