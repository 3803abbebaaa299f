"""Inputs of a cell, made from the seed: the resident set's bitmaps as
portable serialized bytes.

Frozen in the benchmark, so that no change to the program moves what is
measured.  The shapes of a configuration (which keys each bitmap holds, how
many values each container has, which containers are bitmaps, which are
drawn as runs and how many runs each has) are drawn from the
configuration's fixed ``shape_seed``, so every ``--seed`` gives the same
sizes and the same work; ``--seed`` draws the members of every container
(array values, bitmap words, run starts and lengths).  Each segment has
generators of its own, keyed by the seeds, its number and a tag a kind of
draw.

Run containers are switched on by three optional keys of a configuration;
one without them draws no run and writes the bytes it always did:

- ``run_share``: the share of the containers that are not bitmap
  containers (``bitmap_share``) whose members are drawn as runs;
- ``run_card``: such a container's cardinality, a distribution of
  ``_draw`` over ``[lo, hi]`` with ``hi <= 65536``;
- ``run_count``: its number of runs, a distribution of ``_draw``, cut to
  what the cardinality allows (at most ``card`` runs, and at most
  ``65537 - card``, since neighbouring runs are a value apart).

Runs are canonical: sorted, a value or more apart, inside ``[0, 65535]``,
their lengths summing to the cardinality.  A container drawn as runs is
written as a run container only where that form (``2 + 4 * runs`` bytes)
is smaller than both its array form (``2 * card`` for ``card <= 4096``)
and its bitmap form (8,192 bytes), as the upstream's ``runOptimize()`` then
``serialize()`` would write it; elsewhere the same members are written as
an array container (``card <= 4096``) or a bitmap container.

Portable format written here (RoaringFormatSpec), all little-endian.  A
bitmap with no run container: u32 cookie 12346, u32 container count ``n``.
A bitmap with one or more: u32 cookie ``12347 | (n - 1) << 16``, then the
run flags, one bit a container, in ``(n + 7) // 8`` bytes.  Then per
container u16 key and u16 cardinality - 1; then per container u32 payload
offset, left out for a bitmap with a run container and ``n < 4``
(``NO_OFFSET_THRESHOLD``); then the payloads: an array container's sorted
u16 values, a bitmap container's 1,024 u64 words, a run container's u16
run count and per run u16 start and u16 length - 1.
"""

from __future__ import annotations

import dataclasses

import numpy as np

COOKIE_NO_RUNS = 12346
COOKIE_RUNS = 12347
#: below this many containers a bitmap with runs has no offset header
NO_OFFSET_THRESHOLD = 4
ARRAY_MAX = 4096
WORDS32 = 2048
#: u16 slots of a bitmap container's payload
BITMAP_U16 = 2 * WORDS32
#: the tags of the shape's and the members' run draws
RUN_SHAPE_TAG = 0x5E7
RUN_MEMBER_TAG = 0x52E


def _rng(*parts: int) -> np.random.Generator:
    """A generator keyed by whole numbers of any size and sign."""
    return np.random.default_rng(
        np.random.SeedSequence([int(p) % (1 << 64) for p in parts]))


@dataclasses.dataclass
class SegmentShape:
    """Sizes of one segment's bitmaps, in bitmap order and, within a
    bitmap, in key order: ``n_cont[b]`` containers for bitmap ``b``, each
    with its local key, its kind and its cardinality.  A container is a
    bitmap container of random words (``is_bitmap``), one whose members are
    drawn as ``runs[i] > 0`` runs, or an array container of random
    values."""

    n_cont: np.ndarray      # i64[attributes]
    keys: np.ndarray        # i64[containers] local key within the segment
    is_bitmap: np.ndarray   # bool[containers]
    card: np.ndarray        # i64[containers] (0 for random bitmaps)
    runs: np.ndarray        # i64[containers] (0 unless drawn as runs)

    @property
    def is_run(self) -> np.ndarray:
        """bool[containers]: written as a run container, where that form is
        the smallest."""
        other = np.where(self.card <= ARRAY_MAX, 2 * self.card, 8192)
        return (self.runs > 0) & (2 + 4 * self.runs < other)


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


def _run_shape(cfg: dict, segment: int, is_bitmap: np.ndarray):
    """(drawn as runs, their cardinalities, their run counts), each over
    every container, from a generator of its own."""
    if int(cfg["run_card"]["hi"]) > 1 << 16:
        raise ValueError("run_card's hi is over 65536")
    rng = _rng(cfg["shape_seed"], segment, RUN_SHAPE_TAG)
    n = is_bitmap.size
    drawn = ~is_bitmap & (rng.random(n) < float(cfg["run_share"]))
    card = _draw(rng, cfg["run_card"], n)
    runs = np.clip(_draw(rng, cfg["run_count"], n), 1,
                   np.minimum(card, 65537 - card))
    return drawn, card, runs


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
    runs = np.zeros(total, np.int64)
    if "run_share" in cfg:
        drawn, rcard, rcount = _run_shape(cfg, segment, is_bitmap)
        card = np.where(drawn, rcard, card)
        runs = np.where(drawn, rcount, 0)
    return SegmentShape(n_cont=n_cont, keys=keys, is_bitmap=is_bitmap,
                        card=card, runs=runs)


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


def _within(counts: np.ndarray) -> np.ndarray:
    """For groups of ``counts`` items laid end to end, each item's place in
    its group."""
    return np.arange(int(counts.sum())) - np.repeat(
        np.cumsum(counts) - counts, counts)


def _composition(rng: np.random.Generator, total: np.ndarray,
                 parts: np.ndarray) -> np.ndarray:
    """For each ``i``, ``parts[i] >= 1`` whole numbers >= 0 that sum to
    ``total[i]``, concatenated: the steps between ``parts[i] - 1`` cut
    points drawn uniformly over ``[0, total[i]]`` and sorted."""
    ncut = parts - 1
    grp = np.repeat(np.arange(total.size), ncut)
    cuts = rng.integers(0, np.repeat(total, ncut) + 1)
    # sorted within each group: the group in the bits above a cut's 17
    cuts = np.sort((grp << 17) | cuts) & ((1 << 17) - 1)
    first = np.cumsum(parts + 1) - (parts + 1)      # a group's first point
    pts = np.empty(int(parts.sum()) + total.size, np.int64)
    pts[first] = 0
    pts[first + parts] = total
    pts[np.repeat(first + 1, ncut) + _within(ncut)] = cuts
    keep = np.ones(pts.size - 1, bool)
    keep[first[1:] - 1] = False                     # steps across two groups
    return np.diff(pts)[keep]


def _run_members(rng: np.random.Generator, card: np.ndarray,
                 runs: np.ndarray) -> tuple:
    """Canonical runs of each container, ``runs[i]`` of them holding
    ``card[i]`` values, concatenated: (starts, lengths), both i64.  The
    lengths are 1 plus a split of ``card - runs``; the ``65536 - card``
    values outside the runs split into a gap before each run (one value
    more than drawn after the first) and one after the last."""
    length = 1 + _composition(rng, card - runs, runs)
    gaps = _composition(rng, 65536 - card - (runs - 1), runs + 1)
    last = np.cumsum(runs + 1) - 1
    gap = np.delete(gaps, last) + (_within(runs) > 0)
    step = gap + length
    # a run starts after the steps before it in its container and its gap
    end = np.cumsum(step)
    first = np.cumsum(runs) - runs
    return end - length - np.repeat(end[first] - step[first], runs), length


def _run_payloads(rng: np.random.Generator, shape: SegmentShape,
                  drawn: np.ndarray) -> tuple:
    """The u16 payloads of the containers ``drawn`` (indices, in order) as
    runs: (payload sizes, payloads concatenated) in the form each is
    written in, run, array or bitmap."""
    card, runs = shape.card[drawn], shape.runs[drawn]
    start, length = _run_members(rng, card, runs)
    as_run = shape.is_run[drawn]
    as_array = ~as_run & (card <= ARRAY_MAX)
    size = np.where(as_run, 1 + 2 * runs,
                    np.where(as_array, card, BITMAP_U16))
    out = np.empty(int(size.sum()), np.uint16)
    pos = np.cumsum(size) - size
    run_of = np.repeat(np.arange(drawn.size), runs)     # container of a run
    k = _within(runs)
    r = as_run[run_of]                                  # a run written so
    out[pos[as_run]] = runs[as_run]
    out[pos[run_of[r]] + 1 + 2 * k[r]] = start[r]
    out[pos[run_of[r]] + 2 + 2 * k[r]] = length[r] - 1
    # the members of the others, run by run
    vals = np.repeat(start[~r], length[~r]) + _within(length[~r])
    cont = np.repeat(run_of[~r], length[~r])
    arr = as_array[cont]
    out[pos[cont[arr]] + _within(card[as_array])] = vals[arr]
    bm = np.flatnonzero(~as_run & ~as_array)
    if bm.size:
        bits = np.zeros((bm.size, 1 << 16), bool)
        bits[np.searchsorted(bm, cont[~arr]), vals[~arr]] = True
        words = np.packbits(bits, axis=1, bitorder="little").view("<u2")
        out[pos[bm][:, None] + np.arange(BITMAP_U16)] = words
    return size, out


def _put(buf: np.ndarray, pos: np.ndarray, value, width: int) -> None:
    """Write whole numbers little-endian, ``width`` bytes each, at the byte
    positions ``pos`` of the u8 array ``buf``."""
    value = np.asarray(value, np.int64)
    for b in range(width):
        buf[pos + b] = (value >> (8 * b)) & 0xFF


def segment_bytes(cfg: dict, segment: int, seed: int) -> tuple:
    """One segment's serialized bitmaps, in attribute order, as one u8
    array and each bitmap's length in it.  Keys are global: segment ``s``
    holds keys [s * span, (s + 1) * span)."""
    shape = segment_shape(cfg, segment)
    rng = _rng(seed, segment, 0xB17)
    nb = shape.n_cont
    drawn = shape.runs > 0
    bm = np.flatnonzero(shape.is_bitmap)
    arr = np.flatnonzero(~shape.is_bitmap & ~drawn)
    vals = _array_values(rng, shape.card[arr])
    words = _bitmap_words(rng, bm.size, cfg["bitmap_density"])
    card = shape.card.copy()
    card[bm] = np.bitwise_count(words).sum(axis=1, dtype=np.int64)
    # every container's payload in container order, as one u16 stream
    psize = np.where(shape.is_bitmap, BITMAP_U16, card)
    ran = np.flatnonzero(drawn)
    rstream = np.empty(0, np.uint16)
    if ran.size:
        psize[ran], rstream = _run_payloads(
            _rng(seed, segment, RUN_MEMBER_TAG), shape, ran)
    pstart = np.cumsum(psize) - psize
    # the array values, with the other payloads spliced in, in order
    rest = np.flatnonzero(drawn | shape.is_bitmap)
    is_words = np.repeat(shape.is_bitmap[rest], psize[rest])
    other = np.empty(is_words.size, np.uint16)
    other[is_words] = words.view(np.uint16).reshape(-1)
    other[~is_words] = rstream
    oend = np.cumsum(psize[rest])
    vpos = pstart[rest] - (oend - psize[rest])      # in ``vals``
    pieces, v0, o0 = [], 0, 0
    for v, o1 in zip(vpos.tolist(), oend.tolist()):
        pieces += [vals[v0:v], other[o0:o1]]
        v0, o0 = v, o1
    stream = np.concatenate(pieces + [vals[v0:]])
    # the headers, all bitmaps' one after another, in bytes
    cb = np.repeat(np.arange(nb.size), nb)          # bitmap of a container
    j = _within(nb)
    is_run = shape.is_run
    has_run = np.bincount(cb, weights=is_run, minlength=nb.size) > 0
    flags = np.where(has_run, (nb + 7) // 8, 4)     # run flags or the count
    has_off = ~has_run | (nb >= NO_OFFSET_THRESHOLD)
    hlen = 4 + flags + 4 * nb + 4 * nb * has_off
    hstart = np.cumsum(hlen) - hlen
    head = np.zeros(int(hlen.sum()), np.uint8)
    _put(head, hstart, np.where(has_run, COOKIE_RUNS | (nb - 1) << 16,
                                COOKIE_NO_RUNS), 4)
    _put(head, hstart[~has_run] + 4, nb[~has_run], 4)
    np.add.at(head, (hstart[cb] + 4 + (j >> 3))[is_run],
              (1 << (j & 7))[is_run].astype(np.uint8))
    desc = (hstart + 4 + flags)[cb] + 4 * j
    _put(head, desc, shape.keys + segment * int(cfg["segment_span_keys"]), 2)
    _put(head, desc + 2, card - 1, 2)
    plen = np.bincount(cb, weights=psize, minlength=nb.size).astype(np.int64)
    pa = np.cumsum(plen) - plen                     # a bitmap's payloads
    o = has_off[cb]
    _put(head, (desc + 4 * nb[cb])[o],
         (hlen[cb] + 2 * (pstart - pa[cb]))[o], 4)
    body = stream.view(np.uint8)
    parts = []
    for h0, h1, p0, p1 in zip(hstart.tolist(), (hstart + hlen).tolist(),
                              (2 * pa).tolist(), (2 * (pa + plen)).tolist()):
        parts += [head[h0:h1], body[p0:p1]]
    return np.concatenate(parts), hlen + 2 * plen


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
