"""Fuzzing harness (the port's own copy of ``roaringbitmap_tpu.utils.fuzz``;
the reference Java library's RandomisedTestData, Fuzzer and Reporter).

- ``random_bitmap``: reproducible bitmaps whose 2^16 chunks are a random mix
  of run / dense / sparse regions, which exercises all three container
  kinds and every promotion boundary.
- ``verify_invariance``: a property across many seeded iterations; a
  failure raises with a JSON repro holding the base64-serialized inputs.
- ``mutate_serialized`` / ``verify_decoder_hardening``: structured
  mutations of valid serialized bitmaps; each mutated blob must parse or
  raise ``InvalidRoaringFormat``, never a raw numpy / struct error.  The
  same seed gives the same mutations as the JAX package, so a test can
  hold the two decoders (and the native ingest engine) to the same verdict
  blob for blob.
- Iteration count via ``ROARINGBITMAP_TPU_FUZZ_ITERATIONS``.
"""

from __future__ import annotations

import base64
import json
import os
from typing import Callable

import numpy as np

from ..core.bitmap import RoaringBitmap

ITERATIONS = int(os.environ.get("ROARINGBITMAP_TPU_FUZZ_ITERATIONS", "100"))


def random_bitmap(rng: np.random.Generator, max_keys: int = 24,
                  rle_limit: float | None = None,
                  dense_limit: float | None = None) -> RoaringBitmap:
    """One random bitmap: for each chosen high-16 key, draw a region type
    (rle/dense/sparse) and fill accordingly (RandomisedTestData:17-53)."""
    rle_limit = rng.random() if rle_limit is None else rle_limit
    dense_limit = rle_limit + (1 - rle_limit) * rng.random() \
        if dense_limit is None else dense_limit
    n_keys = int(rng.integers(1, max_keys + 1))
    keys = np.sort(rng.choice(1 << 16, size=n_keys, replace=False))
    parts = []
    for k in keys:
        base = int(k) << 16
        roll = rng.random()
        if roll < rle_limit:  # run region: few long runs
            n_runs = int(rng.integers(1, 30))
            starts = np.sort(rng.choice(1 << 16, n_runs, replace=False))
            for s in starts:
                length = int(rng.integers(1, 2048))
                parts.append(base + np.arange(s, min(s + length, 1 << 16)))
        elif roll < dense_limit:  # dense region, up to a FULL container
            count = int(rng.integers(4097, (1 << 16) + 1))
            parts.append(base + rng.choice(1 << 16, count, replace=False))
        else:  # sparse region
            count = int(rng.integers(1, 4096))
            parts.append(base + rng.choice(1 << 16, count, replace=False))
    vals = np.unique(np.concatenate(parts)).astype(np.uint32)
    rb = RoaringBitmap.from_values(vals)
    if rng.random() < 0.5:
        rb.run_optimize()
    return rb


def report_failure(seed: int, iteration: int, bitmaps, error: str) -> str:
    """Reporter.report analog: JSON artifact with base64 portable payloads."""
    doc = {
        "seed": seed,
        "iteration": iteration,
        "error": error,
        "bitmaps": [base64.b64encode(b.serialize()).decode() for b in bitmaps],
    }
    return json.dumps(doc)


def replay(artifact: str) -> list[RoaringBitmap]:
    """Rebuild the inputs of a reported failure."""
    doc = json.loads(artifact)
    return [RoaringBitmap.deserialize(base64.b64decode(s))
            for s in doc["bitmaps"]]


def verify_invariance(prop: Callable[..., bool], n_bitmaps: int = 2,
                      iterations: int | None = None, seed: int = 0xF022,
                      max_keys: int = 24) -> None:
    """Fuzzer.verifyInvariance (Fuzzer.java:31-80): generate inputs, assert
    the property, dump a replayable artifact on failure."""
    iterations = ITERATIONS if iterations is None else iterations
    for it in range(iterations):
        rng = np.random.default_rng((seed << 20) ^ it)
        bitmaps = [random_bitmap(rng, max_keys) for _ in range(n_bitmaps)]
        try:
            ok = prop(*bitmaps)
        except Exception as e:  # property crashed: still report
            raise AssertionError(
                report_failure(seed, it, bitmaps, repr(e))) from e
        if not ok:
            raise AssertionError(
                report_failure(seed, it, bitmaps, "property violated"))


# ------------------------------------------------- malformed-input mutation
#
# Decoder-hardening corpus (robustness satellite): structured mutations of
# VALID serialized bitmaps, aimed at the format's load-bearing fields —
# each mutated blob must either still parse or raise InvalidRoaringFormat
# (runtime.errors.CorruptInput); a raw numpy/struct error escaping the
# parser is the failure this corpus exists to catch.

MUTATION_KINDS = ("truncate", "bitflip", "cookie", "key_swap", "card_lie",
                  "payload_scramble", "nruns_lie", "grow")


def _header_desc_pos(blob: bytes) -> tuple[int, int] | None:
    """(descriptor offset, container count) of a valid blob, or None."""
    from ..format import spec

    if len(blob) < 8:
        return None
    cookie = int(np.frombuffer(blob[:4], dtype="<u4")[0])
    if (cookie & 0xFFFF) == spec.SERIAL_COOKIE:
        size = (cookie >> 16) + 1
        return 4 + (size + 7) // 8, size
    if cookie == spec.SERIAL_COOKIE_NO_RUNCONTAINER:
        return 8, int(np.frombuffer(blob[4:8], dtype="<u4")[0])
    return None


def mutate_serialized(rng: np.random.Generator, blob: bytes,
                      kind: str | None = None) -> bytes:
    """One structured mutation of a valid serialized bitmap."""
    kind = kind or MUTATION_KINDS[int(rng.integers(len(MUTATION_KINDS)))]
    b = bytearray(blob)
    hdr = _header_desc_pos(blob)
    if kind == "truncate":
        return bytes(b[:int(rng.integers(0, max(len(b), 1)))])
    if kind == "grow":       # trailing bytes are legal (framed streams)
        return bytes(b) + rng.bytes(int(rng.integers(1, 64)))
    if kind == "cookie":
        for i in range(4):
            b[i] = int(rng.integers(256))
        return bytes(b)
    if kind == "bitflip":
        for _ in range(int(rng.integers(1, 9))):
            i = int(rng.integers(len(b)))
            b[i] ^= 1 << int(rng.integers(8))
        return bytes(b)
    if hdr is None:
        return bytes(b)
    pos, size = hdr
    if kind == "key_swap" and size >= 2:
        i, j = rng.choice(size, 2, replace=False)
        pi, pj = pos + 4 * int(i), pos + 4 * int(j)
        b[pi:pi + 2], b[pj:pj + 2] = b[pj:pj + 2], b[pi:pi + 2]
        return bytes(b)
    if kind == "card_lie" and size:
        p = pos + 4 * int(rng.integers(size)) + 2
        if p + 2 <= len(b):
            b[p] = (b[p] + int(rng.integers(1, 256))) & 0xFF
        return bytes(b)
    if kind == "nruns_lie":
        # scribble over the first payload bytes after the header block —
        # hits a run count, array values, or bitmap words depending on the
        # layout drawn
        start = min(pos + 4 * size, max(len(b) - 1, 0))
        for _ in range(int(rng.integers(1, 6))):
            if start >= len(b):
                break
            p = int(rng.integers(start, len(b)))
            b[p] = int(rng.integers(256))
        return bytes(b)
    if kind == "payload_scramble" and len(b) > pos + 4 * size:
        lo = pos + 4 * size
        n = min(16, len(b) - lo)
        seg = list(range(lo, lo + n))
        rng.shuffle(seg)
        b[lo:lo + n] = bytes(b[i] for i in seg)
        return bytes(b)
    return bytes(b)


def verify_decoder_hardening(iterations: int | None = None,
                             seed: int = 0xDEC0DE, max_keys: int = 12
                             ) -> int:
    """The decoder-hardening property over the mutation corpus: every
    mutated blob either round-trips through the parser or raises
    InvalidRoaringFormat — never a raw numpy/struct/index error.  Returns
    the number of mutations that were (correctly) rejected; failures raise
    with a replayable artifact carrying the mutated blob."""
    from ..core.bitmap import RoaringBitmap
    from ..format.spec import InvalidRoaringFormat

    iterations = ITERATIONS if iterations is None else iterations
    rejected = 0
    for it in range(iterations):
        rng = np.random.default_rng((seed << 16) ^ it)
        rb = random_bitmap(rng, max_keys)
        blob = rb.serialize()
        kind = MUTATION_KINDS[it % len(MUTATION_KINDS)]
        mutated = mutate_serialized(rng, blob, kind)
        try:
            back = RoaringBitmap.deserialize(mutated)
            # a surviving parse must yield a self-consistent bitmap
            back.serialize()
        except InvalidRoaringFormat:
            rejected += 1
        except Exception as e:
            doc = {"seed": seed, "iteration": it, "mutation": kind,
                   "error": repr(e),
                   "blob": base64.b64encode(mutated).decode()}
            raise AssertionError(json.dumps(doc)) from e
    return rejected
