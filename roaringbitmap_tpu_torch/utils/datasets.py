"""Synthetic bitmap sets for tests and the chip smoke run.

The real-roaring dataset zips are not shipped with the repository, so the
port carries the JAX package's synthetic generator, which makes the same
bitmaps from the same seed.
"""

from __future__ import annotations

import numpy as np

from ..core.bitmap import RoaringBitmap


def synthetic_bitmaps(n: int, seed: int = 0, universe: int = 1 << 22,
                      density: float = 0.01) -> list[RoaringBitmap]:
    """Random bitmap set: a mix of sparse uniform, dense-cluster and
    run-heavy bitmaps."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        kind = rng.integers(3)
        count = max(1, int(universe * density))
        if kind == 0:  # sparse uniform
            v = rng.integers(0, universe, count)
        elif kind == 1:  # dense clusters
            centers = rng.integers(0, universe, 8)
            v = (centers[:, None] + rng.integers(0, 1 << 14, (8, count // 8))).ravel()
        else:  # runs
            starts = rng.integers(0, universe, 64)
            lens = rng.integers(1, 2048, 64)
            v = np.concatenate([np.arange(s, s + l) for s, l in zip(starts, lens)])
        out.append(RoaringBitmap.from_values((v % universe).astype(np.uint32)))
    return out
