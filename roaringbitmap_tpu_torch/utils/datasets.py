"""Dataset loaders and synthetic bitmap sets.

The loaders read the real-roaring-dataset zips (each ``.txt`` member of a
zip is one bitmap's comma-separated sorted values; the range zip's lines are
``start:end`` pairs), as the JAX package's ``utils.datasets`` and the
reference's ZipRealDataRetriever do.  The zips are not shipped with the
repository: they are looked for under ``ROARING_DATASET_DIR`` (by default
``datasets/`` at the repository root, holding the reference's
``real-roaring-dataset/`` and ``random-generated-data/`` folders), and
``has_dataset`` / ``has_range_dataset`` say whether they are there.

``synthetic_bitmaps`` is the JAX package's generator: the same bitmaps from
the same seed.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np

from ..core.bitmap import RoaringBitmap

#: where the dataset folders are looked for
DATASET_ROOT = os.environ.get(
    "ROARING_DATASET_DIR",
    os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), "datasets"))
REFERENCE_DATASET_DIR = os.path.join(DATASET_ROOT, "real-roaring-dataset")
RANGE_DATASET_ZIP = os.path.join(DATASET_ROOT, "random-generated-data",
                                 "random_range.zip")

#: the datasets the JAX package's loaders name
AVAILABLE = (
    "census1881", "census1881_srt", "uscensus2000",
    "wikileaks-noquotes", "wikileaks-noquotes_srt",
)


def dataset_path(name: str) -> str:
    return os.path.join(REFERENCE_DATASET_DIR, f"{name}.zip")


def has_dataset(name: str) -> bool:
    return os.path.exists(dataset_path(name))


def load_value_arrays(name: str) -> list[np.ndarray]:
    """Each zip member -> one sorted u32 value array."""
    out = []
    with zipfile.ZipFile(dataset_path(name)) as z:
        for member in sorted(z.namelist()):
            raw = z.read(member).decode()
            parts = [p for p in raw.replace("\n", ",").split(",") if p]
            out.append(np.array(parts, dtype=np.int64).astype(np.uint32))
    return out


def load_bitmaps(name: str) -> list[RoaringBitmap]:
    return [RoaringBitmap.from_values(v) for v in load_value_arrays(name)]


#: the reference's ZipRealDataRetriever.fetchBitPositions name
fetch_bit_positions = load_value_arrays


def load_range_arrays() -> list[np.ndarray]:
    """The ZipRealDataRangeRetriever analog: each line of each member is
    comma-separated ``start:end`` pairs -> one [N, 2] int64 array a line."""
    out = []
    with zipfile.ZipFile(RANGE_DATASET_ZIP) as z:
        for member in sorted(z.namelist()):
            raw = z.read(member).decode()
            for line in raw.splitlines():
                if not line.strip():
                    continue
                pairs = [p.split(":") for p in line.split(",") if p]
                out.append(np.array(pairs, dtype=np.int64))
    return out


def has_range_dataset() -> bool:
    return os.path.exists(RANGE_DATASET_ZIP)


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


def uscensus_like_values(segments: int, keys: int = 600, attrs: int = 200,
                         seed: int = 2000) -> list[np.ndarray]:
    """u32 value arrays of ``segments`` x ``attrs`` bitmaps shaped as the
    uscensus2000 file is recorded (mostly-singleton containers): segment s
    holds keys [s * keys, (s + 1) * keys), one container on 55% of them and
    3-8 on the rest, in distinct bitmaps drawn with weights rank ** -0.5,
    each of 1 + a geometric count (mean 3.1) of values.  A bitmap left
    empty gets one value."""
    rng = np.random.default_rng(seed)
    w = np.arange(1, attrs + 1) ** -0.5
    w /= w.sum()
    out = []
    for s in range(segments):
        per: list = [[] for _ in range(attrs)]
        for key in range(keys):
            n = 1 if rng.random() < 0.55 else int(rng.integers(3, 9))
            for b in rng.choice(attrs, n, replace=False, p=w):
                card = min(int(rng.geometric(1 / 3.1)), 4096)
                per[b].append(((s * keys + key) << 16)
                              + rng.choice(1 << 16, card, replace=False))
        out += [np.concatenate(p) if p else np.array([(s * keys) << 16])
                for p in per]
    return [np.unique(v).astype(np.uint32) for v in out]


#: the run shapes of ``row_stream_case``
ROW_CASES = ("one bit", "word edge", "many words", "whole row")


def _case_runs(rng: np.random.Generator, case: str) -> np.ndarray:
    """One run container's canonical (start, length - 1) u16 pairs of the
    shape ``case``: runs of one bit; runs across a 32-bit word edge, with
    the first and last words of the row covered whole; runs over many
    words; one run over the whole 65,536-bit row."""
    if case == "one bit":
        s = np.sort(rng.choice(np.arange(0, 65536, 2), 40, replace=False))
        ln = np.zeros_like(s)
    elif case == "word edge":
        w = np.sort(rng.choice(np.arange(4, 2040, 4), 30, replace=False))
        a, b = rng.integers(1, 32, w.size), rng.integers(1, 32, w.size)
        s = np.concatenate(([0], 32 * w - a, [65504]))
        ln = np.concatenate(([31], a + b - 1, [31]))
    elif case == "many words":
        s = np.sort(rng.choice(np.arange(0, 65536, 8192), 6, replace=False))
        ln = rng.integers(1000, 8000, s.size)
    elif case == "whole row":
        s, ln = np.array([0]), np.array([65535])
    else:
        raise ValueError(f"unknown case {case!r}")
    return np.stack([s, ln], axis=1).ravel().astype(np.uint16)


def row_stream_case(case: str, seed: int = 0) -> dict:
    """Compact streams of 12 rows, one container a row, for the dense
    image's build (B8) and its plain versions: rows 0, 4, 6 and 9 a run
    container of the shape ``case`` (``ROW_CASES``), rows 1 and 5 array
    containers (500 values, one value), rows 2 and 7 bitmap containers,
    the rest empty; each stream ends with an entry for the scratch row
    ``n_rows``, as padded streams have.  NumPy arrays under the names of
    ``ops.packing.CompactStreams``, and ``n_rows``."""
    rng = np.random.default_rng(seed)
    n_rows = 12
    runs = [_case_runs(rng, case) for _ in range(4)] + [_case_runs(
        rng, "one bit")]
    vals = [np.sort(rng.choice(1 << 16, 500, replace=False)),
            np.array([65535]), np.arange(7)]
    dense = rng.integers(0, 1 << 32, (3, 2048), dtype=np.uint32)
    return {
        "n_rows": n_rows,
        "dense_words": dense,
        "dense_dest": np.array([2, 7, n_rows], np.int32),
        "values": np.concatenate(vals).astype(np.uint16),
        "val_counts": np.array([v.size for v in vals], np.int32),
        "val_dest": np.array([1, 5, n_rows], np.int32),
        "runs": np.concatenate(runs),
        "run_counts": np.array([r.size // 2 for r in runs], np.int32),
        "run_dest": np.array([0, 4, 6, 9, n_rows], np.int32),
    }
