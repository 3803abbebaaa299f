"""The flagship pipeline: the end-to-end wide-aggregation "model".

N compressed bitmaps -> group-by-key rotation (``ops.packing``) -> resident
int32 word rows -> one fused pass producing the union and exact per-key
cardinalities.  The port of the JAX package's ``models.flagship``: on a
CUDA tensor ``forward`` is one launch of B1 (``ops.kernels``), on a CPU
tensor B1's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.bitmap import RoaringBitmap
from ..ops import kernels, packing
from ..ops.words import as_i32, resolve_device


def forward(words: torch.Tensor, seg_ids: torch.Tensor,
            head_idx: torch.Tensor):
    """Wide OR with fused cardinalities: words int32[M, 2048] (u32 bits),
    seg_ids int32[M] (sorted), head_idx int32[K] -> (int32[K, 2048] union
    words, int32[K] cardinalities)."""
    return kernels.segmented_reduce("or", words, seg_ids,
                                    int(head_idx.shape[0]))


def example_inputs(n_bitmaps: int = 16, seed: int = 0, device=None):
    """A small packed aggregation problem (the JAX function's bitmaps, from
    the same generator) as (words, seg_ids, head_idx) on ``device``."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    bitmaps = [
        RoaringBitmap.from_values(
            rng.integers(0, 1 << 18, 2048).astype(np.uint32))
        for _ in range(n_bitmaps)
    ]
    packed = packing.pack_for_aggregation(bitmaps)
    return (as_i32(packed.words, dev), as_i32(packed.seg_ids, dev),
            as_i32(packed.head_idx, dev))
