"""The word tier: u32 container rows held as ``torch.int32`` tensors.

PyTorch's ``uint32`` supports too few operations (right shift, complement,
index_select and scatter_add raise for it, and there is no popcount op), so
every row of 2048 u32 words lives on the device as an int32 tensor with the
same bits.  This module holds the conversions and the two operations whose
int32 form differs from the u32 one:

- ``srl``: a logical right shift (int32 ``>>`` sign-extends);
- ``popcount``: a SWAR bit count, taken in int64 so that no step relies on
  int32 overflow.

``fold_u32`` turns an int64 accumulator of u32 values back into the int32
view explicitly: a value >= 2^31 becomes the value - 2^32.
"""

from __future__ import annotations

import numpy as np
import torch

WORDS32 = 2048

_U32 = (1 << 32) - 1


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card: ``None`` means ``"cuda"``.  Only an
    explicit CPU request gets the CPU; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return dev


def as_i32(a: np.ndarray, device) -> torch.Tensor:
    """u32 (or i32) NumPy array -> int32 tensor with the same bits on device."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype != np.int32:
        a = a.astype(np.int32)
    if not a.flags.writeable:
        a = a.copy()   # a CPU tensor shares the array's memory
    return torch.from_numpy(a).to(device)


def to_u32(t: torch.Tensor) -> np.ndarray:
    """int32 tensor -> u32 NumPy array with the same bits (host copy)."""
    return t.detach().cpu().numpy().view(np.uint32)


def srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant 0 < k < 32."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def fold_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the int32 view of their u32 bits."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def popcount(words: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Set-bit count along ``dim`` of int32 words -> int32 cardinalities.

    The SWAR steps run in place on one int64 copy and one int64 scratch,
    so the working memory is four times the input's bytes
    (``insights.analysis.POPCOUNT_ROWS``)."""
    x = words.to(torch.int64, copy=True)
    x &= _U32
    t = x >> 1
    t &= 0x55555555
    x -= t
    torch.bitwise_right_shift(x, 2, out=t)
    t &= 0x33333333
    x &= 0x33333333
    x += t
    torch.bitwise_right_shift(x, 4, out=t)
    x += t
    x &= 0x0F0F0F0F
    torch.bitwise_right_shift(x, 8, out=t)
    x += t
    torch.bitwise_right_shift(x, 16, out=t)
    x += t
    x &= 0x3F
    del t
    return x.sum(dim=dim, dtype=torch.int64).to(torch.int32)


def upload(a: np.ndarray, device) -> torch.Tensor:
    """A plan operand (int32 bits or bool) -> tensor on ``device`` without a
    host sync: on a CUDA device the array is copied into pinned memory and
    the upload is queued on the current stream (a copy from pageable
    memory would wait for the stream first); on the CPU it is shared.
    Resident images go up through ``as_i32``: the pinned allocator would
    keep a copy of their size cached on the host.  A tensor (a cached
    result's rows, already on the card) is returned as it is, or copied
    if it lies on another device; the caller only reads it."""
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype not in (np.int32, np.bool_):
        a = a.astype(np.int32)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    dev = torch.device(device)
    if dev.type != "cuda":
        return t.to(dev)
    return t.pin_memory().to(dev, non_blocking=True)
