"""Each kernel's plain PyTorch version (and its wrapper, which takes the plain
version for CPU tensors) against the JAX kernel it replaces, run as the JAX
tests run it on the CPU: Pallas in interpret mode, at a few dozen grid steps.

B1 segmented_reduce_pallas, B2 segmented_reduce_pallas_blocked,
B3 densify_chunks_pallas, B4 counts_segmented_reduce.  Bit-exact throughout.
The CUDA kernels themselves run only on the card (tests/test_torch_on_gpu.py
and chip_smoke.py).
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from roaringbitmap_tpu.ops import kernels as jkernels
from roaringbitmap_tpu.ops import packing as jpacking
from roaringbitmap_tpu_torch.ops import build, kernels
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32

torch.set_num_threads(2)


def _t(a):
    return as_i32(np.asarray(a), "cpu")


def _rows(seed: int, m: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 1 << 32, (m, 2048), dtype=np.uint64).astype(np.uint32)
    rows[:, 0] = 0x80000000
    rows[0, 1] = 0xFFFFFFFF
    return rows


def _eq(got, want):
    for g, w in zip(got, want):
        g = to_u32(g) if g.dtype == torch.int32 else g.numpy()
        assert np.array_equal(g, np.asarray(w).astype(g.dtype))


@pytest.fixture(autouse=True)
def _no_launches():
    kernels.reset_launches()
    yield
    # CPU tensors take the plain versions: no kernel is launched or counted
    assert all(k.launches == 0 for k in kernels.KERNELS)


@pytest.mark.parametrize("op", ["or", "and", "xor", "andnot"])
def test_b1_segmented_reduce(op):
    # 5 segments of 1..6 rows, then 4 padding rows of segment id K
    seg = np.array([0, 1, 1, 2, 2, 2, 2, 2, 2, 3, 3, 3, 4, 4, 5, 5, 5, 5],
                   np.int32)
    seg[-4:] = 5
    rows = _rows(1, seg.size)
    want = jkernels.segmented_reduce_pallas(op, jnp.asarray(rows),
                                            jnp.asarray(seg), 5)
    _eq(kernels.segmented_reduce_plain(op, _t(rows), _t(seg), 5), want)
    _eq(kernels.segmented_reduce(op, _t(rows), _t(seg), 5), want)


@pytest.mark.parametrize("op", ["or", "xor"])
@pytest.mark.parametrize("block", [4, 8])
def test_b2_segmented_reduce_blocked(op, block):
    # segment-padded blocked layout straight from the JAX packer
    from roaringbitmap_tpu import RoaringBitmap as JRB
    from roaringbitmap_tpu.ops import dense as jdense

    rng = np.random.default_rng(block)
    bms = [JRB.from_values(rng.integers(0, 1 << 19, 3000).astype(np.uint32))
           for _ in range(5)]
    p = jpacking.pack_blocked_compact(bms, block=block)
    s = p.streams
    words = np.asarray(jdense.densify_streams(
        jnp.asarray(s.dense_words), jnp.asarray(s.dense_dest),
        jnp.asarray(s.values), jnp.asarray(s.val_counts),
        jnp.asarray(s.val_dest), p.n_rows, s.total_values))
    k = p.keys.size
    want = jkernels.segmented_reduce_pallas_blocked(
        op, jnp.asarray(words), jnp.asarray(p.blk_seg), k, block)
    _eq(kernels.segmented_reduce_blocked_plain(op, _t(words), _t(p.blk_seg),
                                               k, block), want)
    _eq(kernels.segmented_reduce_blocked(op, _t(words), _t(p.blk_seg), k,
                                         block), want)


@pytest.mark.parametrize("op", ["and", "andnot"])
def test_b2_refuses_non_identity_padding_ops(op):
    with pytest.raises(ValueError):
        kernels.segmented_reduce_blocked(op, _t(_rows(0, 4)),
                                         _t(np.zeros(1, np.int32)), 1, 4)


@pytest.mark.parametrize("seed", [0, 1])
def test_b3_densify_chunks(seed):
    rng = np.random.default_rng(seed)
    n_rows = 10
    rows = np.sort(rng.choice(n_rows, 4, replace=False)).astype(np.int32)
    pieces = [np.unique(rng.integers(0, 1 << 16, int(rng.integers(1, 300))))
              for _ in rows]
    pieces[0] = np.unique(np.concatenate([pieces[0], [0, 31, 65535]]))
    values = np.concatenate(pieces).astype(np.uint16)
    counts = np.array([p.size for p in pieces], np.int32)
    cv, cr = jpacking.chunk_value_stream(values, counts, rows, n_rows)
    live = np.zeros(n_rows + 1, np.uint32)
    live[cr] = 1
    want = jkernels.densify_chunks_pallas(jnp.asarray(cv), jnp.asarray(cr),
                                          jnp.asarray(live), n_rows)
    assert cv.shape[0] <= 32  # a few dozen interpret-mode grid steps
    _eq([kernels.densify_chunks_plain(_t(cv), _t(cr), n_rows)], [want])
    _eq([kernels.densify_chunks(_t(cv), _t(cr), n_rows)], [want])


def _densify_by_bounds(cv: np.ndarray, bounds: np.ndarray, n_rows: int):
    """B3's kernel, row by row in NumPy: each row ORs the bits of the slots
    of its chunks [bounds[r], bounds[r + 1]) into a zero tile."""
    out = np.zeros((n_rows, 2048), np.uint32)
    for r in range(n_rows):
        v = cv[bounds[r]:bounds[r + 1]].ravel()
        v = v[v <= 0xFFFF]
        np.bitwise_or.at(out[r], v >> 5, np.uint32(1) << (v & 31))
    return out


def _chunk_case(case: str):
    """(chunk_vals u32[NC, 128], chunk_row i32[NC], n_rows) of one B3
    launch-plan case, from the packer."""
    rng = np.random.default_rng(len(case))
    if case == "all padding":
        return jpacking.chunk_value_stream(np.zeros(0, np.uint16),
                                           np.zeros(0, np.int32),
                                           np.zeros(0, np.int32), 6) + (6,)
    n_rows, rows, sizes = {
        "empty rows": (12, [1, 4, 5, 11], [130, 10, 260, 5]),
        "scratch padding": (7, [0, 2, 3, 6], [100, 200, 50, 300]),
        "one row": (1, [0], [1000])}[case]
    pieces = [np.sort(rng.choice(1 << 16, n, replace=False)) for n in sizes]
    values = np.concatenate(pieces).astype(np.uint16)
    counts = np.array([p.size for p in pieces], np.int32)
    cv, cr = jpacking.chunk_value_stream(values, counts,
                                         np.asarray(rows, np.int32), n_rows)
    return cv, cr, n_rows


@pytest.mark.parametrize("case", ["empty rows", "scratch padding",
                                  "all padding", "one row"])
def test_b3_launch_plan(case):
    """densify_chunk_bounds against a count of the chunks below each row;
    the kernel's row-by-row walk over those bounds equals the plain
    version, which ignores order."""
    cv, cr, n_rows = _chunk_case(case)
    if case == "scratch padding":
        assert (cr == n_rows).sum() > 0      # pow2 padding chunks
    if case == "all padding":
        assert (cr == n_rows).all() and (cv == jpacking.CHUNK_PAD).all()
    bounds = kernels.densify_chunk_bounds(_t(cr), n_rows).numpy()
    want = (cr[None, :] < np.arange(n_rows + 1)[:, None]).sum(1)
    assert bounds.dtype == np.int32 and np.array_equal(bounds, want)
    for r in range(n_rows):
        assert (cr[bounds[r]:bounds[r + 1]] == r).all()
    assert (cr[bounds[n_rows]:] >= n_rows).all()
    image = _densify_by_bounds(cv, bounds, n_rows)
    _eq([kernels.densify_chunks_plain(_t(cv), _t(cr), n_rows)], [image])
    _eq([kernels.densify_chunks(_t(cv), _t(cr), n_rows)], [image])
    _eq([kernels.densify_chunks(_t(cv), _t(cr), n_rows, _t(bounds))], [image])
    if case == "empty rows":
        assert not image[[0, 2, 3, 6, 7, 8, 9, 10]].any()
        assert image[[1, 4, 5, 11]].any(axis=1).all()


@pytest.mark.parametrize("fault", ["unsorted rows", "foreign bounds",
                                   "short bounds"])
def test_densify_refuses_what_the_kernel_would_misread(fault):
    """The kernel trusts chunk_row to ascend and its bounds to be that
    order's plan; on the CPU the wrapper holds its caller to the same
    contract and raises."""
    cv, cr, n_rows = _chunk_case("empty rows")
    bounds = kernels.densify_chunk_bounds(_t(cr), n_rows)
    if fault == "unsorted rows":
        cr, bounds = cr[::-1].copy(), None
    elif fault == "foreign bounds":
        bounds = torch.roll(bounds, 1)
    else:
        bounds = bounds[:-1].contiguous()
    with pytest.raises(ValueError):
        kernels.densify_chunks(_t(cv), _t(cr), n_rows, bounds)
    _eq([kernels.densify_chunks_plain(_t(cv), _t(cr), n_rows)],
        [kernels.densify_chunks_plain(_t(cv[::-1].copy()),
                                      _t(cr[::-1].copy()), n_rows)])


def _counts(seed: int, g: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    nib = rng.integers(0, 9, (g, 4, 2048, 8)).astype(np.uint64)
    nib[rng.random((g, 4, 2048, 8)) < 0.7] = 0   # mostly-zero counts
    nib[0, :, :2] = 8                            # negative int32 views
    return (nib << (4 * np.arange(8, dtype=np.uint64))).sum(
        axis=-1).astype(np.uint32).reshape(g, 4 * 2048)


@pytest.mark.parametrize("op", ["or", "xor"])
@pytest.mark.parametrize("gps", [1, 2])
def test_b4_counts_segmented_reduce(op, gps):
    # 4 segments of 2, 4, 2, 2 groups, then 2 padding groups of id K
    grp_seg = np.array([0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4], np.int32)
    counts = _counts(gps, grp_seg.size)
    want = jkernels.counts_segmented_reduce(
        op, jnp.asarray(counts), jnp.asarray(grp_seg), 4, gps)
    _eq(kernels.counts_segmented_reduce_plain(op, _t(counts), _t(grp_seg), 4),
        want)
    _eq(kernels.counts_segmented_reduce(op, _t(counts), _t(grp_seg), 4), want)


@pytest.mark.parametrize("fn,args", [
    ("segmented_reduce", lambda w, s: ("or", w, s, 1)),
    ("counts_segmented_reduce", lambda w, s: ("or", w, s, 1)),
])
def test_wrappers_check_tensors(fn, args):
    f = getattr(kernels, fn)
    width = 2048 if fn == "segmented_reduce" else 4 * 2048
    w = torch.zeros((2, width), dtype=torch.int32)
    s = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        f(*args(w.to(torch.int64), s))
    with pytest.raises(ValueError):
        f(*args(w[:, :-1].contiguous(), s))
    with pytest.raises(ValueError):
        f(*args(torch.zeros((width, 2), dtype=torch.int32).t(), s))
    with pytest.raises(ValueError):
        f(*args(w, s[:1]))
    with pytest.raises(ValueError):   # no kernel for this device
        f(*args(w.to("meta"), s.to("meta")))


def test_densify_wrapper_checks():
    with pytest.raises(ValueError):
        kernels.densify_chunks(torch.zeros((2, 64), dtype=torch.int32),
                               torch.zeros(2, dtype=torch.int32), 4)
    with pytest.raises(ValueError):
        kernels.densify_chunks(torch.zeros((2, 128), dtype=torch.int32),
                               torch.zeros(3, dtype=torch.int32), 4)


def test_launch_counts_and_errors(monkeypatch):
    """A launch that returns a CUDA error raises and is not counted; a
    launch that succeeds is counted once."""
    codes = iter([0, 700])

    class FakeLib:
        def __init__(self):
            self.rb_segmented_reduce = lambda *a: next(codes)
            self.rb_error_string = lambda e: b"an illegal memory access"

    monkeypatch.setattr(build, "load", lambda source: FakeLib())
    k = kernels.CudaKernel("probe", "segmented_reduce.cu",
                           "rb_segmented_reduce", [ctypes.c_int], "x")
    k.launch(0, nbytes=8)
    assert k.launches == 1
    with pytest.raises(kernels.KernelLaunchError, match="illegal memory"):
        k.launch(0, nbytes=8)
    assert k.launches == 1


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(build.KernelBuildError):
        build.nvcc_path()


def test_library_paths_are_keyed_by_source():
    paths = {build.library_path(s) for s in build.SOURCES}
    assert len(paths) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so" for p in paths)
    assert {k.source for k in kernels.KERNELS} == set(build.SOURCES)
