"""Native ingest engine: serialized bitmaps -> the packers' compact streams
in one C++ pass over the wire bytes, loaded with ctypes.

``stream_ingest.cpp`` is host code, the same source as the JAX package's
native engine.  It is built with ``g++ -O3 -march=native -std=c++17
-shared -fPIC`` at first use into ``_build/`` beside this file (listed in
``.gitignore``; ``ROARING_TPU_COMPILE_CACHE`` names another directory,
``runtime.warmup``), named by a hash of the source and a tag of the host CPU
(a ``-march=native`` library must not be loaded on another CPU).
``ops.packing.pack_blocked_compact`` and ``pack_pairwise`` take it first for
inputs that are all serialized bytes; their NumPy paths are its oracle.

Unlike the JAX package, nothing degrades silently: a failed build or load
raises ``NativeBuildError``.  ``RB_NATIVE=0`` (the JAX package's switch)
selects the NumPy path, and ``CALLS`` counts which engine served each
byte-input pack.  Hostile blobs raise ``InvalidRoaringFormat``, as the
NumPy path does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import zlib
from pathlib import Path

import numpy as np

SRC = Path(__file__).with_name("stream_ingest.cpp")
BUILD_DIR = Path(__file__).with_name("_build")
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

#: byte-input packs served by each engine since the last reset
CALLS = {"native": 0, "numpy": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class NativeBuildError(RuntimeError):
    """g++ is missing or refused the ingest source, or the built library
    would not load."""


def reset_calls() -> None:
    for k in CALLS:
        CALLS[k] = 0


def enabled() -> bool:
    """False when ``RB_NATIVE=0`` asks for the NumPy path."""
    return os.environ.get("RB_NATIVE", "1") != "0"


def _cpu_tag() -> str:
    """Short fingerprint of the host CPU's feature flags."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return f"{zlib.crc32(line.encode()):08x}"
    except OSError:
        pass
    import platform

    return f"{zlib.crc32(platform.machine().encode()):08x}"


def build_dir() -> Path:
    """Where the library is built and found: ``ROARING_TPU_COMPILE_CACHE``
    when set (``runtime.warmup``), else ``BUILD_DIR``."""
    from ..runtime import warmup

    cache = warmup.compile_cache_dir()
    return Path(cache) if cache else BUILD_DIR


def library_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode())
    return build_dir() / (f"stream_ingest_{digest.hexdigest()[:12]}_"
                          f"{_cpu_tag()}.so")


def build() -> Path:
    """Compile the library if it is not built yet; returns its path."""
    lib = library_path()
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    # compile to a process-unique name and rename: a process racing on the
    # same checkout never loads a half-written library
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                              capture_output=True, text=True)
    except OSError as exc:
        raise NativeBuildError(f"g++ could not run: {exc}") from exc
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeBuildError(
            f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
            f"{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The ingest library, built and loaded once per process."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            raise NativeBuildError(f"cannot load {path}: {exc}") from exc
        i64, vp = ctypes.c_int64, ctypes.c_void_p
        lib.rb_ingest.restype = vp
        lib.rb_ingest.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), i64,
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.rb_error.restype = ctypes.c_char_p
        lib.rb_error.argtypes = [vp]
        for name in ("rb_num_keys", "rb_n_blocks", "rb_nb_pad",
                     "rb_carry_row", "rb_md", "rb_total_values", "rb_mv"):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = i64, [vp]
        lib.rb_block.restype, lib.rb_block.argtypes = ctypes.c_int, [vp]
        lib.rb_export.restype = None
        lib.rb_export.argtypes = [vp] + [vp] * 9
        lib.rb_free.restype, lib.rb_free.argtypes = None, [vp]
        lib.rb_ingest_pairwise.restype = vp
        lib.rb_ingest_pairwise.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64),
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(i64), i64]
        lib.rbp_error.restype = ctypes.c_char_p
        lib.rbp_error.argtypes = [vp]
        for name in ("rbp_m", "rbp_md_a", "rbp_v_a", "rbp_mv_a",
                     "rbp_md_b", "rbp_v_b", "rbp_mv_b"):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = i64, [vp]
        lib.rbp_export.restype = None
        lib.rbp_export.argtypes = [vp] + [vp] * 12
        lib.rbp_free.restype, lib.rbp_free.argtypes = None, [vp]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _by_dest(dense_words, dense_dest, values, val_counts, val_dest):
    """Both streams in destination-row order, as the NumPy packer emits
    them (the C++ pass emits them input by input): a stable sort of the
    dense rows by row, and of the value runs by row, values moving with
    their runs."""
    order = np.argsort(dense_dest, kind="stable")
    dense_words, dense_dest = dense_words[order], dense_dest[order]
    order = np.argsort(val_dest, kind="stable")
    counts = val_counts[order].astype(np.int64)
    starts = np.concatenate(([0], np.cumsum(val_counts, dtype=np.int64)))[
        :-1][order]
    # each moved run's source offset, repeated over its values, plus the
    # position inside the run
    new_starts = np.concatenate(([0], np.cumsum(counts)))[:-1]
    idx = np.repeat(starts - new_starts, counts) + np.arange(counts.sum())
    return (dense_words, dense_dest, values[idx], val_counts[order],
            val_dest[order])


def pack_blocked_compact(blobs: list[bytes], block: int | None,
                         round_blocks: int, carry_slot: bool):
    """Rotation and classification of serialized blobs, as
    ``ops.packing.pack_blocked_compact`` (without ``row_src``, which the
    caller rebuilds from the keys)."""
    from ..format.spec import InvalidRoaringFormat
    from ..ops import packing

    lib = load()
    ptrs = (ctypes.c_char_p * len(blobs))(*blobs)
    lens = np.array([len(b) for b in blobs], dtype=np.int64)
    handle = lib.rb_ingest(
        ptrs, lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(blobs), 0 if block is None else block, round_blocks,
        1 if carry_slot else 0)
    try:
        err = lib.rb_error(handle)
        if err:
            raise InvalidRoaringFormat(err.decode())
        k, nb_pad = lib.rb_num_keys(handle), lib.rb_nb_pad(handle)
        md, v, mv = (lib.rb_md(handle), lib.rb_total_values(handle),
                     lib.rb_mv(handle))
        keys = np.empty(k, np.uint16)
        blk_seg = np.empty(nb_pad, np.int32)
        seg_sizes = np.empty(k, np.int64)
        seg_offsets = np.empty(k, np.int64)
        dense_words = np.empty((md, packing.WORDS32), np.uint32)
        dense_dest = np.empty(md, np.int32)
        values = np.empty(v, np.uint16)
        val_counts = np.empty(mv, np.int32)
        val_dest = np.empty(mv, np.int32)
        lib.rb_export(handle, _ptr(keys), _ptr(blk_seg), _ptr(seg_sizes),
                      _ptr(seg_offsets), _ptr(dense_words), _ptr(dense_dest),
                      _ptr(values), _ptr(val_counts), _ptr(val_dest))
        out_block = lib.rb_block(handle)
        n_blocks = lib.rb_n_blocks(handle)
        carry_row = lib.rb_carry_row(handle)
    finally:
        lib.rb_free(handle)
    dw, dd, vals, vc, vd = _by_dest(dense_words, dense_dest, values,
                                    val_counts, val_dest)
    streams = packing.CompactStreams(
        n_rows=int(nb_pad) * out_block, dense_words=dw, dense_dest=dd,
        values=vals, val_counts=vc, val_dest=vd)
    return packing.PackedBlockedCompact(
        keys=keys, blk_seg=blk_seg, block=int(out_block),
        n_blocks=int(n_blocks), seg_sizes=seg_sizes,
        seg_offsets=seg_offsets, streams=streams, carry_row=int(carry_row))


def pack_pairwise(a_blobs: list[bytes], b_blobs: list[bytes],
                  pad_rows: bool):
    """Per-pair union alignment of serialized pairs, as
    ``ops.packing.pack_pairwise``."""
    from ..format.spec import InvalidRoaringFormat
    from ..ops import packing

    lib = load()
    n = len(a_blobs)
    i64p = ctypes.POINTER(ctypes.c_int64)
    a_lens = np.array([len(b) for b in a_blobs], dtype=np.int64)
    b_lens = np.array([len(b) for b in b_blobs], dtype=np.int64)
    handle = lib.rb_ingest_pairwise(
        (ctypes.c_char_p * n)(*a_blobs), a_lens.ctypes.data_as(i64p),
        (ctypes.c_char_p * n)(*b_blobs), b_lens.ctypes.data_as(i64p), n)
    try:
        err = lib.rbp_error(handle)
        if err:
            raise InvalidRoaringFormat(err.decode())
        m = int(lib.rbp_m(handle))
        keys = np.empty(m, np.uint16)
        heads = np.empty(n + 1, np.int64)
        sides = {}
        for side in ("a", "b"):
            md = getattr(lib, f"rbp_md_{side}")(handle)
            v = getattr(lib, f"rbp_v_{side}")(handle)
            mv = getattr(lib, f"rbp_mv_{side}")(handle)
            sides[side] = (np.empty((md, packing.WORDS32), np.uint32),
                           np.empty(md, np.int32), np.empty(v, np.uint16),
                           np.empty(mv, np.int32), np.empty(mv, np.int32))
        lib.rbp_export(handle, _ptr(keys), _ptr(heads),
                       *[_ptr(x) for side in ("a", "b") for x in sides[side]])
    finally:
        lib.rbp_free(handle)
    n_rows = packing.next_pow2(m) if pad_rows else m

    def streams(side):
        dw, dd, vals, vc, vd = sides[side]
        return packing.CompactStreams(
            n_rows=n_rows, dense_words=dw, dense_dest=dd, values=vals,
            val_counts=vc, val_dest=vd)

    return packing.PackedPairwiseCompact(
        keys=keys, heads=heads, m=m, n_rows=n_rows,
        a_streams=streams("a"), b_streams=streams("b"))
