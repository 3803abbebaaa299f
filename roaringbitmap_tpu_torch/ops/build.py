"""Build the CUDA kernels with ``nvcc`` at first use and load them with ctypes.

Each source under ``csrc/`` compiles into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  The libraries go
into ``_build/`` beside this file (or into ``ROARING_TPU_COMPILE_CACHE``,
``runtime.warmup``), named by a hash of the source and the flags, so an
edited source is rebuilt and an unchanged one is reused.  A
source's compile-time sizes are passed as ``-D`` defines from
:data:`DEFINES`, the one place they are written.  All
missing libraries are built together, one ``nvcc`` for each source, started
at once.  A failed build raises ``KernelBuildError`` with ``nvcc``'s output:
nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..obs import cost as obs_cost

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
SOURCES = ("segmented_reduce.cu", "densify_chunks.cu", "counts_reduce.cu",
           "megakernel.cu", "stream_reduce.cu", "row_build.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: compile-time sizes by source, passed to nvcc as -D defines: the
#: megakernel's ring of staged step records and its row-prefetch depth
#: (``ops.megakernel`` sizes its shared memory from the same entries)
DEFINES = {"megakernel.cu": {"RB_RECORD_RING": 128, "RB_PREFETCH_DEPTH": 32}}

_LIBS: dict[str, ctypes.CDLL] = {}
#: kernel libraries loaded by this process (a first load may include their
#: nvcc build): a one-time cost no steady-state estimate may learn from
LOADS = 0


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a kernel source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise KernelBuildError(
            "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit")
    return path


def nvcc_flags(source: str) -> tuple:
    return NVCC_FLAGS + tuple(f"-D{name}={value}" for name, value
                              in DEFINES.get(source, {}).items())


def build_dir() -> Path:
    """Where the libraries are built and found: ``ROARING_TPU_COMPILE_CACHE``
    when set (``runtime.warmup``), else ``BUILD_DIR``."""
    from ..runtime import warmup

    cache = warmup.compile_cache_dir()
    return Path(cache) if cache else BUILD_DIR


def library_path(source: str) -> Path:
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(nvcc_flags(source)).encode()
    ).hexdigest()[:16]
    return build_dir() / f"{Path(source).stem}-{digest}.so"


def build(sources=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.
    Returns {source: ptxas report} for the sources built by this call."""
    nvcc = None
    jobs = []
    for src in sources:
        out = library_path(src)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen(
            [nvcc, *nvcc_flags(src), "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((src, proc, tmp, out))
    reports, errors = {}, []
    for src, proc, tmp, out in jobs:
        stdout, stderr = proc.communicate()
        if proc.returncode:
            errors.append(f"nvcc {src} (exit {proc.returncode}):\n"
                          f"{stdout}{stderr}")
            continue
        os.replace(tmp, out)
        reports[src] = stderr
    if errors:
        raise KernelBuildError("\n".join(errors))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one source, building all sources first if its
    library is missing."""
    global LOADS
    lib = _LIBS.get(source)
    if lib is None:
        LOADS += 1
        t0 = time.perf_counter()
        path = library_path(source)
        if not path.exists():
            build()
        lib = ctypes.CDLL(str(path))
        # a first load (with its nvcc build when the library is missing)
        # is one program build of the process
        obs_cost.observe_compile("kernels", "miss", time.perf_counter() - t0)
        lib.rb_error_string.argtypes = [ctypes.c_int]
        lib.rb_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
    return lib
