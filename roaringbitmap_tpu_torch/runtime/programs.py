"""Program cache: one captured CUDA graph per program signature (the port's
counterpart of the JAX engines' ``_programs``).

The JAX engines compile one XLA program per plan signature and run every
later plan of that signature through it.  On the card the one-time cost a
program saves is host work rather than compilation: the plan's uploads and
the tens to hundreds of eager launches of a batch (gathers, masks,
``segment_ranges``, the kernels).  So a program here is a
``torch.cuda.CUDAGraph`` of the engine's device part, captured once per
signature at warmup and replayed for every plan that snaps onto it.

A plan's device operands (gather indices, masks, the megakernel's stream,
its step count, the column planes) are one **operand pack**: a flat byte
buffer per plan, uploaded once (:func:`pack_operands`), whose typed views
the device part reads.  A program holds a static pack of the same layout;
a replay copies the plan's pack into it (one device copy), replays, and
hands back the graph's static outputs, which the caller copies out on the
same stream before the next replay.  What the
graph reads by address instead (a dense image patched in place, the
compact streams B3 rebuilds from inside the graph) is keyed by the owning
set's ``(uid, structure_version)``; :meth:`ProgramCache.retire` drops every
graph when that moves and releases their memory.

Nothing is uploaded inside a capture and no host scalar of one plan is
baked into a graph: the megakernel reads its step count from the pack
(``megakernel.raw_call(steps_dev=)``), and value scans read their predicate
bits and top-k's k from it (``expr.eval_section(device_scalars=True)``).

All graphs of one engine share one private memory pool and replay on the
caller's stream, one at a time.  A replay adds each graph's kernel launches
(recorded at capture, when nothing runs) to ``ops.kernels`` counts.  On a
CPU device a program is a marker: the same keys and ``note_compile``
bookkeeping, with the device part run on the packed operands each time.
A failed capture or replay raises ``errors.GraphCaptureError``; an
allocator failure stays a ``torch.OutOfMemoryError`` (the guard halves the
batch).  Nothing falls back to the eager path.

Each dispatch's program lookup (``prepare``, which the engines call before
the launch, or ``note_eager``) observes ``rb_compile_seconds{site,cache}``:
a capture (on the CPU, a marker's build) or a new unsnapped key is a
``miss`` inside the engine's ``*.program_build`` span (a new unsnapped key
noted before its first run is timed 0: its first eager run is inside the
launch), an existing program a ``hit``.  The graph pools' reserved
bytes are resident in ``obs.memory.LEDGER`` (kind ``graph_pool``).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..obs import cost as obs_cost
from ..obs import memory as obs_memory
from ..obs import trace as obs_trace
from ..ops import build, kernels
from . import errors
from . import lattice as rt_lattice
from .cache import LRUCache

#: the JAX engines' program-build span of each site
_BUILD_SPAN = {"batch_engine": "batch.program_build",
               "multiset": "multiset.program_build",
               "sharded_engine": "sharded.program_build"}

#: programs one engine keeps (the JAX package's cap); a lattice warmup
#: raises it to fit the whole vocabulary
PROGRAM_CACHE_MAX = 64
#: byte alignment of each operand in a pack
ALIGN = 16

#: one-time program work in this process: programs built (a graph capture
#: on the card, a marker on the CPU) and first eager runs of unsnapped
#: plans (``one_time_work``)
_ONE_TIME = {"captures": 0, "eager": 0}


def one_time_work() -> int:
    """Kernel libraries loaded, programs built and first eager runs,
    process-wide: the port's witness of the JAX package's compile-miss
    count.  A dispatch during which it moved paid a one-time cost, so its
    wall must not calibrate a steady-state estimate."""
    return build.LOADS + _ONE_TIME["captures"] + _ONE_TIME["eager"]


# ------------------------------------------------------------ operand packs

class _Leaf:
    """A leaf's place in an operand tree's skeleton."""

    __slots__ = ("path",)

    def __init__(self, path):
        self.path = path


def _skeleton(tree, leaves: list, path=()):
    """``tree`` with each non-None leaf replaced by a :class:`_Leaf`, the
    leaves collected into ``leaves`` as (path, value) in tree order."""
    if isinstance(tree, dict):
        return {k: _skeleton(v, leaves, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v, leaves, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    leaves.append((path, tree))
    return _Leaf(path)


def _fill(skel, views: dict):
    if isinstance(skel, dict):
        return {k: _fill(v, views) for k, v in skel.items()}
    if isinstance(skel, (list, tuple)):
        return type(skel)(_fill(v, views) for v in skel)
    if isinstance(skel, _Leaf):
        return views[skel.path]
    return skel


def _host_array(a) -> np.ndarray:
    """A host operand as the device will hold it: u32 words as int32 bits,
    bool masks as bool, other integers as int32 (``ops.words.upload``)."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        return a.view(np.int32)
    if a.dtype not in (np.int32, np.bool_):
        return a.astype(np.int32)
    return a


_DTYPES = {"int32": torch.int32, "bool": torch.bool}


@dataclasses.dataclass
class OperandPack:
    """A plan's device operands in one flat uint8 buffer: ``layout`` is a
    hashable tuple of ``(path, dtype, shape, offset)``, which depends only
    on the operands' places, types and shapes; ``skeleton`` the operand
    tree with its leaves as places."""

    layout: tuple
    flat: torch.Tensor
    skeleton: object

    def views(self, flat: torch.Tensor | None = None):
        """The operand tree with typed views of ``flat`` (default: this
        pack's own buffer) at its leaves."""
        return _fill(self.skeleton, _views(self.layout,
                                           self.flat if flat is None
                                           else flat))


def _views(layout, flat) -> dict:
    out = {}
    for path, dtype, shape, off in layout:
        td = _DTYPES[dtype]
        n = int(np.prod(shape, dtype=np.int64)) * (1 if td == torch.bool
                                                   else 4)
        out[path] = flat[off:off + n].view(td).view(shape)
    return out


def pack_operands(tree, device) -> OperandPack:
    """Pack a plan's operand tree (nested dicts, lists and tuples whose
    leaves are host arrays or tensors) into one flat buffer on ``device``.
    Host arrays go up together in one copy (through pinned memory on a
    card); tensor leaves (cached result rows, column planes) are copied in
    on the device."""
    leaves: list = []
    skeleton = _skeleton(tree, leaves)
    layout, host_parts, dev_parts = [], [], []
    off = host_bytes = 0
    for host_pass in (True, False):
        for path, v in leaves:
            if isinstance(v, torch.Tensor) == host_pass:
                continue
            if host_pass:
                v = _host_array(v)
                dtype, nbytes = str(v.dtype), v.nbytes
            else:
                dtype = str(v.dtype).replace("torch.", "")
                nbytes = v.numel() * v.element_size()
            if dtype not in _DTYPES:
                raise TypeError(f"operand {path}: unsupported dtype {dtype}")
            layout.append((path, dtype, tuple(v.shape), off))
            (host_parts if host_pass else dev_parts).append((path, off, v))
            off += -(-nbytes // ALIGN) * ALIGN
        if host_pass:
            host_bytes = off
    flat = torch.empty(max(off, ALIGN), dtype=torch.uint8, device=device)
    if host_bytes:
        buf = np.zeros(host_bytes, np.uint8)
        for _path, o, a in host_parts:
            buf[o:o + a.nbytes] = a.reshape(-1).view(np.uint8)
        src = torch.from_numpy(buf)
        if flat.device.type == "cuda":
            src = src.pin_memory()
        flat[:host_bytes].copy_(src, non_blocking=True)
    layout = tuple(layout)
    views = _views(layout, flat)
    for path, _o, t in dev_parts:
        views[path].copy_(t)
    return OperandPack(layout=layout, flat=flat, skeleton=skeleton)


def copy_out(outs):
    """A program's outputs as tensors the next replay cannot overwrite: on
    a card, copies into pinned host tensors queued on the current stream
    (the caller waits before reading them); CPU outputs as they are."""
    if outs is None:
        return None
    if isinstance(outs, (list, tuple)):
        return type(outs)(copy_out(x) for x in outs)
    if outs.device.type != "cuda":
        return outs
    h = torch.empty(outs.shape, dtype=outs.dtype, pin_memory=True)
    h.copy_(outs, non_blocking=True)
    return h


# ---------------------------------------------------------------- programs

@dataclasses.dataclass
class Program:
    """One program: a captured graph with its static operand buffer and
    static outputs (None on the CPU, where ``run`` is called on each plan's
    pack), the kernel launches one replay makes, and the capture's wall
    time."""

    run: object
    graph: object = None
    static_flat: object = None
    outs: object = None
    launches: tuple = ()
    #: per kernel, the launches by variant one replay makes
    variants: tuple = ()
    capture_ms: float = 0.0


class GraphPool:
    """A private graph memory pool, made at the first capture; shared by
    the program caches of engines that replay on one stream (a pooled
    engine and its member engines)."""

    def __init__(self):
        self._handle = None
        self._stream = None
        self.users = 1
        obs_memory.LEDGER.register(
            "graph_pool", "device", GraphPool.bytes, owner=self,
            stamp=lambda p: (_ONE_TIME["captures"], p._handle is None))

    def handle(self):
        if self._handle is None:
            self._handle = torch.cuda.graph_pool_handle()
        return self._handle

    def stream(self, device):
        """The side stream every capture into this pool runs on: the
        allocator reuses a block freed by one capture only for work on the
        stream that freed it, so one stream lets the graphs of a pool share
        their intermediates' memory."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(device)
        return self._stream

    def release(self) -> None:
        """Forget the pool (its memory goes when its last graph does)."""
        self._handle = None

    def bytes(self) -> int:
        """Device bytes the pool reserves (0 before any capture)."""
        if self._handle is None:
            return 0
        pool = tuple(self._handle)
        return sum(int(seg["total_size"])
                   for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class ProgramCache:
    """The programs of one engine on ``device``: an LRU of
    :class:`Program` by key, the graph pool, and counters (``captures``,
    ``replays``, ``eager``, ``retired``)."""

    def __init__(self, device, site: str, maxsize: int = PROGRAM_CACHE_MAX):
        self.device = torch.device(device)
        self.site = site
        self._entries = LRUCache(maxsize, name=f"{site}_programs")
        #: bumped by ``retire``; engines put it in their program keys
        self.generation = 0
        self.pool = GraphPool()
        self.captures = 0
        self.replays = 0
        self.retired = 0
        #: first dispatches of unsnapped plans (run eagerly, no program)
        self.eager = 0

    @property
    def maxsize(self) -> int:
        return self._entries.maxsize

    @maxsize.setter
    def maxsize(self, n: int) -> None:
        self._entries.maxsize = int(n)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        return key in self._entries

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    @property
    def graphs(self) -> int:
        return sum(1 for e in self._entries._data.values()
                   if e.graph is not None)

    def stats(self) -> dict:
        return {**self._entries.stats(), "graphs": self.graphs,
                "captures": self.captures, "replays": self.replays,
                "eager": self.eager, "retired": self.retired,
                "generation": self.generation,
                "pool_bytes": self.pool_bytes()}

    # ----------------------------------------------------------- lookups

    def note_eager(self, key, engine: str, point, run_s: float,
                   tags=None) -> None:
        """An unsnapped plan ran eagerly (it has no program): the first run
        of its key counts as a new program, reported to the lattice and
        timed by the run, as the JAX package reports a compile; warmup
        and the engines' pre-launch lookup register such keys ahead with
        ``run_s`` 0.  ``tags()`` gives the build span's tags."""
        t0 = time.perf_counter()
        if self._entries.get(key) is not None:
            obs_cost.observe_compile(self.site, "hit",
                                     time.perf_counter() - t0)
            return
        self.eager += 1
        _ONE_TIME["eager"] += 1
        self._entries.put(key, Program(run=None))
        with obs_trace.span(_BUILD_SPAN.get(self.site, "program_build"),
                            engine=engine) as sp:
            sp.tag(**(tags() if tags is not None else {}),
                   compile_ms=round(run_s * 1e3, 2))
            obs_cost.observe_compile(self.site, "miss", run_s)
        rt_lattice.note_compile(self.site, engine, point, run_s)

    def prepare(self, key, engine: str, point, run, pack: OperandPack,
                tags=None) -> Program:
        """The program of ``key``, captured now if it is missing (a counted
        lattice escape after the seal); warmup calls this alone.
        ``tags()`` gives the build span's tags."""
        t0 = time.perf_counter()
        entry = self._entries.get(key)
        if entry is not None:
            obs_cost.observe_compile(self.site, "hit",
                                     time.perf_counter() - t0)
            return entry
        with obs_trace.span(_BUILD_SPAN.get(self.site, "program_build"),
                            engine=engine) as sp:
            entry = self._build(run, pack)
            _ONE_TIME["captures"] += 1
            entry.capture_ms = (time.perf_counter() - t0) * 1e3
            sp.tag(**(tags() if tags is not None else {}),
                   compile_ms=round(entry.capture_ms, 2))
            obs_cost.observe_compile(self.site, "miss",
                                     entry.capture_ms / 1e3)
        self._entries.put(key, entry)
        rt_lattice.note_compile(self.site, engine, point,
                                entry.capture_ms / 1e3)
        return entry

    def dispatch(self, key, engine: str, point, run, pack: OperandPack):
        """Run ``run(operands)`` for a plan's operand ``pack`` through the
        program of ``key`` (which must hold ``pack.layout``): captured on
        first use (a counted lattice escape after the seal), replayed
        after.  Returns the outputs, copied out (``copy_out``)."""
        entry = self._entries.get(key)
        if entry is None:       # no prepare built it: built now
            entry = self.prepare(key, engine, point, run, pack)
        return copy_out(self._replay(entry, pack))

    def _build(self, run, pack: OperandPack) -> Program:
        if not self.on_card:
            return Program(run=run)
        static_flat = torch.empty_like(pack.flat)
        static_flat.copy_(pack.flat)
        views = pack.views(static_flat)
        main = torch.cuda.current_stream(self.device)
        side = self.pool.stream(self.device)
        side.wait_stream(main)
        try:
            # once eagerly first (its kernels load and really run), then
            # the capture, which runs nothing: its launches are counted
            # per replay instead
            with torch.cuda.stream(side):
                run(views)
            main.wait_stream(side)
            before = [k.launches for k in kernels.KERNELS]
            before_v = [dict(k.variants) for k in kernels.KERNELS]
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.stream(side):
                    graph.capture_begin(pool=self.pool.handle())
                    try:
                        outs = run(views)
                    except BaseException:
                        try:
                            graph.capture_end()
                        except Exception:
                            pass        # the run's own error is the cause
                        raise
                    graph.capture_end()
            finally:
                counted = [k.launches for k in kernels.KERNELS]
                counted_v = [{v: n - bv.get(v, 0)
                              for v, n in k.variants.items()
                              if n != bv.get(v, 0)}
                             for k, bv in zip(kernels.KERNELS, before_v)]
                for k, b, bv in zip(kernels.KERNELS, before, before_v):
                    k.launches = b
                    k.variants = bv
        except (torch.OutOfMemoryError, kernels.KernelLaunchError,
                errors.GraphCaptureError):
            raise
        except Exception as exc:
            raise errors.GraphCaptureError(
                f"{self.site}: capturing the program failed: "
                f"{type(exc).__name__}: {exc}") from exc
        self.captures += 1
        return Program(run=run, graph=graph,
                       static_flat=static_flat, outs=outs,
                       launches=tuple(c - b for c, b in zip(counted, before)),
                       variants=tuple(counted_v))

    def _replay(self, entry: Program, pack: OperandPack):
        self.replays += 1
        if entry.graph is None:
            return entry.run(pack.views())
        entry.static_flat.copy_(pack.flat, non_blocking=True)
        try:
            entry.graph.replay()
        except Exception as exc:
            raise errors.GraphCaptureError(
                f"{self.site}: replaying the program failed: "
                f"{type(exc).__name__}: {exc}") from exc
        for k, n in zip(kernels.KERNELS, entry.launches):
            k.launches += n
        for k, vs in zip(kernels.KERNELS, entry.variants):
            for v, n in vs.items():
                k.variants[v] = k.variants.get(v, 0) + n
        return entry.outs

    # --------------------------------------------------------- lifecycle

    def share_pool(self, other: "ProgramCache") -> None:
        """Capture into ``other``'s pool from now on: for an engine whose
        replays run on the same stream as ``other``'s, one at a time."""
        self.pool.users -= 1
        self.pool = other.pool
        self.pool.users += 1

    def retire(self) -> int:
        """Drop every program (their graphs read an image or streams that
        a repack replaced); returns the graphs dropped.  The generation
        moves, so no old key matches again.  A pool no other cache shares
        is released with them, its memory returned to the device."""
        n = self.graphs
        self._entries.clear()
        self.generation += 1
        self.retired += n
        if n and self.on_card:
            torch.cuda.synchronize(self.device)
            if self.pool.users == 1:
                self.pool.release()
            torch.cuda.empty_cache()
        return n

    def pool_bytes(self) -> int:
        """Device bytes reserved by the graph pool (shared pools count
        whole; 0 on the CPU)."""
        return self.pool.bytes() if self.on_card else 0
