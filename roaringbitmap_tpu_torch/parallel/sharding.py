"""Multi-device wide aggregation over a mesh of shards
(``roaringbitmap_tpu.parallel.sharding``).

The container-row axis is sharded over the mesh's "rows" axis (the
data-parallel direction), the 2048-word row over "lanes" (the
tensor-parallel direction).  Each shard reduces its rows into a per-key
accumulator with B1 at its row width (2048 / lanes words); the shards then
combine with a bitwise OR/XOR/AND butterfly.

A :class:`Mesh` is named axes over an array of ``torch.device``\\ s in which a
device may repeat: eight CPU shards in the tests, one to eight logical
shards on one card.  Shards on one device share what they can (a tensor
moved to its own device is the same tensor), so a mesh on one card measures
the combine's cost, not scaling.  A mesh built by
``multihost.global_mesh`` spans processes: each shard has an owner rank, a
process holds only its own shards, and the combine moves accumulators
between ranks point to point.

Collective choice: a bitwise reduce is in no collective library's
vocabulary (NCCL and gloo reduce with sum/prod/min/max only, as XLA does
with psum), so the combine is an explicit log2(D) butterfly: each step
exchanges accumulators with the partner at XOR distance d and merges
locally, and every shard ends with the full reduction.  The exchange is the
mesh's communicator: in one process a ``.to(device)`` (a no-op between
shards of one device), across processes ``torch.distributed``'s
``batch_isend_irecv``; a gloo group stages CUDA tensors through pinned host
memory, and counts the bytes it staged.  Cardinalities add with
``all_reduce(SUM)`` across processes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..obs import trace as obs_trace
from ..ops import dense, kernels, packing
from ..ops.words import WORDS32, as_i32, popcount, resolve_device, to_u32


class P(tuple):
    """A partition spec: per tensor dimension, the mesh axis (or tuple of
    axes) it is split over, None for replicated (the JAX
    ``PartitionSpec``'s vocabulary, as plain data)."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclasses.dataclass(frozen=True)
class SpecLayout:
    """The partition specs every sharded path shares, by axis name:

    - ``row_axis`` ("rows"): container rows / pooled rows, data-parallel;
      resident pool images shard here.
    - ``data_axis`` ("data"): query/pool replication; a launch's gathered
      rows spread over ``(rows, data)`` jointly.
    - ``lane_axis`` ("lanes"): the 2048-word row, tensor-parallel (wide
      aggregation only).
    """

    row_axis: str = "rows"
    data_axis: str = "data"
    lane_axis: str = "lanes"

    def pooled_rows(self) -> P:
        return P(self.row_axis, None)

    def packed_rows(self) -> P:
        return P(self.row_axis, self.lane_axis)

    def row_vec(self) -> P:
        return P(self.row_axis)

    def gather_rows(self) -> P:
        return P((self.row_axis, self.data_axis), None)

    def gather_vec(self) -> P:
        return P((self.row_axis, self.data_axis))

    def replicated(self) -> P:
        return P()

    def combined_heads(self) -> P:
        return P(None, None)

    def heads(self) -> P:
        return P(None, self.lane_axis)

    def index_rows(self) -> P:
        return P(self.row_axis, self.lane_axis)

    def sliced_index(self) -> P:
        return P(None, self.row_axis, self.lane_axis)


#: the default axis vocabulary
SPECS = SpecLayout()

#: Per-shard accumulator ceiling, in keys: each shard holds u32[K, W] before
#: the butterfly (8 KiB a key at full width), so K is a direct device-memory
#: budget: 4096 keys = 32 MiB.  ``wide_aggregate_sharded`` chunks the key
#: axis at this granularity; ``make_sharded_aggregator`` refuses more.
MAX_KEYS_PER_SHARD_PASS = 4096


class ShardedKeyBudgetError(ValueError):
    """num_keys exceeds the per-shard accumulator ceiling."""


# --------------------------------------------------------- communicators

class InProcessComm:
    """Every shard of the mesh lives in this process: an exchange moves
    each partner's tensor to the shard's device (the same tensor when the
    devices agree), and a sum is already complete."""

    multi_process = False
    rank = 0

    def __init__(self):
        self.exchanges = 0
        self.staged_bytes = 0

    def exchange(self, mesh: "Mesh", tensors: dict, partners: dict) -> dict:
        self.exchanges += 1
        return {i: tensors[p].to(mesh.device_of(i))
                for i, p in partners.items()}

    def all_sum(self, value: torch.Tensor) -> torch.Tensor:
        return value


class DistComm:
    """The shards of a ``torch.distributed`` process group: a partner on
    another rank exchanges through ``batch_isend_irecv`` (point to point:
    no collective reduces bitwise).  A gloo group moves host tensors only,
    so a CUDA tensor goes through pinned host memory, explicitly, and
    ``staged_bytes`` counts what was staged (sent and received)."""

    multi_process = True

    def __init__(self, group=None):
        import torch.distributed as dist

        self.group = group
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.exchanges = 0
        self.staged_bytes = 0

    def _host_staged(self) -> bool:
        return self.backend == "gloo"

    def _stage_out(self, t: torch.Tensor) -> torch.Tensor:
        if t.is_cuda and self._host_staged():
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
            self.staged_bytes += t.numel() * t.element_size()
            return h
        return t.contiguous()

    def exchange(self, mesh: "Mesh", tensors: dict, partners: dict) -> dict:
        import torch.distributed as dist

        self.exchanges += 1
        out, ops, recvs = {}, [], []
        # both ends order their ops by the (shard, partner) pair, so the
        # n-th send to a peer meets that peer's n-th receive
        for i, p in sorted(partners.items(),
                           key=lambda kv: (min(kv), max(kv))):
            owner = int(mesh.ranks.flat[p])
            if owner == self.rank:
                out[i] = tensors[p].to(mesh.device_of(i))
                continue
            send = self._stage_out(tensors[i])
            buf = torch.empty_like(send)
            tag = min(i, p) * mesh.size + max(i, p)
            ops.append(dist.P2POp(dist.isend, send, owner, self.group, tag))
            ops.append(dist.P2POp(dist.irecv, buf, owner, self.group, tag))
            recvs.append((i, buf))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for i, buf in recvs:
            dev = mesh.device_of(i)
            if dev.type == "cuda" and not buf.is_cuda:
                self.staged_bytes += buf.numel() * buf.element_size()
            out[i] = buf.to(dev)
        return out

    def all_sum(self, value: torch.Tensor) -> torch.Tensor:
        """``value`` summed over the group's ranks (int64, on the
        collective's device: the host for gloo)."""
        import torch.distributed as dist

        dev = value.device
        t = value.to(torch.int64)
        if self._host_staged() and t.is_cuda:
            t = t.cpu()
            self.staged_bytes += 8 * t.numel()
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t.to(dev)


# ----------------------------------------------------------------- mesh

def _as_device(d) -> torch.device:
    """``d`` as a ``torch.device``, a bare "cuda" resolved to the current
    card (so "cuda" and "cuda:0" name one device of a mesh)."""
    d = d if isinstance(d, torch.device) else torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """Named axes over an array of ``torch.device``\\ s (a device may
    repeat).  ``ranks`` gives each shard's owner process (all 0 in one
    process); ``comm`` is the communicator, a ``DistComm`` when the shards
    span ranks.  Shards are numbered in row-major order of ``devices``."""

    def __init__(self, devices, axis_names, ranks=None, comm=None):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        flat = np.asarray(devices, dtype=object).reshape(-1)
        if flat.size == 0:
            raise ValueError("a mesh needs at least one device")
        for i, d in enumerate(flat):
            arr.flat[i] = _as_device(d)
        self.axis_names = tuple(axis_names)
        if arr.ndim != len(self.axis_names):
            raise ValueError(f"mesh devices of shape {arr.shape} need "
                             f"{arr.ndim} axis names, got {self.axis_names}")
        self.devices = arr
        self.shape = dict(zip(self.axis_names, arr.shape))
        self.ranks = (np.zeros(arr.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))
        if comm is None:
            if (self.ranks != self.ranks.flat[0]).any():
                comm = DistComm()
            else:
                comm = InProcessComm()
        self.comm = comm
        for dev in {d for d, r in zip(arr.flat, self.ranks.flat)
                    if r == comm.rank}:
            resolve_device(dev)         # a CUDA mesh without a card raises

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multi_process(self) -> bool:
        return bool(self.comm.multi_process)

    def device_of(self, i: int) -> torch.device:
        return self.devices.flat[i]

    def coords(self, i: int) -> tuple:
        return tuple(int(c) for c in np.unravel_index(i, self.devices.shape))

    def index(self, coords) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.devices.shape))

    def coord(self, i: int, axis: str) -> int:
        return self.coords(i)[self.axis_names.index(axis)]

    def local(self) -> list:
        """The flat indices of the shards this process holds."""
        return [i for i in range(self.size)
                if int(self.ranks.flat[i]) == self.comm.rank]

    def lead(self) -> int:
        return self.local()[0]

    def partners(self, axis: str, d: int, shards) -> dict:
        """{shard: its partner at XOR distance ``d`` along ``axis``}."""
        ax = self.axis_names.index(axis)
        out = {}
        for i in shards:
            c = list(self.coords(i))
            c[ax] ^= d
            out[i] = self.index(c)
        return out

    def distinct_devices(self) -> list:
        seen = []
        for i in self.local():
            d = self.device_of(i)
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self) -> str:
        return (f"Mesh({dict(self.shape)}, devices="
                f"{sorted({str(d) for d in self.devices.flat})}, "
                f"ranks={sorted(set(int(r) for r in self.ranks.flat))})")


def _butterfly_combine(op: str, acc: dict, mesh: Mesh, axis_name: str
                       ) -> dict:
    """log2(D) butterfly over ``axis_name``: ``acc`` maps each local shard
    to its accumulator; every shard ends with the full reduction.  Two
    partners of one device share one merged tensor (the op commutes)."""
    fn = dense.OPS[op]
    n = mesh.shape[axis_name]
    if n & (n - 1):
        raise ValueError(f"mesh axis {axis_name!r} size must be a power of "
                         f"two for the butterfly combine, got {n}")
    d = 1
    while d < n:
        partners = mesh.partners(axis_name, d, acc)
        other = mesh.comm.exchange(mesh, acc, partners)
        new = {}
        for i in acc:
            if i in new:
                continue
            p = partners[i]
            merged = fn(acc[i], other[i])
            new[i] = merged
            if (p in acc and p not in new
                    and mesh.device_of(p) == mesh.device_of(i)):
                new[p] = merged
        acc = new
        d *= 2
    return acc


def _sum_local(mesh: Mesh, parts: dict) -> torch.Tensor:
    """Sum of per-shard int64 tensors over the local shards, then over
    the mesh's processes."""
    dev = mesh.device_of(mesh.lead())
    total = None
    for t in parts.values():
        t = t.to(dev, torch.int64)
        total = t if total is None else total + t
    return mesh.comm.all_sum(total)


# ------------------------------------------------------ wide aggregation

def _axes(mesh: Mesh, row_axis: str, lane_axis: str) -> tuple:
    if row_axis not in mesh.axis_names:
        raise ValueError(f"sharded wide ops need a {row_axis!r} mesh axis, "
                         f"got {mesh.axis_names}")
    extra = [a for a in mesh.axis_names if a not in (row_axis, lane_axis)]
    if extra:
        raise ValueError(f"sharded wide ops run over ({row_axis!r}, "
                         f"{lane_axis!r}); the mesh also has {extra}")
    lanes = mesh.shape.get(lane_axis, 1)
    width = WORDS32 // lanes
    if lanes * width != WORDS32 or width not in kernels.ROW_WIDTHS:
        raise ValueError(f"a {lanes}-way lane axis gives {WORDS32 / lanes} "
                         f"words a shard; B1 takes {kernels.ROW_WIDTHS}")
    return mesh.shape[row_axis], lanes, width


def _lane_coord(mesh: Mesh, i: int, lane_axis: str) -> int:
    return mesh.coord(i, lane_axis) if lane_axis in mesh.shape else 0


def _assemble_lanes(mesh: Mesh, acc: dict, row_axis: str,
                    lane_axis: str) -> torch.Tensor:
    """The full-width rows, on the lead shard's device, from the lane
    shards' slices (equal along the row axis after the butterfly).  Across
    processes each shard places its slice into zero rows and an OR
    butterfly over the lanes completes them."""
    lanes = mesh.shape.get(lane_axis, 1)
    dev = mesh.device_of(mesh.lead())
    if lanes == 1:
        return acc[mesh.lead()].to(dev)
    width = WORDS32 // lanes
    if not mesh.multi_process:
        row0 = [i for i in sorted(acc) if mesh.coord(i, row_axis) == 0]
        row0.sort(key=lambda i: _lane_coord(mesh, i, lane_axis))
        return torch.cat([acc[i].to(dev) for i in row0], dim=1)
    full = {}
    for i, a in acc.items():
        l = _lane_coord(mesh, i, lane_axis)
        z = a.new_zeros((a.shape[0], WORDS32))
        z[:, l * width:(l + 1) * width] = a
        full[i] = z
    full = _butterfly_combine("or", full, mesh, lane_axis)
    return full[mesh.lead()].to(dev)


def make_sharded_aggregator(mesh: Mesh, op: str, num_keys: int, n_steps: int,
                            row_axis: str = "rows", lane_axis: str = "lanes"):
    """The sharded wide OR/XOR step for ``num_keys`` keys: ``step(words,
    seg_ids)`` takes per-shard int32[M_s, W] rows and their sorted segment
    ids (dicts by shard) and returns (int32[K, 2048] heads, int32[K] cards)
    on the lead shard's device.  B1 reduces each shard's rows at width W;
    the butterfly over ``row_axis`` combines them.  ``n_steps`` (the JAX
    doubling depth) is accepted for the signature: B1 needs none.  AND
    goes through :func:`wide_and_sharded`: a ragged segment missing from
    a shard would read as zero."""
    if op not in ("or", "xor"):
        raise ValueError("sharded ragged aggregation supports or/xor only")
    if num_keys > MAX_KEYS_PER_SHARD_PASS:
        raise ShardedKeyBudgetError(
            f"{num_keys} keys would allocate a "
            f"{(num_keys + 1) * 8 // 1024} MiB accumulator on EVERY "
            f"row shard (ceiling {MAX_KEYS_PER_SHARD_PASS} keys = "
            f"{(MAX_KEYS_PER_SHARD_PASS + 1) * 8 // 1024} MiB); use "
            "wide_aggregate_sharded, which chunks the key axis under the "
            "ceiling")
    _axes(mesh, row_axis, lane_axis)

    def step(words: dict, seg_ids: dict):
        acc = {i: kernels.segmented_reduce(op, words[i], seg_ids[i],
                                           num_keys)[0] for i in words}
        acc = _butterfly_combine(op, acc, mesh, row_axis)
        heads = _assemble_lanes(mesh, acc, row_axis, lane_axis)
        return heads, popcount(heads)

    return step


def _shard_rows(mesh: Mesh, words: np.ndarray, seg_ids: np.ndarray,
                scratch_seg: int, row_axis: str = "rows",
                lane_axis: str = "lanes") -> tuple:
    """Pad rows to a row-axis multiple (padding rows target the scratch
    segment) and place each local shard's (row block, lane slice) on its
    device.  Returns ({shard: int32[M/R, W]}, {shard: int32[M/R]})."""
    n_rows, _lanes, width = _axes(mesh, row_axis, lane_axis)
    m_pad = max(-(-words.shape[0] // n_rows) * n_rows, n_rows)
    if m_pad != words.shape[0]:
        extra = m_pad - words.shape[0]
        words = np.concatenate([words, np.zeros((extra, WORDS32), np.uint32)])
        seg_ids = np.concatenate(
            [seg_ids, np.full(extra, scratch_seg, np.int32)])
    m = m_pad // n_rows
    w_out, s_out = {}, {}
    for i in mesh.local():
        r = mesh.coord(i, row_axis)
        l = _lane_coord(mesh, i, lane_axis)
        dev = mesh.device_of(i)
        w_out[i] = as_i32(words[r * m:(r + 1) * m, l * width:(l + 1) * width],
                          dev)
        s_out[i] = as_i32(seg_ids[r * m:(r + 1) * m], dev)
    return w_out, s_out


def shard_packed(mesh: Mesh, packed: packing.PackedAggregation,
                 row_axis: str = "rows", lane_axis: str = "lanes"):
    """A dense pack placed over the mesh (see :func:`_shard_rows`)."""
    return _shard_rows(mesh, packed.words, packed.seg_ids, packed.num_keys,
                       row_axis, lane_axis)


def _key_chunks(num_keys: int) -> list:
    step = MAX_KEYS_PER_SHARD_PASS
    return [(k, min(k + step, num_keys)) for k in range(0, num_keys, step)]


def _slice_blocked(blocked: packing.PackedBlockedCompact, k0: int, k1: int
                   ) -> packing.PackedBlockedCompact:
    """Key-range [k0, k1) slice of a blocked compact pack: a contiguous
    block range whose streams are re-based to row 0."""
    block = blocked.block
    b0 = int(np.searchsorted(blocked.blk_seg, k0, side="left"))
    b1 = int(np.searchsorted(blocked.blk_seg, k1, side="left"))
    row0, row1 = b0 * block, b1 * block
    s = blocked.streams
    dm = (s.dense_dest >= row0) & (s.dense_dest < row1)
    heads = np.concatenate(([0], np.cumsum(s.val_counts)))
    vi = np.flatnonzero((s.val_dest >= row0) & (s.val_dest < row1))
    values = (np.concatenate([s.values[heads[i]:heads[i + 1]] for i in vi])
              if vi.size else np.empty(0, np.uint16))
    streams = packing.CompactStreams(
        n_rows=row1 - row0,
        dense_words=s.dense_words[dm],
        dense_dest=(s.dense_dest[dm] - row0).astype(np.int32),
        values=values,
        val_counts=s.val_counts[vi].astype(np.int32),
        val_dest=(s.val_dest[vi] - row0).astype(np.int32))
    return packing.PackedBlockedCompact(
        keys=blocked.keys[k0:k1],
        blk_seg=(blocked.blk_seg[b0:b1] - k0).astype(np.int32),
        block=block, n_blocks=b1 - b0,
        seg_sizes=blocked.seg_sizes[k0:k1],
        seg_offsets=blocked.seg_offsets[k0:k1] - row0,
        streams=streams, carry_row=-1)


def _split_streams_by_shard(s: packing.CompactStreams, rows_per_shard: int,
                            d: int):
    """Compact streams partitioned by destination row shard, each padded to
    the cross-shard maximum (padding targets the per-shard scratch row
    ``rows_per_shard``, the densify's sentinel)."""
    sh = s.dense_dest // rows_per_shard
    md = int(np.bincount(sh, minlength=d).max()) if sh.size else 0
    dense_words = np.zeros((d, max(md, 1), WORDS32), np.uint32)
    dense_dest = np.full((d, max(md, 1)), rows_per_shard, np.int32)
    for k in range(d):
        rows = np.flatnonzero(sh == k)
        dense_words[k, :rows.size] = s.dense_words[rows]
        dense_dest[k, :rows.size] = s.dense_dest[rows] - k * rows_per_shard
    heads = np.concatenate(([0], np.cumsum(s.val_counts)))
    shv = s.val_dest // rows_per_shard
    mv = int(np.bincount(shv, minlength=d).max()) if shv.size else 0
    vmax = 0
    per_shard: list = []
    for k in range(d):
        idx = np.flatnonzero(shv == k)
        vals = (np.concatenate([s.values[heads[i]:heads[i + 1]]
                                for i in idx])
                if idx.size else np.empty(0, np.uint16))
        per_shard.append((vals, s.val_counts[idx],
                          s.val_dest[idx] - k * rows_per_shard))
        vmax = max(vmax, vals.size)
    values = np.zeros((d, max(vmax, 1)), np.uint16)
    val_counts = np.zeros((d, max(mv, 1) + 1), np.int32)
    val_dest = np.full((d, max(mv, 1) + 1), rows_per_shard, np.int32)
    for k, (vals, counts, dests) in enumerate(per_shard):
        values[k, :vals.size] = vals
        val_counts[k, :counts.size] = counts
        val_counts[k, -1] = values.shape[1] - vals.size  # sentinel soak
        val_dest[k, :dests.size] = dests
    return dense_words, dense_dest, values, val_counts, val_dest


def shard_streams(mesh: Mesh, blocked: packing.PackedBlockedCompact,
                  row_axis: str = "rows", lane_axis: str = "lanes"):
    """Compact ingest: ship each row shard its compact streams and densify
    them there (``kernels.row_build``: B8 on the card), so the host
    never builds the dense image.  Returns ({shard: int32[rows/R, W]},
    {shard: int32[rows/R]} segment ids, the padded block -> segment
    map)."""
    d, _lanes, width = _axes(mesh, row_axis, lane_axis)
    block, k = blocked.block, blocked.keys.size
    nb = int(blocked.blk_seg.size)
    nb_pad = max(-(-nb // d) * d, d)
    blk_seg = np.full(nb_pad, k, np.int32)
    blk_seg[:nb] = blocked.blk_seg
    rows_per_shard = nb_pad * block // d
    parts = _split_streams_by_shard(blocked.streams, rows_per_shard, d)
    total_values = int(parts[2].shape[1])
    seg_rows = np.repeat(blk_seg, block).astype(np.int32)
    images: dict = {}
    w_out, s_out = {}, {}
    for i in mesh.local():
        r = mesh.coord(i, row_axis)
        l = _lane_coord(mesh, i, lane_axis)
        dev = mesh.device_of(i)
        img = images.get((r, dev))
        if img is None:
            dw, dd, v, vc, vd = (p[r] for p in parts)
            img = images[(r, dev)] = kernels.row_build(
                as_i32(dw, dev), as_i32(dd, dev),
                as_i32(v.astype(np.int32), dev), as_i32(vc, dev),
                as_i32(vd, dev), rows_per_shard, total_values)
        w_out[i] = img[:, l * width:(l + 1) * width].contiguous()
        s_out[i] = as_i32(seg_rows[r * rows_per_shard:
                                   (r + 1) * rows_per_shard], dev)
    return w_out, s_out, blk_seg


def _check_op(op: str, ingest: str) -> None:
    if ingest not in ("dense", "compact"):
        raise ValueError(f"unknown ingest {ingest!r}")
    if op not in ("or", "xor", "and"):
        raise ValueError(f"unsupported sharded wide op {op!r}")


def wide_aggregate_sharded(mesh: Mesh, op: str, bitmaps,
                           ingest: str = "dense", fallback: bool = True
                           ) -> tuple:
    """End to end: pack, shard, reduce across the mesh.  Returns (keys,
    u32[K, 2048] words, i32[K] cards) as host arrays.

    ``ingest="dense"`` densifies on the host and ships rows;
    ``ingest="compact"`` ships compact streams and densifies per shard.
    AND goes through the key-intersection path for either ingest.  The
    inputs may be bitmaps (either tier) or their serialized bytes.

    Guarded (``runtime.guard``): a classified mesh fault retries, then on
    CPU shards lands on the host fold (an equivalent triple, zero-card keys
    dropped); on the card the chain is the sharded rung alone and the fault
    re-raises typed.  ``fallback=False`` runs the sharded path raw."""
    _check_op(op, ingest)
    from ..runtime import faults, guard

    bitmaps = list(bitmaps)
    with obs_trace.span("sharding.wide_aggregate", site="sharding", op=op,
                        ingest=ingest, n=len(bitmaps), devices=mesh.size,
                        fallback=fallback) as sp:
        if not fallback:
            return _wide_aggregate_sharded_device(mesh, op, bitmaps, ingest)

        def attempt(rung):
            faults.maybe_fail("sharding", rung)
            return _wide_aggregate_sharded_device(mesh, op, bitmaps, ingest)

        res, rung = guard.run_with_fallback(
            "sharding", guard.chain_from(
                "sharded", ("sharded",), mesh.device_of(mesh.lead())),
            attempt, sequential=lambda: _sequential_sharded(op, bitmaps))
        sp.tag(rung_used=rung)
        return res


def explain_sharded(mesh: Mesh, op: str, bitmaps,
                    ingest: str = "dense") -> dict:
    """Plan report of :func:`wide_aggregate_sharded`: the key-chunk
    schedule under the per-shard ceiling and each pass's per-shard
    accumulator bytes.  JSON-serializable; no device work."""
    from ..insights import analysis as insights
    from ..runtime import guard

    bitmaps = _wrap_bytes(list(bitmaps))
    keys = (np.unique(np.concatenate([np.asarray(b.keys) for b in bitmaps]))
            if bitmaps else np.empty(0, np.uint16))
    passes = [{"keys": [int(k0), int(k1)],
               "per_device_accumulator_bytes":
                   insights.dense_rows_bytes(k1 - k0 + 1)}
              for k0, k1 in _key_chunks(int(keys.size))] or [
        {"keys": [0, 0], "per_device_accumulator_bytes": 0}]
    peak = max(p["per_device_accumulator_bytes"] for p in passes)
    lead = mesh.device_of(mesh.lead())
    budget = guard.resolve_hbm_budget(None, lead)
    chain = guard.chain_from("sharded", ("sharded",), lead)
    return {
        "site": "sharding", "op": op, "ingest": ingest,
        "n": len(bitmaps), "devices": mesh.size,
        "num_keys": int(keys.size), "passes": passes,
        "max_keys_per_pass": MAX_KEYS_PER_SHARD_PASS,
        "predicted_hbm_bytes": int(peak),
        "hbm_budget_bytes": budget,
        "within_budget": budget is None or peak <= budget,
        "engine_chain": list(chain),
    }


def _empty_triple(key_dtype=np.uint16) -> tuple:
    return (np.empty(0, key_dtype), np.zeros((0, WORDS32), np.uint32),
            np.zeros((0,), np.int32))


def _sequential_sharded(op: str, bitmaps) -> tuple:
    """The host fold shaped like the device result: (keys, words, cards)."""
    from .aggregation import _sequential_reduce

    bs = _wrap_bytes(bitmaps)
    if not bs:
        return _empty_triple()
    if op == "and" and any(b.is_empty() for b in bs):
        return _empty_triple()
    if op != "and":
        bs = [b for b in bs if not b.is_empty()]
        if not bs:
            return _empty_triple()
    acc = _sequential_reduce(op, bs)
    if acc.is_empty():
        return _empty_triple()
    packed = packing.pack_for_aggregation([acc], pad_rows=False)
    words = np.asarray(packed.words, dtype=np.uint32)
    cards = np.unpackbits(words.view(np.uint8), axis=1).sum(
        axis=1).astype(np.int32)
    return packed.keys, words, cards


def _concat_chunks(parts: list, empty_shape, dtype) -> np.ndarray:
    if not parts:
        return np.zeros(empty_shape, dtype)
    return parts[0] if len(parts) == 1 else np.concatenate(parts)


def _wide_aggregate_sharded_device(mesh: Mesh, op: str, bitmaps,
                                   ingest: str) -> tuple:
    if op == "and":
        return wide_and_sharded(mesh, _wrap_bytes(bitmaps))
    if ingest == "dense":
        bitmaps = _wrap_bytes(bitmaps)
    heads_parts, cards_parts = [], []
    if ingest == "compact":
        blocked = packing.pack_blocked_compact(bitmaps, carry_slot=False)
        for k0, k1 in _key_chunks(blocked.keys.size):
            sub = (blocked if (k0, k1) == (0, blocked.keys.size)
                   else _slice_blocked(blocked, k0, k1))
            words_d, segs_d, _ = shard_streams(mesh, sub)
            step = make_sharded_aggregator(mesh, op, sub.keys.size, 1)
            heads, cards = step(words_d, segs_d)
            heads_parts.append(to_u32(heads))
            cards_parts.append(cards.cpu().numpy())
        return (blocked.keys,
                _concat_chunks(heads_parts, (0, WORDS32), np.uint32),
                _concat_chunks(cards_parts, (0,), np.int32))
    packed = packing.pack_for_aggregation(bitmaps)
    for k0, k1 in _key_chunks(packed.num_keys):
        if (k0, k1) == (0, packed.num_keys):
            words_d, segs_d = shard_packed(mesh, packed)
        else:
            row0 = int(packed.head_idx[k0])
            row1 = (int(packed.head_idx[k1]) if k1 < packed.num_keys
                    else packed.m)
            words_d, segs_d = _shard_rows(
                mesh, packed.words[row0:row1],
                (packed.seg_ids[row0:row1] - k0).astype(np.int32), k1 - k0)
        step = make_sharded_aggregator(mesh, op, k1 - k0, 1)
        heads, cards = step(words_d, segs_d)
        heads_parts.append(to_u32(heads))
        cards_parts.append(cards.cpu().numpy())
    return (packed.keys,
            _concat_chunks(heads_parts, (0, WORDS32), np.uint32),
            _concat_chunks(cards_parts, (0,), np.int32))


def _pad_to_multiple(arr: np.ndarray, multiple: int, fill,
                     axis: int = 0) -> np.ndarray:
    pad = -(-arr.shape[axis] // multiple) * multiple - arr.shape[axis]
    if pad == 0:
        return arr
    shape = list(arr.shape)
    shape[axis] = pad
    return np.concatenate([arr, np.full(shape, fill, arr.dtype)], axis=axis)


def make_sharded_and(mesh: Mesh, row_axis: str = "rows",
                     lane_axis: str = "lanes"):
    """The sharded wide AND over a regular block: ``step(blocks)`` takes
    per-shard int32[K, N/R, W] bitmap slices (padding bitmaps all ones, the
    AND identity), reduces each on B1 (one segment a key, every segment
    present), combines with an AND butterfly over ``row_axis`` and returns
    (int32[K, 2048], int32[K]) on the lead shard's device."""
    _axes(mesh, row_axis, lane_axis)

    def step(blocks: dict):
        acc = {}
        for i, blk in blocks.items():
            k, n, w = blk.shape
            seg = torch.arange(k, dtype=torch.int32,
                               device=blk.device).repeat_interleave(n)
            acc[i] = kernels.segmented_reduce(
                "and", blk.reshape(k * n, w), seg, k)[0]
        acc = _butterfly_combine("and", acc, mesh, row_axis)
        heads = _assemble_lanes(mesh, acc, row_axis, lane_axis)
        return heads, popcount(heads)

    return step


def _wrap_bytes(bitmaps) -> list:
    """Serialized sources (bytes or a ``format.spec.SerializedView``) ->
    zero-copy ``ImmutableRoaringBitmap``s (headers parsed, payloads left in
    the buffer), for the object consumers: the AND runs its key
    intersection first and decodes only the containers that survive."""
    from ..buffer import ImmutableRoaringBitmap
    from ..format import spec

    out = []
    for b in bitmaps:
        if isinstance(b, (bytes, bytearray, memoryview)):
            out.append(ImmutableRoaringBitmap(b))
        elif isinstance(b, spec.SerializedView):
            out.append(ImmutableRoaringBitmap(b.buf))
        else:
            out.append(b)
    return out


def wide_and_sharded(mesh: Mesh, bitmaps, row_axis: str = "rows",
                     lane_axis: str = "lanes") -> tuple:
    """Sharded workShyAnd: the key intersection on the host, then the
    bitmap axis split over ``row_axis`` and the AND butterfly.  Returns
    (keys, words, cards)."""
    from .aggregation import _intersect_keys

    if not bitmaps or any(b.is_empty() for b in bitmaps):
        return _empty_triple()
    keys = _intersect_keys(bitmaps)
    if keys.size == 0:
        return (keys, np.zeros((0, WORDS32), np.uint32),
                np.zeros((0,), np.int32))
    n_rows, _lanes, width = _axes(mesh, row_axis, lane_axis)
    packed = packing.pack_for_intersection(bitmaps, keys=keys)
    words = _pad_to_multiple(packed.words, n_rows, np.uint32(0xFFFFFFFF),
                             axis=1)
    n = words.shape[1] // n_rows
    blocks = {}
    for i in mesh.local():
        r = mesh.coord(i, row_axis)
        l = _lane_coord(mesh, i, lane_axis)
        blocks[i] = as_i32(words[:, r * n:(r + 1) * n,
                                 l * width:(l + 1) * width],
                           mesh.device_of(i))
    heads, cards = make_sharded_and(mesh, row_axis, lane_axis)(blocks)
    return packed.keys, to_u32(heads), cards.cpu().numpy()


# ---------------------------------------------------------- sharded BSI
#
# BSI / RangeBitmap slices u32[S, K, 2048] put the container-key axis on
# "rows" and the word axis on "lanes".  The O'Neil scan is elementwise
# over [K, 2048], so each comparator runs with no communication; only the
# cardinalities add across shards (and top-k's per-slice candidate count).

def _shard_index(mesh: Mesh, ebm_np: np.ndarray, slices_np: np.ndarray,
                 row_axis: str, lane_axis: str) -> tuple:
    """Pad the key rows to a row-axis multiple (zero rows hold no member)
    and place each local shard's (key rows, lane slice) of the existence
    rows and the slice planes.  Returns ({shard: ebm}, {shard: slices})."""
    r_n, _lanes, width = _axes(mesh, row_axis, lane_axis)
    k = ebm_np.shape[0]
    kpad = max(-(-k // r_n) * r_n, r_n)
    if kpad != k:
        ebm_np = np.concatenate(
            [ebm_np, np.zeros((kpad - k, WORDS32), np.uint32)])
        slices_np = np.concatenate(
            [slices_np, np.zeros((slices_np.shape[0], kpad - k, WORDS32),
                                 np.uint32)], axis=1)
    kr = kpad // r_n
    ebm, slices = {}, {}
    for i in mesh.local():
        r = mesh.coord(i, row_axis)
        l = _lane_coord(mesh, i, lane_axis)
        dev = mesh.device_of(i)
        cols = slice(l * width, (l + 1) * width)
        ebm[i] = as_i32(ebm_np[r * kr:(r + 1) * kr, cols], dev)
        slices[i] = as_i32(slices_np[:, r * kr:(r + 1) * kr, cols], dev)
    return ebm, slices


def _card_sum(mesh: Mesh, words: dict) -> int:
    return int(_sum_local(mesh, {i: popcount(w).sum(dtype=torch.int64)
                                 for i, w in words.items()}))


class ShardedBSI:
    """A ``RoaringBitmapSliceIndex`` sharded over a mesh (the multi-device
    form of ``bsi.device.DeviceBSI``): key rows data-parallel, words
    tensor-parallel; predicates stay host bits."""

    def __init__(self, mesh: Mesh, bsi, row_axis: str = "rows",
                 lane_axis: str = "lanes"):
        from ..bsi import device as bsi_dev

        self.mesh = mesh
        self.row_axis, self.lane_axis = row_axis, lane_axis
        self.depth = bsi.bit_count()
        self.min_value, self.max_value = bsi.min_value, bsi.max_value
        self._ebm_card = bsi.ebm.cardinality
        keys = bsi.ebm.keys.copy()
        ebm_np = bsi_dev._densify(bsi.ebm, keys)
        slices_np = (np.stack([bsi_dev._densify(s, keys) for s in bsi.slices])
                     if bsi.slices else
                     np.zeros((0,) + ebm_np.shape, np.uint32))
        self.keys = keys
        self.ebm, self.slices = _shard_index(mesh, ebm_np, slices_np,
                                             row_axis, lane_axis)

    def _bits(self, predicate: int) -> np.ndarray:
        from ..bsi.device import predicate_bits

        return predicate_bits(predicate, self.depth)

    def compare_cardinality(self, op, start_or_value: int,
                            end: int = 0) -> int:
        """Cardinality of the compare over the whole mesh (found set =
        ebm); min/max pruning and RANGE clamping as the host comparator."""
        from ..bsi.device import _compare_res
        from ..bsi.slice_index import clamp_range_bounds, minmax_decision

        decision = minmax_decision(op, start_or_value, end,
                                   self.min_value, self.max_value)
        if decision == "empty":
            return 0
        if decision == "all":
            return self._ebm_card
        start_or_value, end = clamp_range_bounds(
            op, start_or_value, end, self.min_value, self.max_value)
        a, b = self._bits(start_or_value), self._bits(end)
        return _card_sum(self.mesh, {
            i: _compare_res(op.value, self.slices[i], e, a, b, e)
            for i, e in self.ebm.items()})

    def sum(self) -> tuple:
        """(sum of values, member count): per-slice popcounts added over
        the mesh, weighted by 2^i in Python ints."""
        from ..bsi.device import _slice_cards_res, _weighted_total

        cards = _sum_local(self.mesh, {
            i: _slice_cards_res(self.slices[i], e)
            for i, e in self.ebm.items()})
        return (_weighted_total(cards.cpu().numpy()),
                _card_sum(self.mesh, self.ebm))

    def top_k_cardinality(self, k: int) -> int:
        """Pre-trim cardinality of the Kaser top-K candidate set (>= k when
        the last slice ties; ``DeviceBSI``'s device cardinality): the scan
        is shard-local but for each slice's candidate count, which adds
        over the mesh (on the device, no host sync a step)."""
        g = {i: torch.zeros_like(e) for i, e in self.ebm.items()}
        e = dict(self.ebm)
        for s in range(self.depth - 1, -1, -1):
            x = {i: g[i] | (e[i] & self.slices[i][s]) for i in e}
            n = _sum_local(self.mesh, {
                i: popcount(v).sum(dtype=torch.int64) for i, v in x.items()})
            take = n < k
            for i in e:
                t = take.to(x[i].device)
                w = self.slices[i][s]
                g[i] = torch.where(t, x[i], g[i])
                e[i] = torch.where(t, e[i] & ~w, e[i] & w)
        return _card_sum(self.mesh, {i: g[i] | e[i] for i in e})


class ShardedRangeBitmap:
    """A ``core.rangebitmap.RangeBitmap`` sharded over a mesh (layout of
    :class:`ShardedBSI`; a RangeBitmap is a base-2 BSI over row ids with an
    implicit all-rows existence set)."""

    def __init__(self, mesh: Mesh, rb, row_axis: str = "rows",
                 lane_axis: str = "lanes"):
        from ..bsi import device as bsi_dev
        from ..core.bitmap import RoaringBitmap
        from ..core.rangebitmap import RangeBitmap as HostRangeBitmap

        if not isinstance(rb, HostRangeBitmap):
            raise TypeError(
                f"ShardedRangeBitmap needs a core.rangebitmap.RangeBitmap, "
                f"got {type(rb).__name__}")
        self.mesh = mesh
        self.row_axis, self.lane_axis = row_axis, lane_axis
        self.rows = rb.row_count
        self.max_value = rb.max_value
        self.depth = len(rb.slices)
        all_rows = RoaringBitmap.from_range(0, self.rows)
        keys = all_rows.keys.copy()
        ebm_np = bsi_dev._densify(all_rows, keys)
        slices_np = (np.stack([bsi_dev._densify(s, keys) for s in rb.slices])
                     if rb.slices else
                     np.zeros((0,) + ebm_np.shape, np.uint32))
        self.keys = keys
        self.ebm, self.slices = _shard_index(mesh, ebm_np, slices_np,
                                             row_axis, lane_axis)

    def _query_cardinality(self, op: str, a: int, b: int = 0) -> int:
        from ..bsi.device import _range_res, predicate_bits

        ba, bb = predicate_bits(a, self.depth), predicate_bits(b, self.depth)
        return _card_sum(self.mesh, {
            i: _range_res(op, self.slices[i], e, ba, bb, e)
            for i, e in self.ebm.items()})

    def lte_cardinality(self, threshold: int) -> int:
        if threshold < 0:
            return 0
        if threshold >= self.max_value:
            return self.rows
        return self._query_cardinality("lte", threshold)

    def lt_cardinality(self, threshold: int) -> int:
        return self.lte_cardinality(threshold - 1)

    def gte_cardinality(self, threshold: int) -> int:
        if threshold <= 0:
            return self.rows
        if threshold > self.max_value:
            return 0
        return self._query_cardinality("gte", threshold)

    def gt_cardinality(self, threshold: int) -> int:
        return self.gte_cardinality(threshold + 1)

    def eq_cardinality(self, value: int) -> int:
        if value < 0 or value > self.max_value:
            return 0
        return self._query_cardinality("eq", value)

    def neq_cardinality(self, value: int) -> int:
        return self.rows - self.eq_cardinality(value)

    def between_cardinality(self, lo: int, hi: int) -> int:
        lo, hi = max(lo, 0), min(hi, self.max_value)
        if lo > hi:
            return 0
        if lo <= 0 and hi >= self.max_value:
            return self.rows
        return self._query_cardinality("between", lo, hi)
