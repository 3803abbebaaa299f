"""Mesh-sharded pooled batch serving (``roaringbitmap_tpu.parallel
.sharded_engine``): the pooled engine's query pools over a mesh of shards.

The pooled resident image is placed once over the mesh: ``sharded`` splits
its rows over the ``rows`` axis (replicated along ``data``), ``replicated``
holds a full copy per device, ``auto`` replicates pools up to
``REPLICATE_MAX_BYTES``.  The image is built on the device from each
tenant's resident words (B3 rebuilds a compact tenant's rows; nothing goes
through the host) and held in the HBM ledger as ``sharded_pool`` at the
bytes the devices hold: shards of one device share one image.

Execution model
---------------
Planning is the pooled planner one level down (per-set row selection,
global pooled-row offsets, ``plan_bucket`` shape buckets, the per-op merge
into one flat segmented reduce) plus a flat-row pad to a multiple of the
device count.  Each op group then runs as:

1. a per-shard reduce on B1 into an accumulator that starts as the op's
   identity: every segment a shard holds no row of is set to all ones for
   AND afterwards (B1 writes zero there), so the combine cannot annihilate;
2. the butterfly combine per mesh axis (``parallel.sharding``), after
   which every shard holds the exact reduction;
3. the post passes on the replicated side: presence/keep masks, the andnot
   head pass, popcount.

Which rows a shard reduces: when every shard's device holds the whole
image (a replicated pool, or a sharded one whose shards share a device)
the flat rows split by position, as the JAX package's ``gather_rows``
spec splits them; the shards of one device index one tensor.  Otherwise
(shards on other processes or devices) each shard reduces the rows its own
row shard holds, split along ``data`` (owner computes): GSPMD's
cross-shard gather has no PyTorch counterpart.  Rows the replicated side
needs in full (the andnot heads, the fused sections' resident leaves) come
back through an OR butterfly over zero rows that each owner fills.  The
result never depends on the mesh shape: the ops are associative and
commutative, and the tests hold 1x1 to 8x1 and 2x2 equal.

Fused expressions run on B5 in **combine mode**
(``megakernel.build_combines``): bank 0 is the combined flat heads of the
groups that produce them, bank 1 the gathered leaves and the ad-hoc rows;
one launch a dispatch.  Sections past B5's capacity are halved, in order,
until every part fits, one combine-mode launch a part; a section that does
not fit on its own is counted as a capacity demotion, and the launch raises
``EngineLoweringError``, which demotes it to ``single``.

Guard, budget, lattice
----------------------
Every launch runs down ``mesh -> single`` (the un-sharded pooled engine
over the same adopted ``BatchEngine``\\ s, on its kernel rungs), and on
CPU shards on to the host ``sequential`` fold; on the card a fault both
rungs fail to absorb raises typed.  ``ResourceExhausted`` halves the pool;
the proactive split halves it while the per-shard prediction
(``insights.predict_sharded_dispatch_bytes``) passes the per-device
budget.  Under an active lattice a snapped plan replays a captured CUDA
graph (``runtime.programs``) when the mesh is one device in one process;
a mesh over processes or several devices runs eagerly (a graph cannot
capture a ``torch.distributed`` exchange), and its lattice report says so.

Observability: the JAX package's ``sharded.*`` spans, the ``batch.shard``
event, the ``sharded.memory`` / ``sharded.cost`` events and the
``rb_shard_balance`` / ``rb_sharded_*`` metrics.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..insights import analysis as insights
from ..obs import cost as obs_cost
from ..obs import memory as obs_memory
from ..obs import metrics as obs_metrics
from ..obs import slo as obs_slo
from ..obs import trace as obs_trace
from ..ops import kernels, megakernel, packing
from ..ops.words import WORDS32, popcount, resolve_device, upload
from ..runtime import errors, faults, guard
from ..runtime import lattice as rt_lattice
from ..runtime import programs as rt_programs
from ..runtime import warmup as rt_warmup
from ..runtime.cache import LRUCache
from . import expr as expr_mod
from .aggregation import DeviceBitmapSet, _device_key
from .batch_engine import (PLAN_CACHE_MAX, _RED_OP, BatchEngine, BatchQuery,
                           BatchResult, plan_bucket, plan_padding, query_desc,
                           resolve_query_engine, snap_plan_groups)
from .multiset import (BatchGroup, MultiSetBatchEngine, _merge_op_groups,
                       assemble_pooled_results)
from .sharding import SPECS, Mesh, SpecLayout, _butterfly_combine

#: the guard/trace/metric site of every mesh-sharded dispatch
SITE = "sharded_engine"

#: the sharded fallback ladder (off the card the guard appends the host
#: fold): a mesh fault demotes to the un-sharded pooled engine
ENGINE_LADDER = (guard.MESH, guard.SINGLE_DEVICE)


def default_mesh(devices=None, data: int = 1, specs: SpecLayout = SPECS,
                 ranks=None) -> Mesh:
    """A (rows x data) mesh over the largest power-of-two prefix of
    ``devices`` (default: every visible card; a device may repeat).  Both
    axes must be powers of two: the butterfly pairs partners by XOR.
    ``ranks`` gives each device's owner process in a multi-process mesh."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = ([torch.device("cuda", i) for i in range(n)] if n
                   else [resolve_device(None)])
    devices = list(devices)
    if data < 1 or data & (data - 1):
        raise ValueError(f"data axis size must be a power of two: {data}")
    if len(devices) < data:
        raise ValueError(f"data axis size {data} needs at least {data} "
                         f"devices, got {len(devices)}")
    rows = 1
    while rows * 2 * data <= len(devices):
        rows *= 2
    n = rows * data
    arr = np.empty((rows, data), dtype=object)
    for i, d in enumerate(devices[:n]):
        arr.flat[i] = d
    rk = None if ranks is None else np.asarray(list(ranks)[:n]).reshape(
        rows, data)
    return Mesh(arr, (specs.row_axis, specs.data_axis), ranks=rk)


def _check_mesh(mesh: Mesh, specs: SpecLayout) -> Mesh:
    for axis in (specs.row_axis, specs.data_axis):
        if axis not in mesh.axis_names:
            raise ValueError(f"sharded engine mesh needs a {axis!r} axis, "
                             f"got {mesh.axis_names}")
        n = mesh.shape[axis]
        if n & (n - 1):
            raise ValueError(
                f"mesh axis {axis!r} size must be a power of two for the "
                f"butterfly combine, got {n}")
    return mesh


@dataclasses.dataclass
class _ShardedPlan:
    """One mesh-sharded pooled plan: the shape buckets and per-op groups,
    each group's replicated post-pass operands (``padded``: the masks and
    andnot's head rows), its device-count-padded flat row count
    (``n_pads``), and each local shard's rows of it (``shards``: {shard:
    {"idx", "valid", "seg", "present"}}).  ``megas`` holds the fused
    sections' B5 combine-mode streams in section order, one a launch (each
    with its resident leaf rows in ``host["leafidx"]``), or None when a
    section does not fit B5 on its own."""

    buckets: list
    op_groups: list
    sids: tuple
    padded: list
    n_pads: tuple
    shards: list = dataclasses.field(default_factory=list)
    exprs: list = dataclasses.field(default_factory=list)
    owner: dict = dataclasses.field(default_factory=dict)
    rb_meta: dict = dataclasses.field(default_factory=dict)
    megas: tuple | None = ()
    point: object = None
    padding: tuple = (0, 0.0)
    predicted: dict | None = None
    packs: dict = dataclasses.field(default_factory=dict)
    _arrays: dict | None = None

    @property
    def fused(self) -> list:
        return expr_mod.fused_of(self.exprs)

    @property
    def expr_signature(self) -> tuple:
        return expr_mod.signature_of(self.exprs)

    @property
    def signature(self):
        # gathers are global pooled rows, so under a lattice the tenant mix
        # drops out of the signature (the JAX package's key)
        return (self.sids if self.point is None else ("lattice",),
                self.n_pads,
                tuple(g.sig for g in self.op_groups),
                self.expr_signature)


class ShardedBatchEngine:
    """Plan and execute mixed-op query pools over S resident sets, one
    pooled launch spanning a mesh.

    ``sets`` may mix ``DeviceBitmapSet`` and ``BatchEngine`` instances
    (adopted, as ``MultiSetBatchEngine`` adopts them); a bare single set is
    accepted too.  ``mesh`` defaults to :func:`default_mesh`; its ``rows``
    and ``data`` axes must be powers of two."""

    #: "auto" replicates the pooled image while one copy stays under this
    #: many bytes (64 MiB): the throughput regime; larger pools shard rows
    REPLICATE_MAX_BYTES = 64 << 20

    def __init__(self, sets, mesh: Mesh | None = None,
                 placement: str = "auto", specs: SpecLayout = SPECS,
                 result_cache="env"):
        rt_warmup.enable_compile_cache()
        if isinstance(sets, (DeviceBitmapSet, BatchEngine)):
            sets = [sets]
        if placement not in ("auto", "sharded", "replicated"):
            raise ValueError(f"unknown pool placement {placement!r}")
        self._specs = specs
        self._mesh = (_check_mesh(mesh, specs) if mesh is not None
                      else default_mesh(specs=specs))
        self.mesh_shape = (int(self._mesh.shape[specs.row_axis]),
                           int(self._mesh.shape[specs.data_axis]))
        self.mesh_devices = self.mesh_shape[0] * self.mesh_shape[1]
        self._mesh_label = f"{self.mesh_shape[0]}x{self.mesh_shape[1]}"
        #: the single-device rung and the shadow reference: the un-sharded
        #: pooled engine over the SAME adopted engines
        self._single = MultiSetBatchEngine(sets, result_cache=result_cache)
        self._engines = self._single._engines
        self.device = self._single.device
        self.n_sets = len(self._engines)
        self.result_cache = self._single.result_cache
        self._requested_placement = placement
        self._ledger_handle = None
        self._programs = rt_programs.ProgramCache(self.device, SITE)
        self._place_pool(placement)
        self._plans = LRUCache(PLAN_CACHE_MAX, name="sharded_plans")
        self.split_count = 0
        self.proactive_split_count = 0
        self.launch_count = 0
        self.last_dispatch_memory: dict | None = None
        self.last_dispatch_cost: dict | None = None
        self._first_query_done = False

    @classmethod
    def from_bitmap_sets(cls, bitmap_sets: list, mesh: Mesh | None = None,
                         layout: str = "auto", **kw) -> "ShardedBatchEngine":
        return cls([DeviceBitmapSet(b, layout=layout, **kw)
                    for b in bitmap_sets], mesh=mesh)

    @property
    def capturable(self) -> bool:
        """Whether a snapped plan runs as a captured CUDA graph: the mesh
        is one device, in this process."""
        dev = _device_key(self.device)
        return (not self._mesh.multi_process
                and all(self._mesh.device_of(i) == dev
                        for i in self._mesh.local()))

    # ------------------------------------------------------ pool placement

    @staticmethod
    def _aligned_bases(rows: list, rows_per_shard0: int, r_axis: int):
        """Tenant-aligned row layout of the sharded placement: no tenant
        smaller than a row shard straddles a shard boundary (its delta
        patch is then a one-shard write); larger tenants start aligned.
        Grows the shard until the greedy first-fit layout fits."""
        u = max(1, int(rows_per_shard0))
        while True:
            bases, cur = [], 0
            for n in rows:
                if n and (cur % u) and ((cur % u) + n > u or n > u):
                    cur = -(-cur // u) * u
                bases.append(cur)
                cur += n
            if cur <= u * r_axis:
                return bases, u
            u = -(-cur // r_axis)

    def _place_pool(self, placement: str) -> None:
        """Lay out every tenant's rows in one pooled image and place it
        over the mesh (see the module docstring).  Each device of this
        process holds the whole image when it hosts every row shard (or
        the pool is replicated), else one tensor per row shard it hosts."""
        rows_axis = self.mesh_shape[0]
        self._rows = [int(e._row_src.size) for e in self._engines]
        total = sum(self._rows)
        if placement == "auto":
            placement = ("replicated"
                         if total * insights.ROW_BYTES
                         <= self.REPLICATE_MAX_BYTES else "sharded")
        self.placement = placement
        if placement == "sharded":
            bases, u = self._aligned_bases(
                self._rows, -(-max(total, 1) // rows_axis), rows_axis)
            padded = u * rows_axis
        else:
            bases = np.concatenate(
                ([0], np.cumsum(self._rows)[:-1])).astype(np.int64)
            padded = max(rows_axis, -(-total // rows_axis) * rows_axis)
        end = (int(bases[-1]) + self._rows[-1]) if self._rows else 0
        self._base = np.concatenate((np.asarray(bases, np.int64), [end]))
        live = np.zeros((padded,), bool)
        for b, n in zip(self._base[:-1], self._rows):
            live[int(b):int(b) + n] = True
        self.pool_rows_live = total
        self.pool_rows = padded
        self.rows_per_shard = (padded // rows_axis if placement == "sharded"
                               else padded)
        dead = np.flatnonzero(~live)
        self._pool_pad_row = int(dead[0]) if dead.size else -1
        self._build_holders()
        self._placed_versions = [e._ds.version for e in self._engines]
        self._placed_structures = [e._ds.structure_version
                                   for e in self._engines]
        if placement == "sharded":
            per_shard = np.bincount(np.flatnonzero(live)
                                    // self.rows_per_shard,
                                    minlength=rows_axis)
            mean = float(per_shard.mean()) if total else 1.0
            self.shard_balance = (float(per_shard.max()) / mean
                                  if mean > 0 else 1.0)
        else:
            self.shard_balance = 1.0
        obs_metrics.gauge("rb_shard_balance", site=SITE,
                          mesh=self._mesh_label).set(self.shard_balance)
        if self._ledger_handle is not None:
            obs_memory.LEDGER.release(self._ledger_handle)
        self._ledger_handle = obs_memory.LEDGER.register(
            "sharded_pool", "dense", self.hbm_bytes(), owner=self)
        self._programs.retire()

    def _row_shard(self, i: int) -> int:
        return (self._mesh.coord(i, self._specs.row_axis)
                if self.placement == "sharded" else 0)

    def _build_holders(self) -> None:
        """The placed image's tensors: ``_holders`` is [(device, lo, hi,
        tensor)], ``_full`` the whole-image tensor of each device that has
        one, ``pool_words`` each local shard's rows (a view of its
        holder)."""
        mesh, rps = self._mesh, self.rows_per_shard
        self._holders, self._full, self.pool_words = [], {}, {}
        for dev in mesh.distinct_devices():
            on = [i for i in mesh.local() if mesh.device_of(i) == dev]
            need = sorted({self._row_shard(i) for i in on})
            if self.placement != "sharded" or len(need) == self.mesh_shape[0]:
                t = self._image_rows(dev, 0, self.pool_rows)
                self._holders.append((dev, 0, self.pool_rows, t))
                self._full[dev] = t
                for i in on:
                    r = self._row_shard(i)
                    self.pool_words[i] = t[r * rps:(r + 1) * rps]
                continue
            for r in need:
                t = self._image_rows(dev, r * rps, (r + 1) * rps)
                self._holders.append((dev, r * rps, (r + 1) * rps, t))
                for i in on:
                    if self._row_shard(i) == r:
                        self.pool_words[i] = t

    def _image_rows(self, dev, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) of the pooled image on ``dev``, copied from each
        tenant's resident words on the device (B3 rebuilds a stream
        tenant's image on the card)."""
        out = torch.zeros((hi - lo, WORDS32), dtype=torch.int32, device=dev)
        for e, b, n in zip(self._engines, self._base[:-1], self._rows):
            b, n = int(b), int(n)
            a, z = max(lo, b), min(hi, b + n)
            if a >= z:
                continue
            words = e._words("cuda")
            out[a - lo:z - lo].copy_(words[a - b:z - b])
            del words
        return out

    def hbm_bytes(self) -> int:
        """Bytes the devices of this process hold for the placed image
        (shards of one device share it)."""
        return sum(t.numel() * t.element_size()
                   for _d, _lo, _hi, t in self._holders)

    def pool_shards(self) -> dict:
        """{local shard: its rows of the placed image}."""
        return dict(self.pool_words)

    # ------------------------------------------------------ mutation sync

    def _sync_pool(self) -> None:
        """Bring the placed image up to date with member-set mutations:
        value deltas replay from each set's bounded journal as in-place
        row patches; a structural repack, or a journal that dropped
        entries the image still needs, re-places the pool."""
        stale = False
        for i, e in enumerate(self._engines):
            ds = e._ds
            if ds.structure_version != self._placed_structures[i]:
                stale = True
                break
            if ds.version == self._placed_versions[i]:
                continue
            if ds._journal_dropped_version > self._placed_versions[i]:
                obs_metrics.counter("rb_sharded_journal_overflows_total",
                                    site=SITE).inc()
                obs_trace.current().event(
                    "sharded.journal_overflow", site=SITE, tenant=i,
                    placed_version=int(self._placed_versions[i]),
                    dropped_through=int(ds._journal_dropped_version),
                    version=int(ds.version))
                stale = True
                break
        if stale:
            self._single._sync_with_sets()
            self._place_pool(self._requested_placement)
            return
        for i, e in enumerate(self._engines):
            ds = e._ds
            if ds.version == self._placed_versions[i]:
                continue
            for ver, rows, add_m, rem_m in ds._delta_journal:
                if ver <= self._placed_versions[i]:
                    continue
                self._patch_pool(int(self._base[i]) + rows.astype(np.int64),
                                 add_m, rem_m)
            self._placed_versions[i] = ds.version

    def _patch_pool(self, rows, add_m, rem_m) -> None:
        """One in-place patch of the placed image: each holder writes the
        rows it holds (tenant-aligned placement: one row shard)."""
        p = int(rows.size)
        masks = np.stack((add_m, rem_m), axis=1)
        for dev, lo, hi, t in self._holders:
            sel = np.flatnonzero((rows >= lo) & (rows < hi))
            if not sel.size:
                continue
            idx = upload((rows[sel] - lo).astype(np.int32), dev).long()
            m = upload(masks[sel], dev)
            cur = t.index_select(0, idx)
            cur.bitwise_or_(m[:, 0]).bitwise_and_(m[:, 1].bitwise_not())
            t.index_copy_(0, idx, cur)
        obs_metrics.counter("rb_sharded_pool_patches_total", site=SITE,
                            mesh=self._mesh_label).inc()
        obs_trace.current().event(
            "mutation.pool_patch", site=SITE, rows=p,
            mesh=list(self.mesh_shape), placement=self.placement)

    @property
    def sets(self) -> list:
        return [e._ds for e in self._engines]

    # ------------------------------------------------------------ planning

    def _normalize(self, groups_or_queries):
        """MultiSet-style groups, or a bare BatchQuery list (one tenant):
        returns (groups, bare)."""
        seq = list(groups_or_queries)
        if seq and isinstance(seq[0], (BatchQuery, expr_mod.ExprQuery)):
            return [BatchGroup(0, seq)], True
        return seq, False

    def _position_split(self) -> bool:
        """Whether every local shard's device holds the whole image, so a
        group's flat rows split by position (else by owning row shard)."""
        return all(self._mesh.device_of(i) in self._full
                   for i in self._mesh.local())

    def _plan(self, pooled) -> _ShardedPlan:
        self._sync_pool()
        lat = rt_lattice.active()
        sids = tuple(sorted({sid for sid, _ in pooled}))
        key = (tuple(pooled),
               tuple((self._engines[s]._ds.uid,
                      self._engines[s]._ds.version) for s in sids),
               tuple(self._engines[s]._columns_token() for s in sids),
               rt_lattice.plan_token(), self.pool_rows, self.placement)
        cached = self._plans.get(key)
        if cached is not None:
            return cached
        with obs_slo.phase("plan"), \
                obs_trace.span("sharded.plan", q=len(pooled),
                               sets=len(sids), mesh=self._mesh_label) as sp:
            plan = self._plan_fresh(pooled, lat, sids, sp)
        self._plans.put(key, plan)
        return plan

    def _plan_fresh(self, pooled, lat, sids, sp) -> _ShardedPlan:
        groups: dict = {}
        owner: dict = {}
        sections: list = []
        counter = [0]

        def add_item(sid, pq, own):
            pid = counter[0]
            counter[0] += 1
            rows, segs, keys_q, keep, hrows = \
                self._engines[sid]._plan_query(pq)
            off = int(self._base[sid])
            rows = rows + off
            if hrows is not None:
                hrows = hrows + off
            rung = (0 if lat is not None
                    else packing.next_pow2(max(1, len(set(pq.operands)))))
            groups.setdefault((pq.op, rung), []).append(
                (pid, pq, rows, segs, keys_q, keep, hrows))
            if own is not None:
                owner[pid] = own
            return pid, keys_q

        def plan_leaf(sid, i):
            rows, keys = self._engines[sid]._plan_leaf(i)
            return rows + int(self._base[sid]), keys

        for qid, (sid, q) in enumerate(pooled):
            if isinstance(q, expr_mod.ExprQuery):
                sections.append(expr_mod.compile_query(
                    q, qid,
                    lambda pq, own, sid=sid: add_item(sid, pq, own),
                    lambda i, sid=sid: plan_leaf(sid, i),
                    cache_probe=self._single._cache_probe_for(sid),
                    col_resolve=self._engines[sid]._column))
            else:
                add_item(sid, q, qid)
        pad_to, point = snap_plan_groups(
            lat, groups, sections, any(q.form == "bitmap" for _, q in pooled),
            counter, self._engines[0].keys[:0], placement=self.placement)
        sp.tag(need_q=max((len(i) for i in groups.values()), default=0),
               need_rows=max((it[2].size for i in groups.values()
                              for it in i), default=0),
               need_keys=max((it[4].size for i in groups.values()
                              for it in i), default=0))
        with obs_trace.span("sharded.pool", groups=len(groups)):
            buckets = [plan_bucket(op, items, pad_to=pad_to)
                       for (op, _), items in sorted(groups.items())]
            op_groups = _merge_op_groups(buckets)
            padded, n_pads, shards = [], [], []
            d = self.mesh_devices
            for g in op_groups:
                n = int(g.n_rows)
                n_pad = max(d, -(-n // d) * d)
                gather = np.zeros(n_pad, np.int64)
                gather[:n] = g.host["gather"]
                valid = np.zeros(n_pad, bool)
                valid[:n] = g.host["valid"]
                flat_seg = np.full(n_pad, g.nseg, np.int32)
                flat_seg[:n] = g.host["flat_seg"]
                host = {"mask_ok": g.host["mask_ok"]}
                if g.op == "andnot":
                    host["head_gather"] = g.host["head_gather"]
                    host["head_ok"] = g.host["head_ok"]
                padded.append(host)
                n_pads.append(n_pad)
                shards.append(self._split_group(g, gather, valid, flat_seg))
        expr_mod.finalize_sections(sections, buckets)
        fused = expr_mod.fused_of(sections)
        megas = (_combine_streams(buckets, op_groups, fused,
                                  expr_mod.expr_bucket_ids(fused))
                 if fused else ())
        padding = (plan_padding(buckets, groups)
                   if point is not None else (0, 0.0))
        sp.tag(buckets=len(buckets), op_groups=len(op_groups),
               flat_rows=int(sum(n_pads)), exprs=len(sections),
               mega=bool(megas), snapped=point is not None)
        return _ShardedPlan(
            buckets=buckets, op_groups=op_groups, sids=sids, padded=padded,
            n_pads=tuple(n_pads), shards=shards, exprs=sections,
            owner=owner, megas=megas, point=point, padding=padding)

    def _split_group(self, g, gather, valid, flat_seg) -> dict:
        """Each local shard's rows of one op group: a position chunk of the
        flat rows (global rows into its device's whole image), or the valid
        rows its row shard owns, split along ``data`` (rows local to its
        row shard).  ``present`` marks the segments the shard holds a row
        of: the others take the AND identity after B1."""
        mesh, specs = self._mesh, self._specs
        d = self.mesh_devices
        out = {}
        if self._position_split():
            m = gather.size // d
            for i in mesh.local():
                sl = slice(i * m, (i + 1) * m)
                seg = flat_seg[sl]
                out[i] = {"idx": gather[sl].astype(np.int32),
                          "valid": valid[sl], "seg": seg,
                          "present": _present(seg, g.nseg)}
            return out
        rps = self.rows_per_shard
        ok = np.flatnonzero(valid)
        owner_r = gather[ok] // rps
        n_data = self.mesh_shape[1]
        for i in mesh.local():
            r = mesh.coord(i, specs.row_axis)
            dd = mesh.coord(i, specs.data_axis)
            ent = ok[owner_r == r]
            ent = np.array_split(ent, n_data)[dd]
            seg = flat_seg[ent]
            out[i] = {"idx": (gather[ent] - r * rps).astype(np.int32),
                      "valid": np.ones(ent.size, bool), "seg": seg,
                      "present": _present(seg, g.nseg)}
        return out

    # ------------------------------------------------------------ operands

    def _operand_tree(self, plan: _ShardedPlan) -> dict:
        """The device part's operands as host arrays (and column tensors):
        per group its shards' rows and the replicated masks, and per B5
        stream its leaf rows and its operands."""
        tree = {"g": []}
        for g, host, sh in zip(plan.op_groups, plan.padded, plan.shards):
            ent = {"shards": sh, "mask_ok": host["mask_ok"]}
            if g.op == "andnot":
                ent["head_gather"] = host["head_gather"]
                ent["head_ok"] = host["head_ok"]
            tree["g"].append(ent)
        if plan.megas:
            tree["leaf"] = [m.host["leafidx"] for m in plan.megas]
            tree["m"] = [m.operands(self.device) for m in plan.megas]
        return tree

    def _eager_operands(self, plan: _ShardedPlan) -> dict:
        """The operand tree uploaded once per plan, each shard's arrays to
        its own device (the eager path)."""
        if plan._arrays is not None:
            return plan._arrays
        mesh, dev = self._mesh, self.device
        tree = self._operand_tree(plan)
        ops = {"g": []}
        for ent in tree["g"]:
            up = {k: upload(v, dev) for k, v in ent.items() if k != "shards"}
            up["shards"] = {i: {k: upload(v, mesh.device_of(i))
                                for k, v in a.items()}
                            for i, a in ent["shards"].items()}
            ops["g"].append(up)
        if plan.megas:
            ops["leaf"] = [upload(m.host["leafidx"], dev) for m in plan.megas]
            ops["m"] = [m.device_arrays(dev) for m in plan.megas]
        plan._arrays = ops
        return ops

    def predict_dispatch_bytes(self, groups_or_queries,
                               engine: str = "auto") -> dict:
        """Per-shard and mesh-total transients of ONE sharded launch
        (``insights.predict_sharded_dispatch_bytes``): ``per_shard_bytes``
        is what the proactive split compares with the per-device budget.
        ``engine`` is accepted for the pooled engines' signature."""
        groups, _ = self._normalize(groups_or_queries)
        pooled, _ = self._single._flatten(groups)
        return self._predict(self._plan(tuple(pooled)))

    def predict_dispatch_seconds(self, pooled_or_groups,
                                 engine: str = "auto") -> float:
        """Execute-time estimate of ONE sharded launch: the per-shard
        bytes and word ops over the rates this site's launches achieved
        (``obs.cost``)."""
        seq = list(pooled_or_groups)
        if not seq:
            return 0.0
        if isinstance(seq[0], tuple) and len(seq[0]) == 2 \
                and not isinstance(seq[0], BatchGroup):
            pooled = tuple(seq)
        else:
            groups, _ = self._normalize(seq)
            pooled, _ = self._single._flatten(groups)
        plan = self._plan(tuple(pooled))
        return obs_cost.estimate_seconds(
            self._word_ops(plan), self._predict(plan)["per_shard_bytes"],
            SITE, guard.MESH)

    def _word_ops(self, plan: _ShardedPlan) -> int:
        ops = insights.predict_batch_dispatch_word_ops(
            [b.signature for b in plan.buckets], "dense", 0, "cuda")
        if plan.exprs:
            ops += insights.predict_expr_word_ops(plan.expr_signature, "cuda")
        return ops

    def _predict(self, plan: _ShardedPlan) -> dict:
        if plan.predicted is not None:
            return plan.predicted
        out = insights.predict_sharded_dispatch_bytes(
            [b.signature for b in plan.buckets], self.pool_rows,
            self.mesh_devices,
            self.mesh_shape[0] if self.placement == "sharded" else 1)
        if plan.exprs:
            # the combine side is replicated: it adds to the per-shard
            # figure and D times to the mesh total
            e = insights.predict_expr_dispatch_bytes(
                plan.expr_signature,
                "megakernel" if plan.megas else "cuda"
            )["peak_bytes"]
            out["expr_bytes"] = e
            out["per_shard_bytes"] += e
            out["peak_bytes"] += self.mesh_devices * e
        plan.predicted = out
        return out

    # ---------------------------------------------------------- device part

    def _replicated_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Global pooled rows ``idx`` in full on the lead shard's device:
        an index of the whole image where the device holds one; else each
        shard of data coordinate 0 fills the rows its row shard owns into
        zero rows and an OR butterfly over the mesh completes them."""
        mesh, specs = self._mesh, self._specs
        lead = mesh.lead()
        dev = mesh.device_of(lead)
        full = self._full.get(dev)
        if full is not None:
            return full.index_select(0, idx.to(dev).long())
        rps = self.rows_per_shard
        g = idx.to("cpu").long().numpy()
        acc = {}
        for i in mesh.local():
            di = mesh.device_of(i)
            bank = torch.zeros((g.size, WORDS32), dtype=torch.int32,
                               device=di)
            if mesh.coord(i, specs.data_axis) == 0:
                r = mesh.coord(i, specs.row_axis)
                pos = np.flatnonzero(g // rps == r)
                if pos.size:
                    p = torch.from_numpy(pos).to(di)
                    loc = torch.from_numpy(g[pos] - r * rps).to(di)
                    bank[p] = self.pool_words[i].index_select(0, loc)
            acc[i] = bank
        for axis in (specs.row_axis, specs.data_axis):
            if mesh.shape[axis] > 1:
                acc = _butterfly_combine("or", acc, mesh, axis)
        return acc[lead].to(dev)

    def _shard_source(self, i: int) -> torch.Tensor:
        dev = self._mesh.device_of(i)
        full = self._full.get(dev)
        return full if full is not None and self._position_split() \
            else self.pool_words[i]

    def _group_body(self, g_sig, arrs: dict):
        """One op group over the mesh: B1 per shard into an
        identity-initialized accumulator, the butterfly per mesh axis, then
        the post passes on the lead shard.  Returns (heads, cards)."""
        op, nseg, _n_rows, _n_steps, _needs_words, _reg = g_sig
        red = _RED_OP[op]
        mesh, specs = self._mesh, self._specs
        ident = -1 if red == "and" else 0
        acc = {}
        for i, a in arrs["shards"].items():
            dev = mesh.device_of(i)
            if a["idx"].shape[0] == 0:
                acc[i] = torch.full((nseg, WORDS32), ident,
                                    dtype=torch.int32, device=dev)
                continue
            rows = self._shard_source(i).index_select(0, a["idx"].long())
            rows.masked_fill_(~a["valid"][:, None], ident)
            heads, _ = kernels.segmented_reduce(red, rows, a["seg"], nseg)
            del rows
            if red == "and":
                heads.masked_fill_(~a["present"][:, None], -1)
            acc[i] = heads
        for axis in (specs.row_axis, specs.data_axis):
            if mesh.shape[axis] > 1:
                acc = _butterfly_combine(red, acc, mesh, axis)
        heads = torch.where(arrs["mask_ok"][:, None], acc[mesh.lead()], 0)
        if op == "andnot":
            hg = self._replicated_rows(arrs["head_gather"])
            hg.masked_fill_(~arrs["head_ok"][:, None], 0)
            heads = hg & ~heads
        return heads, popcount(heads)

    def _run(self, plan: _ShardedPlan, ops: dict):
        """The device part of one launch: per-group (heads | None, cards),
        and the fused sections' outputs."""
        feeding = expr_mod.expr_bucket_ids(plan.exprs)
        outs, group_heads = [], []
        for g, arrs in zip(plan.op_groups, ops["g"]):
            heads, cards = self._group_body(g.sig, arrs)
            force = any(bi in feeding for bi in g.bucket_idx)
            group_heads.append((heads if (force or g.needs_words) else None,
                                cards))
            outs.append((heads if g.needs_words else None, cards))
        if not plan.megas:
            return outs, []
        # every stream reads the same bank 0: its group bases are equal
        parts = [h for (h, _), gb in zip(group_heads,
                                         plan.megas[0].group_base)
                 if gb >= 0]
        bank_a = (torch.cat(parts) if len(parts) > 1
                  else parts[0] if parts else None)
        expr_outs = []
        for m, leaf, arrs in zip(plan.megas, ops["leaf"], ops["m"]):
            leaves = self._replicated_rows(leaf) if m.leaf_rows else None
            expr_outs += megakernel.eval_combines(m, bank_a, leaves, arrs)
        return outs, expr_outs

    def _program_key(self, plan: _ShardedPlan, layout) -> tuple:
        """The JAX package's key (the mesh rung, the plan's signature, the
        placement and the placed image's rows: a program reads the whole
        image, so the tenant mix is not part of it), the B5 streams' shapes,
        then the cache's generation (a re-placed image retires every
        program) and the operand pack's layout."""
        return (guard.MESH, plan.signature, self.placement, self.pool_rows,
                tuple(m.signature for m in plan.megas),
                self._programs.generation, layout)

    def _program(self, plan: _ShardedPlan, run: bool = True):
        """The device part through its program, outputs copied out: a
        snapped plan on a capturable mesh replays its signature's graph;
        every other plan runs eagerly.  ``run=False`` only prepares; a plan
        past B5's capacity prepares nothing (its launch demotes)."""
        if plan.megas is None:
            return None
        if plan.point is None or not self.capturable:
            key = self._program_key(plan, None)
            if not run:
                self._programs.note_eager(key, guard.MESH, plan.point, 0.0,
                                          tags=lambda: self._build_tags(plan))
                return None
            t0 = time.perf_counter()
            outs = rt_programs.copy_out(self._run(
                plan, self._eager_operands(plan)))
            if key not in self._programs:
                self._programs.note_eager(key, guard.MESH, plan.point,
                                          time.perf_counter() - t0)
            return outs
        pack = plan.packs.get("mesh")
        if pack is None:
            pack = plan.packs["mesh"] = rt_programs.pack_operands(
                self._operand_tree(plan), self.device)
        for m in plan.megas:
            m.check((max(1, sum(g.nseg for g, gb in zip(plan.op_groups,
                                                        m.group_base)
                                if gb >= 0)),
                     m.leaf_rows + m.extra_rows, max(1, m.col_rows)))
        key = self._program_key(plan, pack.layout)

        def device_part(ops, plan=plan):
            return self._run(plan, ops)

        if not run:
            self._programs.prepare(key, guard.MESH, plan.point, device_part,
                                   pack, tags=lambda: self._build_tags(plan))
            return None
        return self._programs.dispatch(key, guard.MESH, plan.point,
                                       device_part, pack)

    def _build_tags(self, plan: _ShardedPlan) -> dict:
        predicted = self._predict(plan)
        return {"mesh": self._mesh_label, "groups": len(plan.op_groups),
                "donate": False, "exprs": len(plan.fused),
                "per_shard_predicted_bytes": predicted["per_shard_bytes"],
                "measured_peak_bytes": None,
                "flops": float(self._word_ops(plan))}

    # ------------------------------------------------------------ execution

    def execute(self, groups, engine: str = "auto", fallback: bool = True,
                policy: guard.GuardPolicy | None = None) -> list:
        """Run a pool of per-set query groups as mesh-sharded launches;
        returns per-group result lists, or a flat list for bare
        ``BatchQuery`` sugar.  ``engine`` is accepted for the pooled
        engines' signature: the mesh rung's reduce is B1.

        Guarded per launch down ``mesh -> single`` (and the host fold off
        the card); ``ResourceExhausted`` halves the pool, and the proactive
        split halves it while the per-shard prediction passes the
        per-device budget."""
        groups, bare = self._normalize(groups)
        pooled, lengths = self._single._flatten(groups)
        if not pooled:
            return [] if bare else [[] for _ in groups]
        t_exec0 = time.perf_counter()
        with obs_trace.span("sharded.execute", site=SITE, q=len(pooled),
                            sets=len({s for s, _ in pooled}),
                            mesh=self._mesh_label, fallback=fallback):
            obs_metrics.counter("rb_sharded_queries_total", site=SITE,
                                mesh=self._mesh_label).inc(len(pooled))
            if not fallback:
                flat = self._launch_once(pooled, inject=False)
                return flat if bare else self._single._regroup(flat, lengths)
            policy = policy or guard.GuardPolicy.from_env()
            budget = guard.resolve_hbm_budget(policy, self.device)
            deadline = guard.Deadline(policy.deadline)
            chain = guard.chain_from(guard.MESH, ENGINE_LADDER, self.device)

            def run_misses(qs):
                out = []
                for sub in self._launch_iter(tuple(qs), budget):
                    res, _rung = self._launch_guarded(sub, chain, policy,
                                                      deadline, budget)
                    out.extend(res)
                return out

            with obs_slo.query(SITE, deadline_ms=policy.slo_deadline_ms):
                flat = self._single._serve(list(pooled), run_misses)
            if not self._first_query_done:
                self._first_query_done = True
                obs_metrics.histogram(
                    "rb_first_query_seconds", site=SITE).observe(
                        time.perf_counter() - t_exec0)
            if policy.shadow_rate > 0.0:
                self._shadow_check(pooled, flat, policy)
            return flat if bare else self._single._regroup(flat, lengths)

    def _launch_iter(self, pooled, budget: int | None):
        """Left-to-right launch partition: a sub-pool whose per-shard
        prediction passes the per-device budget is halved before
        dispatch."""
        stack = [list(pooled)]
        while stack:
            qs = stack.pop()
            while budget is not None and len(qs) >= 2:
                per_shard = self._predict(
                    self._plan(tuple(qs)))["per_shard_bytes"]
                if per_shard <= budget:
                    break
                mid = (len(qs) + 1) // 2
                self.proactive_split_count += 1
                obs_metrics.counter("rb_sharded_proactive_splits_total",
                                    site=SITE, mesh=self._mesh_label).inc()
                obs_trace.current().event(
                    "proactive_split", site=SITE, q=len(qs),
                    predicted_bytes=per_shard, budget_bytes=budget,
                    mesh=list(self.mesh_shape),
                    halves=(mid, len(qs) - mid))
                stack.append(qs[mid:])
                qs = qs[:mid]
            yield tuple(qs)

    def _single_engine(self, qs) -> str:
        """The single rung's engine: the pooled engine's own choice for the
        device (B5 for expression pools and B1 otherwise on the card)."""
        return resolve_query_engine("auto", [q for _, q in qs],
                                    self._single.device)

    def _launch_guarded(self, qs, chain, policy, deadline, budget):
        """One guarded launch down the sharded ladder.  The single rung is
        the un-sharded pooled engine's raw launch over the same sets; its
        own ladder is not re-entered."""

        def attempt(rung):
            if rung == guard.MESH:
                return self._launch_once(qs)
            faults.maybe_fail(SITE, guard.SINGLE_DEVICE)
            obs_slo.note_engine(guard.SINGLE_DEVICE)
            return self._single._launch_once(qs, self._single_engine(qs))

        def on_oom(rung, fault, dl):
            if len(qs) < 2:
                return guard.NO_SPLIT
            mid = (len(qs) + 1) // 2
            self.split_count += 1
            obs_metrics.counter("rb_sharded_oom_splits_total", site=SITE,
                                mesh=self._mesh_label).inc()
            obs_trace.current().event(
                "oom_split", site=SITE, engine_from=rung, engine_to=rung,
                q=len(qs), halves=(mid, len(qs) - mid))
            sub = chain[chain.index(rung):] if rung in chain else chain
            return (self._launch_guarded(qs[:mid], sub, policy, dl,
                                         budget)[0]
                    + self._launch_guarded(qs[mid:], sub, policy, dl,
                                           budget)[0])

        return guard.run_with_fallback(
            SITE, chain, attempt, policy=policy,
            sequential=lambda: self._single._sequential(qs),
            on_resource_exhausted=on_oom, deadline=deadline)

    def _launch_once(self, pooled, inject: bool = True) -> list:
        """Raw mesh launch: plan -> the device part -> host assembly.  The
        fault seam sits at the engine boundary."""
        pooled = tuple(pooled)
        plan = self._plan(pooled)
        obs_slo.note_engine(guard.MESH)
        if inject:
            faults.maybe_fail(SITE, guard.MESH)
        if plan.megas is None:
            raise errors.EngineLoweringError(
                "sharded_engine: a fused section's combine-mode stream does "
                "not fit the megakernel on its own")
        with obs_slo.phase("program_build"):
            self._program(plan, run=False)
        predicted = self._predict(plan)
        with obs_trace.span("sharded.dispatch", engine=guard.MESH,
                            q=len(pooled), sets=len(plan.sids),
                            mesh=self._mesh_label) as sp:
            start = obs_cost.launch_timer(self.device)
            t_launch = time.perf_counter()
            with obs_slo.phase("dispatch"):
                outs = self._program(plan)
                event = obs_cost.end_event(self.device, start is not None)
            self.launch_count += 1
            obs_metrics.counter("rb_sharded_launches_total", site=SITE,
                                mesh=self._mesh_label).inc()
            if plan.exprs:
                expr_mod.record_fused_dispatch(SITE, plan.exprs)
                expr_mod.record_analytics_dispatch(SITE, plan.exprs, sp)
            for m in plan.megas:
                sp.event("expr.megakernel", **m.stats_event())
            with obs_slo.phase("sync"):
                sp.sync(event)
                if event is not None:
                    event.synchronize()
            launch_s = obs_cost.launch_seconds(
                start, event, time.perf_counter() - t_launch)
            mem = obs_memory.record_dispatch(
                SITE, predicted["per_shard_bytes"], None)
            mem["engine"], mem["q"] = guard.MESH, len(pooled)
            mem["sets"] = len(plan.sids)
            mem["mesh"] = list(self.mesh_shape)
            mem["per_shard_predicted_bytes"] = predicted["per_shard_bytes"]
            mem["mesh_total_predicted_bytes"] = predicted["peak_bytes"]
            if plan.point is not None:
                pb, pf = plan.padding
                mem["lattice_padding_bytes"] = int(pb)
                mem["lattice_padding_fraction"] = round(pf, 6)
                rt_lattice.record_padding(SITE, int(pb), pf)
            self.last_dispatch_memory = mem
            sp.event("sharded.memory", **mem)
            cost_ev = obs_cost.record_dispatch(
                SITE, guard.MESH,
                obs_cost.plan_cost(self._word_ops(plan),
                                   predicted["peak_bytes"]),
                launch_s, devices=self.mesh_devices, q=len(pooled))
            self.last_dispatch_cost = cost_ev
            sp.event("sharded.cost", **cost_ev)
            sp.event("batch.shard", site=SITE, mesh=list(self.mesh_shape),
                     placement=self.placement,
                     rows_per_shard=self.rows_per_shard,
                     flat_rows=int(sum(plan.n_pads)),
                     shard_balance=round(self.shard_balance, 4),
                     per_shard_predicted_bytes=predicted["per_shard_bytes"])
        return self._readback(plan, outs, pooled, inject)

    def _group_outputs(self, plan: _ShardedPlan, outs):
        """Each op group's flat heads/cards sliced into per-bucket host
        arrays (the padded flat layout: ``k_pad + 1`` slots a query)."""
        for grp, (heads_f, cards_f) in zip(plan.op_groups, outs):
            heads_f = (None if heads_f is None
                       else heads_f.numpy().view(np.uint32))
            cards_f = cards_f.numpy()
            for bi, s0 in zip(grp.bucket_idx, grp.seg_offs):
                b = plan.buckets[bi]
                n = b.q * (b.k_pad + 1)
                cards = cards_f[s0:s0 + n].reshape(
                    b.q, b.k_pad + 1)[:, :b.k_pad]
                heads = (None if heads_f is None else
                         heads_f[s0:s0 + n].reshape(
                             b.q, b.k_pad + 1, WORDS32)[:, :b.k_pad])
                yield b, heads, cards

    def _readback(self, plan: _ShardedPlan, outs, pooled,
                  inject: bool) -> list:
        outs, expr_outs = outs
        with obs_slo.phase("readback"), \
                obs_trace.span("sharded.readback", q=len(pooled),
                               mesh=self._mesh_label):
            results = assemble_pooled_results(
                self._group_outputs(plan, outs), pooled, plan.rb_meta,
                owner=(plan.owner if (plan.exprs or plan.point is not None)
                       else None))
            fi = 0
            for sec in plan.exprs:
                if sec.kind == "flat":
                    continue
                out = None
                if sec.kind == "fused":
                    out = expr_outs[fi]
                    fi += 1
                sid, q = pooled[sec.qid]
                card, bm, value = expr_mod.assemble_section_result(
                    sec, out, q.form, self._engines[sid]._empty_cls)
                results[sec.qid] = BatchResult(cardinality=card, bitmap=bm,
                                               value=value)
        if inject and faults.should_corrupt(SITE, guard.MESH):
            results[0] = dataclasses.replace(
                results[0], cardinality=results[0].cardinality + 1)
        return results

    def _shadow_check(self, pooled, results, policy) -> None:
        idx = guard.shadow_sample(len(pooled), policy.shadow_rate,
                                  policy.shadow_seed, SITE)
        for i in idx:
            sid, q = pooled[i]
            ref = self._engines[sid]._sequential_result(q)
            got = results[i]
            bad = (got.cardinality != ref.cardinality
                   or got.value != ref.value)
            if not bad and q.form == "bitmap":
                bad = got.bitmap != ref.bitmap
            if bad:
                raise errors.ShadowMismatch(
                    f"sharded query {i} ({query_desc(q)} on set "
                    f"{sid}) diverged from the sequential reference: got "
                    f"cardinality {got.cardinality}/value {got.value}, "
                    f"want {ref.cardinality}/{ref.value}")

    # -------------------------------------------------------------- warmup

    def _compile_lattice_points(self, lat) -> int:
        """The mesh half of the lattice vocabulary: one program per flat
        point (a pinned two-tenant pool: the pool image is the whole
        placed concat, so the tenant mix never enters the signature), the
        representative expression DAGs and analytics batches, and every
        tenant's delta-patch rungs."""
        from .batch_engine import analytics_rung_queries

        points = lat.enumerate_points(pooled=False)
        self._programs.maxsize = max(self._programs.maxsize,
                                     2 * len(points) + 8)
        compiled = 0
        second = 1 % self.n_sets
        for point in points:
            if point.delta:
                for e in self._engines:
                    e._ds.warmup_delta(point.delta)
                compiled += 1
                continue
            if point.bsi:
                pools = [[BatchGroup(0, batch)] for batch in
                         analytics_rung_queries(
                             getattr(self._engines[0]._ds, "columns", {}),
                             point.bsi, self._engines[0].n)]
            elif point.expr:
                pools = [[BatchGroup(0, expr_mod.rung_expressions(
                    point.expr, self._engines[0].n))]]
            else:
                pools = [[BatchGroup(0, [BatchQuery(op, (0,))
                                         for op in point.ops]),
                          BatchGroup(second,
                                     [BatchQuery(point.ops[0], (0,))])]]
            with lat.pin(point):
                for pool in pools:
                    pooled, _ = self._single._flatten(pool)
                    plan = self._plan(tuple(pooled))
                    for sec in plan.exprs:
                        lat.note_expr(sec.signature)
                    self._program(plan, run=False)
            compiled += 1
        return compiled

    def _warmup_lattice(self, profile, pools=None) -> dict:
        """``warmup(profile=...)`` over the mesh: activate, prepare the
        mesh vocabulary (captured graphs on a capturable mesh, eager
        programs otherwise) and the programs of ``pools`` (expression DAGs
        the rungs do not name are programs of their own), seal.  The single
        rung prepares nothing: a demotion after the seal is an escape by
        design."""
        t0 = time.perf_counter()
        lat = rt_lattice.activate(profile)
        with obs_trace.span("lattice.warmup", site=SITE,
                            points=lat.n_points(),
                            profile=lat.to_profile()) as sp:
            compiled = self._compile_lattice_points(lat)
            for pool in pools or ():
                groups, _ = self._normalize(pool)
                pooled, _ = self._single._flatten(groups)
                plan = self._plan(tuple(pooled))
                for sec in plan.exprs:
                    lat.note_expr(sec.signature)
                self._program(plan, run=False)
                compiled += 1
            lat.seal()
            sp.tag(compiled=compiled, sealed=True)
        return {"site": SITE,
                "compile_cache_dir": str(rt_warmup.build_dir()),
                "mesh": list(self.mesh_shape),
                "lattice": {"profile": lat.to_profile(),
                            "points": lat.n_points(),
                            "compiled": compiled, "sealed": True},
                "programs": ("graphs" if self.capturable and
                             self._programs.on_card else "eager"),
                "graphs": self._programs.graphs,
                "pool_bytes": self._programs.pool_bytes(),
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    def warmup(self, rungs=(1, 2, 4, 8),
               ops=("or", "and", "xor", "andnot"),
               pools=None, profile=None, engine: str = "auto") -> dict:
        """Prepare mesh programs for pow2 operand rungs (or explicit
        ``pools=``); ``"expr:N"`` / ``"delta:N"`` rungs as in
        ``BatchEngine.warmup``.  ``profile=`` is the closed-lattice boot
        (``pools=`` then adds representative pools to the vocabulary)."""
        rt_warmup.enable_compile_cache()
        if profile is not None:
            return self._warmup_lattice(profile, pools)
        t0 = time.perf_counter()
        programs = []
        if pools is None:
            pools = []
            for r in rungs:
                kind, n = expr_mod.parse_warmup_rung(r)
                if kind == "delta":
                    for e in self._engines:
                        rep = e._ds.warmup_delta(n)
                        programs.append({"delta_rung": n,
                                         "engine": "mutation",
                                         "compiled": rep["compiled"]})
                    continue
                pools.append([
                    BatchGroup(sid, expr_mod.rung_expressions(n, e.n)
                               if kind == "expr"
                               else e._rung_queries(n, ops))
                    for sid, e in enumerate(self._engines)])
        for pool in pools:
            groups, _ = self._normalize(pool)
            pooled, _ = self._single._flatten(groups)
            if not pooled:
                continue
            plan = self._plan(tuple(pooled))
            self._program(plan, run=False)
            programs.append({"q": len(pooled), "sets": len(plan.sids),
                             "groups": len(plan.op_groups),
                             "mesh": self._mesh_label})
        return {"site": SITE,
                "compile_cache_dir": str(rt_warmup.build_dir()),
                "mesh": list(self.mesh_shape), "programs": programs,
                "wall_ms": round((time.perf_counter() - t0) * 1e3, 2)}

    # --------------------------------------------------------- conveniences

    def cardinalities(self, groups, engine: str = "auto"):
        """Flat / per-group int64 cardinalities, matching the input."""
        out = self.execute(groups, engine=engine)
        if out and not isinstance(out[0], list):
            return np.array([r.cardinality for r in out], np.int64)
        return [np.array([r.cardinality for r in rows], np.int64)
                for rows in out]

    def count_cache_hits(self, groups_or_queries) -> int:
        """The un-sharded pooled engine's count (placement-independent)."""
        seq = list(groups_or_queries)
        if seq and isinstance(seq[0], (BatchQuery, expr_mod.ExprQuery)):
            seq = [BatchGroup(0, seq)]
        return self._single.count_cache_hits(seq)

    def cache_stats(self) -> dict:
        return {"plans": self._plans.stats(),
                "programs": self._programs.stats(),
                "splits": self.split_count,
                "proactive_splits": self.proactive_split_count,
                "launches": self.launch_count}


def _present(seg: np.ndarray, nseg: int) -> np.ndarray:
    """bool[nseg]: the segments ``seg`` holds a row of."""
    out = np.zeros(nseg, bool)
    s = seg[seg < nseg]
    out[s] = True
    return out


def _combine_streams(buckets, op_groups, fused, expr_bis) -> tuple | None:
    """The fused sections as B5 combine-mode streams, in section order: one
    stream when they fit B5, else the sections halved until every part
    fits.  ``expr_bis`` are the buckets every section reads, so each stream
    has the same bank 0.  None (counted as a capacity demotion) when a
    section does not fit on its own."""
    mega = megakernel.build_combines(buckets, op_groups, fused, expr_bis)
    if mega.fits():
        return (mega,)
    if len(fused) == 1:
        megakernel.note_capacity_demotion("sharding", mega)
        return None
    mid = len(fused) // 2
    head = _combine_streams(buckets, op_groups, fused[:mid], expr_bis)
    tail = _combine_streams(buckets, op_groups, fused[mid:], expr_bis)
    return None if head is None or tail is None else head + tail
