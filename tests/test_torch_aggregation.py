"""The port's wide aggregation against roaringbitmap_tpu.parallel.aggregation.

Same numpy-seeded inputs through both packages, the JAX side on its "xla"
engine with ``fallback=False``, the port on ``device="cpu"`` with both of
its engines ("cuda" takes each kernel's plain version for CPU tensors).
Results are compared bit-exact: device words and cards, ``to_array()`` and
``serialize()`` bytes.  Also: ``DeviceBitmapSet.from_numpy_state`` fed the
JAX set's arrays, and the port's import isolation from JAX.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import fast_aggregation as jfast
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import fast_aggregation as tfast
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops.words import to_u32

torch.set_num_threads(2)

CPU = "cpu"
EDGES = [0, 0x80000000, 0xFFFFFFFF]


def _values(seed: int, n: int) -> list[np.ndarray]:
    """n value sets sharing a common part (so the wide AND keeps keys) over
    sparse, dense and run-heavy shapes, plus the edge values."""
    rng = np.random.default_rng(seed)
    common = np.concatenate([rng.integers(0, 1 << 18, 2000),
                             np.arange(70000, 75000), EDGES])
    out = []
    for i in range(n):
        kind = i % 3
        if kind == 0:
            own = rng.integers(0, 1 << 20, 800)
        elif kind == 1:
            own = (int(rng.integers(0, 8)) << 16) + rng.integers(0, 1 << 16, 7000)
        else:
            s = int(rng.integers(0, 1 << 20))
            own = np.arange(s, s + int(rng.integers(100, 9000)))
        out.append(np.concatenate([common, own]).astype(np.uint32))
    return out


def _pair(seed: int = 0, n: int = 7):
    vals = _values(seed, n)
    j = [JRB.from_values(v) for v in vals]
    for b in j[::2]:
        b.run_optimize()
    t = [TRB.deserialize(b.serialize()) for b in j]
    return j, t


def _same(tb, jb):
    assert np.array_equal(tb.to_array(), jb.to_array())
    assert tb.serialize() == jb.serialize()


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("op", ["or_", "xor", "and_"])
def test_adhoc_matches_jax(pair, op, engine):
    j, t = pair
    want = getattr(jagg, op)(j, engine="xla", fallback=False)
    _same(getattr(tagg, op)(t, engine=engine, device=CPU), want)


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("op", ["or", "xor"])
def test_cardinality_matches_jax(pair, op, engine):
    j, t = pair
    want = getattr(jagg, f"{op}_cardinality")(j, engine="xla", fallback=False)
    got = getattr(tagg, f"{op}_cardinality")(t, engine=engine, device=CPU)
    assert got == want


def test_and_cardinality_matches_jax(pair):
    j, t = pair
    assert (tagg.and_cardinality(t, device=CPU)
            == jagg.and_cardinality(j, fallback=False) > 0)


@pytest.mark.parametrize("op", ["or_", "xor", "and_"])
def test_adhoc_shortcuts(op):
    a = TRB.bitmap_of(1, 2, 0xFFFFFFFF)
    disjoint = TRB.bitmap_of(1 << 20)
    f = getattr(tagg, op)
    assert f([], device=CPU).is_empty()
    assert f([TRB(), TRB()], device=CPU).is_empty()
    assert f([a], device=CPU) == a and f([a], device=CPU) is not a
    if op == "and_":
        assert f([a, TRB()], device=CPU).is_empty()
        assert f([a, disjoint], device=CPU).is_empty()
        assert tagg.and_cardinality([a, disjoint], device=CPU) == 0
    else:
        assert f([a, TRB()], device=CPU) == a
    assert f(a, a, device=CPU) == f([a, a], device=CPU)


def test_edge_values():
    bms = [TRB.from_values(np.array(EDGES + [i], np.uint32)) for i in (5, 6)]
    assert tagg.or_(bms, device=CPU).to_array().tolist() == \
        [0, 5, 6, 0x80000000, 0xFFFFFFFF]
    assert tagg.xor(bms, device=CPU).to_array().tolist() == [5, 6]
    assert tagg.and_(bms, device=CPU).to_array().tolist() == EDGES
    ds = tagg.DeviceBitmapSet(bms, layout="dense", device=CPU)
    assert ds.aggregate("or").to_array().tolist() == \
        [0, 5, 6, 0x80000000, 0xFFFFFFFF]


# ------------------------------------------------------------ resident sets

_JAX_SETS = {}


def _jax_set(j, layout: str, block=None):
    if (layout, block) not in _JAX_SETS:
        _JAX_SETS[layout, block] = jagg.DeviceBitmapSet(j, layout=layout,
                                                        block=block)
    return _JAX_SETS[layout, block]


def _same_device(got, want):
    gw, gc = got
    ww, wc = want
    assert np.array_equal(to_u32(gw), np.asarray(ww))
    assert np.array_equal(gc.numpy(), np.asarray(wc))


@pytest.mark.parametrize("engine", ["cuda", "torch"])
@pytest.mark.parametrize("layout", ["dense", "counts", "compact", "auto"])
@pytest.mark.parametrize("op", ["or", "xor", "and"])
def test_set_layouts_match_jax(pair, op, layout, engine):
    j, t = pair
    js = _jax_set(j, layout)
    ts = tagg.DeviceBitmapSet(t, layout=layout, device=CPU)
    assert ts.layout == js.layout and ts.block == js.block
    assert np.array_equal(ts.keys, js.keys)
    _same_device(ts.aggregate_device(op, engine=engine),
                 js.aggregate_device(op, engine="xla"))
    _same(ts.aggregate(op, engine=engine), js.aggregate(op, engine="xla"))


def _state(js) -> dict:
    """The packed arrays a JAX DeviceBitmapSet holds, as NumPy arrays."""
    p = js._packed
    st = {"keys": js.keys, "n": js.n, "block": js.block, "blk_seg": p.blk_seg,
          "n_blocks": p.n_blocks, "seg_sizes": p.seg_sizes,
          "seg_offsets": p.seg_offsets}
    if js.words is not None:
        st["words"] = np.asarray(js.words)
        return st
    for name, a in zip(("dense_words", "dense_dest", "values", "val_counts",
                        "val_dest"), js._streams):
        st[name] = np.asarray(a)
    st["chunk_vals"], st["chunk_row"] = (np.asarray(a) for a in js._chunks)
    st["row_live"] = np.asarray(js._row_live)
    if js.counts is not None:
        st["counts"] = np.asarray(js.counts)
        st["grp_seg"] = np.asarray(js._grp_seg_counts)
        st["gps"] = js._gps
    return st


@pytest.mark.parametrize("layout", ["dense", "counts", "compact"])
def test_from_numpy_state(pair, layout):
    j, t = pair
    js = _jax_set(j, layout)
    st = _state(js)
    if layout == "counts":
        del st["chunk_vals"], st["chunk_row"]   # counts needs no chunks
    ts = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    assert ts.layout == layout
    for op in ("or", "xor", "and"):
        for engine in ("cuda", "torch"):
            _same_device(ts.aggregate_device(op, engine=engine),
                         js.aggregate_device(op, engine="xla"))
        _same(ts.aggregate(op), js.aggregate(op, engine="xla"))


@pytest.mark.parametrize("block", [None, 16, 32])
@pytest.mark.parametrize("layout", ["counts", "compact"])
def test_port_state_matches_jax_set(pair, layout, block):
    """The port builds the same resident arrays as the JAX set (block 16
    and 32 pad the count groups to 2 and 4 per block)."""
    j, t = pair
    js = _jax_set(j, layout, block)
    ts = tagg.DeviceBitmapSet(t, layout=layout, block=block, device=CPU)
    for op in ("or", "xor"):
        _same_device(ts.aggregate_device(op), js.aggregate_device(op, "xla"))
    st = _state(js)
    assert np.array_equal(ts.blk_seg.numpy(), st["blk_seg"])
    assert np.array_equal(to_u32(ts._chunks[0]), st["chunk_vals"])
    assert np.array_equal(ts._chunks[1].numpy(), st["chunk_row"])
    if layout == "counts":
        assert np.array_equal(to_u32(ts.counts), st["counts"])
        assert np.array_equal(ts._grp_seg_counts.numpy(), st["grp_seg"])


@pytest.mark.parametrize("layout", ["counts", "compact"])
def test_from_numpy_state_sorts_chunk_stream(pair, layout):
    """A state whose chunk stream comes in another order loads sorted by
    row (B3 bisects it), each chunk with its values, and answers as the
    JAX set does."""
    j, _ = pair
    js = _jax_set(j, layout)
    st = _state(js)
    order = np.random.default_rng(7).permutation(st["chunk_row"].size)
    cv, cr = st["chunk_vals"], st["chunk_row"]
    st["chunk_vals"], st["chunk_row"] = cv[order], cr[order]
    assert np.any(np.diff(st["chunk_row"]) < 0)
    ts = tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    rows = ts._chunks[1].numpy()
    assert np.all(np.diff(rows) >= 0)
    assert np.array_equal(rows, np.sort(cr))
    want = np.searchsorted(rows, np.arange(ts._n_rows + 1))
    assert np.array_equal(ts._chunk_bounds.numpy(), want)
    got = {tuple(v) for v in to_u32(ts._chunks[0])[rows < ts._n_rows]}
    assert got == {tuple(v) for v in cv[cr < ts._n_rows]}
    for op in ("or", "xor", "and"):
        for engine in ("cuda", "torch"):
            _same_device(ts.aggregate_device(op, engine=engine),
                         js.aggregate_device(op, engine="xla"))


def test_compact_set_plans_densify_once(pair, monkeypatch):
    """A compact set plans B3's bounds when it loads its chunk stream, and
    its queries reuse them."""
    _, t = pair
    ts = tagg.DeviceBitmapSet(t, layout="compact", device=CPU)
    assert ts._chunk_bounds.shape == (ts._n_rows + 1,)
    passed = []
    densify = kernels.densify_chunks
    monkeypatch.setattr(kernels, "densify_chunks", lambda *a: passed.append(
        a[-1]) or densify(*a))
    for op in ("or", "xor", "and"):
        got = ts.aggregate_device(op, engine="cuda")
        want = ts.aggregate_device(op, engine="torch")
        assert all(torch.equal(g, w) for g, w in zip(got, want)), op
    assert len(passed) == 3 and all(b is ts._chunk_bounds for b in passed)


def test_from_numpy_state_rejects_incomplete(pair):
    j, _ = pair
    st = _state(_jax_set(j, "compact"))
    del st["values"]
    with pytest.raises(ValueError, match="missing"):
        tagg.DeviceBitmapSet.from_numpy_state(st, device=CPU)
    with pytest.raises(ValueError):
        tagg.DeviceBitmapSet.from_numpy_state({"keys": st["keys"]}, device=CPU)


def test_auto_layout_picks_counts_for_census_shape():
    rng = np.random.default_rng(3)
    vals = []
    for _ in range(300):
        keys = rng.choice(1 << 16, 4, replace=False).astype(np.uint32)
        lows = rng.integers(0, 1 << 16, (4, 4)).astype(np.uint32)
        vals.append(((keys[:, None] << np.uint32(16)) | lows).ravel())
    j = [JRB.from_values(v) for v in vals]
    t = [TRB.from_values(v) for v in vals]
    js = jagg.DeviceBitmapSet(j)
    ts = tagg.DeviceBitmapSet(t, device=CPU)
    assert ts.layout == js.layout == "counts"
    for op in ("or", "xor"):
        for engine in ("cuda", "torch"):
            _same_device(ts.aggregate_device(op, engine=engine),
                         js.aggregate_device(op, engine="xla"))


def test_byte_backed_set(pair):
    j, t = pair
    blobs = [b.serialize() for b in t]
    a = tagg.DeviceBitmapSet(blobs, layout="compact", device=CPU)
    b = tagg.DeviceBitmapSet(t, layout="compact", device=CPU)
    for op in ("or", "xor", "and"):
        assert a.aggregate(op) == b.aggregate(op)
    assert a.hbm_bytes() == b.hbm_bytes() > 0


def test_set_argument_errors(pair):
    _, t = pair
    with pytest.raises(ValueError):
        tagg.DeviceBitmapSet(t, layout="sparse", device=CPU)
    with pytest.raises(ValueError):
        tagg.DeviceBitmapSet(t, layout="counts", block=12, device=CPU)
    ds = tagg.DeviceBitmapSet(t[:2], layout="dense", device=CPU)
    with pytest.raises(ValueError):
        ds.aggregate("andnot")
    with pytest.raises(ValueError):
        ds.aggregate("or", engine="pallas")


def test_no_cuda_means_no_silent_cpu(pair):
    """Without a card, an entry point that was not asked for the CPU raises;
    nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    _, t = pair
    with pytest.raises(RuntimeError, match="CUDA"):
        tagg.or_(t)
    with pytest.raises(RuntimeError, match="CUDA"):
        tagg.DeviceBitmapSet(t[:2])


@pytest.mark.parametrize("name", [
    "naive_or", "naive_xor", "naive_and", "priorityqueue_or",
    "priorityqueue_xor", "horizontal_or", "horizontal_xor", "work_shy_and",
    "work_and_memory_shy_and", "workShyAnd", "workAndMemoryShyAnd", "or_",
    "xor", "and_", "or_cardinality", "and_cardinality", "xor_cardinality"])
def test_fast_aggregation_strategies(pair, name):
    j, t = pair
    want = getattr(jfast, name)(j[:4])
    kwargs = {} if name.startswith(("naive", "priorityqueue")) else {"device": CPU}
    got = getattr(tfast, name)(t[:4], **kwargs)
    if isinstance(want, int):
        assert got == want
    else:
        _same(got, want)


def test_naive_andnot(pair):
    j, t = pair
    _same(tfast.naive_andnot(t[0], t[1:4], device=CPU),
          jfast.naive_andnot(j[0], j[1:4]))


def test_port_imports_no_jax():
    """The port's import graph holds neither jax nor any roaringbitmap_tpu
    module (the port's own name shares that prefix), also after one pooled
    ``MultiSetBatchEngine.execute``, one ``apply_delta``, a request served
    by a ``ServingLoop``, a wire frame, a captured durable state and a
    traced pooled execute with the obs layer's statusz and Prometheus
    renders, a sharded wide op, a sharded-engine query, a pod front
    door request, the flagship model, the bitmap iterators, an explain, a
    node-at-a-time batch, a warmed delta rung, and the rest of the host
    tier (immutables and navigable maps through the wide ops, the writer,
    the bitset, a mapped RangeBitmap and BSI, the insights, the dataset
    loaders) on the CPU."""
    code = (
        "import sys, numpy as np\n"
        "import roaringbitmap_tpu_torch as rt\n"
        "from roaringbitmap_tpu_torch.ops import build, kernels, megakernel\n"
        "from roaringbitmap_tpu_torch.parallel import batch_engine, expr\n"
        "from roaringbitmap_tpu_torch.runtime import cache\n"
        "bms = [rt.RoaringBitmap.from_values(np.arange(i, 70000 + i, 3, "
        "dtype=np.uint32)) for i in range(3)]\n"
        "assert rt.aggregation.or_(bms, device='cpu').cardinality > 0\n"
        "eng = rt.BatchEngine(rt.DeviceBitmapSet(bms, device='cpu'))\n"
        "q = expr.ExprQuery(expr.and_(expr.or_(0, 1), expr.not_(2)))\n"
        "assert eng.execute([q], engine='megakernel')[0].cardinality > 0\n"
        "xs = rt.DeviceBitmapSet(bms, layout='compact', device='cpu')\n"
        "assert int(xs.chained_wide_or(2, engine='cuda-nibble')()) > 0\n"
        "assert rt.DeviceBitmap.aggregate(xs, 'or').cardinality() > 0\n"
        "ps = rt.DevicePairSet([(bms[0], bms[1])], device='cpu')\n"
        "assert ps.cardinalities('or')[0] > 0\n"
        "from roaringbitmap_tpu_torch import analytics, bsi\n"
        "from roaringbitmap_tpu_torch.core import rangebitmap\n"
        "ids = np.arange(0, 70000, 7, dtype=np.uint32)\n"
        "eng._ds.attach_column(analytics.BsiColumn('p', ids, ids % 1000, "
        "device='cpu'))\n"
        "eng._ds.attach_column(analytics.RangeColumn('t', ids, "
        "device='cpu'))\n"
        "aq = [expr.ExprQuery(expr.sum_('p', found=expr.and_(0, "
        "expr.range_('p', 5, 500)))), expr.ExprQuery(expr.top_k('t', 3))]\n"
        "assert eng.execute(aq, engine='megakernel')[0].value > 0\n"
        "hb = bsi.RoaringBitmapSliceIndex.from_pairs(ids, ids % 1000)\n"
        "assert bsi.DeviceBSI(hb, device='cpu').sum()[1] == ids.size\n"
        "rb = rangebitmap.RangeBitmap.from_values(ids)\n"
        "assert bsi.DeviceRangeBitmap(rb, device='cpu').lte_cardinality(70)"
        " == 11\n"
        "assert analytics.two_phase_execute(eng, aq)[1].cardinality == 3\n"
        "from roaringbitmap_tpu_torch import native\n"
        "from roaringbitmap_tpu_torch.core.bitmap64 import Roaring64Bitmap\n"
        "from roaringbitmap_tpu_torch.runtime import errors, faults, guard\n"
        "from roaringbitmap_tpu_torch.utils import fuzz\n"
        "b64 = [Roaring64Bitmap.from_values(np.array([i, 1 << 63], "
        "np.uint64)) for i in range(3)]\n"
        "assert rt.aggregation.or64(b64, device='cpu').cardinality == 4\n"
        "with faults.inject('lowering@cuda:1'):\n"
        "    assert rt.aggregation.or_(bms, engine='cuda', device='cpu')"
        ".cardinality > 0\n"
        "assert guard.dispatch_stats('aggregation')['demotions'] == 1\n"
        "blobs = [b.serialize() for b in bms]\n"
        "assert rt.DeviceBitmapSet(blobs, device='cpu').aggregate('or')"
        " == rt.aggregation.or_(bms, device='cpu')\n"
        "assert native.CALLS['native'] + native.CALLS['numpy'] == 1\n"
        "assert fuzz.verify_decoder_hardening(8) >= 0\n"
        "from roaringbitmap_tpu_torch.parallel import multiset\n"
        "ms = multiset.MultiSetBatchEngine.from_bitmap_sets([bms, bms[:2]], "
        "layout='dense', device='cpu')\n"
        "got = ms.execute([multiset.BatchGroup(0, [rt.BatchQuery('or', (0, "
        "2))]), multiset.BatchGroup(1, [rt.BatchQuery('xor', (0, 1))])])\n"
        "assert ms.launch_count == 1 and got[0][0].cardinality > 0\n"
        "from roaringbitmap_tpu_torch import mutation\n"
        "ds = rt.DeviceBitmapSet(bms, layout='dense', device='cpu')\n"
        "rep = ds.apply_delta(adds={0: [1]}, removes={1: [1]})\n"
        "assert rep['mode'] == 'patch' and ds.version == 1\n"
        "assert mutation.ResultCache(1 << 20).stats()['entries'] == 0\n"
        "from roaringbitmap_tpu_torch import serving, wire\n"
        "from roaringbitmap_tpu_torch.mutation import durability\n"
        "from roaringbitmap_tpu_torch.wire import bootstrap, migrate\n"
        "loop = serving.ServingLoop(ms, serving.ServingPolicy("
        "default_deadline_ms=1e6))\n"
        "t = loop.submit(serving.ServingRequest(1, rt.BatchQuery('or', "
        "(0, 1))))\n"
        "loop.drain()\n"
        "assert t.ok and t.result.cardinality > 0\n"
        "assert wire.protocol.decode_payload(wire.protocol.encode_frame("
        "4, 1, {})[8:])[1] == 1\n"
        "assert len(durability.capture_state(ds)['sources']) == 3\n"
        "import os, tempfile\n"
        "from roaringbitmap_tpu_torch import obs\n"
        "dump = os.path.join(tempfile.mkdtemp(), 't.jsonl')\n"
        "obs.enable(dump)\n"
        "got = ms.execute([multiset.BatchGroup(0, [rt.BatchQuery('or', (0, "
        "2))]), multiset.BatchGroup(1, [rt.BatchQuery('and', (0, 1))])])\n"
        "obs.disable()\n"
        "assert 'multiset.dispatch' in open(dump).read()\n"
        "assert obs.render_markdown(obs.statusz()).startswith('#')\n"
        "assert 'rb_serving_requests_total' in obs.render_prometheus()\n"
        "from roaringbitmap_tpu_torch.parallel import (multihost, podmesh, "
        "sharded_engine, sharding)\n"
        "from roaringbitmap_tpu_torch.serving import frontdoor, migration\n"
        "mesh = sharding.Mesh(np.array(['cpu'] * 4).reshape(2, 2), "
        "('rows', 'lanes'))\n"
        "k, w, c = sharding.wide_aggregate_sharded(mesh, 'or', bms)\n"
        "assert int(c.sum()) == rt.aggregation.or_(bms, device='cpu')"
        ".cardinality\n"
        "se = sharded_engine.ShardedBatchEngine([ms.sets[0], ms.sets[1]], "
        "mesh=sharded_engine.default_mesh(['cpu'] * 2))\n"
        "assert se.execute([rt.BatchQuery('or', (0, 2))])[0].cardinality "
        "> 0\n"
        "pod = podmesh.PodMesh.simulate(2, devices=['cpu'] * 2)\n"
        "fd = frontdoor.PodFrontDoor(ms.sets, pod=pod, policy="
        "serving.ServingPolicy(default_deadline_ms=1e6))\n"
        "t = fd.submit(serving.ServingRequest(1, rt.BatchQuery('or', (0, "
        "1))))\n"
        "fd.drain()\n"
        "assert t.ok and multihost.snapshot() == {}\n"
        "assert migration.MigrationError.__name__ and migrate."
        "migrate_tenant_wire\n"
        "from roaringbitmap_tpu_torch.models import flagship\n"
        "from roaringbitmap_tpu_torch.core import iterators\n"
        "w, c = flagship.forward(*flagship.example_inputs(device='cpu'))\n"
        "assert int(c.sum()) > 0 and w.shape[1] == 2048\n"
        "it = iterators.PeekableIntIterator(bms[0])\n"
        "it.advance_if_needed(9)\n"
        "assert it.peek_next() == 9 and bms[0].rank(9) == 4\n"
        "assert eng.explain([q])['engine'] == 'torch'\n"
        "assert expr.execute_node_at_a_time(eng, [q])[0].cardinality > 0\n"
        "assert ds.warmup_delta(4)['compiled']\n"
        "assert ds.apply_delta(adds={2: [5]})['mode'] == 'patch'\n"
        "from roaringbitmap_tpu_torch import buffer, insights\n"
        "from roaringbitmap_tpu_torch.bsi import immutable as bimm\n"
        "from roaringbitmap_tpu_torch.core import bitset, fastrank, writer\n"
        "from roaringbitmap_tpu_torch.utils import datasets\n"
        "im = buffer.ImmutableRoaringBitmap(bms[0].serialize())\n"
        "assert rt.aggregation.or_([im, bms[1]], device='cpu') == "
        "rt.aggregation.or_(bms[:2], device='cpu')\n"
        "nm = rt.Roaring64NavigableMap.from_values(np.array([1, 1 << 40], "
        "np.uint64))\n"
        "assert rt.aggregation.or64([nm, nm], device='cpu').cardinality == 2\n"
        "w = writer.RoaringBitmapWriter.wizard().fast_rank().get()\n"
        "w.add(3)\n"
        "assert isinstance(w.get(), fastrank.FastRankRoaringBitmap)\n"
        "assert bitset.RoaringBitSet(bms[0]).cardinality() == "
        "bms[0].cardinality\n"
        "assert rt.RangeBitmap.map(rb.serialize()).lte_cardinality(70) == 11\n"
        "assert bimm.ImmutableBitSliceIndex(hb.serialize_buffer()).sum()[1]"
        " == ids.size\n"
        "assert insights.BitmapAnalyser.analyse(bms[0]).bitmaps_count == 1\n"
        "datasets.has_dataset('census1881')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'roaringbitmap_tpu' or m.startswith('roaringbitmap_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_empty_set_auto_layout():
    """Regression (ROADMAP C1): an empty input with the default
    ``layout="auto"`` builds a set whose or/xor/and are empty, as in JAX
    (the layout report of an empty input has no block advice)."""
    ts = tagg.DeviceBitmapSet([], device=CPU)
    js = jagg.DeviceBitmapSet([])
    assert ts.layout == js.layout == "dense"
    for op in ("or", "xor", "and"):
        got, want = ts.aggregate(op), js.aggregate(op)
        assert got.is_empty() and want.is_empty()
        assert got.serialize() == want.serialize()
    from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEng
    from roaringbitmap_tpu_torch.parallel.batch_engine import (
        BatchEngine as TEng)
    te, je = TEng.from_bitmaps([], device=CPU), JEng.from_bitmaps([])
    assert te.n == je.n == 0
    assert te.execute([]) == je.execute([]) == []
