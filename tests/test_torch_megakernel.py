"""The port's megakernel (B5) against roaringbitmap_tpu.ops.megakernel.

- the assembled instruction stream and ``MegaPlan.signature`` equal the JAX
  plan's for a mixed flat + expression pool (ad-hoc leaves included) on the
  dense, compact and counts layouts;
- B5's plain version equals the JAX kernel (``_raw_call``, interpret mode on
  the CPU) on seeded random streams over all 20 opcodes, TAKE over random
  words included (its int32 sum wraps);
- megakernel results equal the JAX megakernel rung and ``evaluate_host``;
- capacity demotions are counted by reason; "auto" on the CPU is "torch".
Set algebra has no tolerance: everything is compared exactly.
"""

import numpy as np
import pytest

import jax.numpy as jnp
from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.ops import megakernel as jmk
from roaringbitmap_tpu.parallel import BatchEngine as JEngine
from roaringbitmap_tpu.parallel import BatchQuery as JQuery
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu_torch import DeviceBitmapSet, RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.ops import build
from roaringbitmap_tpu_torch.ops import megakernel as mk
from roaringbitmap_tpu_torch.ops.words import as_i32, to_u32
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           BatchQuery,
                                                           resolve_query_engine)

LAYOUTS = ["dense", "compact", "counts"]


def _values():
    """The bitmaps of tests/test_megakernel.py (8 sets over 2^17)."""
    rng = np.random.default_rng(0x11E9)
    out = []
    for i in range(8):
        vals = [rng.integers(0, 1 << 17, 2000).astype(np.uint32)]
        if i % 3 == 0:
            vals.append(np.arange(1 << 16, (1 << 16) + 5000,
                                  dtype=np.uint32))
        out.append(np.unique(np.concatenate(vals)))
    return out


AD = np.unique(np.random.default_rng(3).integers(0, 1 << 17, 2500)
               .astype(np.uint32))


@pytest.fixture(scope="module")
def pair():
    vals = _values()
    return ([JRB.from_values(v) for v in vals],
            [TRB.from_values(v) for v in vals])


def _pool(m, query, rb, form="bitmap"):
    """tests/test_megakernel.py's _pool() plus an ad-hoc leaf query, in one
    package's IR."""
    depth2 = m.and_(m.or_(0, 1), m.not_(2))
    depth3 = m.xor(m.and_(m.or_(0, 1), m.or_(2, 3)),
                   m.andnot(m.or_(4, 5), 6))
    ad = m.bitmap(rb.from_values(AD))
    return ([m.ExprQuery(depth2, form=form), m.ExprQuery(depth3, form=form),
             query("xor", (1, 4), form=form),
             query("and", (0, 3, 6), form=form),
             query("andnot", (2, 5, 7), form=form),
             m.ExprQuery(depth2),
             m.ExprQuery(m.xor(m.and_(m.or_(0, 1), ad), m.andnot(ad, 2)),
                         form=form)]
            + m.random_expr_pool(8, 5, depth=2, seed=19, form=form))


_ENGINES = {}


def _engines(pair, layout):
    if layout not in _ENGINES:
        j, t = pair
        _ENGINES[layout] = (
            JEngine.from_bitmaps(j, layout=layout),
            BatchEngine(DeviceBitmapSet(t, layout=layout, device="cpu")))
    return _ENGINES[layout]


def _same(got, want, pool):
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.cardinality == w.cardinality, i
        if pool[i].form == "bitmap":
            assert np.array_equal(g.bitmap.to_array(), w.to_array()
                                  if hasattr(w, "to_array")
                                  else w.bitmap.to_array()), i


@pytest.mark.parametrize("layout", LAYOUTS)
def test_stream_matches_jax(pair, layout):
    jeng, teng = _engines(pair, layout)
    jplan = jeng.plan(_pool(jexpr, JQuery, JRB))
    tplan = teng.plan(_pool(texpr, BatchQuery, TRB))
    jm, tm = jplan.mega, tplan.mega
    assert tm.signature == jm.signature
    assert (tm.n_steps, tm.n_slots) == (jm.n_steps, jm.n_slots)
    for k in mk.STREAM_KEYS + ("extra",):
        assert np.array_equal(tm.host[k], np.asarray(jm.arrays[k])), k
    assert tm.fits() and tm.extra_rows > 1


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(slots_pad=8, out_pad=4, card_pad=8)),
    (2, dict(n_steps=512, slots_pad=32, out_pad=16, card_pad=32,
             bank_rows=(16, 2, 8)))])
def test_plain_b5_matches_jax_kernel(seed, kw):
    mega, banks = mk.random_plan(seed, **kw)
    ops = np.bincount(mega.host["opc"][:mega.n_steps], minlength=20)
    assert (ops > 0).all()
    out, cards = mk.raw_call(mega, *(as_i32(b, "cpu") for b in banks))
    jm = jmk.MegaPlan(mode="full", n_steps=mega.n_steps,
                      steps_pad=mega.steps_pad, n_slots=mega.n_slots,
                      slots_pad=mega.slots_pad, out_pad=mega.out_pad,
                      card_pad=mega.card_pad, host=None)
    arrs = {k: jnp.asarray(mega.host[k]) for k in mk.STREAM_KEYS}
    jout, jcards = jmk._raw_call(jm, *(jnp.asarray(b) for b in banks), arrs)
    jout = np.asarray(jout)[:mega.out_pad].reshape(mega.out_pad, -1)
    assert np.array_equal(to_u32(out), jout)
    assert np.array_equal(cards.sum(1).numpy(),
                          np.asarray(jcards)[:mega.card_pad].sum(1))
    assert cards.sum() > 0 and out.any()


def test_take_wraps_as_int32():
    """TAKE over an all-ones row: the int32 sum is -2048, below imm 0 and
    above imm -4096; ACC_POP adds 32 per word as u32."""
    em = mk._Emitter()
    em.emit(mk.LOAD_ROW, dst=0, row=0)
    em.emit(mk.TAKE, dst=1, src=0, imm=0)
    em.emit(mk.TAKE, dst=2, src=0, imm=-4096)
    em.emit(mk.ACC_POP, dst=0, src=0)
    for s in range(3):
        em.emit(mk.OUT, src=s, orow=s)
    host = em.finish(4, 4, 1)
    host["extra"] = np.zeros((1, 2048), np.uint32)
    mega = mk.MegaPlan("full", len(em.ops), host["opc"].size, 4, 4, 4, 1, host)
    bank = as_i32(np.full((1, 2048), 0xFFFFFFFF, np.uint32), "cpu")
    out, _ = mk.raw_call(mega, bank, bank, bank)
    assert (out[1] == -1).all() and not out[2].any()
    assert (out[0] == 31).all()     # 0xFFFFFFFF + 32 wraps to 31


def test_stream_bytes_counts_what_the_stream_moves():
    """A row read twice counts once, a row of another bank apart; only the
    real out/card rows and the real steps count, not the padding."""
    em = mk._Emitter()
    em.emit(mk.LOAD_ROW, dst=0, row=3)
    em.emit(mk.OR_ROW, dst=0, row=3)
    em.emit(mk.OR_ROW, dst=0, row=3, bank=1)
    em.emit(mk.OUT, src=0, orow=0)
    em.emit(mk.CARD, src=0, crow=1)
    host = em.finish(4, 4, 4)
    mega = mk.MegaPlan("full", len(em.ops), host["opc"].size, 1, 4, 4, 4, host)
    assert mega.steps_pad == 8
    assert mk.stream_bytes(mega) == 3 * 2048 * 4 + mk.SLICES * 4 + 5 * 32


@pytest.mark.parametrize("layout", LAYOUTS)
def test_megakernel_results_match_jax(pair, layout):
    j, t = pair
    jeng, teng = _engines(pair, layout)
    jp, tp = _pool(jexpr, JQuery, JRB), _pool(texpr, BatchQuery, TRB)
    got = teng.execute(tp, engine="megakernel")
    assert teng.last_timings["engine"] == "megakernel"
    _same(got, jeng.execute(jp, engine="megakernel", fallback=False), tp)
    for i, q in enumerate(tp):
        if isinstance(q, texpr.ExprQuery):
            want = texpr.evaluate_host(q.expr, t)
            assert got[i].cardinality == want.cardinality, i


def test_capacity_demotion_counted(pair, monkeypatch):
    _, teng = _engines(pair, "dense")
    tp = _pool(texpr, BatchQuery, TRB)
    want = teng.execute(tp, engine="megakernel")
    monkeypatch.setattr(mk, "MAX_SLOTS", 8)
    tobs.reset()
    plan = teng.plan(tp)
    assert not plan.mega.fits() and mk.capacity_reason(plan.mega) == "slots"
    got = teng.execute(tp, engine="megakernel")
    assert teng.last_timings["engine"] == "cuda"
    demoted = tobs.snapshot()["counters"]["rb_mega_capacity_demotions_total"]
    assert demoted == [{"labels": {"reason": "slots", "site": "batch_engine"},
                        "value": 1.0}]
    _same(got, want, tp)
    flat = [q for q in tp if isinstance(q, BatchQuery)]
    teng.execute(flat, engine="megakernel")
    assert tobs.counter("rb_mega_capacity_demotions_total",
                        site="batch_engine", reason="no_fused").value == 1


def test_auto_resolution(pair):
    _, teng = _engines(pair, "dense")
    tp = _pool(texpr, BatchQuery, TRB)
    assert resolve_query_engine("auto", tp, teng.device) == "torch"
    assert resolve_query_engine("auto", tp, "cuda") == "megakernel"
    assert resolve_query_engine("auto", tp[2:5], "cuda") == "cuda"
    assert resolve_query_engine("megakernel", tp, teng.device) == "megakernel"


def test_stream_index_checked():
    mega, banks = mk.random_plan(4)
    tb = [as_i32(b, "cpu") for b in banks]
    with pytest.raises(mk.StreamIndexError, match="row"):
        mk.raw_call(mega, tb[0][:1], tb[1], tb[2])
    mega.host["dst"][3] = mega.slots_pad + 1
    mega._checked.clear()
    with pytest.raises(mk.StreamIndexError, match="slot"):
        mk.raw_call(mega, *tb)


def test_device_stream_is_step_major():
    """The device copy of the stream: one record of the eight fields per
    step, equal field for field to the host arrays."""
    mega, _ = mk.random_plan(5)
    stream = mega.device_arrays("cpu")["stream"]
    assert tuple(stream.shape) == (mega.steps_pad, len(mk.STREAM_KEYS))
    assert stream.is_contiguous()
    for j, k in enumerate(mk.STREAM_KEYS):
        assert np.array_equal(stream[:, j].numpy(), mega.host[k]), k


@pytest.mark.parametrize("slots_pad,reason", [(2048, None), (4096, "slots")])
def test_capacity_beside_the_prefetch_ring(slots_pad, reason):
    """The ring takes shared memory from the slots, and slots_pad 2048
    still fits beside the deepest ring built."""
    assert mk.MAX_SLOTS >= 2049
    assert mk.MAX_SLOTS * mk.SLOT_BYTES + mk.RING_BYTES <= mk.SMEM_BYTES
    em = mk._Emitter()
    em.emit(mk.ZERO, dst=0)
    host = em.finish(slots_pad, 0, 1)
    mega = mk.MegaPlan("full", 1, host["opc"].size, slots_pad, slots_pad, 0,
                       1, host)
    assert mk.capacity_reason(mega) == reason
    ring = mk.PREFETCH_DEPTH * mk.SLOT_BYTES + 128 * mk.RECORD_BYTES
    assert mk.RING_BYTES == ring == 6144
    assert mega.smem_bytes == (slots_pad + 1) * mk.SLOT_BYTES + ring


def test_ring_sizes_are_compiled_in_from_one_place(monkeypatch):
    """The kernel's ring sizes are the -D defines the build passes, the
    same entries the capacity rests on; the source writes no number of its
    own, and another size builds another library."""
    flags = build.nvcc_flags("megakernel.cu")
    assert f"-DRB_RECORD_RING={mk.RECORD_RING}" in flags
    assert f"-DRB_PREFETCH_DEPTH={mk.PREFETCH_DEPTH}" in flags
    src = (build.CSRC / "megakernel.cu").read_text()
    assert "constexpr int kRecs = RB_RECORD_RING;" in src
    assert "constexpr int kDepth = RB_PREFETCH_DEPTH;" in src
    assert build.nvcc_flags("densify_chunks.cu") == build.NVCC_FLAGS
    path = build.library_path("megakernel.cu")
    monkeypatch.setitem(build.DEFINES, "megakernel.cu",
                        {"RB_RECORD_RING": 128, "RB_PREFETCH_DEPTH": 16})
    assert build.library_path("megakernel.cu") != path
