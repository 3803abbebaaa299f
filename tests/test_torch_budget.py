"""The device-memory budget of the port against roaringbitmap_tpu's.

``guard.parse_bytes`` / ``ROARING_TPU_HBM_BUDGET`` and ``GuardPolicy``'s
budget and pipeline-depth fields read as in the JAX package;
``resolve_hbm_budget`` is None on the CPU, where no card has memory to
protect.  The batch engine's proactive split halves a batch predicted past
the budget by the JAX package's rule (``_split_layout`` of both packages
over the same predictions), and the results stay bit-exact.  The footprint
model (``insights.analysis``) adds up its terms as documented.
"""

import numpy as np
import pytest

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEng
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.insights import analysis
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine as TEng
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.parallel.batch_engine import random_query_pool
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.runtime import guard

CPU = "cpu"
N = 12


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for var in (guard.ENV_HBM_BUDGET, guard.ENV_PIPELINE_DEPTH):
        monkeypatch.delenv(var, raising=False)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(0xB0D)
    vals = [np.unique(rng.integers(0, 1 << 18, 3000 + 500 * i)).astype(
        np.uint32) for i in range(N)]
    return ([JRB.from_values(v) for v in vals],
            [TRB.from_values(v) for v in vals])


def _pool():
    return [TQ(q.op, q.operands, form="bitmap")
            for q in random_query_pool(N, 24, seed=0xB0, max_operands=6)]


# ----------------------------------------------------------- the knobs

@pytest.mark.parametrize("spec", ["64M", "1g", "512", "0", "-5", " 2K ",
                                  "1.5M", "3G"])
def test_parse_bytes_matches_jax(spec, monkeypatch):
    assert guard.parse_bytes(spec) == jguard.parse_bytes(spec)
    monkeypatch.setenv(guard.ENV_HBM_BUDGET, spec)
    assert guard.ENV_HBM_BUDGET == jguard.ENV_HBM_BUDGET
    assert guard.GuardPolicy.from_env().hbm_budget == \
        jguard.GuardPolicy.from_env().hbm_budget == guard.parse_bytes(spec)


@pytest.mark.parametrize("bad", ["abc", "12X", "", "M"])
def test_bad_budget_raises_in_both(bad):
    with pytest.raises(ValueError):
        guard.parse_bytes(bad)
    with pytest.raises(ValueError):
        jguard.parse_bytes(bad)


def test_pipeline_depth_knob_matches_jax(monkeypatch):
    assert guard.GuardPolicy().pipeline_depth == \
        jguard.GuardPolicy().pipeline_depth == 2
    for raw in ("4", "1", "0"):
        monkeypatch.setenv(guard.ENV_PIPELINE_DEPTH, raw)
        assert guard.ENV_PIPELINE_DEPTH == jguard.ENV_PIPELINE_DEPTH
        assert guard.GuardPolicy.from_env().pipeline_depth == \
            jguard.GuardPolicy.from_env().pipeline_depth


def test_resolve_budget_on_the_cpu():
    """None on the CPU (nothing to protect; no allocator query); an
    explicit budget wins everywhere, <= 0 meaning unlimited."""
    assert guard.resolve_hbm_budget(guard.GuardPolicy(), CPU) is None
    assert guard.resolve_hbm_budget(guard.GuardPolicy()) is None
    assert guard.resolve_hbm_budget(
        guard.GuardPolicy(hbm_budget=1 << 20), CPU) == 1 << 20
    assert guard.resolve_hbm_budget(guard.GuardPolicy(hbm_budget=0),
                                    "cuda") is None
    assert guard.resolve_hbm_budget(guard.GuardPolicy(hbm_budget=-3),
                                    CPU) is None


# ------------------------------------------------ the batch engine split

@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("share", [2, 3, 7])
def test_split_layout_follows_the_jax_rule(pair, layout, share):
    """Both packages' ``_split_layout`` over the port's predictions give
    the same sub-batch sizes, and ``execute`` dispatches exactly them."""
    jb, tb = pair
    te = TEng(DeviceBitmapSet(tb, layout=layout, device=CPU))
    je = JEng.from_bitmaps(jb, layout="dense")
    pool = _pool()
    full = te.predict_dispatch_bytes(pool)
    budget = full // share
    by_key = {(q.op, q.operands, q.form): q for q in pool}

    def port_pred(qs, _eng="auto"):
        return te.predict_dispatch_bytes(
            [by_key[(q.op, q.operands, q.form)] for q in qs], "torch")

    je.predict_dispatch_bytes = port_pred
    jpool = [JQ(q.op, q.operands, form=q.form) for q in pool]
    layout_t = te._split_layout(pool, "torch", budget)
    assert layout_t == je._split_layout(jpool, "xla", budget)
    assert sum(layout_t) == len(pool) and len(layout_t) > 1
    assert te._split_layout(pool, "torch", None) == [len(pool)]
    assert te._split_layout(pool, "torch", full) == [len(pool)]

    dispatched = []
    real = te._execute_once

    def spy(qs, eng, inject=True):
        dispatched.append(len(qs))
        return real(qs, eng, inject)

    te._execute_once = spy
    got = te.execute(pool, engine="torch",
                     policy=guard.GuardPolicy(hbm_budget=budget))
    assert dispatched == layout_t
    assert te.proactive_split_count == len(layout_t) - 1
    assert te.split_count == 0
    want = je.execute(jpool, engine="xla", fallback=False)
    for g, w, r in zip(got, want, te._execute_sequential(pool)):
        assert g.cardinality == w.cardinality == r.cardinality
        assert g.bitmap.serialize() == w.bitmap.serialize()


def test_split_keeps_expressions_exact(pair):
    _, tb = pair
    te = TEng(DeviceBitmapSet(tb, layout="dense", device=CPU))
    pool = texpr.random_expr_pool(N, 6, depth=2, seed=4, form="bitmap")
    budget = te.predict_dispatch_bytes(pool, "cuda") // 2
    got = te.execute(pool, engine="cuda",
                     policy=guard.GuardPolicy(hbm_budget=budget))
    assert te.proactive_split_count > 0
    for g, r in zip(got, te._execute_sequential(pool)):
        assert g.cardinality == r.cardinality and g.bitmap == r.bitmap


# ------------------------------------------------------- the footprint

SIGS = [("or", 4, 8, 4, 3, True), ("andnot", 2, 16, 8, 4, False),
        ("and", 8, 4, 2, 2, False)]


@pytest.mark.parametrize("engine", ["megakernel", "cuda", "torch"])
def test_batch_model_terms(engine):
    dense = analysis.predict_batch_dispatch_bytes(SIGS, "dense", 100, engine)
    streams = analysis.predict_batch_dispatch_bytes(SIGS, "streams", 100,
                                                    engine)
    terms = ("gather_bytes", "scratch_bytes", "heads_bytes", "output_bytes",
             "densify_bytes")
    for rep in (dense, streams):
        assert rep["peak_bytes"] == sum(rep[k] for k in terms) \
            + analysis.DISPATCH_SLACK_BYTES
    assert dense["densify_bytes"] == 0
    assert streams["densify_bytes"] == analysis.densify_bytes(100, engine)
    if engine == "megakernel":
        assert dense["gather_bytes"] == dense["heads_bytes"] == 0
    else:
        # each bucket gathers q * r_pad rows and reduces into q * (k_pad +
        # 1) head slots
        assert dense["gather_bytes"] == sum(
            q * r * (analysis.ROW_BYTES + analysis.INDEX_BYTES)
            for _, q, r, _, _, _ in SIGS)


def test_models_order_the_rungs():
    """B5 streams rows through shared memory, the kernel rung gathers once,
    the plain rung adds the doubling scratch and popcount's copies."""
    peaks = [analysis.predict_batch_dispatch_bytes(SIGS, "dense", 0, e)
             ["peak_bytes"] for e in ("megakernel", "cuda", "torch")]
    assert peaks[0] < peaks[1] < peaks[2]
    sets = [("dense", 500), ("streams", 300), ("streams", 700)]
    rep = analysis.predict_multiset_dispatch_bytes(SIGS, sets, "cuda",
                                                   pool_rows=64)
    assert rep["densify_bytes"] == analysis.densify_bytes(700, "cuda")
    assert rep["concat_bytes"] == 64 * analysis.ROW_BYTES
    whole = analysis.predict_multiset_dispatch_bytes(SIGS, sets, "cuda")
    assert whole["concat_bytes"] == 1500 * analysis.ROW_BYTES


def test_expr_model_counts_fused_sections(pair):
    _, tb = pair
    te = TEng(DeviceBitmapSet(tb, layout="dense", device=CPU))
    pool = texpr.random_expr_pool(N, 4, depth=2, seed=9, form="bitmap")
    sig = te.plan(pool).expr_signature
    reps = {e: analysis.predict_expr_dispatch_bytes(sig, e)
            for e in ("megakernel", "cuda")}
    for rep in reps.values():
        assert rep["peak_bytes"] == (rep["leaf_bytes"] + rep["combine_bytes"]
                                     + rep["scan_bytes"]
                                     + rep["output_bytes"]) > 0
    assert reps["megakernel"]["combine_bytes"] == 0
    assert reps["cuda"]["combine_bytes"] > 0
    assert analysis.predict_expr_dispatch_bytes(
        [("flat", True, (), -1, 3)], "cuda")["peak_bytes"] == 0
