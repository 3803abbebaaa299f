"""The port's guarded runtime (``runtime.errors`` / ``faults`` / ``guard``)
against roaringbitmap_tpu.runtime.

- ``classify`` gives the JAX package's class on the same messages, and the
  port-only cases: ``torch.OutOfMemoryError`` is ``ResourceExhausted``; a
  kernel build or launch failure is never classified, even with "out of
  memory" in its text, and the guard re-raises it raw (no demotion).
- The fault grammar parses the same specs into the same rules, rejects the
  same bad specs, and draws the same schedule for the same calls (a port
  rung is drawn under the JAX rung it stands for: "cuda" as "pallas",
  "torch" as "xla").
- Under the same injected specs (JAX rung names mapped to the port's),
  ``or_`` / ``xor`` / ``and_`` / ``*_cardinality`` and
  ``BatchEngine.execute`` take the same retries and demotions and land on
  the same rung position as the JAX package, with results equal to the
  sequential host fold.  The port runs on ``device="cpu"``, where the
  "cuda" rung runs the kernels' plain versions, so the ladder is testable
  here.  Exact: counts, cardinalities and members.
"""

import json

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.parallel import aggregation as jagg
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.batch_engine import BatchEngine as JEng
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.runtime import errors as jerrors
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.ops import kernels
from roaringbitmap_tpu_torch.ops.build import KernelBuildError
from roaringbitmap_tpu_torch.ops.kernels import KernelLaunchError
from roaringbitmap_tpu_torch.parallel import aggregation as tagg
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.batch_engine import ENGINES as BATCH_ENGINES
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchEngine as TEng
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.obs import metrics as tmetrics
from roaringbitmap_tpu_torch.obs import trace as ttrace
from roaringbitmap_tpu_torch.runtime import errors, faults, guard

torch.set_num_threads(2)

CPU = "cpu"
N = 10
#: the JAX rung each port rung stands for
RUNG_OF = {"pallas": "cuda", "xla": "torch", "xla-vmap": "torch-vmap",
           "megakernel": "megakernel"}

MESSAGES = [
    "RESOURCE_EXHAUSTED: out of memory allocating 8388608 bytes",
    "XlaRuntimeError: UNAVAILABLE: device connection dropped",
    "DEADLINE_EXCEEDED: something slow",
    "INTERNAL: coordination service barrier timed out",
    "Mosaic lowering failed", "kernel lowering failed",
    "CUDA error: out of memory", "memory allocation failed",
    "connection reset by peer", "heartbeat timeout from task 3",
    "scan aborted: invalid plan state",
    "cannot open /data/zoom_datasets/x.bin",
    "bad coordinator_address argument type", "value cancelled_flag must be bool",
    "todo", "plain bad arg",
]


def _name(fault):
    return None if fault is None else type(fault).__name__


@pytest.mark.parametrize("msg", MESSAGES)
@pytest.mark.parametrize("exc_type", [RuntimeError, NotImplementedError,
                                      ValueError])
def test_classify_matches_jax(msg, exc_type):
    assert _name(errors.classify(exc_type(msg))) == \
        _name(jerrors.classify(exc_type(msg)))


def test_classify_typed_and_port_only_cases():
    for cls in (errors.TransientDeviceError, errors.ResourceExhausted,
                errors.EngineLoweringError, errors.ShadowMismatch,
                errors.CorruptInput):
        e = cls("x")
        assert errors.classify(e) is e
    assert isinstance(errors.classify(torch.OutOfMemoryError("no room")),
                      errors.ResourceExhausted)
    for raw in (KernelBuildError("nvcc: out of memory"),
                KernelLaunchError("segmented_reduce: CUDA error 2 (out of "
                                  "memory)"),
                KernelLaunchError("UNAVAILABLE: transient")):
        assert errors.classify(raw) is None
    assert errors.CorruptInput is TRB.deserialize.__globals__[
        "spec"].InvalidRoaringFormat


def test_failed_launch_is_never_demoted(monkeypatch):
    """A launch failure with "out of memory" in its status text re-raises
    as it is: the guard neither retries nor demotes to the plain rung."""
    def fail(*a, **k):
        raise KernelLaunchError("segmented_reduce_blocked: CUDA error 2 "
                                "(out of memory)")

    monkeypatch.setattr(kernels, "segmented_reduce_blocked", fail)
    bms = _bitmaps(TRB)
    guard.reset_dispatch_stats()
    with pytest.raises(KernelLaunchError):
        tagg.or_(bms, engine="cuda", device=CPU)
    assert guard.dispatch_stats("aggregation") == {
        "retries": 0, "demotions": 0, "sequential": 0}
    assert tagg.or_(bms, engine="torch", device=CPU) == \
        tagg._sequential_reduce("or", bms)


SPECS = ["transient=0.5,oom@pallas,lowering@batch_engine=0.25:42",
         "slow@aggregation=0.1,silent:7", "crash@torn=0.5:3",
         "wire@conn_drop=1.0,coordinator:0x10"]


@pytest.mark.parametrize("spec", SPECS)
def test_fault_grammar_matches_jax(spec):
    t, j = faults.FaultPlan.from_spec(spec), jfaults.FaultPlan.from_spec(spec)
    assert t.seed == j.seed
    assert [(r.kind, r.scope, r.rate) for r in t.rules] == \
        [(r.kind, r.scope, r.rate) for r in j.rules]
    for i in range(len(t.rules)):
        for key in ("aggregation/pallas", "batch_engine/xla", "s/e"):
            assert [t._draw(i, key) for _ in range(8)] == \
                [j._draw(i, key) for _ in range(8)]


@pytest.mark.parametrize("bad", [
    "transient=0.5", "nosuchkind:3", "transient=2.0:3", "transient=x:3",
    ":", "  :9", "wire=1.0:3", "oom=0:1"])
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        faults.FaultPlan.from_spec(bad)
    with pytest.raises(ValueError):
        jfaults.FaultPlan.from_spec(bad)


def test_schedule_matches_jax_under_rung_names():
    t = faults.FaultPlan.from_spec("transient=0.4,oom@aggregation=0.3:99")
    j = jfaults.FaultPlan.from_spec("transient=0.4,oom@aggregation=0.3:99")
    for jr, tr in RUNG_OF.items():
        assert [t.pick("aggregation", tr) for _ in range(32)] == \
            [j.pick("aggregation", jr) for _ in range(32)]


def test_clock_and_deadline():
    t0 = faults.clock()
    with faults.inject("slow=1.0:1"):
        assert faults.maybe_delay("aggregation", "cuda") == \
            faults.SLOW_LATENCY_S
    assert faults.clock() - t0 >= faults.SLOW_LATENCY_S
    dl = guard.Deadline(0.01)
    faults.advance_clock(0.02)
    assert dl.expired() and dl.remaining() == 0.0
    with faults.inject("slow@aggregation=1.0:4"):
        with pytest.raises(errors.TransientDeviceError, match="deadline"):
            guard.run_with_fallback(
                "aggregation", ("cuda",), lambda r: 1,
                policy=guard.GuardPolicy(deadline=0.01),
                sequential=lambda: 2)


def test_policy_from_env(monkeypatch):
    monkeypatch.setenv("ROARING_TPU_MAX_ATTEMPTS", "5")
    monkeypatch.setenv("ROARING_TPU_BACKOFF_S", "0")
    monkeypatch.setenv("ROARING_TPU_SHADOW", "0.25:0x11")
    t, j = guard.GuardPolicy.from_env(), jguard.GuardPolicy.from_env()
    for f in ("max_attempts", "backoff_base", "shadow_rate", "shadow_seed"):
        assert getattr(t, f) == getattr(j, f)
    assert guard.chain_from("cuda", ("cuda", "torch")) == tuple(
        RUNG_OF.get(r, r)
        for r in jguard.chain_from("pallas", ("pallas", "xla")))
    assert guard.shadow_sample(50, 0.3, 7, "x") == \
        jguard.shadow_sample(50, 0.3, 7, "x")


# ------------------------------------------- the ladders against the JAX one

def _values():
    rng = np.random.default_rng(0xBEEF)
    common = np.arange(300, 700, dtype=np.uint32)
    out = []
    for i in range(N):
        parts = [rng.integers(0, 1 << 17, 2500).astype(np.uint32), common]
        if i % 4 == 0:
            parts.append(np.arange(1 << 16, (1 << 16) + 15000,
                                   dtype=np.uint32))
        out.append(np.unique(np.concatenate(parts)))
    return out


def _bitmaps(cls):
    return [cls.from_values(v) for v in _values()]


def _port_spec(spec: str) -> str:
    for jr, tr in RUNG_OF.items():
        spec = spec.replace(f"@{jr}", f"@{tr}")
    return spec


@pytest.fixture(autouse=True)
def _no_backoff(monkeypatch):
    monkeypatch.setenv("ROARING_TPU_BACKOFF_S", "0")
    monkeypatch.delenv("ROARING_TPU_FAULTS", raising=False)
    monkeypatch.delenv("ROARING_TPU_SHADOW", raising=False)


WIDE_SPECS = ["transient@aggregation=1.0:1", "lowering@pallas:2",
              "oom=1.0:3", "lowering:4", "transient=0.5:5",
              "transient=0.7,oom@xla=0.5:9", "lowering@xla:6",
              "oom@pallas=0.5,transient@xla=0.6:12"]


@pytest.mark.parametrize("spec", WIDE_SPECS)
@pytest.mark.parametrize("call", ["or_", "xor", "and_", "or_cardinality",
                                  "xor_cardinality", "and_cardinality"])
def test_wide_ladder_matches_jax(spec, call):
    tb, jb = _bitmaps(TRB), _bitmaps(JRB)
    op = call.split("_")[0]
    kw = {} if call.startswith("and") else {"engine": "pallas"}
    guard.reset_dispatch_stats()
    jguard.reset_dispatch_stats()
    with jfaults.inject(spec):
        want = getattr(jagg, call)(*jb, **kw)
    with faults.inject(_port_spec(spec)):
        got = getattr(tagg, call)(
            tb, device=CPU, **({"engine": "cuda"} if kw else {}))
    assert guard.dispatch_stats("aggregation") == \
        jguard.dispatch_stats("aggregation")
    ref = tagg._sequential_reduce(op, tb)
    if call.endswith("cardinality"):
        assert got == want == ref.cardinality
    else:
        assert got == ref and got.serialize() == want.serialize()


@pytest.mark.parametrize("spec,start,landed", [
    ("lowering@pallas:1", "pallas", "torch"),
    ("transient@pallas=1.0:2", "pallas", "torch"),
    ("transient@batch_engine=0.5:5", "pallas", "cuda"),
    ("oom@pallas=1.0:3", "pallas", "torch"),
    ("transient=0.3,oom@pallas=0.4:8", "pallas", None),
    ("lowering@megakernel,lowering@pallas:4", "megakernel", "torch"),
    ("oom@megakernel:6", "megakernel", "cuda"),
    ("lowering@pallas,lowering@xla:3", "pallas", "torch-vmap"),
    ("transient@xla=1.0,lowering@pallas:5", "pallas", "torch-vmap"),
    ("lowering@megakernel,lowering@pallas,lowering@xla:4", "megakernel",
     "torch-vmap"),
    ("oom@xla=1.0,lowering@pallas:9", "pallas", None),
])
def test_batch_ladder_matches_jax(spec, start, landed):
    """A fault spec walks both ladders alike: the same retries, demotions,
    splits and landings, down to the per-query cross-check rung
    ("xla-vmap" in the JAX package, "torch-vmap" in the port)."""
    tb, jb = _bitmaps(TRB), _bitmaps(JRB)
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    je = JEng(jagg.DeviceBitmapSet(jb))
    flat = [("or", (0, 3, 5)), ("and", (0, 4, 8)), ("xor", (1, 2, 7)),
            ("andnot", (2, 6, 9))]
    tq = [TQ(o, s, form="bitmap") for o, s in flat]
    jq = [JQ(o, s, form="bitmap") for o, s in flat]
    if start == "megakernel":
        tq = [texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)),
                              form="bitmap"),
              texpr.ExprQuery(texpr.xor(texpr.or_(3, 4), 5), form="bitmap")]
        jq = [jexpr.ExprQuery(jexpr.and_(jexpr.or_(0, 1), jexpr.not_(2)),
                              form="bitmap"),
              jexpr.ExprQuery(jexpr.xor(jexpr.or_(3, 4), 5), form="bitmap")]
    guard.reset_dispatch_stats()
    jguard.reset_dispatch_stats()
    t_split, j_split = te.split_count, je.split_count
    with jfaults.inject(spec):
        want = je.execute(jq, engine=start)
    with faults.inject(_port_spec(spec)):
        got = te.execute(tq, engine=RUNG_OF[start])
    stats = guard.dispatch_stats("batch_engine")
    assert stats == jguard.dispatch_stats("batch_engine")
    assert te.split_count - t_split == je.split_count - j_split
    assert stats["sequential"] == 0
    if landed is not None:
        assert te.last_timings["engine"] == landed
    ref = te._execute_sequential(tq)
    for g, w, r in zip(got, want, ref):
        assert g.cardinality == w.cardinality == r.cardinality
        assert g.bitmap == r.bitmap
        assert g.bitmap.serialize() == w.bitmap.serialize()


@pytest.mark.parametrize("spec", [
    "lowering@pallas,lowering@xla:3",
    "transient@xla=1.0,lowering@pallas:5",
    "oom@xla=1.0,lowering@pallas:9",
    "transient@multiset=0.5:11",
])
def test_multiset_ladder_matches_jax(spec):
    """The pooled engine walks the same ladder: a walk that reaches the
    per-query rung runs the unmerged per-bucket path on both packages."""
    from roaringbitmap_tpu.parallel import multiset as jms
    from roaringbitmap_tpu_torch.parallel import multiset as tms

    tb, jb = _bitmaps(TRB), _bitmaps(JRB)
    tm = tms.MultiSetBatchEngine.from_bitmap_sets([tb[:5], tb[5:]],
                                                  layout="dense", device=CPU)
    jm = jms.MultiSetBatchEngine.from_bitmap_sets([jb[:5], jb[5:]],
                                                  layout="dense")
    flat = [(0, "or", (0, 3)), (1, "xor", (1, 2, 4)), (0, "and", (0, 1)),
            (1, "andnot", (2, 0, 3))]
    tg = [tms.BatchGroup(s, [TQ(o, ops, form="bitmap")])
          for s, o, ops in flat]
    jg = [jms.BatchGroup(s, [JQ(o, ops, form="bitmap")])
          for s, o, ops in flat]
    guard.reset_dispatch_stats()
    jguard.reset_dispatch_stats()
    with jfaults.inject(spec):
        want = jm.execute(jg, engine="pallas")
    with faults.inject(_port_spec(spec)):
        got = tm.execute(tg, engine="cuda")
    stats = guard.dispatch_stats("multiset")
    assert stats == jguard.dispatch_stats("multiset")
    assert stats["sequential"] == 0
    ref = tm._sequential([(g.set_id, q) for g in tg for q in g.queries])
    for g, w, r in zip(sum(got, []), sum(want, []), ref):
        assert g.cardinality == w.cardinality == r.cardinality
        assert g.bitmap.serialize() == w.bitmap.serialize()
        assert g.bitmap == r.bitmap


def test_plain_rungs_stay_off_the_card_chain():
    """On a CUDA device the chain drops both plain rungs unless one is the
    requested rung; off the card it walks them before the host."""
    from roaringbitmap_tpu_torch.parallel.batch_engine import ENGINES

    assert ENGINES[-1] == "torch-vmap"
    assert guard.chain_from("megakernel", ENGINES, "cuda") == \
        ("megakernel", "cuda")
    assert guard.chain_from("torch-vmap", ENGINES, "cuda") == ("torch-vmap",)
    assert guard.chain_from("cuda", ENGINES, "cpu") == \
        ("cuda", "torch", "torch-vmap", "sequential")


def test_every_rung_down_lands_on_sequential():
    tb = _bitmaps(TRB)
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    q = [TQ("or", (0, 1, 2), form="bitmap"), TQ("and", (0, 4))]
    guard.reset_dispatch_stats()
    with faults.inject("lowering=1.0:23"):
        got = te.execute(q, engine="megakernel")
    assert te.last_timings["engine"] == guard.SEQUENTIAL
    assert guard.dispatch_stats("batch_engine")["sequential"] == 1
    assert tmetrics.histogram("rb_execute_latency_seconds",
                              site="batch_engine",
                              engine="sequential").count == 1
    assert [g.cardinality for g in got] == \
        [r.cardinality for r in te._execute_sequential(q)]


def test_shadow_and_corrupt_and_raw_paths():
    tb = _bitmaps(TRB)
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    q = [TQ("or", (0, 1, 2)), TQ("xor", (3, 4))]
    shadow = guard.GuardPolicy(shadow_rate=1.0, sleep=lambda s: None)
    assert [r.cardinality for r in te.execute(q, policy=shadow)] == \
        [r.cardinality for r in te._execute_sequential(q)]
    with faults.inject("silent@batch_engine=1.0:3"):
        with pytest.raises(errors.ShadowMismatch):
            te.execute(q, engine="cuda", policy=shadow)
    with faults.inject("silent@batch_engine=1.0:3"):
        got = te.execute(q, engine="cuda", policy=guard.GuardPolicy())
    assert got[0].cardinality == te._execute_sequential(q)[0].cardinality + 1
    with faults.inject("corrupt@cuda=1.0:17"):
        with pytest.raises(errors.CorruptInput):
            te.execute(q, engine="cuda")
    # fallback=False: no guard and no injection
    with faults.inject("lowering=1.0:1"):
        raw = te.execute(q, engine="cuda", fallback=False)
        assert tagg.or_(tb, engine="cuda", device=CPU, fallback=False) == \
            tagg._sequential_reduce("or", tb)
    assert [r.cardinality for r in raw] == \
        [r.cardinality for r in te._execute_sequential(q)]


def test_wide_shadow_catches_a_wrong_result(monkeypatch):
    """The wide harness's shadow check: a rung that returns a wrong bitmap
    raises ShadowMismatch under ROARING_TPU_SHADOW=1.0, and the same rung
    passes unchecked without it."""
    tb = _bitmaps(TRB)

    dev = torch.device(CPU)

    def raw(rung):
        res = tagg._aggregate_ragged_device("or", tb, rung, dev)
        res.remove(int(res.to_array()[0]))
        return res

    assert tagg._guarded_wide("or", tb, "cuda", dev, raw,
                              True).cardinality == \
        tagg._sequential_reduce("or", tb).cardinality - 1
    monkeypatch.setenv("ROARING_TPU_SHADOW", "1.0")
    with pytest.raises(errors.ShadowMismatch, match="diverged from the sequential"):
        tagg._guarded_wide("or", tb, "cuda", dev, raw, True)
    assert tagg.or_(tb, device=CPU) == tagg._sequential_reduce("or", tb)


# ------------------------------------------------- the chains on the card
#
# On a CUDA device a chain never reaches the plain rung or the host: it
# holds the requested rung and the kernel rungs below it, and a fault the
# last rung cannot retry or split away re-raises typed.  The chain is a
# function of the device alone, so it is held here on CPU tensors by
# handing the guard a CUDA device (the wide harness) or the card's chain
# (the batch engine).

CARD = torch.device("cuda", 0)


@pytest.mark.parametrize("engine,ladder,want", [
    ("cuda", tagg.ENGINES, ("cuda",)),
    ("torch", tagg.ENGINES, ("torch",)),
    ("megakernel", BATCH_ENGINES, ("megakernel", "cuda")),
    ("cuda", BATCH_ENGINES, ("cuda",)),
])
def test_card_chain_has_no_plain_or_host_rung(engine, ladder, want):
    assert guard.chain_from(engine, ladder, CARD) == want
    assert guard.chain_from(engine, ladder, "cuda") == want
    assert guard.chain_from(engine, ladder, CPU)[-1] == guard.SEQUENTIAL


@pytest.mark.parametrize("spec,fault,retries", [
    ("lowering@cuda:1", errors.EngineLoweringError, 0),
    ("oom@cuda:2", errors.ResourceExhausted, 0),
    ("transient@aggregation=1.0:3", errors.TransientDeviceError, 2),
])
def test_wide_fault_on_the_card_raises_typed(spec, fault, retries):
    tb = _bitmaps(TRB)
    ran = []

    def raw(rung):
        ran.append(rung)
        return tagg._aggregate_ragged_device("or", tb, rung,
                                             torch.device(CPU))

    guard.reset_dispatch_stats()
    with faults.inject(spec):
        with pytest.raises(fault):
            tagg._guarded_wide("or", tb, "cuda", CARD, raw, True)
    assert ran == []          # the seam fires before every attempt
    assert guard.dispatch_stats("aggregation") == {
        "retries": retries, "demotions": 0, "sequential": 0}
    # the same fault on the CPU demotes and the result stays equal
    with faults.inject(spec):
        got = tagg._guarded_wide("or", tb, "cuda", torch.device(CPU), raw,
                                 True)
    assert got == tagg._sequential_reduce("or", tb)


@pytest.mark.parametrize("spec,landed,fault", [
    ("oom@megakernel:6", "cuda", None),
    ("lowering@megakernel:4", "cuda", None),
    ("lowering=1.0:23", None, errors.EngineLoweringError),
    ("oom=1.0:5", None, errors.ResourceExhausted),
])
def test_batch_fault_on_the_card_chain(spec, landed, fault, tmp_path):
    """The card's chain, megakernel -> cuda: a megakernel fault lands on the
    "cuda" kernels; a fault "cuda" cannot split away re-raises typed after
    the OOM halving, with no sequential landing."""
    tb = _bitmaps(TRB)
    te = TEng(tagg.DeviceBitmapSet(tb, device=CPU))
    q = [texpr.ExprQuery(texpr.and_(texpr.or_(0, 1), texpr.not_(2)),
                         form="bitmap"),
         texpr.ExprQuery(texpr.xor(texpr.or_(3, 4), 5), form="bitmap")]
    chain = guard.chain_from("megakernel", BATCH_ENGINES, CARD)
    policy = guard.GuardPolicy.from_env()
    guard.reset_dispatch_stats()
    splits = te.split_count
    path = tmp_path / "guard.jsonl"
    ttrace.enable(str(path))
    try:
        with faults.inject(spec):
            if fault is None:
                got = te._dispatch(q, chain, policy, guard.Deadline(None))
            else:
                with pytest.raises(fault):
                    te._dispatch(q, chain, policy, guard.Deadline(None))
    finally:
        ttrace.disable()
    stats = guard.dispatch_stats("batch_engine")
    assert stats["sequential"] == 0
    # no guard decision (retry, demotion, landing) ever touched "torch"
    spans = [json.loads(line) for line in path.read_text().splitlines()]
    rungs = {ev.get(k) for sp in spans if sp["name"] == "guard.dispatch"
             for ev in sp["events"] for k in ("engine_from", "engine_to")}
    assert "torch" not in rungs
    assert all(sp["tags"].get("rung_used") != "torch" for sp in spans
               if sp["name"] == "guard.dispatch")
    if spec.startswith("oom"):
        assert te.split_count - splits == 1      # halved to single queries
    if fault is None:
        assert te.last_timings["engine"] == landed
        for g, r in zip(got, te._execute_sequential(q)):
            assert g.cardinality == r.cardinality and g.bitmap == r.bitmap
