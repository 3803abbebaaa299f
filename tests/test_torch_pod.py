"""The port's pod data plane (parallel/podmesh.py, serving/frontdoor.py,
serving/migration.py) against the JAX package's.

A simulated pod over the device "cpu" repeated eight times stands for the
JAX suite's 8 virtual CPU devices.  Held exact against the JAX package:
the placement math, routes, the front door's routing of every ticket and
its cardinalities, reroutes and demotions under the same fault specs;
held exact against the host oracle: every served ticket.  Two and four
gloo processes (``file://`` store, one timeout each) bring up a detected
pod whose plan and routes agree across processes and with the JAX
package's single-process simulated pod, and whose pod-spanning sharded
dispatch equals the single-process result and the JAX engine's on the
simulated pod's mesh."""

import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu.insights import analysis as jins
from roaringbitmap_tpu.parallel import BatchGroup as JGroup
from roaringbitmap_tpu.parallel import BatchQuery as JQ
from roaringbitmap_tpu.parallel import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel import ShardedBatchEngine as JSharded
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel import podmesh as jpod
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu.serving import PodFrontDoor as JFront
from roaringbitmap_tpu.serving import ServingPolicy as JPolicy
from roaringbitmap_tpu.serving import ServingRequest as JReq
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs
from roaringbitmap_tpu_torch.insights import analysis as insights
from roaringbitmap_tpu_torch.mutation.durability import (DurableTenant,
                                                         FlushPolicy)
from roaringbitmap_tpu_torch.parallel import (BatchQuery, DeviceBitmapSet,
                                              MultiSetBatchEngine, expr,
                                              multihost, podmesh)
from roaringbitmap_tpu_torch.runtime import errors, faults, guard
from roaringbitmap_tpu_torch.serving import (MigrationError, PodFrontDoor,
                                             ServingLoop, ServingPolicy,
                                             ServingRequest, TenantPolicy,
                                             begin_migration, host_join,
                                             host_leave, migrate_tenant,
                                             restore_host_tenants)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"
DEVICES = [CPU] * 8
NOSLEEP = guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
JNOSLEEP = jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)
EASY_MS = 300_000.0
MIB = 1 << 20


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("ROARING_TPU_FAULTS", raising=False)
    obs.disable()
    obs.reset()
    guard.reset_dispatch_stats()
    faults.reset_clock()
    jfaults.reset_clock()
    yield
    obs.disable()
    obs.reset()
    faults.reset_clock()
    jfaults.reset_clock()


def _values(seed=0x90D, n_sets=3, n=5):
    rng = np.random.default_rng(seed)
    return [[np.unique(rng.integers(0, 1 << 16, 700).astype(np.uint32))
             for _ in range(n)] for _ in range(n_sets)]


@pytest.fixture(scope="module")
def tenant_sets():
    return [DeviceBitmapSet([TRB.from_values(v) for v in t], layout="dense",
                            device=CPU) for t in _values()]


@pytest.fixture(scope="module")
def jtenant_sets():
    return [JSet([JRB.from_values(v) for v in t], layout="dense")
            for t in _values()]


@pytest.fixture(scope="module")
def reference(tenant_sets):
    return MultiSetBatchEngine(tenant_sets)


#: tenant 0 capacity-sharded, tenant 1 replicated on both hosts, tenant 2
#: local to host 0
MIXED_PLAN = podmesh.PlacementPlan(
    regimes=("sharded", "replicated-2", "local"),
    hosts=((0, 1), (0, 1), (0,)), bytes_per_host=(0, 0))


def _jplan(plan):
    return jpod.PlacementPlan(regimes=plan.regimes, hosts=plan.hosts,
                              bytes_per_host=plan.bytes_per_host)


def _policy(**kw):
    kw.setdefault("guard", NOSLEEP)
    kw.setdefault("default_deadline_ms", EASY_MS)
    kw.setdefault("pool_target", 4)
    return ServingPolicy(**kw)


def _front_door(tenant_sets, plan=MIXED_PLAN, n_hosts=2, **kw):
    return PodFrontDoor(tenant_sets,
                        pod=podmesh.PodMesh.simulate(n_hosts,
                                                     devices=DEVICES),
                        plan=plan, policy=_policy(**kw))


def _jfront_door(jsets, plan=MIXED_PLAN, n_hosts=2):
    return JFront(jsets, pod=jpod.PodMesh.simulate(n_hosts),
                  plan=_jplan(plan), policy=JPolicy(
                      guard=JNOSLEEP, default_deadline_ms=EASY_MS,
                      pool_target=4))


def _requests(n, n_sets=3, seed=0xA12, jax_side=False):
    rng = np.random.default_rng(seed)
    ex, Q, R = ((jexpr, JQ, JReq) if jax_side
                else (expr, BatchQuery, ServingRequest))
    out = []
    for i in range(n):
        sid = int(rng.integers(n_sets))
        form = "bitmap" if i % 3 == 0 else "cardinality"
        if i % 7 == 3:
            q = ex.ExprQuery(ex.and_(ex.or_(0, 1), ex.not_(2)), form=form)
        else:
            op = ("or", "and", "xor", "andnot")[int(rng.integers(4))]
            q = Q(op, (0, 1, 2), form=form)
        out.append(R(sid, q, tenant=f"t{sid}"))
    return out


def _assert_exact(reference, t):
    assert t.status == "done", (t.status, t.error)
    ref = reference._engines[t.pod_sid]._sequential_one(t.query)
    assert t.result.cardinality == ref.cardinality
    if t.query.form == "bitmap":
        assert t.result.bitmap == ref


def _same_tickets(tickets, jtickets):
    assert [t.pod_host for t in tickets] == [t.pod_host for t in jtickets]
    assert [t.status for t in tickets] == [t.status for t in jtickets]
    assert [t.result.cardinality for t in tickets] == [
        t.result.cardinality for t in jtickets]


# ------------------------------------------------------- placement planner

def test_plan_pod_placement_regimes():
    t_bytes = [100 * MIB, 4 * MIB, 8 * MIB, 8 * MIB]
    kw = dict(budget_per_host=64 * MIB, qps=[1.0, 12.0, 1.0, 1.0])
    raw = insights.plan_pod_placement(t_bytes, 4, **kw)
    assert raw == jins.plan_pod_placement(t_bytes, 4, **kw)
    assert raw["regimes"][0] == "sharded" and raw["hosts"][0] == [0, 1, 2, 3]
    assert raw["regimes"][1].startswith("replicated-")
    n = int(raw["regimes"][1].split("-")[1])
    assert 2 <= n <= 4 and len(raw["hosts"][1]) == n
    assert raw["regimes"][2] == raw["regimes"][3] == "local"
    assert raw["hosts"][2] != raw["hosts"][3]
    assert not raw["over_budget"]


def test_plan_pod_placement_degenerate_and_budget():
    cases = [([MIB, 200 * MIB], 1, dict(budget_per_host=64 * MIB)),
             ([4 * MIB] * 3, 2, dict(qps=[1.0, 1.0, 1.0])),
             ([30 * MIB] * 4, 2, dict(budget_per_host=72 * MIB,
                                      qps=[8.0, 1.0, 1.0, 1.0])),
             ([5, 900, 77, 900, 3], 3, dict(budget_per_host=1000,
                                            qps=[0, 9, 1, 0, 4]))]
    for t_bytes, hosts, kw in cases:
        assert insights.plan_pod_placement(t_bytes, hosts, **kw) == \
            jins.plan_pod_placement(t_bytes, hosts, **kw)
    assert insights.plan_pod_placement([MIB, 200 * MIB], 1)["regimes"] == [
        "local", "local"]
    raw = insights.plan_pod_placement([30 * MIB] * 4, 2,
                                      budget_per_host=72 * MIB,
                                      qps=[8.0, 1.0, 1.0, 1.0])
    assert raw["regimes"][0].startswith("replicated") and raw["over_budget"]


def test_place_resolves_from_footprint_model(tenant_sets, jtenant_sets):
    pod = podmesh.PodMesh.simulate(2, devices=DEVICES)
    plan = podmesh.place(tenant_sets, pod)
    jplan = jpod.place(jtenant_sets, jpod.PodMesh.simulate(2))
    assert plan.n_tenants == 3 and all(r == "local" for r in plan.regimes)
    assert sum(plan.bytes_per_host) == sum(
        podmesh.tenant_bytes_of(tenant_sets))
    assert (plan.regimes, plan.hosts) == (jplan.regimes, jplan.hosts)
    plan2 = podmesh.place(tenant_sets, pod, qps=[50.0, 1.0, 1.0])
    jplan2 = jpod.place(jtenant_sets, jpod.PodMesh.simulate(2),
                        qps=[50.0, 1.0, 1.0])
    assert plan2.regime(0).startswith("replicated-")
    assert (plan2.regimes, plan2.hosts) == (jplan2.regimes, jplan2.hosts)
    # a per-host budget that yields all three regimes
    plan3 = podmesh.place(tenant_sets, pod,
                          budget_per_host=int(1.5 * min(
                              podmesh.tenant_bytes_of(tenant_sets))),
                          qps=[1.0, 60.0, 1.0])
    assert set(plan3.regime_counts()) <= {"sharded", "replicated", "local"}


def test_route_is_consistent_under_host_loss():
    plan = podmesh.PlacementPlan(regimes=tuple(["local"] * 32),
                                 hosts=tuple((0, 1, 2, 3) for _ in range(32)),
                                 bytes_per_host=(0, 0, 0, 0))
    jplan = _jplan(plan)
    before = {s: podmesh.route(plan, s, (0, 1, 2, 3)) for s in range(32)}
    assert before == {s: jpod.route(jplan, s, (0, 1, 2, 3))
                      for s in range(32)}
    assert len(set(before.values())) > 1
    after = {s: podmesh.route(plan, s, (0, 1, 3)) for s in range(32)}
    assert after == {s: jpod.route(jplan, s, (0, 1, 3)) for s in range(32)}
    for s in range(32):
        if before[s] != 2:
            assert after[s] == before[s]
        else:
            assert after[s] in (0, 1, 3)
    assert podmesh.route(plan, 0, ()) is None
    assert podmesh.route(plan, 5, (0, 1), overrides={5: 1}) == 1
    assert podmesh.route(plan, 5, (0,), overrides={5: 1}) == jpod.route(
        jplan, 5, (0,), overrides={5: 1})


def test_pod_meshes_and_global_put():
    pod = podmesh.PodMesh.simulate(2, devices=DEVICES)
    assert pod.host_mesh(1).devices.shape == (4, 1)
    assert pod.pod_mesh().devices.shape == (8, 1)
    pod.mark_down(1)
    assert pod.pod_mesh().devices.shape == (4, 1)
    from roaringbitmap_tpu_torch.parallel.sharding import P

    img = np.arange(8 * 6, dtype=np.uint32).reshape(8, 6)
    got = podmesh.global_put(img, pod.pod_mesh(), P("rows", None))
    assert sorted(got) == [0, 1, 2, 3]
    for i, t in got.items():
        assert np.array_equal(t.numpy().view(np.uint32),
                              img[2 * i:2 * i + 2])
    assert podmesh.supports_pod_dispatch()


# ------------------------------------------------------------ parity path

def test_pod_parity_bit_exact_matrix(tenant_sets, jtenant_sets, reference):
    """(op x regime x flat/expression x bitmap/cardinality) through the
    routed front door, including the capacity tenant through the
    pod-spanning mesh: exact against the oracle and the JAX front door."""
    fd = _front_door(tenant_sets)
    tickets = [fd.submit(r) for r in _requests(28)]
    fd.drain()
    jfd = _jfront_door(jtenant_sets)
    jt = [jfd.submit(r) for r in _requests(28, jax_side=True)]
    jfd.drain()
    assert "capacity" in {t.pod_host for t in tickets}
    for t in tickets:
        _assert_exact(reference, t)
    _same_tickets(tickets, jt)
    snap = fd.snapshot()
    assert snap["stats"] == jfd.snapshot()["stats"]
    assert snap["backlog"] == 0
    assert set(snap["placement"]) == {"0", "1", "2"}


def test_misroute_forwarding(tenant_sets, reference):
    fd = _front_door(tenant_sets)
    t = fd.submit(ServingRequest(2, BatchQuery("or", (0, 1)), tenant="t2"),
                  via_host=1)
    assert t.pod_forwarded and t.pod_host == 0
    t2 = fd.submit(ServingRequest(2, BatchQuery("or", (0, 1)),
                                  tenant="t2"), via_host=0)
    assert not t2.pod_forwarded
    fd.drain()
    assert fd.stats["forwarded"] == 1
    _assert_exact(reference, t)
    _assert_exact(reference, t2)


# --------------------------------------------------------------- host loss

def test_host_drop_reroutes_to_replica(tenant_sets, jtenant_sets,
                                       reference, tmp_path):
    """The reroute rung under ``coordinator@host1``: the same reroutes and
    landings as the JAX front door, bit-exact, and a host-loss flight
    dump."""
    obs.flight.configure(dir=str(tmp_path))
    try:
        fd = _front_door(tenant_sets)
        tickets = [fd.submit(r) for r in _requests(16, seed=0xB0B)]
        jfd = _jfront_door(jtenant_sets)
        jt = [jfd.submit(r) for r in _requests(16, seed=0xB0B,
                                               jax_side=True)]
        assert {t.pod_host for t in tickets} == {0, 1, "capacity"}
        rerouted = [t for t in tickets if t.pod_host == 1]
        with faults.inject("coordinator@host1=1.0:9"):
            fd.pump()
            fd.drain()
        with jfaults.inject("coordinator@host1=1.0:9"):
            jfd.pump()
            jfd.drain()
        assert not fd.pod.is_alive(1) and fd.pod.is_alive(0)
        assert fd.stats == jfd.stats
        assert fd.stats["reroutes"] == len(rerouted) > 0
        for t in tickets:
            _assert_exact(reference, t)
        _same_tickets(tickets, jt)
        assert all(t.pod_host == 0 for t in rerouted)
        dumps = [f for f in os.listdir(tmp_path) if "host_lost" in f]
        assert dumps
    finally:
        obs.flight.configure(dir=None)


def test_host_drop_without_replica_demotes_to_single(tenant_sets,
                                                     reference):
    plan = podmesh.PlacementPlan(regimes=("local", "local", "local"),
                                 hosts=((0,), (0,), (1,)),
                                 bytes_per_host=(0, 0))
    fd = _front_door(tenant_sets, plan=plan)
    queued = [fd.submit(ServingRequest(0, BatchQuery("xor", (0, 1, 2)),
                                       tenant="t0")) for _ in range(3)]
    fd.fail_host(0)
    late = fd.submit(ServingRequest(1, BatchQuery("and", (0, 1)),
                                    tenant="t1"))
    assert late.pod_host == "single"
    fd.drain()
    for t in queued + [late]:
        _assert_exact(reference, t)
    assert fd.stats["single_demotions"] >= 4
    assert fd.stats["host_drops"] == 1


def test_capacity_failure_demotes_tickets_to_single(tenant_sets,
                                                    reference):
    fd = _front_door(tenant_sets)
    t = fd.submit(ServingRequest(0, BatchQuery("or", (0, 1)), tenant="t0"))
    fd._cap_loop.evict_queued()
    t.status = "failed"
    t.error = errors.HostLost("pod: capacity dispatch lost its mesh")
    assert fd._after_pump("capacity", [t]) == []
    fd.drain()
    _assert_exact(reference, t)
    assert t.pod_host == "single"


def test_reroute_fires_once_typed(tenant_sets):
    fd = _front_door(tenant_sets)
    t = fd.submit(ServingRequest(2, BatchQuery("or", (0, 1)), tenant="t2"))
    fd._loops[1].evict_queued()
    t.status = "failed"
    t.error = errors.HostLost("pod: host 1 lost")
    t.pod_rerouted = True
    assert fd._after_pump(1, [t]) == [t] and t.status == "failed"
    assert isinstance(t.error, errors.CoordinatorTimeout)


def test_double_host_loss_lands_in_single_not_stranded(tenant_sets,
                                                       reference):
    plan = podmesh.PlacementPlan(regimes=("replicated-2", "local", "local"),
                                 hosts=((0, 1), (0,), (1,)),
                                 bytes_per_host=(0, 0))
    fd = _front_door(tenant_sets, plan=plan)
    t = fd.submit(ServingRequest(0, BatchQuery("or", (0, 1)), tenant="t0"))
    first = t.pod_host
    fd.fail_host(first)
    assert t.status == "queued" and t.pod_host == 1 - first
    fd.fail_host(1 - first)
    assert t.pod_host == "single"
    fd.drain()
    _assert_exact(reference, t)


# --------------------------------------------------------- fair share

def test_cross_host_fair_share_survives_reroute(tenant_sets):
    plan = podmesh.PlacementPlan(regimes=("local", "local", "local"),
                                 hosts=((0,), (1, 0), (1,)),
                                 bytes_per_host=(0, 0))
    pol = _policy(pool_target=6, tenants={
        "t0": TenantPolicy(weight=2.0), "t1": TenantPolicy(weight=1.0)})
    fd = PodFrontDoor(tenant_sets,
                      pod=podmesh.PodMesh.simulate(2, devices=DEVICES),
                      plan=plan, policy=pol)
    for _ in range(12):
        fd.submit(ServingRequest(0, BatchQuery("or", (0, 1)), tenant="t0"))
        fd.submit(ServingRequest(1, BatchQuery("or", (0, 1)), tenant="t1"))
    fd._gossip()
    fd.fail_host(1)
    by: dict = {}
    for t in fd._loops[0]._pick(6):
        by[t.request.tenant] = by.get(t.request.tenant, 0) + 1
    assert by == {"t0": 4, "t1": 2}, by


def test_gossip_merges_vtime_monotone(tenant_sets):
    fd = _front_door(tenant_sets)
    fd._loops[0]._vtime.update({"a": 5.0, "b": 1.0})
    fd._loops[1]._vtime.update({"a": 2.0, "c": 3.0})
    board = fd._gossip()
    assert board["a"] == 5.0 and board["b"] == 1.0 and board["c"] == 3.0
    assert fd._loops[1]._vtime["a"] == 5.0
    assert fd._gossip()["a"] == 5.0


# ------------------------------------------------------- pump-on-timer

def _wait(pred, secs=60):
    deadline = time.monotonic() + secs
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.005)


def test_pod_front_door_pump_driver(tenant_sets, reference):
    fd = _front_door(tenant_sets)
    drv = fd.start_pump(interval_s=0.002)
    try:
        tickets = [fd.submit(ServingRequest(
            sid, BatchQuery(("or", "and", "xor", "andnot")[i % 4],
                            (0, 1, 2)), tenant=f"t{sid}"))
            for sid in range(3) for i in range(8)]
        drv.kick()
        _wait(lambda: not any(t.status == "queued" for t in tickets), 120)
    finally:
        drv.stop(drain=True)
    assert drv.last_error is None
    for t in tickets:
        _assert_exact(reference, t)


def test_pump_driver_fault_clock_deadline(tenant_sets):
    loop = ServingLoop(MultiSetBatchEngine(tenant_sets),
                       _policy(pool_target=64))
    drv = loop.start_pump(interval_s=0.002)
    try:
        t = loop.submit(ServingRequest(0, BatchQuery("or", (0, 1)),
                                       tenant="t0", deadline_ms=10.0))
        faults.advance_clock(0.5)
        drv.kick()

        def shed():
            drv.kick()
            return t.status != "queued"
        _wait(shed)
    finally:
        drv.stop()
    assert t.status == "shed" and t.error.reason == "expired"


def test_rebalance_replans_and_requeues_without_demotion(tenant_sets,
                                                        reference):
    plan = podmesh.PlacementPlan(regimes=("local", "local", "local"),
                                 hosts=((0,), (0,), (1,)),
                                 bytes_per_host=(0, 0))
    fd = _front_door(tenant_sets, plan=plan)
    tickets = [fd.submit(ServingRequest(sid, BatchQuery("or", (0, 1)),
                                        tenant=f"t{sid}"))
               for sid in (0, 1, 2, 0)]
    rep = fd.rebalance(qps=[50.0, 1.0, 1.0])
    assert rep["changed"] and fd.plan.regime(0).startswith("replicated-")
    fd.drain()
    for t in tickets:
        _assert_exact(reference, t)
    assert fd.stats["single_demotions"] == 0
    assert all(t.pod_host in (0, 1) for t in tickets)
    assert fd.stats["reroutes"] == len(tickets)


def test_warmup_runs_per_host_and_statusz_has_both(tenant_sets):
    fd = _front_door(tenant_sets)
    reports = fd.warmup(rungs=(2,))
    assert set(reports) == {"0", "1", "capacity"}
    assert all("wall_ms" in r for r in reports.values())
    doc = fd.statusz()
    assert {"0", "1"} <= set(doc["hosts"]) and doc["pod"]["n_hosts"] == 2
    plain = obs.statusz()
    assert {"0", "1"} <= set(plain["hosts"])


def test_sharded_host_engine(tenant_sets, reference):
    """``host_engine="sharded"``: each host serves through a per-host-mesh
    ShardedBatchEngine, bit-exact."""
    fd = PodFrontDoor(tenant_sets,
                      pod=podmesh.PodMesh.simulate(2, devices=DEVICES),
                      plan=MIXED_PLAN, policy=_policy(),
                      host_engine="sharded")
    tickets = [fd.submit(r) for r in _requests(14, seed=0x51)]
    fd.drain()
    for t in tickets:
        _assert_exact(reference, t)


# ------------------------------------------------------- live migration

def _mk_sets(seed):
    rng = np.random.default_rng(seed)
    return [DeviceBitmapSet([TRB.from_values(np.unique(
        rng.integers(0, 1 << 14, 300)).astype(np.uint32))
        for _ in range(3)], device=CPU) for _ in range(3)]


def _mig_door(seed, n_hosts=2):
    return PodFrontDoor(_mk_sets(seed),
                        pod=podmesh.PodMesh.simulate(n_hosts,
                                                     devices=[CPU] * 8),
                        policy=ServingPolicy(default_deadline_ms=60_000,
                                             pool_target=2))


def _ask(fd, sid):
    t = fd.submit(ServingRequest(sid, BatchQuery("or", (0, 1, 2)),
                                 tenant=f"t{sid}"))
    done = fd.drain()
    bad = [x for x in done if x.status == "failed"
           or (x.status == "shed" and x.shed_reason != "expired")]
    assert not bad
    assert t.status == "done", (t.status, t.error)
    return int(t.result.cardinality)


def test_live_migration_bit_exact_zero_failures(tmp_path):
    obs.enable(str(tmp_path / "mig.jsonl"))
    fd = _mig_door(21)
    sid = next(s for s in range(3) if fd.plan.regime(s) != "sharded")
    src = fd.owner_host(sid)
    target = next(h for h in fd.pod.alive() if h != src)
    before = _ask(fd, sid)

    def during(fd_):
        fd_.apply_delta(sid, adds={0: [999991, 999992]})
        assert _ask(fd_, sid) == before + 2

    rep = migrate_tenant(fd, sid, target, during=during)
    assert rep["catch_up_records"] >= 1 and rep["bytes"] > 0
    assert fd.owner_host(sid) == target
    assert _ask(fd, sid) == before + 2
    fd.apply_delta(sid, adds={0: [999993]})
    assert _ask(fd, sid) == before + 3
    obs.disable()
    import json

    spans = [json.loads(line) for line in open(tmp_path / "mig.jsonl")
             if '"pod.migrate"' in line]
    tags = spans[0]["tags"]
    assert tags["set_id"] == sid and tags["to"] == str(target)
    assert tags["from_host"] == str(src) and tags["bytes"] > 0


def test_migration_typed_refusals():
    fd = _mig_door(33)
    sid = next(s for s in range(3) if fd.plan.regime(s) != "sharded")
    with pytest.raises(MigrationError, match="unknown"):
        migrate_tenant(fd, sid, 99)
    fd.pod.mark_down(1)
    if fd.owner_host(sid) != 0:
        sid = next(s for s in range(3) if fd.owner_host(s) == 0)
    with pytest.raises(MigrationError, match="down"):
        migrate_tenant(fd, sid, 1)
    fd.pod.mark_up(1)
    s1 = begin_migration(fd, sid, 1)
    with pytest.raises(MigrationError, match="already migrating"):
        begin_migration(fd, sid, 1)
    s1.finish()


def test_host_join_and_leave_keep_serving():
    fd = _mig_door(44)
    sid = next(s for s in range(3) if fd.plan.regime(s) != "sharded")
    base = _ask(fd, sid)
    j = host_join(fd)
    assert j["host"] == 2
    assert _ask(fd, sid) == base
    migrate_tenant(fd, sid, j["host"])
    assert fd.owner_host(sid) == j["host"] and _ask(fd, sid) == base
    rep = host_leave(fd, j["host"])
    assert sid in rep["moved"] and fd.owner_host(sid) != j["host"]
    assert _ask(fd, sid) == base
    for h in list(fd.pod.alive())[1:]:
        fd.pod.mark_down(h)
    with pytest.raises(MigrationError, match="last alive"):
        host_leave(fd, fd.pod.alive()[0])


def test_restore_host_tenants_from_durable_state(tmp_path):
    root = str(tmp_path)
    fd = _mig_door(55)
    sid = next(s for s in range(3) if fd.plan.regime(s) != "sharded"
               and len(fd.plan.hosts_of(s)) == 1)
    lost = fd.owner_host(sid)
    tenant = DurableTenant(fd._sets[sid], root=root, tenant=f"sid{sid}",
                           policy=FlushPolicy(mode="never"),
                           snapshot_every=None)
    tenant.apply_delta(adds={0: [777777, 777778]})
    expect = _ask(fd, sid)
    tenant.close()
    fd.fail_host(lost)
    rep = restore_host_tenants(fd, lost, root, {sid: f"sid{sid}"})
    assert rep["restored"] == [sid]
    assert fd.owner_host(sid) in fd.pod.alive()
    assert _ask(fd, sid) == expect
    assert rep["reports"][sid]["replayed"] >= 1
    with pytest.raises(MigrationError, match="alive"):
        restore_host_tenants(fd, fd.pod.alive()[0], root, {})


# ------------------------------------------- multihost probe satellite

def test_probe_latency_surfaces_in_obs_snapshot():
    srv = socket.socket()
    try:
        srv.bind(("127.0.0.1", 0))
        srv.listen(1)
        port = srv.getsockname()[1]
        multihost._STATE.clear()
        multihost._STATE.update(coordinator=f"127.0.0.1:{port}",
                                process_id=1, timeout_s=5.0,
                                probe_ms=None, status="probing")
        multihost._probe_coordinator(
            f"127.0.0.1:{port}", 5.0, time.monotonic() + 5.0,
            lambda: "probe-test", errors)
    finally:
        srv.close()
    snap = obs.snapshot()
    info = snap["multihost"]
    assert info["coordinator"].endswith(str(port))
    assert isinstance(info["probe_ms"], float) and info["probe_ms"] >= 0
    assert info["process_id"] == 1
    assert "rb_multihost_probe_seconds" in snap["gauges"]


def test_failed_bootstrap_records_typed_state():
    with faults.inject("coordinator@multihost=1.0:11"):
        with pytest.raises(errors.CoordinatorTimeout):
            multihost.initialize("10.9.9.9:1", num_processes=2,
                                 process_id=0, timeout=3, backend="gloo")
    info = obs.snapshot()["multihost"]
    assert info["status"] == "failed" and info["coordinator"] == "10.9.9.9:1"


# ------------------------------------------- multi-process pod (gloo)

_POD_WORKER = """
import json, os, sys
sys.path.insert(0, {repo!r})
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np, torch
torch.set_num_threads(1)
from roaringbitmap_tpu_torch import RoaringBitmap, obs
from roaringbitmap_tpu_torch.parallel import (BatchGroup, BatchQuery,
    DeviceBitmapSet, ShardedBatchEngine, expr, multihost, podmesh)
from roaringbitmap_tpu_torch.parallel.sharding import P
from roaringbitmap_tpu_torch.runtime import guard
from roaringbitmap_tpu_torch.serving import (PodFrontDoor, ServingPolicy,
    ServingRequest)
multihost.initialize("file://" + store, num_processes=world,
                     process_id=rank, timeout=60, backend="gloo")
mh = obs.snapshot()["multihost"]
assert mh["status"] == "initialized" and mh["process_count"] == world, mh
pod = podmesh.PodMesh.detect(devices=["cpu"])
assert pod.n_hosts == world and pod.local_host == rank
assert pod.hosts[rank].local and sum(h.local for h in pod.hosts) == 1
mesh = pod.pod_mesh()
img = np.arange(world * 2 * 8, dtype=np.uint32).reshape(world * 2, 8)
got = podmesh.global_put(img, mesh, P("rows", None))
assert list(got) == [rank], list(got)
assert (got[rank].numpy().view(np.uint32) == img[2 * rank:2 * rank + 2]).all()
rng = np.random.default_rng(3)
sets = [DeviceBitmapSet([RoaringBitmap.from_values(np.unique(
    rng.integers(0, 1 << 16, 400).astype(np.uint32)))
    for _ in range(4)], layout="dense", device="cpu") for _ in range(4)]
plan = podmesh.place(sets, pod)
routes = [podmesh.route(plan, s, pod.alive()) for s in range(4)]
print("PODN_PLAN", rank, list(plan.regimes), [list(h) for h in plan.hosts],
      routes, flush=True)
# the pod-spanning sharded dispatch: every rank holds its own row shard
eng = ShardedBatchEngine(sets, mesh=mesh, placement="sharded")
assert len(eng.pool_shards()) == 1 and not eng.capturable
pool = [BatchGroup(s, [BatchQuery(op, (0, 1, 2), form="bitmap")
                       for op in ("or", "and", "xor", "andnot")]
                   + [expr.ExprQuery(expr.and_(expr.or_(0, 1),
                                               expr.not_(3)))])
        for s in range(4)]
res = eng.execute(pool)
for g, rows in zip(pool, res):
    for q, r in zip(g.queries, rows):
        ref = eng._engines[g.set_id]._sequential_result(q)
        assert r.cardinality == ref.cardinality, (rank, q)
        if q.form == "bitmap":
            assert r.bitmap == ref.bitmap
print("PODN_CARDS", rank, [r.cardinality for rows in res for r in rows],
      flush=True)
print("PODN_BYTES", rank, json.dumps([r.bitmap.serialize().hex()
                                      for rows in res for r in rows
                                      if r.bitmap is not None]), flush=True)
# per-host front door: this process serves its routed share
fd = PodFrontDoor(sets, pod=pod, plan=plan, policy=ServingPolicy(
    pool_target=4, default_deadline_ms=600000.0,
    guard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None)))
served = 0
for i in range(16):
    sid = i % 4
    if fd.owner_host(sid) not in fd._loops:
        continue
    t = fd.submit(ServingRequest(sid, BatchQuery(
        ("or", "and", "xor", "andnot")[i % 4], (0, 1)), tenant="t%d" % sid))
    fd.drain()
    r = eng._engines[sid]._sequential_one(t.request.query)
    assert t.status == "done" and t.result.cardinality == r.cardinality
    served += 1
fd._gossip()
assert fd.statusz()["pod"]["multi_process"]
torch.distributed.barrier()
print("PODN_OK", rank, served, mesh.comm.exchanges, flush=True)
torch.distributed.destroy_process_group()
""".format(repo=REPO)


def _run_workers(tmp_path, source: str, world: int, timeout: float = 240):
    worker = tmp_path / "worker.py"
    worker.write_text(source)
    store = str(tmp_path / "store")
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROARING_TPU_FAULTS", "XLA_FLAGS")}
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(r), str(world), store],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def _lines(outs, tag):
    return [[ln.split(" ", 2)[2] for ln in out.splitlines()
             if ln.startswith(tag)][0] for out in outs]


@pytest.mark.parametrize("world", [2, 4])
def test_multi_process_pod_bringup(tmp_path, world):
    """A detected pod over ``world`` gloo processes: each places only its
    own shard, plans and routes agree across processes and with the JAX
    package's single-process simulated pod over the same tenants, and the
    pod-spanning sharded dispatch is bit-exact on every rank: equal to the
    port's host reference (in the children) and, cardinalities and
    serialized bitmaps, to the JAX ``ShardedBatchEngine`` over the same
    pool on the simulated pod's mesh of ``world`` devices (here)."""
    outs = _run_workers(tmp_path, _POD_WORKER, world)
    for r, out in enumerate(outs):
        assert f"PODN_OK {r}" in out, out
    plans = _lines(outs, "PODN_PLAN")
    assert len(set(plans)) == 1, plans
    cards = _lines(outs, "PODN_CARDS")
    assert len(set(cards)) == 1, cards
    # the JAX package's simulated pod over the same tenants
    rng = np.random.default_rng(3)
    jsets = [JSet([JRB.from_values(np.unique(
        rng.integers(0, 1 << 16, 400).astype(np.uint32)))
        for _ in range(4)], layout="dense") for _ in range(4)]
    jplan = jpod.place(jsets, jpod.PodMesh.simulate(world))
    jroutes = [jpod.route(jplan, s, tuple(range(world))) for s in range(4)]
    assert plans[0] == f"{list(jplan.regimes)} " \
        f"{[list(h) for h in jplan.hosts]} {jroutes}"
    # the same pool through the JAX engine on the simulated pod's mesh
    jmesh = jpod.PodMesh.simulate(
        world, devices=jax.devices()[:world]).pod_mesh()
    jeng = JSharded(jsets, mesh=jmesh, placement="sharded")
    jres = jeng.execute([JGroup(s, [JQ(op, (0, 1, 2), form="bitmap")
                                    for op in ("or", "and", "xor", "andnot")]
                                + [jexpr.ExprQuery(jexpr.and_(
                                    jexpr.or_(0, 1), jexpr.not_(3)))])
                         for s in range(4)])
    assert cards[0] == str([r.cardinality for rows in jres for r in rows])
    jbytes = [r.bitmap.serialize().hex() for rows in jres for r in rows
              if r.bitmap is not None]
    assert len(jbytes) == 16
    for r, got in enumerate(_lines(outs, "PODN_BYTES")):
        assert json.loads(got) == jbytes, r
