"""The port's wire front door against roaringbitmap_tpu.wire.

Frames are an interchange format: the same query, result or error encodes
to the same bytes in both packages, the migration frames of one captured
state are the JAX sender's, and each package's client is served by the
other package's ``WireServer`` (both in this process, on loopback; the
port's loop on ``device="cpu"``).  Auth, backpressure, garbled frames and
the ``wire`` fault shapes give the same typed errors; the ``mig_*``
receive restores a tenant with the source's CRCs; one
``python -m roaringbitmap_tpu_torch.wire.bootstrap --device cpu`` child
serves the port's client exactly and exits 0 when its pipe closes.
"""

import gc
import json
import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.mutation import durability as jdur
from roaringbitmap_tpu.parallel import MultiSetBatchEngine as JMS
from roaringbitmap_tpu.parallel import expr as jexpr
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.parallel.batch_engine import BatchQuery as JQ
from roaringbitmap_tpu.parallel.batch_engine import BatchResult as JRes
from roaringbitmap_tpu.runtime import errors as jerrors
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu.runtime import guard as jguard
from roaringbitmap_tpu import serving as jserving
from roaringbitmap_tpu.serving import replay as jreplay
from roaringbitmap_tpu.wire import WireClient as JClient
from roaringbitmap_tpu.wire import WireServer as JServer
from roaringbitmap_tpu.wire import migrate as jmig
from roaringbitmap_tpu.wire import protocol as jwp
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch.parallel import expr as texpr
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchQuery as TQ
from roaringbitmap_tpu_torch.parallel.batch_engine import BatchResult as TRes
from roaringbitmap_tpu_torch.parallel.multiset import MultiSetBatchEngine
from roaringbitmap_tpu_torch.runtime import errors, faults, guard
from roaringbitmap_tpu_torch import serving
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.serving import loop as tloop
from roaringbitmap_tpu_torch.serving import replay as treplay
from roaringbitmap_tpu_torch.wire import WireClient, WireServer
from roaringbitmap_tpu_torch.wire import migrate as tmig
from roaringbitmap_tpu_torch.wire import protocol as wp

torch.set_num_threads(2)

CPU = "cpu"
EASY_MS = 300_000.0
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROFILE = dict(sets=2, sources=6, tenants=4, density=600, users=1 << 16,
               seed=11)


def _ctr(name: str, **labels) -> float:
    """The port's registry counter ``name`` summed over every label set
    that includes ``labels``."""
    return sum(row["value"] for row in
               tobs.snapshot()["counters"].get(name, [])
               if labels.items() <= row["labels"].items())


@pytest.fixture(autouse=True)
def _clean():
    jobs.disable()
    jobs.reset()
    tobs.reset()
    tobs.flight.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    yield
    jobs.disable()
    jobs.reset()
    jfaults.reset_clock()
    faults.reset_clock()
    gc.collect()


@pytest.fixture(scope="module")
def dataset():
    return treplay.build_dataset(treplay.ReplayProfile(**PROFILE))


def _tloop(dataset, **kw):
    prof = treplay.ReplayProfile(**PROFILE)
    sets = [DeviceBitmapSet(b, layout="dense", device=CPU)
            for b in dataset[0]]
    treplay.attach_columns(sets, prof, dataset[1])
    kw.setdefault("pool_target", 4)
    kw.setdefault("default_deadline_ms", EASY_MS)
    policy = serving.ServingPolicy(
        guard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None), **kw)
    return serving.ServingLoop(MultiSetBatchEngine(sets), policy)


def _jloop(**kw):
    prof = jreplay.ReplayProfile(**PROFILE)
    bms, cols = jreplay.build_dataset(prof)
    sets = [JSet(b, layout="dense") for b in bms]
    jreplay.attach_columns(sets, prof, cols)
    kw.setdefault("pool_target", 4)
    kw.setdefault("default_deadline_ms", EASY_MS)
    return jserving.ServingLoop(JMS(sets), jserving.ServingPolicy(
        guard=jguard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None),
        **kw))


def _requests(n, ex, Q, R, seed=5, n_sets=2, n_sources=6) -> list:
    """tests/test_wire.py's mixed stream in one package's types."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        sid = int(rng.integers(n_sets))
        form = "bitmap" if i % 3 == 0 else "cardinality"
        if i % 5 == 2:
            q = ex.ExprQuery(ex.and_(ex.or_(0, 1), ex.not_(2)), form=form)
        elif i % 5 == 4:
            q = ex.ExprQuery(ex.sum_("v", ex.or_(0, 1)), form="cardinality")
        else:
            op = ("or", "and", "xor", "andnot")[int(rng.integers(4))]
            k = int(rng.integers(2, 5))
            q = Q(op, tuple(int(x) for x in rng.choice(
                n_sources, size=k, replace=False)), form=form)
        out.append(R(sid, q, tenant=f"t{sid}"))
    return out


def _treqs(n, seed=5):
    return _requests(n, texpr, TQ, serving.ServingRequest, seed)


def _jreqs(n, seed=5):
    return _requests(n, jexpr, JQ, jserving.ServingRequest, seed)


def _exact(engine, req, res) -> None:
    ref = engine._engines[req.set_id]._sequential_result(req.query)
    assert res.cardinality == ref.cardinality, req
    if req.query.form == "bitmap" and not res.degraded:
        assert np.array_equal(res.bitmap.to_array(), ref.bitmap.to_array())
    if ref.value is not None:
        assert res.value == ref.value


# ------------------------------------------------------- frames, byte-equal

def _adhoc_queries(ex, Q, RB):
    vals = np.array([3, 70000, 131072 + 5], np.uint32)
    return [Q("or", (0, 1, 2), form="bitmap"), Q("andnot", (3, 1)),
            ex.ExprQuery(ex.and_(ex.or_(0, 1), ex.not_(2)), form="bitmap"),
            ex.ExprQuery(ex.xor(ex.ref(4), ex.bitmap(RB.from_values(vals)))),
            ex.ExprQuery(ex.sum_("v", ex.and_(0, ex.range_("v", 5, 900)))),
            ex.ExprQuery(ex.top_k("v", 7, ex.cmp("v", "ge", 12)))]


def test_query_frames_byte_equal():
    tq = _adhoc_queries(texpr, TQ, TRB)
    jq = _adhoc_queries(jexpr, JQ, JRB)
    for i, (a, b) in enumerate(zip(jq, tq)):
        jh, jb = jwp.encode_query(a)
        th, tb = wp.encode_query(b)
        assert th == jh and tb == jb
        header = {"set_id": 1, "tenant": "t1", "query": th, "trace": None,
                  "deadline_ms": 25.0}
        tf = wp.encode_frame(wp.T_SUBMIT, i + 1, header, tuple(tb))
        assert tf == jwp.encode_frame(jwp.T_SUBMIT, i + 1, header,
                                      tuple(jb))
        # each package decodes the other's frame to the same query
        _, rid, h, blobs = wp.decode_payload(tf[8:])
        assert rid == i + 1
        back = wp.decode_query(h["query"], blobs)
        assert wp.encode_query(back) == (th, tb)
        jback = jwp.decode_query(h["query"], blobs)
        assert jwp.encode_query(jback) == (jh, jb)


def test_result_frames_byte_equal():
    bm = [3, 9, 70000, 1 << 20]
    cases = [(TRes(cardinality=4, bitmap=TRB.from_values(
                  np.array(bm, np.uint32)), value=None),
              JRes(cardinality=4, bitmap=JRB.from_values(
                  np.array(bm, np.uint32)), value=None)),
             (TRes(cardinality=12, bitmap=None, value=987654321),
              JRes(cardinality=12, bitmap=None, value=987654321)),
             ({"mode": "patch", "version": 3}, {"mode": "patch",
                                                "version": 3})]
    for t, j in cases:
        for kw in ({}, {"degraded": True, "wall_ms": 1.25, "missed": True}):
            th, tb = wp.encode_result(t, **kw)
            jh, jb = jwp.encode_result(j, **kw)
            assert (th, tb) == (jh, jb)
            tf = wp.encode_frame(wp.T_RESULT, 7, th, tuple(tb))
            assert tf == jwp.encode_frame(jwp.T_RESULT, 7, jh, tuple(jb))
            r = wp.WireResult(*wp.decode_payload(tf[8:])[2:])
            if isinstance(t, dict):
                assert r.report == t
            else:
                assert (r.cardinality, r.value) == (t.cardinality, t.value)


def _error_pairs():
    return [
        (serving.AdmissionRejected("full", "queue_full", queue_depth=4,
                                   cap=4),
         jserving.AdmissionRejected("full", "queue_full", queue_depth=4,
                                    cap=4)),
        (serving.RequestShed("late", "expired", remaining_ms=-1.5),
         jserving.RequestShed("late", "expired", remaining_ms=-1.5)),
        (errors.AuthRejected("no", reason="tenant", tenant="t9"),
         jerrors.AuthRejected("no", reason="tenant", tenant="t9")),
        (errors.WireBackpressure("busy", inflight=3, cap=3),
         jerrors.WireBackpressure("busy", inflight=3, cap=3)),
        (errors.WireHelloMismatch("v"), jerrors.WireHelloMismatch("v")),
        (errors.PeerClosed("gone"), jerrors.PeerClosed("gone")),
        (errors.CorruptInput("bad"), jerrors.CorruptInput("bad")),
        (errors.TransientDeviceError("UNAVAILABLE: x"),
         jerrors.TransientDeviceError("UNAVAILABLE: x")),
        (errors.RemoteFailed("?", remote_cls="Foo"),
         jerrors.RemoteFailed("?", remote_cls="Foo")),
        (KeyError("k"), KeyError("k")),
    ]


@pytest.mark.parametrize("i", range(len(_error_pairs())))
def test_error_frames_byte_equal_and_rehydrate(i):
    t, j = _error_pairs()[i]
    th, jh = wp.error_fields(t), jwp.error_fields(j)
    assert th == jh
    assert wp.encode_frame(wp.T_ERROR, 3, th) == \
        jwp.encode_frame(jwp.T_ERROR, 3, jh)
    back, jback = wp.rehydrate_error(jh), jwp.rehydrate_error(th)
    assert type(back).__name__ == type(jback).__name__
    assert getattr(back, "reason", None) == getattr(jback, "reason", None)
    assert isinstance(back, (errors.RoaringRuntimeError, errors.CorruptInput))


def test_garble_and_decode_errors_typed():
    f = wp.encode_frame(wp.T_PING, 1, {})
    assert wp.garble(f) == jwp.garble(f) != f
    for bad in (b"\x01", f[8:] + b"x",
                bytes([3]) + (5).to_bytes(8, "little")
                + (99).to_bytes(4, "little") + b"{}"):
        with pytest.raises(errors.CorruptInput):
            wp.decode_payload(bad)
        with pytest.raises(jerrors.CorruptInput):
            jwp.decode_payload(bad)
    with pytest.raises(errors.CorruptInput):
        wp.decode_query({"kind": "nope"}, [])
    with pytest.raises(errors.CorruptInput):
        wp.decode_query({"kind": "expr", "form": "cardinality",
                         "expr": {"t": "adhoc", "b": 0}}, [b"\x00"])


def test_migration_frames_equal_the_jax_sender():
    """The port's ``state_frames`` of one captured state are the frames
    the JAX sender (``WireMigrationSession``) writes for it (a recording
    stand-in client and front door in place of the pod)."""
    bms = [JRB.from_values(np.arange(i, 5000 * (i + 1), 7, dtype=np.uint32))
           for i in range(3)]
    js = JSet(bms, layout="dense")
    sent = []

    class Recorder:
        def migrate_frames(self, frames):
            sent.extend(frames)
            return {"source_crcs": jmig.source_crcs(js)}

    fd = types.SimpleNamespace(
        plan=types.SimpleNamespace(regime=lambda sid: "single"),
        _lock=threading.Lock(), _dual_writes={}, _sets={0: js})
    sess = jmig.WireMigrationSession(fd, 0, Recorder(), tenant="ten")
    sess.mig_id = "m-1"
    sess.begin()
    sess.copy()
    sess.finish()
    state = jdur.capture_state(js, tenant="ten")
    ours = tmig.state_frames("m-1", "ten", state)
    enc = [wp.encode_frame(f, k + 1, h, tuple(b))
           for k, (f, h, b) in enumerate(ours)]
    want = [jwp.encode_frame(f, k + 1, h, tuple(b))
            for k, (f, h, b) in enumerate(sent)]
    assert enc == want
    meta, blobs = tmig.flatten_state(state)
    assert (meta, blobs) == jmig.flatten_state(state)
    assert tmig.unflatten_state(meta, blobs) == state
    with pytest.raises(errors.CorruptInput):
        tmig.unflatten_state({"a": {"__blob__": 9}}, blobs)


# ------------------------------------------------ clients across packages

def test_port_server_serves_both_clients(dataset):
    loop = _tloop(dataset)
    with WireServer(loop) as srv:
        treqs = _treqs(20)
        for Client, reqs in ((WireClient, treqs), (JClient, _jreqs(20))):
            cl = Client(srv.address, timeout=60)
            assert cl.server["version"] == wp.WIRE_VERSION
            assert cl.server["n_sets"] == 2
            cl.ping()
            tickets = cl.submit_many(reqs)
            for t, r in zip(tickets, treqs):
                _exact(loop._engine, r, t.value(timeout=60))
            cl.close()
        assert srv.stats["pump_errors"] == 0
    assert _ctr("rb_serving_pump_errors_total") == 0


def test_port_client_against_jax_server(dataset):
    jl = _jloop()
    tl = _tloop(dataset)
    reqs = _treqs(15, seed=8)
    with JServer(jl) as srv:
        cl = WireClient(srv.address, timeout=60)
        tickets = cl.submit_many(reqs)
        for t, r in zip(tickets, reqs):
            _exact(tl._engine, r, t.value(timeout=60))
        report = cl.apply_delta(1, adds={2: [7, 77, 777]})
        assert isinstance(report, dict) and report["mode"]
        tl._engine._engines[1]._ds.apply_delta({2: [7, 77, 777]}, None)
        q = serving.ServingRequest(1, TQ("or", (0, 2), form="bitmap"),
                                   tenant="t1")
        _exact(tl._engine, q, cl.call(q, 60))
        cl.close()


def test_bad_magic_and_version_skew_typed(dataset):
    for server in (WireServer(_tloop(dataset)), JServer(_jloop())):
        with server as srv:
            for pre, version in ((b"NOTMAGIC", wp.WIRE_VERSION),
                                 (wp.WIRE_MAGIC, 999)):
                s = socket.create_connection(srv.address, timeout=5)
                s.settimeout(10)
                s.sendall(pre + wp.encode_frame(wp.T_HELLO, 0,
                                                {"version": version}))
                ftype, _, h, _ = wp.read_frame(s)
                assert ftype == wp.T_ERROR and h["code"] == "hello_mismatch"
                s.close()


def test_garbage_inbound_dies_as_corrupt_input(dataset):
    with WireServer(_tloop(dataset)) as srv:
        cl = WireClient(srv.address)
        t = cl._reserve()
        with cl._wlock:
            cl._sock.sendall(wp.garble(wp.encode_frame(wp.T_PING, 99, {})))
        t.wait(10)
        assert t.status == "failed" and isinstance(t.error,
                                                   errors.CorruptInput)
        cl.close()


class _StuckTarget:
    """Accepts submits and never completes them."""

    n_sets = 1

    def __init__(self):
        self._lock = threading.RLock()
        self._q = []

    def add_completion_listener(self, fn):
        pass

    def remove_completion_listener(self, fn):
        pass

    def submit(self, request, arrival=None):
        t = tloop.Ticket(request=request)
        self._q.append(t)
        return t

    def backlog(self):
        return 0

    def pump(self, force=False):
        return []

    def drain(self):
        return []


def test_backpressure_past_inflight_cap_is_typed():
    with WireServer(_StuckTarget(), max_inflight=3) as srv:
        for Client, R, Q in ((WireClient, serving.ServingRequest, TQ),
                             (JClient, jserving.ServingRequest, JQ)):
            cl = Client(srv.address)
            tickets = cl.submit_many([R(0, Q("or", (0, 1)), tenant="t")
                                      for _ in range(6)])
            bp = [t for t in tickets[3:] if t._event.wait(10)]
            assert len(bp) == 3
            for t in bp:
                assert type(t.error).__name__ == "WireBackpressure"
                assert t.error.retryable and t.error.context["cap"] == 3
            assert all(t.status == "pending" for t in tickets[:3])
            cl.ping()
            cl.close()
            srv._target._q.clear()


def test_admission_rejection_rides_the_wire_typed(dataset):
    loop = _tloop(dataset, max_queue=2, pool_target=64)
    with WireServer(loop, coalesce_s=0.05) as srv:
        for Client, R, Q, Rej in (
                (WireClient, serving.ServingRequest, TQ,
                 serving.AdmissionRejected),
                (JClient, jserving.ServingRequest, JQ,
                 jserving.AdmissionRejected)):
            cl = Client(srv.address)
            tickets = cl.submit_many([R(0, Q("or", (0, 1, 2)), tenant="t0")
                                      for _ in range(10)])
            for t in tickets:
                t.wait(60)
            rejected = [t for t in tickets if t.status == "failed"]
            assert rejected and all(isinstance(t.error, Rej)
                                    and t.error.reason == "queue_full"
                                    for t in rejected)
            assert len([t for t in tickets if t.ok]) + len(rejected) == 10
            cl.ping()
            cl.close()


def test_auth_token_and_tenant_grant(dataset):
    loop = _tloop(dataset)
    with WireServer(loop, auth={"tok": ["t0"], "root": ["*"]}) as srv:
        for Client, err in ((WireClient, errors.AuthRejected),
                            (JClient, jerrors.AuthRejected)):
            with pytest.raises(err):
                Client(srv.address, token="evil")
            with pytest.raises(err):
                Client(srv.address)
        assert loop.stats["admitted"] == 0
        q = TQ("or", (0, 1, 2))
        cl = WireClient(srv.address, token="tok")
        ok = cl.submit(serving.ServingRequest(0, q, tenant="t0"))
        bad = cl.submit(serving.ServingRequest(0, q, tenant="t1"))
        assert ok.value(60).cardinality >= 0
        with pytest.raises(errors.AuthRejected) as ei:
            bad.value(60)
        assert ei.value.context["tenant"] == "t1"
        cl.ping()
        cl.close()
        root = WireClient(srv.address, token="root")
        assert root.call(serving.ServingRequest(1, q, tenant="t1"),
                         60).cardinality >= 0
        root.close()


def test_wire_fault_shapes_typed(dataset):
    loop = _tloop(dataset)
    with WireServer(loop) as srv:
        cl = WireClient(srv.address)
        with faults.inject("wire@conn_drop=1.0:1"):
            with pytest.raises(errors.PeerClosed):
                cl.submit(serving.ServingRequest(0, TQ("or", (0, 1)),
                                                 tenant="t0"))
        cl.close()
        # the server's garbage shape: the client dies typed, the server
        # keeps its other connections
        cl = WireClient(srv.address)
        t = cl.submit(serving.ServingRequest(0, TQ("or", (0, 1)),
                                             tenant="t0"))
        with faults.inject("wire@garbage=1.0:1"):
            with pytest.raises(errors.CorruptInput):
                t.value(30)
        cl.close()
        cl = WireClient(srv.address)
        t0 = faults.clock()
        with faults.inject("wire@slow_peer=1.0:1"):
            cl.submit(serving.ServingRequest(0, TQ("or", (0, 1)),
                                             tenant="t0")).value(60)
        assert faults.clock() - t0 >= faults.SLOW_LATENCY_S
        cl.close()
    for spec in ("wire=1.0:1", "wire@bogus=1.0:1"):
        with pytest.raises(ValueError):
            faults.FaultPlan.from_spec(spec)
        with pytest.raises(ValueError):
            jfaults.FaultPlan.from_spec(spec)


def test_delta_over_wire_then_query_exact(dataset):
    loop = _tloop(dataset)
    with WireServer(loop) as srv:
        cl = JClient(srv.address)        # the JAX client, the port server
        q = jserving.ServingRequest(0, JQ("or", (0, 1), form="bitmap"),
                                    tenant="t0")
        before = cl.call(q, 60)
        vals = np.array([1_000_001, 1_000_002], np.uint32)
        assert isinstance(cl.apply_delta(0, adds={0: vals}), dict)
        after = cl.call(q, 60)
        assert np.array_equal(after.bitmap.to_array(),
                              np.union1d(before.bitmap.to_array(), vals))
        cl.close()


# ------------------------------------------------------- migration receive

@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_migration_receive_commits_with_source_crcs(dataset, direction):
    prof = PROFILE
    bms_t, cols_t = dataset
    js = JSet([JRB.from_values(b.to_array()) for b in bms_t[1]],
              layout="dense")
    js.apply_delta({0: np.array([5, 50, 500], np.uint32)}, None)
    state = jdur.capture_state(js, tenant="mig")
    records = [{"kind": "delta", "seq": 1, "adds": {"2": [9, 99]},
                "removes": {"0": [5]}}]
    js.apply_delta({2: np.array([9, 99], np.uint32)},
                   {0: np.array([5], np.uint32)})
    want = jmig.source_crcs(js)
    frames = tmig.state_frames("mig-1", "mig", state, records)
    if direction == "jax-to-port":
        got = {}
        loop = _tloop(dataset)
        srv = WireServer(loop, on_migrate=lambda t, ds: got.update({t: ds}))
        Client = JClient
    else:
        srv, Client = JServer(_jloop()), WireClient
    with srv:
        cl = Client(srv.address, timeout=60)
        ack = cl.migrate_frames(frames)
        cl.close()
    assert ack["phase"] == "commit" and ack["records"] == 1
    assert ack["source_crcs"] == want
    if direction == "jax-to-port":
        ds = got["mig"]
        assert ds.device.type == "cpu"
        assert tmig.source_crcs(ds) == want
    assert prof["sets"] == 2


# -------------------------------------------------------- second process

def test_bootstrap_child_serves_the_port_client(dataset):
    """``bootstrap --device cpu``: a separate OS process builds the same
    seeded dataset and serves the port's pipelined client exactly; it
    exits 0 when its stdin closes."""
    args = [sys.executable, "-m", "roaringbitmap_tpu_torch.wire.bootstrap",
            "--device", "cpu"]
    for k in ("seed", "sets", "sources", "tenants", "density", "users"):
        args += [f"--{k}", str(PROFILE[k])]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(args, cwd=REPO, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        assert info["device"] == "cpu" and info["sets"] == 2
        reference = _tloop(dataset)._engine
        cl = WireClient((info["host"], info["port"]), timeout=120)
        reqs = _treqs(24)
        tickets = cl.submit_many(reqs)
        for t, r in zip(tickets, reqs):
            _exact(reference, r, t.value(timeout=120))
        assert cl.stats["results"] == len(reqs)
        cl.close()
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


# ---------------------------------------------------- migration, sending

def _tfront_door(dataset):
    from roaringbitmap_tpu_torch.parallel import podmesh

    prof = treplay.ReplayProfile(**PROFILE)
    sets = [DeviceBitmapSet(b, layout="dense", device=CPU)
            for b in dataset[0]]
    treplay.attach_columns(sets, prof, dataset[1])
    return serving.PodFrontDoor(
        sets, pod=podmesh.PodMesh.simulate(2, devices=[CPU] * 2),
        policy=serving.ServingPolicy(
            guard=guard.GuardPolicy(backoff_base=0.0, sleep=lambda s: None),
            pool_target=4, default_deadline_ms=EASY_MS))


@pytest.mark.parametrize("dest", ["port", "jax"])
def test_wire_migration_bit_exact_with_catch_up(dataset, dest):
    """``migrate_tenant(via=client)`` ships snapshot and dual-write
    catch-up tail as frames, to the port's server and to the JAX
    package's; the destination's copy passes the per-source CRC pin and
    the source keeps serving."""
    from roaringbitmap_tpu_torch.mutation import delta as mut_delta

    fd = _tfront_door(dataset)
    srv = WireServer(_tloop(dataset), name="dest") if dest == "port" \
        else JServer(_jloop(), name="dest")
    with srv:
        cl = WireClient(srv.address, timeout=60)

        def during(fd_):
            t = fd_.submit(serving.ServingRequest(
                1, TQ("or", (0, 1)), tenant="t1"))
            fd_.apply_delta(1, {0: np.array([31337], np.uint32)}, None)
            fd_.drain()
            assert t.ok

        report = serving.migrate_tenant(fd, 1, via=cl, tenant="mig-t1",
                                        during=during)
        assert report["to"] == "wire" and report["catch_up_records"] >= 1
        assert report["source_crcs"] == tmig.source_crcs(fd._sets[1])
        ds = srv.migrated["mig-t1"]
        from roaringbitmap_tpu.mutation import delta as jdelta

        got = (mut_delta.host_bitmaps(ds) if dest == "port"
               else [TRB.from_values(b.to_array())
                     for b in jdelta.host_bitmaps(ds)])
        assert got == mut_delta.host_bitmaps(fd._sets[1])
        assert 31337 in got[0].to_array()
        t = fd.submit(serving.ServingRequest(1, TQ("or", (0, 1)),
                                             tenant="t1"))
        fd.drain()
        assert t.ok
        cl.close()
    assert not fd._dual_writes


def test_wire_migration_to_a_frontdoor_child(dataset):
    """``bootstrap --frontdoor 2 --device cpu``: a second OS process
    serving a pod front door receives a migrated tenant; the commit's
    per-source CRCs equal the source's."""
    args = [sys.executable, "-m", "roaringbitmap_tpu_torch.wire.bootstrap",
            "--device", "cpu", "--frontdoor", "2"]
    for k in ("seed", "sets", "sources", "tenants", "density", "users"):
        args += [f"--{k}", str(PROFILE[k])]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen(args, cwd=REPO, env=env, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)
    try:
        info = json.loads(proc.stdout.readline())
        fd = _tfront_door(dataset)
        cl = WireClient((info["host"], info["port"]), timeout=120)
        report = tmig.migrate_tenant_wire(fd, 0, cl, tenant="xp-t0")
        assert report["bytes"] > 0
        assert report["source_crcs"] == tmig.source_crcs(fd._sets[0])
        cl.close()
        proc.stdin.close()
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
