"""The port's ``multihost`` bootstrap against
roaringbitmap_tpu.parallel.multihost, on gloo processes of this machine.

Each child process imports ``roaringbitmap_tpu_torch`` only, joins through
a ``file://`` store under the test's temporary directory (no TCP port to
collide under parallel test workers), and runs under its own timeout.
Held: the two-process bring-up and its host-pure global mesh, the typed
``CoordinatorTimeout`` of an unreachable coordinator within its budget
(the message names the address and the rank, as the JAX package's does),
the injected coordinator fault, and the sharded wide ops and value columns
over a mesh spanning four processes, exact against the port's
single-process results and against the JAX package's ``sharding`` on the
same seeded inputs (the parent computes those on as many of the conftest's
virtual CPU devices, in the same mesh shapes)."""

import hashlib
import inspect
import json
import os
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
from jax.sharding import Mesh as JMesh

from roaringbitmap_tpu.bsi.slice_index import Operation as JOp
from roaringbitmap_tpu.bsi.slice_index import RoaringBitmapSliceIndex as JBSI
from roaringbitmap_tpu.parallel import sharding as jsh
from roaringbitmap_tpu.utils import datasets as jdatasets
from roaringbitmap_tpu_torch.parallel import multihost
from roaringbitmap_tpu_torch.runtime import errors, faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _spawn(tmp_path, source: str, world: int, timeout: float = 180):
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


_INIT_WORKER = """
import sys
sys.path.insert(0, {repo!r})
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
from roaringbitmap_tpu_torch.parallel import multihost
multihost.initialize("file://" + store, num_processes=world,
                     process_id=rank, backend="gloo", timeout=60)
import torch.distributed as dist
assert dist.get_world_size() == world and dist.get_rank() == rank
assert multihost.process_count() == world
devs = multihost.global_devices(["cpu"])
assert len(devs) == world
mesh = multihost.global_mesh(devices=["cpu"])
assert mesh.devices.shape == (1, world), mesh.devices.shape
assert mesh.multi_process and mesh.local() == [rank]
for col in mesh.ranks.T:
    assert len(set(col)) == 1
assert multihost.snapshot()["status"] == "initialized"
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "roaringbitmap_tpu" or m.startswith("roaringbitmap_tpu.")]
assert not bad, bad
dist.destroy_process_group()
print("MULTIHOST_OK", rank)
""".format(repo=REPO)


def test_two_process_initialize(tmp_path):
    outs = _spawn(tmp_path, _INIT_WORKER, 2)
    for r, out in enumerate(outs):
        assert f"MULTIHOST_OK {r}" in out


_TIMEOUT_WORKER = """
import sys, time
sys.path.insert(0, {repo!r})
port = sys.argv[3]
from roaringbitmap_tpu_torch.parallel import multihost
from roaringbitmap_tpu_torch.runtime import errors
t0 = time.monotonic()
try:
    multihost.initialize("127.0.0.1:" + port, num_processes=2,
                         process_id=1, timeout=5, backend="gloo")
except errors.CoordinatorTimeout as e:
    msg = str(e)
    assert "127.0.0.1:" + port in msg, msg
    assert "process_id 1" in msg, msg
    assert time.monotonic() - t0 < 15, time.monotonic() - t0
    assert multihost.snapshot()["status"] == "failed"
    print("COORD_TIMEOUT_OK")
else:
    print("NO_ERROR_RAISED")
""".format(repo=REPO)


def test_unreachable_coordinator_times_out_typed(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    worker = tmp_path / "timeout_worker.py"
    worker.write_text(_TIMEOUT_WORKER)
    env = {k: v for k, v in os.environ.items()
           if k not in ("ROARING_TPU_FAULTS", "XLA_FLAGS")}
    out = subprocess.run([sys.executable, str(worker), "1", "2", str(port)],
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert "COORD_TIMEOUT_OK" in out.stdout, out.stdout + out.stderr


def test_injected_coordinator_fault_is_typed():
    t0 = time.monotonic()
    with faults.inject("coordinator@multihost=1.0:11"):
        with pytest.raises(errors.CoordinatorTimeout) as ei:
            multihost.initialize("10.1.2.3:9999", num_processes=2,
                                 process_id=0, timeout=7, backend="gloo")
    assert "10.1.2.3:9999" in str(ei.value)
    assert "process_id 0" in str(ei.value)
    assert time.monotonic() - t0 < 7


def test_snapshot_and_init_method_forms():
    assert multihost._init_method("127.0.0.1:1") == "tcp://127.0.0.1:1"
    assert multihost._init_method("file:///x/y") == "file:///x/y"
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    mesh = multihost.global_mesh(devices=["cpu"] * 4, lanes=2)
    assert mesh.devices.shape == (2, 2) and not mesh.multi_process


def _digest(arrays) -> str:
    """One hash of a result triple's dtypes, shapes and bytes: equal
    digests are equal keys, words and cardinalities."""
    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(np.asarray(a))
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


_WIDE_WORKER = """
import hashlib, json, sys
sys.path.insert(0, {repo!r})
rank, world, store = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import numpy as np, torch
torch.set_num_threads(1)
from roaringbitmap_tpu_torch.parallel import multihost, sharding
from roaringbitmap_tpu_torch.ops import packing
from roaringbitmap_tpu_torch.utils import datasets
from roaringbitmap_tpu_torch.bsi.slice_index import (Operation,
    RoaringBitmapSliceIndex)
multihost.initialize("file://" + store, num_processes=world,
                     process_id=rank, backend="gloo", timeout=60)
{digest}
bms = datasets.synthetic_bitmaps(12, seed=5, universe=1 << 20, density=0.01)
local = sharding.Mesh(np.array(["cpu"] * world).reshape(world, 1),
                      ("rows", "lanes"))
res = {{}}
for lanes in (1, 2):
    mesh = multihost.global_mesh(lanes=lanes, devices=["cpu"])
    assert mesh.multi_process
    for op in ("or", "xor", "and"):
        for ingest in ("dense", "compact"):
            got = sharding.wide_aggregate_sharded(mesh, op, bms,
                                                  ingest=ingest,
                                                  fallback=False)
            want = sharding.wide_aggregate_sharded(local, op, bms,
                                                   fallback=False)
            for a, b in zip(got, want):
                assert np.array_equal(a, b), (lanes, op, ingest)
            res[f"{{lanes}} {{op}} {{ingest}}"] = _digest(got)
rng = np.random.default_rng(17)
cols = np.unique(rng.integers(0, 1 << 20, 6000)).astype(np.uint32)
vals = rng.integers(0, 1 << 16, cols.size).astype(np.uint64)
bsi = RoaringBitmapSliceIndex.from_pairs(cols, vals)
mesh = multihost.global_mesh(devices=["cpu"], lanes=2)
sb = sharding.ShardedBSI(mesh, bsi)
thr = int(np.median(vals))
bsi_res = [int(sb.compare_cardinality(Operation.GE, thr)),
           [int(x) for x in sb.sum()], int(sb.top_k_cardinality(50))]
assert bsi_res[0] == bsi.compare(Operation.GE, thr, 0, None).cardinality
assert tuple(bsi_res[1]) == bsi.sum() and bsi_res[2] >= 50
print("WIDE_RES", rank, json.dumps(res), flush=True)
print("WIDE_BSI", rank, json.dumps(bsi_res), flush=True)
print("WIDE_OK", rank, mesh.comm.exchanges, flush=True)
torch.distributed.destroy_process_group()
""".format(repo=REPO, digest=inspect.getsource(_digest))


def _lines(outs, tag):
    return [json.loads([ln.split(" ", 2)[2] for ln in out.splitlines()
                        if ln.startswith(tag + " ")][0]) for out in outs]


def test_sharded_wide_ops_across_four_processes(tmp_path):
    """Sharded OR/XOR/AND (both ingests) and the sharded BSI over a mesh
    of four gloo processes (rows, and rows x lanes): exact against the
    port's single-process mesh (in the children) and against the JAX
    package's ``wide_aggregate_sharded`` and ``ShardedBSI`` over four of
    the conftest's devices in the same mesh shapes (here)."""
    world = 4
    outs = _spawn(tmp_path, _WIDE_WORKER, world)
    for r, out in enumerate(outs):
        assert f"WIDE_OK {r}" in out
    bms = jdatasets.synthetic_bitmaps(12, seed=5, universe=1 << 20,
                                      density=0.01)
    devs = np.array(jax.devices()[:world])
    want = {}
    for lanes in (1, 2):
        mesh = JMesh(devs.reshape(world // lanes, lanes), ("rows", "lanes"))
        for op in ("or", "xor", "and"):
            for ingest in ("dense", "compact"):
                want[f"{lanes} {op} {ingest}"] = _digest(
                    jsh.wide_aggregate_sharded(mesh, op, bms, ingest=ingest,
                                               fallback=False))
    for r, got in enumerate(_lines(outs, "WIDE_RES")):
        assert got == want, r
    rng = np.random.default_rng(17)
    cols = np.unique(rng.integers(0, 1 << 20, 6000)).astype(np.uint32)
    vals = rng.integers(0, 1 << 16, cols.size).astype(np.uint64)
    jb = jsh.ShardedBSI(JMesh(devs.reshape(2, 2), ("rows", "lanes")),
                        JBSI.from_pairs(cols, vals))
    thr = int(np.median(vals))
    jres = [int(jb.compare_cardinality(JOp.GE, thr)),
            [int(x) for x in jb.sum()], int(jb.top_k_cardinality(50))]
    for r, got in enumerate(_lines(outs, "WIDE_BSI")):
        assert got == jres, (r, got, jres)
