"""The port's durable tenants against roaringbitmap_tpu.mutation.durability.

Journals and snapshot directories are an interchange format, so each is
held equal across the packages, in both directions: the same appends
write the same journal bytes; the same set and deltas write the same
snapshot files (sources, column planes, ``MANIFEST.json``); a tenant
directory written by either package recovers in the other (the port's
on ``device="cpu"``) with the same records and the same bitmaps.  The
crash seams (``pre_append``, ``pre_apply``, ``pre_apply@torn``,
``post_apply``) recover exactly against a never-crashed host oracle, a
torn tail is counted, and corruption before the tail raises
``CorruptInput`` in both packages.
"""

import gc
import os

import numpy as np
import pytest
import torch

from roaringbitmap_tpu import RoaringBitmap as JRB
from roaringbitmap_tpu import obs as jobs
from roaringbitmap_tpu.analytics.column import BsiColumn as JBsi
from roaringbitmap_tpu.analytics.column import RangeColumn as JRange
from roaringbitmap_tpu.mutation import delta as jdelta
from roaringbitmap_tpu.mutation import durability as jdur
from roaringbitmap_tpu.parallel.aggregation import DeviceBitmapSet as JSet
from roaringbitmap_tpu.runtime import errors as jerrors
from roaringbitmap_tpu.runtime import faults as jfaults
from roaringbitmap_tpu_torch import RoaringBitmap as TRB
from roaringbitmap_tpu_torch import obs as tobs
from roaringbitmap_tpu_torch.analytics.column import BsiColumn, RangeColumn
from roaringbitmap_tpu_torch.mutation import delta as tdelta
from roaringbitmap_tpu_torch.mutation import durability as tdur
from roaringbitmap_tpu_torch.parallel.aggregation import DeviceBitmapSet
from roaringbitmap_tpu_torch.parallel.batch_engine import (BatchEngine,
                                                           BatchQuery)
from roaringbitmap_tpu_torch.runtime import errors, faults

torch.set_num_threads(2)

CPU = "cpu"
NEVER = tdur.FlushPolicy(mode="never")
JNEVER = jdur.FlushPolicy(mode="never")


@pytest.fixture(autouse=True)
def _clean(tmp_path):
    jobs.disable()
    jobs.reset()
    tobs.reset()
    tobs.flight.reset()
    # crash triggers dump the flight ring: keep the dumps in the test's dir
    tobs.flight.configure(dir=str(tmp_path / "flight"))
    yield
    jobs.disable()
    jobs.reset()
    tobs.flight.configure(dir=None)
    tobs.flight.reset()
    gc.collect()


def _values(seed, n=3, uni=1 << 14, card=300) -> list:
    rng = np.random.default_rng(seed)
    return [np.unique(rng.integers(0, uni, card)).astype(np.uint32)
            for _ in range(n)]


def _columns(seed):
    rng = np.random.default_rng(seed + 1)
    ids = np.unique(rng.integers(0, 1 << 14, 200)).astype(np.uint32)
    vals = rng.integers(0, 500, ids.size).astype(np.int64)
    lat = rng.integers(0, 1 << 30, 64).astype(np.int64)
    return ids, vals, lat


def _tset(seed, layout="dense", columns=True):
    ds = DeviceBitmapSet([TRB.from_values(v) for v in _values(seed)],
                         layout=layout, device=CPU)
    if columns:
        ids, vals, lat = _columns(seed)
        ds.attach_column(BsiColumn("price", ids, vals, device=CPU))
        ds.attach_column(RangeColumn("lat", lat, device=CPU))
    return ds


def _jset(seed, layout="dense", columns=True):
    ds = JSet([JRB.from_values(v) for v in _values(seed)], layout=layout)
    if columns:
        ids, vals, lat = _columns(seed)
        ds.attach_column(JBsi("price", ids, vals))
        ds.attach_column(JRange("lat", lat))
    return ds


def _stream(seed, steps) -> list:
    """tests/test_durability.py's interleaved delta / column stream."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(steps):
        if k % 4 == 2:
            ids = rng.integers(0, 1 << 14, 4).tolist()
            out.append(("bsi", ({int(i): int(rng.integers(1, 500))
                                 for i in ids[:3]}, [int(ids[3])])))
        elif k % 4 == 3:
            out.append(("range", {int(i): int(rng.integers(0, 1 << 30))
                                  for i in rng.integers(0, 64, 3)}))
        else:
            adds = {int(s): np.unique(rng.integers(
                0, 1 << 14, 20)).tolist() for s in rng.integers(0, 3, 2)}
            rems = {0: rng.integers(0, 1 << 14, 5).tolist()}
            out.append(("delta", (adds, rems)))
    return out


def _apply_step(tenant, step) -> None:
    kind, payload = step
    if kind == "delta":
        tenant.apply_delta(adds=payload[0], removes=payload[1])
    elif kind == "bsi":
        tenant.apply_column_delta("price", set_values=payload[0],
                                  removes=payload[1])
    else:
        tenant.apply_column_delta("lat", updates=payload)


class _Oracle:
    """Never-crashed host twin: port RoaringBitmaps and plain column
    models, mutated by the same stream."""

    def __init__(self, seed):
        self.hosts = [TRB.from_values(v) for v in _values(seed)]
        ids, vals, lat = _columns(seed)
        self.bsi = dict(zip(ids.tolist(), vals.tolist()))
        self.lat = lat.copy()

    def apply(self, step) -> None:
        kind, payload = step
        if kind == "delta":
            adds, removes = payload
            for src, vs in adds.items():
                self.hosts[src] = self.hosts[src] | TRB.from_values(
                    np.unique(np.asarray(vs, np.uint32)))
            for src, vs in removes.items():
                self.hosts[src] = self.hosts[src] - TRB.from_values(
                    np.unique(np.asarray(vs, np.uint32)))
        elif kind == "bsi":
            set_values, removes = payload
            self.bsi.update(set_values)
            for i in removes:
                self.bsi.pop(i, None)
        else:
            self.lat = self.lat.copy()
            for i, v in payload.items():
                self.lat[i] = v

    def check(self, ds) -> None:
        assert ds.host_bitmaps() == self.hosts
        assert ds.columns["price"].host_sum(None) == (
            sum(self.bsi.values()), len(self.bsi))
        assert np.array_equal(ds.columns["lat"].values, self.lat)


def _bytes_of(bitmaps) -> list:
    return [b.serialize() for b in bitmaps]


# ------------------------------------------------------------- journals

def test_flush_policy_typed():
    for mod in (tdur, jdur):
        with pytest.raises(ValueError, match="unknown flush mode"):
            mod.FlushPolicy(mode="sometimes")
        with pytest.raises(ValueError, match="every_n"):
            mod.FlushPolicy(mode="batch", every_n=0)
        with pytest.raises(ValueError):
            mod.FlushPolicy(mode="group")
        with pytest.raises(ValueError):
            mod.GroupCommitScheduler(every_n=0)
    p = tdur.GroupCommitScheduler(every_n=5).policy()
    assert (p.mode, p.every_n) == ("group", 5)


def test_journal_bytes_equal_and_cross_read(tmp_path):
    recs = [{"kind": "delta", "adds": {"0": [i, i + 7]}, "removes": {}}
            for i in range(5)]
    recs.append({"kind": "bsi", "col": "p", "set": [[3, 9]],
                 "removes": [4]})
    recs.append({"kind": "range", "col": "r", "updates": {"2": 11}})
    paths = {}
    for name, mod, pol in (("t", tdur, NEVER), ("j", jdur, JNEVER)):
        paths[name] = str(tmp_path / f"{name}.wal")
        j = mod.DeltaJournal(paths[name], pol)
        for r in recs:
            j.append(r)
        j.close()
    assert open(paths["t"], "rb").read() == open(paths["j"], "rb").read()
    for path in paths.values():
        got_t, got_j = tdur.scan_journal(path), jdur.scan_journal(path)
        assert got_t == got_j and not got_t[1]
        assert [r["seq"] for r in got_t[0]] == list(range(1, 8))
    # compaction writes the same bytes too
    for name, mod, pol in (("t", tdur, NEVER), ("j", jdur, JNEVER)):
        j = mod.DeltaJournal(paths[name], pol, start_seq=7)
        assert j.compact(3) == 4
        j.append({"kind": "delta", "adds": {"0": [99]}, "removes": {}})
        j.close()
    assert open(paths["t"], "rb").read() == open(paths["j"], "rb").read()
    assert [r["seq"] for r in tdur.scan_journal(paths["t"])[0]] == \
        [4, 5, 6, 7, 8]


def test_wal_delta_record_equal(tmp_path):
    """A set delta's WAL record, normalized by each package's
    ``apply_delta``, frames to the same bytes."""
    adds = {2: [9, 3, 3, 70000], 0: [5]}
    removes = {1: [4, 4]}
    ts, js = _tset(3, columns=False), _jset(3, columns=False)
    for name, ds, apply, mod, pol in (
            ("t", ts, tdelta.apply_delta, tdur, NEVER),
            ("j", js, jdelta.apply_delta, jdur, JNEVER)):
        j = mod.DeltaJournal(str(tmp_path / f"{name}.wal"), pol)
        apply(ds, adds, removes, journal=j)
        j.close()
    assert open(tmp_path / "t.wal", "rb").read() == \
        open(tmp_path / "j.wal", "rb").read()
    assert _bytes_of(ts.host_bitmaps()) == _bytes_of(js.host_bitmaps())


def test_torn_tail_and_midfile_corruption(tmp_path):
    path = str(tmp_path / "j.wal")
    j = tdur.DeltaJournal(path, NEVER)
    for i in range(3):
        j.append({"kind": "delta", "adds": {"0": [i]}, "removes": {}})
    j.close()
    whole = open(path, "rb").read()
    open(path, "wb").write(whole[:-5])
    got = tdur.scan_journal(path)
    assert got == jdur.scan_journal(path)
    assert got[1] and [r["seq"] for r in got[0]] == [1, 2]
    assert got[2] < len(whole) - 5
    blob = bytearray(whole)
    blob[len(tdur.JOURNAL_MAGIC) + tdur._FRAME.size + 2] ^= 0xFF
    for bad in (bytes(blob), b"NOTAWAL0" + whole[8:]):
        open(path, "wb").write(bad)
        with pytest.raises(errors.CorruptInput):
            tdur.scan_journal(path)
        with pytest.raises(jerrors.CorruptInput):
            jdur.scan_journal(path)
    assert issubclass(errors.TornJournalTail, errors.CorruptInput)


def test_fresh_tenant_refuses_existing_state(tmp_path):
    t = tdur.DurableTenant(_tset(1, columns=False), root=str(tmp_path),
                           tenant="t0", policy=NEVER)
    t.close()
    with pytest.raises(ValueError, match="recover_tenant"):
        tdur.DurableTenant(_tset(1, columns=False), root=str(tmp_path),
                           tenant="t0", policy=NEVER)
    with pytest.raises(ValueError, match="durable root"):
        tdur.DurableTenant(_tset(1, columns=False), root=None)


# ---------------------------------------------- snapshots across packages

def _tree(root) -> dict:
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            out[os.path.relpath(p, root)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("layout", ["dense", "counts"])
def test_snapshot_dirs_byte_equal(tmp_path, layout):
    """The same set, columns and stream write the same tenant directory
    (journal, CURRENT, MANIFEST.json, source and column files)."""
    steps = _stream(0xD0, 6)
    for name, mk, mod, pol in (("t", _tset, tdur, NEVER),
                               ("j", _jset, jdur, JNEVER)):
        ten = mod.DurableTenant(mk(40, layout), root=str(tmp_path / name),
                                tenant="t0", policy=pol, snapshot_every=4)
        for step in steps:
            _apply_step(ten, step)
        ten.close()
    got, want = _tree(tmp_path / "t"), _tree(tmp_path / "j")
    assert sorted(got) == sorted(want)
    assert any(k.endswith("MANIFEST.json") for k in got)
    for k in want:
        assert got[k] == want[k], k


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("point", ["pre_apply", "torn"])
def test_crashed_dir_recovers_in_the_other_package(tmp_path, writer, point):
    steps = _stream(0xA7, 7)
    root = str(tmp_path)
    if writer == "jax":
        ten = jdur.DurableTenant(_jset(40), root=root, tenant="t0",
                                 policy=JNEVER, snapshot_every=3)
        F, crash = jfaults, jerrors.InjectedCrash
    else:
        ten = tdur.DurableTenant(_tset(40), root=root, tenant="t0",
                                 policy=NEVER, snapshot_every=3)
        F, crash = faults, errors.InjectedCrash
    for step in steps[:5]:
        _apply_step(ten, step)
    with F.inject(f"crash@{point}=1.0:1"):
        with pytest.raises(crash):
            _apply_step(ten, steps[5])
    tree = _tree(root)
    # recovery truncates a torn tail: give each package its own copy
    for sub in ("a", "b"):
        for rel, blob in tree.items():
            p = os.path.join(root, sub, rel)
            os.makedirs(os.path.dirname(p), exist_ok=True)
            open(p, "wb").write(blob)
    trec, trep = tdur.recover_tenant(root=os.path.join(root, "a"),
                                     tenant="t0", policy=NEVER, device=CPU)
    jrec, jrep = jdur.recover_tenant(root=os.path.join(root, "b"),
                                     tenant="t0", policy=JNEVER)
    for k in ("snapshot_seq", "replayed", "torn", "version"):
        assert trep[k] == jrep[k], k
    assert trep["torn"] == (point == "torn")
    assert tobs.counter("rb_journal_torn_tails_total").value == (
        point == "torn")
    assert _bytes_of(trec.ds.host_bitmaps()) == _bytes_of(
        jrec.ds.host_bitmaps())
    assert trec.ds.columns["price"].host_sum(None) == \
        jrec.ds.columns["price"].host_sum(None)
    assert np.array_equal(trec.ds.columns["lat"].values,
                          jrec.ds.columns["lat"].values)
    assert list(trec.ds.source_versions) == list(jrec.ds.source_versions)
    oracle = _Oracle(40)
    for step in steps[:5] + ([steps[5]] if point == "pre_apply" else []):
        oracle.apply(step)
    oracle.check(trec.ds)
    trec.close()
    jrec.close()


def test_capture_restore_state_equal():
    ts, js = _tset(12), _jset(12)
    for step in _stream(3, 4):
        kind, payload = step
        if kind == "delta":
            ts.apply_delta(*payload)
            js.apply_delta(*payload)
    st, sj = tdur.capture_state(ts, 5, "x"), jdur.capture_state(js, 5, "x")
    assert st == sj
    assert tdur.state_bytes(st) == jdur.state_bytes(sj)
    back = tdur.restore_state(sj, device=CPU)
    assert back.device.type == "cpu"
    assert _bytes_of(back.host_bitmaps()) == _bytes_of(js.host_bitmaps())
    assert (back.version, back.structure_version) == (js.version,
                                                      js.structure_version)
    assert back.columns["price"].host_sum(None) == \
        js.columns["price"].host_sum(None)
    bad = dict(st, sources=[b"\x00\x01"] + st["sources"][1:])
    with pytest.raises(errors.CorruptInput):
        tdur.restore_state(bad, device=CPU)


def test_corrupt_snapshot_is_typed(tmp_path):
    ten = tdur.DurableTenant(_tset(5), root=str(tmp_path), tenant="t0",
                             policy=NEVER)
    ten.close()
    tdir = tmp_path / "t0"
    snap = open(tdir / "CURRENT").read().strip()
    src = tdir / snap / "src-0.rb"
    blob = bytearray(open(src, "rb").read())
    blob[len(blob) // 2] ^= 0xFF
    open(src, "wb").write(bytes(blob))
    with pytest.raises(errors.CorruptInput):
        tdur.recover_tenant(root=str(tmp_path), tenant="t0", device=CPU)
    with pytest.raises(jerrors.CorruptInput):
        jdur.recover_tenant(root=str(tmp_path), tenant="t0")
    open(tdir / "CURRENT", "w").write("../x")
    with pytest.raises(errors.CorruptInput):
        tdur.load_snapshot(str(tdir), device=CPU)


# ------------------------------------------------- crash-recovery property

@pytest.mark.parametrize("layout", ["dense", "counts"])
@pytest.mark.parametrize("point", ["pre_append", "pre_apply", "torn",
                                   "post_apply"])
def test_crash_recovery_property(tmp_path, layout, point):
    """A crash at each seam of an interleaved delta / column stream:
    recovery (plus the client's retry of the record the WAL says was
    lost) is exact against the never-crashed oracle."""
    steps = _stream(0xD0 + (layout == "counts"), 6)
    committed = point in ("pre_apply", "post_apply")
    for k in range(0, len(steps), 2):
        root = str(tmp_path / f"{k}")
        tenant = tdur.DurableTenant(_tset(40, layout), root=root,
                                    tenant="t0", policy=NEVER,
                                    snapshot_every=3)
        oracle = _Oracle(40)
        for step in steps[:k]:
            _apply_step(tenant, step)
            oracle.apply(step)
        with faults.inject(f"crash@{point}=1.0:1"):
            with pytest.raises(errors.InjectedCrash):
                _apply_step(tenant, steps[k])
        rec, report = tdur.recover_tenant(root=root, tenant="t0",
                                          policy=NEVER, device=CPU)
        assert report["torn"] == (point == "torn")
        assert rec.ds.device.type == "cpu"
        if committed:
            oracle.apply(steps[k])
        oracle.check(rec.ds)
        if not committed:
            _apply_step(rec, steps[k])
            oracle.apply(steps[k])
        for step in steps[k + 1:]:
            _apply_step(rec, step)
            oracle.apply(step)
        oracle.check(rec.ds)
        rec.close()
    got = BatchEngine(rec.ds, result_cache=None).execute(
        [BatchQuery("or", (0, 1, 2), form="bitmap")])[0]
    ref = oracle.hosts[0] | oracle.hosts[1] | oracle.hosts[2]
    assert got.bitmap == ref
    crashes = [e for e in tobs.flight._ring
               if e.get("error_class") == "InjectedCrash"]
    assert crashes[-1]["point"] == ("pre_apply" if point == "torn"
                                    else point)


def test_recovery_replays_snapshot_plus_tail(tmp_path):
    root = str(tmp_path)
    tenant = tdur.DurableTenant(_tset(7), root=root, tenant="t0",
                                policy=NEVER, snapshot_every=3)
    oracle = _Oracle(7)
    for step in _stream(9, 7):
        _apply_step(tenant, step)
        oracle.apply(step)
    h = tenant.health()
    assert h["tenant"] == "t0" and h["seq"] == 7
    assert any(d["tenant"] == "t0" for d in tdur.health())
    tenant.close()
    rec, report = tdur.recover_tenant(root=root, tenant="t0", policy=NEVER,
                                      device=CPU)
    assert report["snapshot_seq"] >= 3 and report["replayed"] <= 4
    assert {"load_ms", "restore_ms", "replay_ms"} <= set(report)
    oracle.check(rec.ds)
    rec.close()


def test_group_commit_amortizes_fsyncs(tmp_path):
    """One scheduler, 4 tenants, in each package: the same appends, the
    same group commits and fsync passes, and every tenant recovers
    exactly."""
    counts = []
    for name, mod, mk in (("t", tdur, _tset), ("j", jdur, _jset)):
        sched = mod.GroupCommitScheduler(every_n=8)
        tenants = [mod.DurableTenant(mk(40 + i, columns=False),
                                     root=str(tmp_path / name),
                                     tenant=f"t{i}", policy=sched.policy())
                   for i in range(4)]
        for k in range(6):
            for t in tenants:
                t.apply_delta(adds={k % 3: np.array([60000 + k],
                                                    np.uint32)})
        sched.commit()
        counts.append(dict(sched.stats))
        for t in tenants:
            t.close()
    assert counts[0] == counts[1]
    assert counts[0]["appends"] == 24 and counts[0]["commits"] >= 2
    assert counts[0]["fsyncs"] < 24
    for i in range(4):
        rec, _ = tdur.recover_tenant(root=str(tmp_path / "t"),
                                     tenant=f"t{i}", policy=NEVER,
                                     device=CPU)
        jrec, _ = jdur.recover_tenant(root=str(tmp_path / "j"),
                                      tenant=f"t{i}", policy=JNEVER)
        assert _bytes_of(rec.ds.host_bitmaps()) == _bytes_of(
            jrec.ds.host_bitmaps())
        rec.close()
        jrec.close()


def test_entry_points_need_a_card(tmp_path, monkeypatch):
    """device=None means "cuda": without a card, recovery, restoring a
    captured state, a descriptor ring and the bootstrap server raise
    instead of falling back to the CPU."""
    from roaringbitmap_tpu_torch.serving.resident import DescriptorRing
    from roaringbitmap_tpu_torch.wire import bootstrap

    ten = tdur.DurableTenant(_tset(2, columns=False), root=str(tmp_path),
                             tenant="t0", policy=NEVER)
    ten.close()
    state = tdur.capture_state(ten.ds)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tdur.recover_tenant(root=str(tmp_path),
                                             tenant="t0"),
                 lambda: tdur.restore_state(state),
                 lambda: DescriptorRing(4),
                 lambda: bootstrap.main(["--sets", "1", "--sources", "2",
                                         "--density", "16", "--users",
                                         "4096", "--no-columns"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
