"""Merges, their snapshot fences, fence GC and the merge scheduler, on
the CPU, held to the JAX package's.

The scenarios of tests/test_merge_sched.py that need no CDC or
materialized views (neither is ported; the fault-hook ones are in
test_torch_ops_surface.py): AS OF a snapshot is the same before a
merge, after it and after a restart that reloads the fence; the swap
window (the merge parked just before its swap by a `merge.swap` wait
fault, as the reference's test parks it); GC holding a fence and its
objects for a named snapshot and for a registered watermark; the scheduler's
candidates and its thread's lifecycle.  Also the merge's refusals (-1,
-2 with a transaction open, -3 when a commit deleted a captured row
during the rewrite), a partitioned table's merge, and a scheduler cycle
that merges and checkpoints.  Every row set read is compared between
the packages (`torch_storage_pkgs.run_both`).
"""

import threading
import time

import pytest

from matrixone_tpu.utils import fault as jfault
from matrixone_tpu_torch.utils import fault as tfault
from matrixone_tpu_torch.utils import metrics as TM
from torch_storage_pkgs import packages, run_both, storage_env  # noqa: F401

pytestmark = pytest.mark.usefixtures("storage_env")


def test_as_of_reads_bit_identical_across_merge_and_restart(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = pkg.session(pkg.Engine(fs))
        s.execute("create table t (id bigint, v varchar(8))")
        s.execute("insert into t values (1, 'a'), (2, 'b')")
        s.execute("create snapshot s1")
        s.execute("insert into t values (3, 'c')")
        s.execute("delete from t where id = 1")
        q = "select id, v from t as of snapshot 's1' order by id"
        before = pkg.rows(s, q)
        assert before == [(1, "a"), (2, "b")]
        cur = pkg.rows(s, "select id, v from t order by id")
        assert s.catalog.merge_table("t", min_segments=1,
                                     checkpoint=False) == 2
        assert pkg.rows(s, q) == before
        assert pkg.rows(s, "select id, v from t order by id") == cur
        # deleted before the merge, its row resolves through the fence
        t = s.catalog.get_table("t")
        a, _v = t.fetch_rows([0, 1], ["id"])
        assert a["id"].tolist() == [1, 2]
        s.catalog.checkpoint()
        s2 = pkg.session(pkg.Engine.open(fs))
        assert pkg.rows(s2, q) == before
        assert pkg.rows(s2, "select id, v from t order by id") == cur
        assert s2.catalog.tables["t"].fences
        assert all(seg.is_lazy
                   for seg in s2.catalog.tables["t"].fences[0].segments)
    run_both(scenario, tmp_path)


def test_as_of_read_during_merge_swap_window(tmp_path):
    """A reader racing the merge sees either side consistently: with the
    merge parked right before its swap (a `merge.swap` wait fault, in
    both packages), current and AS OF reads return the pre-swap rows;
    after the release, the same."""
    def scenario(pkg):
        injector = (jfault if pkg.name == "jax" else tfault).INJECTOR
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        s.execute("insert into t values (1)")
        s.execute("insert into t values (2)")
        s.execute("create snapshot pin")
        s.execute("insert into t values (3)")
        injector.add("merge.swap", "wait", "10", times=1)
        try:
            res = []
            th = threading.Thread(target=lambda: res.append(
                eng.merge_table("t", min_segments=1, checkpoint=False)))
            th.start()
            deadline = time.monotonic() + 5
            while injector.status().get("merge.swap", (0, 0, 0))[2] == 0:
                assert time.monotonic() < deadline, \
                    "merge never reached its swap"
                time.sleep(0.005)
            assert pkg.rows(s, "select id from t order by id") == \
                [(1,), (2,), (3,)]
            assert pkg.rows(s, "select id from t as of snapshot 'pin' "
                               "order by id") == [(1,), (2,)]
            assert not eng.get_table("t").fences
            injector.notify("merge.swap")
            th.join(timeout=10)
            assert res == [3]
        finally:
            injector.clear()
        assert len(eng.get_table("t").segments) == 1
        assert pkg.rows(s, "select id from t order by id") == \
            [(1,), (2,), (3,)]
        assert pkg.rows(s, "select id from t as of snapshot 'pin' "
                           "order by id") == [(1,), (2,)]
    run_both(scenario, tmp_path)


def test_merge_refusals(tmp_path, monkeypatch):
    """-1: too few segments; -2: a transaction is open (its workspace
    holds pre-merge gids); -3: a commit deleted a captured row while
    the merge rewrote."""
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        s.execute("insert into t values (1), (2)")
        assert eng.merge_table("t") == -1
        s.execute("insert into t values (3)")
        other = pkg.session(eng)
        other.execute("begin")
        assert eng.active_txns == 1
        assert eng.merge_table("t") == -2
        other.execute("rollback")
        assert eng.active_txns == 0
        real = pkg.Engine._merge_write_object

        def racing(self, name, arrays, validity):
            out = real(self, name, arrays, validity)
            s.execute("delete from t where id = 2")
            return out
        monkeypatch.setattr(pkg.Engine, "_merge_write_object", racing)
        assert eng.merge_table("t") == -3
        monkeypatch.setattr(pkg.Engine, "_merge_write_object", real)
        assert pkg.rows(s, "select id from t order by id") == [(1,), (3,)]
        assert eng.merge_table("t") == 2
        assert pkg.rows(s, "select id from t order by id") == [(1,), (3,)]
    run_both(scenario, tmp_path)


def test_gc_holds_fence_objects_until_snapshot_drops(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        eng = pkg.Engine(fs)
        s = pkg.session(eng)
        s.execute("create table t (id bigint, v bigint)")
        s.execute("insert into t values (1, 10), (2, 20)")
        s.execute("insert into t values (3, 30)")
        eng.checkpoint()
        old_paths = [seg.obj_path for seg in eng.tables["t"].segments]
        assert all(p is not None for p in old_paths)
        s.execute("create snapshot pin")
        s.execute("delete from t where id = 2")
        assert eng.merge_table("t", min_segments=1, checkpoint=True) == 2
        assert len(eng.tables["t"].fences) == 1
        assert eng.gc_fences() == {"released": 0, "objects_deleted": 0}
        assert eng.tables["t"].fences
        assert all(fs.exists(p) for p in old_paths)
        assert pkg.rows(s, "select id from t as of snapshot 'pin' "
                           "order by id") == [(1,), (2,), (3,)]
        eng.drop_snapshot("pin")
        gc = eng.gc_fences()
        assert gc["released"] == 1 and gc["objects_deleted"] >= 1
        assert not eng.tables["t"].fences
        assert eng.tables["t"].delta_floor > 0
        assert not any(fs.exists(p) for p in old_paths)
        assert pkg.rows(s, "select id, v from t order by id") == \
            [(1, 10), (3, 30)]
        s2 = pkg.session(pkg.Engine.open(fs))
        assert pkg.rows(s2, "select id, v from t order by id") == \
            [(1, 10), (3, 30)]
        assert not s2.catalog.tables["t"].fences
        return gc
    g0 = TM.merge_gc_objects.get()
    out = run_both(scenario, tmp_path)
    assert out["port"] == out["jax"]
    assert TM.merge_gc_objects.get() == g0 + out["port"]["objects_deleted"]


def test_gc_drops_the_merged_away_objects_from_the_cache(tmp_path):
    """The merged-away objects leave both tiers of the block cache."""
    pkg = packages(tmp_path)[1]
    eng = pkg.Engine(pkg.local())
    s = pkg.session(eng)
    s.execute("create table t (id bigint)")
    s.execute("insert into t values (1)")
    s.execute("insert into t values (2)")
    eng.checkpoint(demote=True)
    paths = [seg.obj_path for seg in eng.tables["t"].segments]
    assert s.execute("select sum(id) from t").rows() == [(3,)]
    cache = pkg.blockcache.CACHE
    assert any(k[1] in paths for k in cache._dev)
    assert eng.merge_table("t") == 2
    assert eng.gc_fences()["released"] == 1
    assert not any(k[1] in paths for k in cache._dev)
    assert not any(k[1] in paths for k in cache._host)
    assert s.execute("select sum(id) from t").rows() == [(3,)]


def test_drop_and_recreate_after_merge_reads_the_new_objects(tmp_path):
    """A table dropped after a merge, while its merged-away segments'
    columns sit in the block cache, and re-created under its name
    writes the same object paths again: its scans read the new objects,
    never the dropped table's cached columns.  Held to the rows
    inserted: the JAX package's drop_table forgets only the live
    segments' objects, and its scan returns the dropped table's ids."""
    pkg = packages(tmp_path)[1]
    eng = pkg.Engine(pkg.local())
    s = pkg.session(eng)
    s.execute("create table t (id bigint, v varchar(8))")
    s.execute("insert into t values (1, 'a'), (2, 'b')")
    s.execute("insert into t values (3, 'c')")
    eng.checkpoint(demote=True)
    q = "select id, v from t order by id"
    assert s.execute(q).rows() == [(1, "a"), (2, "b"), (3, "c")]
    cache = pkg.blockcache.CACHE
    old = [seg.obj_path for seg in eng.tables["t"].segments]
    assert any(k[1] in old for k in cache._dev)
    assert eng.merge_table("t", min_segments=1, checkpoint=False) == 3
    s.execute("drop table t")
    assert not any(k[1] in old for k in cache._host)
    assert not any(k[1] in old for k in cache._dev)
    s.execute("create table t (id bigint, v varchar(8))")
    s.execute("insert into t values (10, 'x')")
    s.execute("insert into t values (20, 'y'), (30, 'z'), (40, 'w')")
    eng.checkpoint(demote=True)
    t = eng.tables["t"]
    assert all(seg.is_lazy for seg in t.segments)
    assert [seg.obj_path for seg in t.segments] == old
    assert s.execute(q).rows() == [(10, "x"), (20, "y"), (30, "z"),
                                   (40, "w")]
    assert s.execute("select sum(id), count(*) from t").rows() == [(100, 4)]


def test_gc_holds_fence_for_registered_consumer_watermark(tmp_path):
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        s.execute("insert into t values (1)")
        wm = {"ts": 1}
        eng.register_watermark("test:consumer", "t", lambda: wm["ts"])
        s.execute("insert into t values (2)")
        assert eng.merge_table("t", min_segments=1, checkpoint=False) == 2
        assert eng.gc_fences()["released"] == 0
        assert eng.min_watermark("t") == 1
        wm["ts"] = eng.committed_ts
        assert eng.gc_fences()["released"] == 1
        eng.unregister_watermark("test:consumer")
        assert eng.min_watermark("t") is None
        pkg.rows(s, "select id from t order by id")
    run_both(scenario, tmp_path)


def test_partitioned_merge_keeps_one_partition_a_segment(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        eng = pkg.Engine(fs)
        s = pkg.session(eng)
        s.execute("create table pr (k int, v int) partition by range(k) ("
                  "partition a values less than (100),"
                  "partition b values less than (maxvalue))")
        for i in range(3):
            s.execute(f"insert into pr values ({i}, {i}), ({150 + i}, {i})")
        s.execute("delete from pr where k = 151")
        assert eng.merge_table("pr") == 5
        t = eng.get_table("pr")
        assert sorted(seg.part_id for seg in t.segments) == [0, 1]
        pkg.rows(s, "select sum(v) from pr where k < 100")
        pkg.rows(s, "select k, v from pr order by k")
        s2 = pkg.session(pkg.Engine.open(fs))
        pkg.rows(s2, "select k, v from pr order by k")
    run_both(scenario, tmp_path)


def test_scheduler_policy_candidates(tmp_path):
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table segs (id bigint)")
        for i in range(4):
            s.execute(f"insert into segs values ({i})")
        s.execute("create table tombs (id bigint)")
        s.execute("insert into tombs values (1), (2), (3), (4)")
        s.execute("insert into tombs values (5)")
        s.execute("delete from tombs where id in (1, 2)")
        s.execute("create table quiet (id bigint)")
        s.execute("insert into quiet values (1)")
        sched = pkg.merge_sched.MergeScheduler(eng)
        assert sched.min_segments == 4
        assert sched.tombstone_ratio == pytest.approx(0.2)
        cands = {c["table"]: c for c in sched.candidates()}
        assert cands["segs"]["reason"] == "segments"
        assert cands["tombs"]["reason"] == "tombstones"
        assert cands["tombs"]["dead_ratio"] == pytest.approx(0.4)
        assert "quiet" not in cands
        summary = sched.run_cycle()
        assert sorted(m["table"] for m in summary["merged"]) == \
            ["segs", "tombs"]
        assert summary["checkpoint"] is True
        assert len(eng.get_table("segs").segments) == 1
        pkg.rows(s, "select id from tombs order by id")
        pkg.rows(s, "select id from segs order by id")
        return {c: (v["reason"], v["segments"]) for c, v in cands.items()
                if not c.startswith("system_")}
    out = run_both(scenario, tmp_path)
    assert out["port"] == out["jax"]


def test_scheduler_defers_while_a_transaction_is_open(tmp_path):
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        for i in range(4):
            s.execute(f"insert into t values ({i})")
        reader = pkg.session(eng)
        reader.execute("begin")
        sched = pkg.merge_sched.MergeScheduler(eng)
        d0 = TM.merge_tasks.get(kind="compact", outcome="deferred")
        summary = sched.run_cycle()
        assert summary["deferred"] == ["*active-txns*"]
        assert len(eng.get_table("t").segments) == 4
        reader.execute("commit")
        summary = sched.run_cycle()
        assert [m["kept"] for m in summary["merged"]] == [4]
        return d0
    run_both(scenario, tmp_path)
    assert TM.merge_tasks.get(kind="compact", outcome="deferred") >= 1


def test_scheduler_thread_lifecycle_pause_and_status(tmp_path, monkeypatch):
    pkg = packages(tmp_path)[1]
    sched_mod = pkg.merge_sched
    eng = pkg.Engine()
    s = pkg.session(eng)
    s.execute("create table t (id bigint)")
    s.execute("insert into t values (1)")
    sched = sched_mod.MergeScheduler(eng, interval_s=0.005)
    st = sched.status()
    assert st["running"] is False and st["cycles"] == 0
    sched.start()
    try:
        deadline = time.monotonic() + 5
        while sched.cycles == 0 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert sched.cycles > 0
        assert sched.status()["running"] is True
        sched.pause()
        time.sleep(0.2)            # a cycle under way when paused ends
        frozen = sched.cycles
        time.sleep(0.05)
        assert sched.cycles == frozen
        sched.resume()
    finally:
        sched.stop()
    assert sched.status()["running"] is False
    sched.stop()
    assert sched_mod.maybe_start(eng) is None
    monkeypatch.setenv("MO_MERGE_SCHED", "1")
    auto = sched_mod.maybe_start(eng)
    try:
        assert auto._thread is not None
        assert sched_mod.scheduler_for(eng) is auto
    finally:
        auto.stop()
    assert 0.01 <= sched_mod.backoff_delay(1) <= 0.03
    assert sched_mod.backoff_delay(50) <= 1.5


def test_mo_ctl_is_not_ported(tmp_path):
    """The reference operates the scheduler through `mo_ctl('merge',
    ...)`; so does the port since its operations surface was ported:
    `mo_ctl('merge', 'status')` answers the status of the engine's one
    scheduler (`scheduler_for`), whose cycle also runs directly."""
    import json
    pkg = packages(tmp_path)[1]
    s = pkg.session()
    sched = pkg.merge_sched.scheduler_for(s.catalog)
    st = json.loads(s.execute("select mo_ctl('merge', 'status')")
                    .rows()[0][0])
    assert st["cycles"] == sched.cycles == 0 and st["running"] is False
    assert sched is pkg.merge_sched.scheduler_for(s.catalog)
    assert sched.run_cycle()["merged"] == []
    assert json.loads(s.execute("select mo_ctl('merge', 'status')")
                      .rows()[0][0])["cycles"] == 1
