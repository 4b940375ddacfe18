"""The port's CN/TN split (cluster/tn.py, cluster/cn.py) in one process
on the CPU, against the JAX package's where the two can be compared:
each scenario that reads rows runs the same DDL and inserts on the JAX
package's TN and two CNs as well, and what the port's replicas (and its
host peers over CNs) return must equal what the JAX package's return.

The in-process scenarios of tests/test_cn_tn.py and
tests/test_cn_tn_hardening.py on a port TN and two port CN replicas
(`RemoteCatalog`, sessions on device="cpu"): snapshot isolation across
CNs, a read path that never calls the TN, the TN's auto-increment,
cross-CN conflicts and duplicates, a merge resync, a resubscribe across
a truncation gap, varchar with NULLs and unicode through a CN and
through a TN restart, the LOAD floor, merges deferred while another
CN's txn is open and unblocked when its lease expires, subscriptions
served from memory, commits not held back by a stalled subscriber, the
logtail breaker tripping on a poisoned record and healing from a
transient one.  Also the `logtail.subscribe` drill of
tests/test_chaos.py, a TN-maintained view and a UDF served on a replica
(tests/test_mview.py, tests/test_udf.py), `mo_ctl('rpc')`'s keys equal
to the JAX package's, one trace whose `tn.commit` span parents under
the CN's `rpc.call`, host peers over two CNServices, and every service
started and stopped leaving no live thread.

The publication of the JAX package's catalog-shape drill is left out:
the port's engine holds no publications (ROADMAP.md, section A, step
5); its TN refuses that DDL naming the step.
"""

import csv
import json
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

from matrixone_tpu_torch.cluster import (FragmentServer, RemoteCatalog,
                                         ReplicaBrokenError, TNService)
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.storage.engine import ConflictError
from matrixone_tpu_torch.utils.fault import INJECTOR
from torch_cluster_rig import (  # noqa: F401  (fixtures)
    one_torch_thread, port_faults_disarmed, ref_pair, sessions, sync,
    tn_pair)


def _wait_rows(s, sql, want, timeout=15.0):
    deadline = time.time() + timeout
    while True:
        rows = sorted(int(r[0]) for r in s.execute(sql).rows())
        if rows == want or time.time() > deadline:
            return rows
        time.sleep(0.05)


def _rows(rows) -> list:
    """Rows as plain Python values (numpy scalars unwrapped), so the two
    packages' rows compare."""
    return [tuple(v.item() if hasattr(v, "item") else v for v in r)
            for r in rows]


def _pkg(port: bool) -> SimpleNamespace:
    """What a scenario takes from the port, or from the JAX package."""
    if port:
        from matrixone_tpu_torch import cluster
        from matrixone_tpu_torch.sql.binder import BindError
        from matrixone_tpu_torch.storage import engine
        from matrixone_tpu_torch.storage.fileservice import LocalFS
        return SimpleNamespace(
            port=True, cluster=cluster, BindError=BindError, engine=engine,
            LocalFS=LocalFS,
            session=lambda cat: TSession(catalog=cat, device="cpu"),
            frag_server=lambda cat: cluster.FragmentServer(
                cat, device="cpu"))
    from matrixone_tpu import cluster
    from matrixone_tpu.cluster.cn import FragmentServer
    from matrixone_tpu.frontend import Session
    from matrixone_tpu.sql.binder import BindError
    from matrixone_tpu.storage import engine
    from matrixone_tpu.storage.fileservice import LocalFS
    return SimpleNamespace(
        port=False, cluster=cluster, BindError=BindError, engine=engine,
        LocalFS=LocalFS, session=lambda cat: Session(catalog=cat),
        frag_server=FragmentServer)


def _both(scenario, tn_pair, ref_pair):
    """Run `scenario(pair, pkg)` on the port's TN and CNs and on the JAX
    package's, with the same DDL and inserts: what each saw must be
    equal.  -> the port's."""
    got = scenario(tn_pair, _pkg(True))
    want = scenario(ref_pair, _pkg(False))
    assert got == want, (got, want)
    return got


# ------------------------------------------------------------ test_cn_tn
def test_replica_ddl_gen_tracks_catalog_shape_ops(tn_pair):
    tn, cat1, cat2 = tn_pair
    s1, _s2 = sessions(tn_pair, port=True)
    s1.execute("create table pt (id bigint primary key)")
    sync(cat1, cat2)
    for ddl in ("create stage st9 url='file:///tmp/st9'",
                "drop stage st9", "create snapshot sn9"):
        g2 = cat2.ddl_gen
        s1.execute(ddl)
        cat2.consumer.wait_ts(cat1.consumer.applied_ts)
        assert cat2.ddl_gen > g2, ddl
    with pytest.raises(ValueError, match="step 5"):
        cat1._ddl({"op": "create_publication", "name": "p9",
                   "tables": ["pt"]})


def test_cross_cn_visibility_and_snapshots(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table t (id bigint primary key, x bigint)")
        s1.execute("insert into t values (1,10),(2,20)")
        sync(cat1, cat2)
        sql = "select * from t order by id"
        s2.execute("begin")
        seen = [_rows(s2.execute(sql).rows())]
        s1.execute("insert into t values (3,30)")
        seen.append(_rows(s2.execute(sql).rows()))
        s2.execute("commit")
        sync(cat1, cat2)
        seen.append(_rows(s2.execute(sql).rows()))
        assert [len(r) for r in seen] == [2, 2, 3]
        return seen
    _both(scenario, tn_pair, ref_pair)


def test_cn_read_path_never_rpcs(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table t (id bigint primary key, v varchar(8))")
        s1.execute("insert into t values (1,'a'),(2,'b')")
        sync(cat1, cat2)
        calls = {"n": 0}
        orig = cat2._client.call

        def counted(header, *a, **k):
            calls["n"] += 1
            return orig(header, *a, **k)
        cat2._client.call = counted
        try:
            rows = _rows(s2.execute("select id, v from t order by id"
                                    ).rows())
            rows += _rows(s2.execute("select count(*) from t where id > 0"
                                     ).rows())
        finally:
            del cat2._client.call
        assert calls["n"] == 0, "the CN read path must not call the TN"
        return rows
    assert _both(scenario, tn_pair, ref_pair) == [(1, "a"), (2, "b"),
                                                  (2,)]


def test_cross_cn_auto_increment_and_conflicts(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table a (id bigint primary key auto_increment,"
                   " v bigint)")
        for i in range(4):
            s1.execute(f"insert into a (v) values ({i})")
            s2.execute(f"insert into a (v) values ({100 + i})")
        sync(cat1, cat2)
        rows = _rows(s1.execute("select id, v from a order by id").rows())
        assert len({r[0] for r in rows}) == 8, rows
        s1.execute("create table t (id bigint primary key, x bigint)")
        s1.execute("insert into t values (1,1),(2,2),(3,3)")
        sync(cat1, cat2)
        s1.execute("begin")
        s2.execute("begin")
        s1.execute("delete from t where id = 3")
        s2.execute("delete from t where id = 3")
        s1.execute("commit")
        with pytest.raises(pkg.engine.ConflictError):
            s2.execute("commit")
        with pytest.raises(pkg.engine.DuplicateKeyError):
            s2.execute("insert into t values (1, 999)")
        sync(cat1, cat2)
        return rows + _rows(s2.execute("select * from t order by id"
                                       ).rows())
    _both(scenario, tn_pair, ref_pair)


def test_merge_resync_rewrites_gids(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table t (id bigint primary key, x bigint)")
        for i in (1, 2, 3):
            s1.execute(f"insert into t values ({i},{i})")
        s1.execute("delete from t where id = 2")
        kept = cat1.merge_table("t")
        assert kept == 2
        # [1, 3] is also the rows before the merge: wait for its record
        sync(cat1, cat2)
        assert _wait_rows(s2, "select id from t", [1, 3]) == [1, 3]
        after = _rows(s2.execute("select id, x from t order by id").rows())
        # deletes against post-merge row ids land on both replicas
        s2.execute("delete from t where id = 3")
        sync(cat1, cat2)
        last = _rows(s1.execute("select id, x from t order by id").rows())
        assert [r[0] for r in last] == [1]
        return kept, after, last
    _both(scenario, tn_pair, ref_pair)


def test_a_delete_behind_a_merge_conflicts(tn_pair):
    """A replica that has not applied a merge yet deletes by the row ids
    the merge rewrote: the TN refuses the commit as a write-write
    conflict instead of tombstoning ids that name no row any more (the
    delete would be acknowledged and lost).  The port alone: the JAX
    package's TN acknowledges that delete and loses it (ROADMAP.md,
    section C), so its rows are not the ones to hold."""
    tn, cat1, cat2 = tn_pair
    s1, s2 = sessions(tn_pair, port=True)
    s1.execute("create table t (id bigint primary key, x bigint)")
    for i in (1, 2, 3):
        s1.execute(f"insert into t values ({i},{i})")
    sync(cat1, cat2)
    snap = cat2.committed_ts
    t = cat2._replica.get_table("t")
    gid3 = next(seg.base_gid + int(np.flatnonzero(seg.arrays["id"] == 3)[0])
                for seg in t.segments if (seg.arrays["id"] == 3).any())
    assert cat1.merge_table("t") == 3
    with pytest.raises(ConflictError):
        cat2.commit_txn(snap, {}, {"t": np.array([gid3], np.int64)})
    sync(cat1, cat2)
    assert _wait_rows(s2, "select id from t", [1, 2, 3]) == [1, 2, 3]
    s2.execute("delete from t where id = 3")
    sync(cat1, cat2)
    assert sorted(int(r[0]) for r in s1.execute("select id from t").rows()) \
        == [1, 2]


def test_resubscribe_across_truncation_gap(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table g (id bigint primary key, v varchar(8))")
        s1.execute("insert into g values (1,'a')")
        sync(cat1, cat2)
        cat2.consumer.stop()                  # CN2 goes dark (joined)
        s1.execute("insert into g values (2,'b'), (3,'c')")
        s1.execute("delete from g where id = 1")
        cat1.checkpoint()                     # the gap is truncated away
        cat2.consumer = pkg.cluster.LogtailConsumer(
            cat2._replica, ("127.0.0.1", tn.port)).start()
        assert _wait_rows(s2, "select id from g", [2, 3]) == [2, 3]
        gap = _rows(s2.execute("select id, v from g order by id").rows())
        s1.execute("insert into g values (4,'d')")
        sync(cat1, cat2)
        rows = _rows(s2.execute("select id, v from g order by id").rows())
        assert [r[0] for r in rows] == [2, 3, 4]
        return gap, rows
    _both(scenario, tn_pair, ref_pair)


# ------------------------------------------------- test_cn_tn_hardening
def test_varchar_through_cn_with_nulls_and_unicode(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table v (id bigint primary key,"
                   " s varchar(32))")
        s1.execute("insert into v values (1,'héllo'), (2,NULL),"
                   " (3,'世界'), (4,'plain')")
        sync(cat1, cat2)
        rows = _rows(s2.execute("select id, s from v order by id").rows())
        assert rows == [(1, "héllo"), (2, None), (3, "世界"),
                        (4, "plain")]
        # a TN restart replays the dictionary-encoded WAL frames alike
        eng = pkg.engine.Engine.open(pkg.LocalFS(tn.engine.fs.root))
        texts, _gids = eng.get_table("v").read_texts("s")
        assert list(texts) == ["héllo", None, "世界", "plain"]
        return rows, list(texts)
    _both(scenario, tn_pair, ref_pair)


def test_load_through_cn_throughput(tn_pair, ref_pair, tmp_path):
    """A 20k-row LOAD through a CN at the JAX package's floor of 100k
    rows/s, or within 20x the port's own CSV read of the same file; CN
    2 then reads what the JAX package's CN 2 reads."""
    from matrixone_tpu_torch.storage import csvread
    n = 20000
    path = str(tmp_path / "rows.csv")
    cities = ["tokyo", "paris", "lima", "oslo", "cairo"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["id", "name", "city", "qty"])
        for i in range(n):
            w.writerow([i, f"name-{i % 97}", cities[i % 5], i * 3])

    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table ld (id bigint primary key,"
                   " name varchar(32), city varchar(32), qty bigint)")
        t0 = time.perf_counter()
        assert s1.load_csv("ld", path) == n
        dt = time.perf_counter() - t0
        if pkg.port:
            t0 = time.perf_counter()
            csvread.read_csv(path)
            t_ref = time.perf_counter() - t0
            assert n / dt > 100_000 or dt < 20 * t_ref, (
                f"LOAD through a CN: {n / dt:.0f} rows/s, "
                f"{dt / max(t_ref, 1e-9):.1f}x the CSV read")
        sync(cat1, cat2)
        return _rows(s2.execute(
            "select city, count(*), sum(qty), max(name) from ld"
            " group by city order by city").rows())
    rows = _both(scenario, tn_pair, ref_pair)
    assert sum(r[1] for r in rows) == n
    assert sum(r[2] for r in rows) == 3 * n * (n - 1) // 2


def test_merge_defers_while_other_cn_txn_open(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table m (id bigint primary key, x bigint)")
        s1.execute("insert into m values (1,1)")
        s1.execute("insert into m values (2,2)")
        sync(cat1, cat2)
        s2.execute("begin")
        seen = [_rows(s2.execute("select * from m order by id").rows())]
        deferred = cat1.merge_table("m")
        assert deferred == -2
        seen.append(_rows(s2.execute("select * from m order by id"
                                     ).rows()))
        s2.execute("commit")
        merged = cat1.merge_table("m")
        assert merged == 2
        return deferred, merged, seen
    _both(scenario, tn_pair, ref_pair)


def test_merge_lease_expiry_unblocks(tn_pair):
    tn, cat1, cat2 = tn_pair
    s1, _s2 = sessions(tn_pair, port=True)
    s1.execute("create table e (id bigint primary key)")
    s1.execute("insert into e values (1)")
    s1.execute("insert into e values (2)")
    cat2._call({"op": "txn_begin", "lease": 0.3})   # a CN that died
    assert cat1.merge_table("e") == -2
    time.sleep(0.5)
    assert cat1.merge_table("e") == 2


def test_subscribe_never_rereads_wal(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, _s2 = sessions(pair, port=pkg.port)
        s1.execute("create table b (id bigint primary key,"
                   " v varchar(8))")
        for i in range(5):
            s1.execute(f"insert into b values ({i}, 'r{i}')")

        def boom(stats=None):
            raise AssertionError("subscribe re-read the WAL")
        tn.hub.wal.replay = boom
        cat3 = pkg.cluster.RemoteCatalog(("127.0.0.1", tn.port),
                                         data_dir=tn.engine.fs.root)
        try:
            cat3.consumer.wait_ts(cat1.committed_ts)
            return _rows(pkg.session(cat3).execute(
                "select * from b order by id").rows())
        finally:
            cat3.close()
    assert len(_both(scenario, tn_pair, ref_pair)) == 5


def test_commits_not_blocked_by_slow_subscriber(tn_pair):
    tn, cat1, cat2 = tn_pair
    s1, _s2 = sessions(tn_pair, port=True)
    s1.execute("create table sl (id bigint primary key)")
    _backlog, q = tn.hub.subscribe(0)       # registered, never drained
    t0 = time.perf_counter()
    for i in range(20):
        s1.execute(f"insert into sl values ({i})")
    dt = time.perf_counter() - t0
    tn.hub.unsubscribe(q)
    assert dt < 5.0, f"20 commits took {dt:.1f}s"
    assert len(s1.execute("select * from sl").rows()) == 20


def test_poisoned_logtail_trips_breaker(tn_pair):
    from matrixone_tpu_torch.storage import wal as walmod
    tn, cat1, cat2 = tn_pair
    s1, s2 = sessions(tn_pair, port=True)
    s1.execute("create table p (id bigint primary key)")
    s1.execute("insert into p values (1)")
    sync(cat1, cat2)
    ts = tn.engine.hlc.now()
    fields, parts = walmod.arrays_to_payload(
        {"id": np.array([1], np.int64)}, {"id": np.array([True])})
    tn.hub.append({"op": "insert", "table": "no_such_table", "ts": ts,
                   **fields}, parts)
    tn.hub.append({"op": "commit", "ts": ts})
    deadline = time.time() + 30
    while time.time() < deadline and not cat2.consumer.broken:
        time.sleep(0.05)
    assert cat2.consumer.broken, "the breaker never opened"
    assert "no_such_table" in (cat2.consumer.last_error or "")
    with pytest.raises(ReplicaBrokenError):
        s2.execute("select * from p")


def test_transient_error_heals_without_breaking(tn_pair):
    tn, cat1, cat2 = tn_pair
    s1, s2 = sessions(tn_pair, port=True)
    s1.execute("create table h (id bigint primary key)")
    s1.execute("insert into h values (1)")
    sync(cat1, cat2)
    orig = cat2.consumer._apply
    state = {"failed": False}

    def flaky(applier, h, b):
        if not state["failed"] and h.get("op") == "commit":
            state["failed"] = True
            raise RuntimeError("transient apply hiccup")
        return orig(applier, h, b)
    cat2.consumer._apply = flaky
    s1.execute("insert into h values (2)")
    sync(cat1, cat2)
    assert not cat2.consumer.broken
    assert len(s2.execute("select * from h").rows()) == 2
    assert cat2.consumer.strikes == 0


# --------------------------------------------------------------- drills
def test_logtail_subscription_drops_then_converges(tn_pair, ref_pair):
    """A new CN whose subscription is dropped twice at connect backs off,
    subscribes and converges (the fault point is the port's; the JAX
    package's CN subscribes at once and reads the same rows)."""
    def scenario(pair, pkg):
        tn, cat1, _cat2 = pair
        s1, _s2 = sessions(pair, port=pkg.port)
        s1.execute("create table lt (id bigint primary key)")
        s1.execute("insert into lt values (1)")
        if pkg.port:
            INJECTOR.add("logtail.subscribe", "return", "drop", times=2)
        cat3 = pkg.cluster.RemoteCatalog(("127.0.0.1", tn.port),
                                         data_dir=tn.engine.fs.root)
        try:
            if pkg.port:
                assert INJECTOR.describe()["logtail.subscribe"][
                    "fired"] == 2
                INJECTOR.clear()
            s3 = pkg.session(cat3)
            s1.execute("insert into lt values (2)")
            cat3.consumer.wait_ts(cat1.committed_ts)
            return _rows(s3.execute("select id from lt order by id"
                                    ).rows())
        finally:
            cat3.close()
    assert _both(scenario, tn_pair, ref_pair) == [(1,), (2,)]


def test_cn_replicas_serve_tn_maintained_views(tn_pair, ref_pair):
    """A view created through one CN is maintained by the TN (replicas
    never maintain) and its backing rows reach every CN through the
    logtail."""
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table t (k varchar(4), v bigint)")
        s1.execute("insert into t values ('a', 1), ('b', 2)")
        s1.execute("create materialized view cv as "
                   "select k, sum(v) sv from t group by k")
        s1.execute("insert into t values ('a', 10)")
        sync(cat1, cat2)
        rows = sorted(_rows(s2.execute("select * from cv").rows()))
        assert rows == [("a", 11), ("b", 2)]
        (name, mode, source, _wm, _n, _sql), = \
            s2.execute("show materialized views").rows()
        assert (name, mode, source) == ("cv", "incremental", "t")
        if pkg.port:
            assert cat2._replica._mview_service is None   # never maintains
            assert tn.engine._mview_service is not None
        return rows, (name, mode, source)
    _both(scenario, tn_pair, ref_pair)


def test_udf_replicates_to_cn_replica(tn_pair, ref_pair):
    def scenario(pair, pkg):
        tn, cat1, cat2 = pair
        s1, s2 = sessions(pair, port=pkg.port)
        s1.execute("create table rt (x double)")
        s1.execute("insert into rt values (5.0), (-3.0)")
        s1.execute("create function half(x DOUBLE) returns DOUBLE "
                   "language python as $$ x / 2.0 $$")
        sync(cat1, cat2)
        rows = _rows(s2.execute("select half(x) from rt order by x"
                                ).rows())
        assert rows == [(-1.5,), (2.5,)]
        g_before = cat2.ddl_gen
        s1.execute("drop function half")
        cat2.consumer.wait_ts(cat1.committed_ts)
        assert cat2.ddl_gen > g_before
        with pytest.raises(pkg.BindError, match="unknown function"):
            s2.execute("select half(x) from rt")
        return rows
    _both(scenario, tn_pair, ref_pair)


def test_mo_ctl_rpc_keys_equal_the_reference(tn_pair, ref_pair):
    outs = []
    for pair, port in ((tn_pair, True), (ref_pair, False)):
        s1, _s2 = sessions(pair, port=port)
        s1.execute("create table r (id bigint primary key)")
        s1.execute("insert into r values (1)")
        (out,), = s1.execute("select mo_ctl('rpc')").rows()
        outs.append(json.loads(out))
    port_st, ref_st = outs
    assert sorted(port_st) == sorted(ref_st) == ["breakers", "logtail"]
    assert sorted(port_st["logtail"]) == sorted(ref_st["logtail"])
    assert port_st["logtail"]["state"] == "closed"
    for st in (port_st, ref_st):
        for b in st["breakers"].values():
            assert sorted(b) == ["cooldown_s", "failures", "state",
                                 "threshold"]


def test_tn_commit_span_parents_under_rpc_call(tn_pair):
    from matrixone_tpu_torch.utils import motrace
    tn, cat1, cat2 = tn_pair
    s1, _s2 = sessions(tn_pair, port=True)
    s1.execute("create table tr (id bigint primary key)")
    tr = motrace.TRACER
    was = (tr.armed, tr.sample)
    tr.arm(sample=1.0)
    tr.clear()
    try:
        s1.execute("insert into tr values (1)")
        spans = [sp for tid in tr.trace_ids() for sp in tr.spans_of(tid)]
    finally:
        tr.armed, tr.sample = was
        tr.clear()
    assert len({sp["tid"] for sp in spans}) == 1, "not one trace"
    commits = [sp for sp in spans if sp["name"] == "tn.commit"]
    calls = {sp["sid"]: sp for sp in spans if sp["name"] == "rpc.call"}
    assert len(commits) == 1 and commits[0]["proc"] == "tn"
    parent = calls.get(commits[0]["psid"])
    assert parent is not None and parent["attrs"]["op"] == "commit"


def _cns(pkg, tn, n=2) -> list:
    """n CNs of `tn`, each a replica and a fragment server: the port's
    CNService, or the JAX package's RemoteCatalog and FragmentServer
    (its CNService would also start a MySQL server)."""
    addr, root = ("127.0.0.1", tn.port), tn.engine.fs.root
    if pkg.port:
        return [pkg.cluster.CNService(addr, data_dir=root,
                                      device="cpu").start()
                for _ in range(n)]
    out = []
    for _ in range(n):
        cat = pkg.cluster.RemoteCatalog(addr, data_dir=root)
        frag = pkg.frag_server(cat).start()

        def stop(cat=cat, frag=frag):
            frag.stop()
            cat.close()
        out.append(SimpleNamespace(catalog=cat, fragments=frag,
                                   frag_port=frag.port, stop=stop))
    return out


def test_host_peers_over_cn_replicas(tn_pair, ref_pair):
    """Two CNs (a replica and a fragment server each) as peers of each
    other: Q3's shape and a top-k distribute from CN 2; their rows equal
    CN 2's local rows and the JAX package's distributed rows over its
    own two CNs, with as many fragments.  A peer whose replica cannot
    reach the snapshot makes a local run, on both."""
    def scenario(pair, pkg):
        tn, cat1, _cat2 = pair
        s1, _s2 = sessions(pair, port=pkg.port)
        s1.execute("create table o (id bigint primary key, c bigint,"
                   " p varchar(8))")
        s1.execute("create table l (id bigint primary key, o bigint,"
                   " q bigint)")
        for lo in range(0, 3000, 1000):
            s1.execute("insert into l values " + ",".join(
                f"({i},{i % 400},{i % 17})" for i in range(lo, lo + 1000)))
        s1.execute("insert into o values " + ",".join(
            f"({i},{i % 9},'p{i % 5}')" for i in range(400)))
        cns = _cns(pkg, tn)
        seen = []
        try:
            for cn in cns:
                cn.catalog.dist_peers = [f"127.0.0.1:{c.frag_port}"
                                         for c in cns]
                cn.catalog.consumer.wait_ts(cat1.committed_ts)
            cat = cns[1].catalog
            local = pkg.session(cat)
            local.execute("set dist = 0")
            sd = pkg.session(cat)
            sd.variables["dist_min_rows"] = 0
            sd.variables["dist_batch_rows"] = 512
            for sql in ("select o.p, sum(l.q), count(*) from l join o"
                        " on l.o = o.id group by o.p order by o.p",
                        "select id, q from l order by q desc, id limit 7"):
                before = sum(cn.fragments.frags_run for cn in cns)
                got = _rows(sd.execute(sql).rows())
                ran = sum(cn.fragments.frags_run for cn in cns) - before
                assert ran == 2
                assert got == _rows(local.execute(sql).rows())
                seen.append((got, ran))
            # a peer whose replica cannot reach the snapshot: a local run
            lagging = cns[0].catalog.consumer

            def never(ts, timeout=30.0):
                raise TimeoutError(f"logtail did not reach ts {ts}")
            lagging.wait_ts = never
            try:
                sql = "select p, count(*) from o group by p order by p"
                ran0 = cns[0].fragments.frags_run
                got = _rows(sd.execute(sql).rows())
                assert got == _rows(local.execute(sql).rows())
                if pkg.port:
                    assert cns[0].fragments.frags_run == ran0  # it refused
                seen.append(got)
            finally:
                del lagging.wait_ts
        finally:
            for cn in cns:
                cn.stop()
        return seen
    _both(scenario, tn_pair, ref_pair)


def test_services_stop_leaving_no_thread(tmp_path):
    """TNService, two RemoteCatalogs (logtail consumers, lease renewers,
    pooled RpcClients) and a FragmentServer, started, used and stopped:
    no thread of theirs is left alive."""
    before = set(threading.enumerate())
    d = str(tmp_path)
    tn = TNService(data_dir=d, device="cpu").start()
    cat1 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    cat2 = RemoteCatalog(("127.0.0.1", tn.port), data_dir=d)
    f = FragmentServer(cat1, device="cpu").start()
    s = TSession(catalog=cat2, device="cpu")
    s.execute("create table x (id bigint primary key, v bigint)")
    s.execute("insert into x values " + ",".join(
        f"({i},{i % 3})" for i in range(300)))
    sync(cat1, cat2)
    cat2.dist_peers = [f.addr]
    s.variables["dist_min_rows"] = 0
    assert s.execute("select v, count(*) from x group by v order by v"
                     ).rows() == [(0, 100), (1, 100), (2, 100)]
    assert f.frags_run == 1
    assert f.stop() == []
    cat1.close()
    cat2.close()
    assert tn.stop() == []
    left = [t.name for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == []
