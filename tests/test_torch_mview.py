"""Materialized views on the port against the JAX package's, on the CPU.

The cases of tests/test_mview.py that need no cluster and no stream,
each a scenario run through both packages (`torch_storage_pkgs.run_both`:
every row set either side reads is recorded and the port's must equal the
reference's, step by step; the JAX side on its per-operator path with its
Pallas kernels in interpret mode), plus the assertions of the reference's
test on each side: the view equal to its defining SELECT after every
statement of the insert/delete/update mix, a restart that rebuilds the
state, the degrade to a full refresh, EXPLAIN's mark and SHOW's
watermark, write protection and DROP, cache invalidation, the dense tier
as one step per delta (the port's counters), `mo_ctl('mview')`, a broken
view that never fails another commit, a filtered view, and a view kept
incremental across a merge (tests/test_merge_sched.py:157).  Integers,
decimals (scaled int64), counts and float extrema compare exactly.
"""

import json
import threading

import pytest

from matrixone_tpu.utils import metrics as JM
from matrixone_tpu_torch.utils import metrics as TM
from torch_storage_pkgs import packages, run_both, \
    storage_env  # noqa: F401

METRICS = {"jax": JM, "port": TM}

VIEW_SQL = ("select k, count(*) n, sum(v) sv, sum(d) sd, avg(d) ad,"
            " min(f) lo, max(f) hi from t group by k")


@pytest.fixture(autouse=True)
def _env(storage_env):       # noqa: F811 — the shared fixture
    yield


def _sorted(rows):
    return sorted(rows, key=repr)


def _setup(pkg, eng=None, fs=None):
    s = pkg.session(eng, fs)
    s.execute("create table t (k varchar(4), v bigint, d decimal(10,2),"
              " f double)")
    return s


def _view_equals_recompute(pkg, s, view, sql):
    got = _sorted(pkg.rows(s, f"select * from {view}"))
    want = _sorted(s.execute(sql).rows())
    assert got == want, (pkg.name, got, want)


def test_lockstep_with_full_recompute(tmp_path):
    """After every statement of the reference's insert/delete/update mix
    (MIN/MAX retraction, a group deleted whole and reborn, NULL keys and
    measures) the view equals its defining SELECT, in both packages."""
    script = [
        "insert into t values ('b', 10, 4.00, 2.0), ('c', 5, 1.00, 7.5)",
        "insert into t values ('a', null, null, null)",
        "insert into t values (null, 7, 0.25, 3.25)",
        "delete from t where f = 9.0",
        "update t set v = v * 10 where k = 'a' and v is not null",
        "delete from t where k = 'c'",
        "insert into t values ('c', 8, 8.00, -2.0)",
        "delete from t where f = -1.5",
        "update t set d = 9.99 where k = 'b'",
        "delete from t where k is null",
    ]

    def scenario(pkg):
        s = _setup(pkg)
        s.execute("insert into t values ('a', 1, 1.25, 0.5),"
                  " ('a', 2, 2.50, -1.5), ('b', 3, 0.75, 9.0)")
        s.execute(f"create materialized view lv as {VIEW_SQL}")
        _view_equals_recompute(pkg, s, "lv", VIEW_SQL)
        for stmt in script:
            s.execute(stmt)
            _view_equals_recompute(pkg, s, "lv", VIEW_SQL)
    run_both(scenario, tmp_path)


def test_reads_snapshot_consistent_under_concurrent_writers(tmp_path):
    """The reference's staleness drill, run on each package's own engine:
    two writers bump the source while two readers loop over the view with
    the result cache on; every read is whole and never goes back, and the
    view holds every bump once the writers return (a writer's commit
    returns after its maintenance).  The two packages' final view rows
    and their reads' verdicts are equal."""

    def drill(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table ctr (id bigint primary key, v bigint,"
                  " k varchar(2))")
        s.execute("insert into ctr values (1, 0, 'a'), (2, 0, 'a')")
        s.execute("create materialized view vc as "
                  "select k, sum(v) sv, count(*) n from ctr group by k")
        s.execute("select mo_ctl('serving','result:on')")
        s.execute("select sv from vc")             # warm compile
        stop = threading.Event()
        errors, reads = [], []

        def writer(row):
            sw = pkg.session(eng)
            try:
                for _ in range(12):
                    sw.execute(f"update ctr set v = v + 1 where id = {row}")
            except Exception as e:   # noqa: BLE001 — asserted below
                errors.append(f"writer: {e!r}")
            finally:
                sw.close()

        def reader():
            sr = pkg.session(eng)
            try:
                last, n_reads = -1, 0
                while not stop.is_set():
                    rows = sr.execute("select sv, n from vc").rows()
                    if not rows:
                        continue
                    (total, n), = rows
                    if n != 2 or total < last:
                        errors.append(f"read {total, n} after {last}")
                        return
                    last, n_reads = total, n_reads + 1
                reads.append(n_reads)
            except Exception as e:   # noqa: BLE001 — asserted below
                errors.append(f"reader: {e!r}")
            finally:
                sr.close()

        writers = [threading.Thread(target=writer, args=(r,))
                   for r in (1, 2)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for th in readers + writers:
            th.start()
        for th in writers:
            th.join(60)
        stop.set()
        for th in readers:
            th.join(30)
        assert not any(th.is_alive() for th in writers + readers)
        final = s.execute("select sv, n from vc").rows()
        view = sorted(s.execute("select * from vc").rows())
        assert view == sorted(s.execute(
            "select k, sum(v), count(*) from ctr group by k").rows())
        s.execute("select mo_ctl('serving','result:off')")
        return {"errors": errors, "readers_done": len(reads),
                "final": final, "view": view}

    out = {pkg.name: drill(pkg) for pkg in packages(tmp_path)}
    assert out["jax"]["errors"] == [] and out["jax"]["final"] == [(24, 2)]
    assert out["port"] == out["jax"], out


def test_restart_rebuilds_state_and_resumes_incremental(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = _setup(pkg, fs=fs)
        s.execute("insert into t values ('a', 1, 1.00, 1.0),"
                  " ('b', 2, 2.00, 2.0)")
        s.execute(f"create materialized view lv as {VIEW_SQL}")
        s.catalog.checkpoint()
        eng2 = pkg.Engine.open(fs)
        s2 = pkg.session(eng2)
        _view_equals_recompute(pkg, s2, "lv", VIEW_SQL)
        s2.execute("insert into t values ('a', 5, 3.00, -4.0)")
        _view_equals_recompute(pkg, s2, "lv", VIEW_SQL)
        svc = eng2._mview_service
        assert svc is not None and svc.runtime("lv").watermark is not None
    run_both(scenario, tmp_path)


def test_non_maintainable_shapes_degrade_to_full_refresh(tmp_path):
    def scenario(pkg):
        s = _setup(pkg)
        s.execute("create table u (k varchar(4), w bigint)")
        s.execute("insert into t values ('a', 1, 1.00, 1.0)")
        s.execute("insert into u values ('a', 7)")
        s.execute("create materialized view fj as select t.k kk, "
                  "sum(t.v) sv from t join u on t.k = u.k group by t.k")
        s.execute("create materialized view nd as select k, count(*) n "
                  "from t where rand() >= 0 group by k")
        s.execute("create materialized view sc as select sum(v) sv from t")
        modes = {r[0]: r[1] for r in
                 s.execute("show materialized views").rows()}
        pkg.seen.append(("modes", modes))
        assert modes == {"fj": "full", "nd": "full", "sc": "full"}
        assert pkg.rows(s, "select * from fj") == [("a", 1)]
        s.execute("insert into t values ('a', 9, 2.00, 2.0)")
        assert pkg.rows(s, "select * from fj") == [("a", 1)]   # stale
        s.execute("refresh materialized view fj")
        assert pkg.rows(s, "select * from fj") == [("a", 10)]
        assert "mview=full" in s.execute("explain select * from fj").text
    run_both(scenario, tmp_path)


def test_explain_marks_incremental_and_show_watermark(tmp_path):
    def scenario(pkg):
        s = _setup(pkg)
        s.execute("insert into t values ('a', 1, 1.00, 1.0)")
        s.execute("create materialized view iv as select k, sum(v) sv "
                  "from t group by k")
        assert "mview=incremental" in \
            s.execute("explain select * from iv").text
        (name, mode, source, wm, rows, sql), = \
            s.execute("show materialized views").rows()
        pkg.seen.append(("show", (name, mode, source, rows, sql)))
        assert wm is not None and wm > 0
        s.execute("insert into t values ('b', 2, 1.00, 1.0)")
        (_n, _m, _s, wm2, rows2, _q), = \
            s.execute("show materialized views").rows()
        assert wm2 > wm and rows2 == 2
    run_both(scenario, tmp_path)


def test_view_write_protection_and_drop(tmp_path):
    def scenario(pkg):
        s = _setup(pkg)
        s.execute("insert into t values ('a', 1, 1.00, 1.0)")
        s.execute("create materialized view pv as select k, sum(v) sv "
                  "from t group by k")
        for stmt in ("insert into pv values ('x', 1)",
                     "update pv set sv = 0",
                     "delete from pv",
                     "load data infile '/nonexistent.csv' into table pv",
                     "drop table pv",
                     "create materialized view pv as select k, count(*) c"
                     " from t group by k"):
            with pytest.raises(Exception) as ei:
                s.execute(stmt)
            pkg.seen.append((stmt, (type(ei.value).__name__,
                                    str(ei.value))))
        s.execute("drop materialized view pv")
        assert pkg.rows(s, "show materialized views") == []
        s.execute("create materialized view pv as select k, count(*) c "
                  "from t group by k")
        s.execute("insert into t values ('a', 9, 1.00, 1.0)")
        assert pkg.rows(s, "select * from pv") == [("a", 2)]
        s.execute("drop materialized view if exists gone_already")
    run_both(scenario, tmp_path)


def test_serving_caches_invalidate_on_view_ddl_and_maintenance(tmp_path):
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (k varchar(4), v bigint)")
        s.execute("insert into t values ('a', 1)")
        g0 = eng.ddl_gen
        s.execute("create materialized view cv as select k, sum(v) sv "
                  "from t group by k")
        assert eng.ddl_gen > g0
        s.execute("select mo_ctl('serving','result:on')")
        q = "select sv from cv where k = 'a'"
        assert pkg.rows(s, q) == pkg.rows(s, q) == [(1,)]
        s.execute("insert into t values ('a', 41)")
        assert pkg.rows(s, q) == [(42,)]
        g1 = eng.ddl_gen
        s.execute("drop materialized view cv")
        assert eng.ddl_gen > g1
        s.execute("select mo_ctl('serving','result:off')")
    run_both(scenario, tmp_path)


def test_dense_tier_is_one_step_per_delta(tmp_path):
    """The Q1 shape: each delta is one dense-tier step through the
    fragment cache; the second delta of a shape hits the cache and is ONE
    dispatch; a new dictionary value re-keys, and the rows still match."""
    q = ("select flag, status, sum(qty), avg(qty), count(*) from li "
         "group by flag, status")

    def scenario(pkg):
        M = METRICS[pkg.name]
        s = pkg.session()
        s.execute("create table li (flag varchar(1), status varchar(1),"
                  " qty decimal(10,2))")
        s.execute("insert into li values ('A','F',1.0),('N','O',2.0)")
        s.execute("create materialized view q1 as select flag, status,"
                  " sum(qty) sq, avg(qty) aq, count(*) n from li"
                  " group by flag, status")
        d0 = M.mview_apply.get(tier="dense")
        s.execute("insert into li values ('A','F',3.0)")
        assert M.mview_apply.get(tier="dense") - d0 == 1
        disp0 = M.fusion_dispatch.get(kind="step")
        hits0 = M.fusion_compile.get(outcome="hit")
        s.execute("insert into li values ('N','F',4.0)")
        assert M.mview_apply.get(tier="dense") - d0 == 2
        assert M.fusion_compile.get(outcome="hit") > hits0
        assert M.fusion_dispatch.get(kind="step") - disp0 == 1
        assert _sorted(pkg.rows(s, "select * from q1")) == \
            _sorted(s.execute(q).rows())
        s.execute("insert into li values ('Z','Z',9.0)")
        assert _sorted(pkg.rows(s, "select * from q1")) == \
            _sorted(s.execute(q).rows())
    run_both(scenario, tmp_path)


def test_mo_ctl_mview_surface(tmp_path):
    def scenario(pkg):
        s = _setup(pkg)
        s.execute("insert into t values ('a', 1, 1.00, 1.0)")
        s.execute("create materialized view mc as select k, sum(v) sv "
                  "from t group by k")
        st = json.loads(s.execute(
            "select mo_ctl('mview','status')").rows()[0][0])
        pkg.seen.append(("status", (st["views"]["mc"]["mode"],
                                    st["n_views"], st["incremental"],
                                    st["sources"])))
        assert st["views"]["mc"]["watermark"] is not None
        assert pkg.rows(s, "select mo_ctl('mview','refresh:mc')") == \
            [("refreshed mc: 1 rows",)]
        with pytest.raises(Exception, match="unknown mview"):
            s.execute("select mo_ctl('mview','bogus')")
    run_both(scenario, tmp_path)


def test_broken_view_never_fails_unrelated_commits(tmp_path):
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        s = _setup(pkg, fs=fs)
        s.execute("insert into t values ('a', 1, 1.00, 1.0)")
        s.execute("create materialized view bv as select k, sum(v) sv "
                  "from t group by k")
        s.catalog.checkpoint()
        s2 = pkg.session(pkg.Engine.open(fs))
        s2.execute("drop table t")          # source gone, state unbuilt
        s2.execute("create table other (x bigint)")
        s2.execute("insert into other values (1)")
        s2.execute("insert into other values (2)")
        assert pkg.rows(s2, "select x from other order by x") == \
            [(1,), (2,)]
        s2.execute("drop materialized view bv")
    run_both(scenario, tmp_path)


def test_filtered_view_maintained_and_deletes_below_filter_ignored(
        tmp_path):
    def scenario(pkg):
        s = _setup(pkg)
        s.execute("create materialized view fv as select k, count(*) n,"
                  " sum(v) sv from t where v >= 10 group by k")
        s.execute("insert into t values ('a', 5, 1.00, 1.0),"
                  " ('a', 50, 1.00, 1.0), ('b', 3, 1.00, 1.0)")
        assert pkg.rows(s, "select * from fv") == [("a", 1, 50)]
        s.execute("delete from t where v = 5")
        assert pkg.rows(s, "select * from fv") == [("a", 1, 50)]
        s.execute("delete from t where v = 50")
        assert pkg.rows(s, "select * from fv") == []
    run_both(scenario, tmp_path)


def test_incremental_view_stays_incremental_across_merge(tmp_path):
    """tests/test_merge_sched.py:157 on both packages: a background merge
    of the source keeps the view exact and never re-initializes it."""
    def scenario(pkg):
        M = METRICS[pkg.name]
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table li (k varchar(4), v bigint)")
        s.execute("insert into li values ('a', 1), ('b', 2)")
        s.execute("create materialized view mv as select k, sum(v) sv, "
                  "count(*) c from li group by k")
        i0 = M.mview_apply.get(tier="init")
        s.execute("insert into li values ('a', 10)")
        sched = pkg.merge_sched.MergeScheduler(eng)
        sched.min_segments = 2
        summary = sched.run_cycle()
        assert any(m["table"] == "li" for m in summary["merged"])
        s.execute("insert into li values ('b', 20), ('c', 5)")
        s.execute("delete from li where k = 'a'")
        assert _sorted(pkg.rows(s, "select k, sv, c from mv")) == _sorted(
            s.execute("select k, sum(v), count(*) from li group by k")
            .rows())
        assert M.mview_apply.get(tier="init") == i0
    run_both(scenario, tmp_path)


def test_logtail_events_match_the_reference(tmp_path):
    """The engine's logtail funnel: every commit's events in the
    reference's order (deletes before inserts, an UPDATE as both at one
    commit ts) with the same row counts, and a WAL replay that emits
    them again."""
    def scenario(pkg):
        fs = pkg.fs.MemoryFS()
        eng = pkg.Engine(fs)
        seen = []

        def on_event(ts, table, kind, payload):
            n = payload.n_rows if kind == "insert" else len(payload)
            seen.append((ts, table, kind, int(n)))
        eng.subscribe(on_event)
        s = pkg.session(eng)
        s.execute("create table ev (id bigint primary key, v bigint)")
        s.execute("insert into ev values (1, 10), (2, 20), (3, 30)")
        s.execute("update ev set v = v + 1 where id >= 2")
        s.execute("delete from ev where id = 1")
        s.execute("begin")
        s.execute("insert into ev values (4, 40)")
        s.execute("delete from ev where id = 3")
        s.execute("commit")
        eng.unsubscribe(on_event)
        s.execute("insert into ev values (5, 50)")      # unsubscribed
        ts_order = sorted({ts for ts, *_ in seen})
        shape = [(ts_order.index(ts), t, k, n) for ts, t, k, n in seen]
        pkg.seen.append(("events", shape))
        replayed = []

        class Probe(pkg.Engine):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                self.subscribe(lambda ts, t, k, p: replayed.append(
                    (t, k, int(p.n_rows if k == "insert" else len(p)))))
        Probe.open(fs)
        pkg.seen.append(("replayed", replayed))
        assert [(t, k, n) for _i, t, k, n in shape] == replayed[:len(shape)]
    run_both(scenario, tmp_path)
