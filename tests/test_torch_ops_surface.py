"""The port's operations surface against the JAX package's, on the CPU:
fault points, `mo_ctl`, EXPLAIN ANALYZE, KILL and SHOW PROCESSLIST.

  * faults: tests/test_chaos.py's `test_object_read_fault_fails_scan_
    cleanly` (a cold scan of a reopened object-backed table, the
    read-ahead on), the `SET fault_point`, `SET fault_point_clear` and
    `mo_ctl('fault', ...)` statements of its `test_fault_and_breaker_
    status_builtins` on a local engine and the local sites (its rig is a
    TN over RPC, which the port lacks), test_merge_sched.py's
    rewrite-fault backoff, swap fault under concurrent writers and
    `mo_ctl('merge', ...)` surface, and a `wal.append` fault that fails
    a commit cleanly;
  * EXPLAIN ANALYZE of Q3, fused: each operator's rows and batches and
    each fragment line's id, chain and mode equal the JAX session's;
  * every `mo_ctl` command this slice ports, held to the reference's
    text (or, for the JSON ones, its keys), and the commands over
    modules the port lacks raising a BindError that names ROADMAP.md.

Every scenario runs through both packages (`torch_serving_pkgs`).
"""

import json
import re
import threading
import time

import pytest

from matrixone_tpu.utils import tpch as jtpch
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql.binder import BindError
from torch_serving_pkgs import packages, run_both


@pytest.fixture(autouse=True)
def clean_faults():
    for pkg in packages():
        pkg.fault.INJECTOR.clear()
    yield
    for pkg in packages():
        pkg.fault.INJECTOR.clear()
        pkg.blockcache.CACHE.clear()


# ----------------------------------------------------------------- faults
def test_object_read_fault_fails_scan_cleanly(tmp_path, monkeypatch):
    """A storage read failure during a cold scan of object-backed
    segments surfaces as a clean error naming the site (no hang, no
    partial rows, whether the read-ahead thread or the scan read the
    block), and the same scan answers once the fault clears."""
    monkeypatch.setenv("MO_SCAN_PREFETCH", "2")

    def scenario(pkg):
        d = str(tmp_path / pkg.name)
        s = pkg.session(pkg.Engine(pkg.fs.LocalFS(d)))
        s.execute("create table orf (id bigint primary key, v bigint)")
        s.execute("insert into orf values (1, 10), (2, 20)")
        s.catalog.checkpoint()
        s2 = pkg.session(pkg.Engine.open(pkg.fs.LocalFS(d)))
        pkg.blockcache.CACHE.clear()
        pkg.fault.INJECTOR.add("object.read", "return", "fail")
        try:
            with pytest.raises(Exception) as ei:
                s2.execute("select id, v from orf order by id").rows()
            assert "object.read" in str(ei.value)
            pkg.note("error", type(ei.value).__name__)
        finally:
            pkg.fault.INJECTOR.clear()
        pkg.blockcache.CACHE.clear()
        assert pkg.rows(s2, "select id, v from orf order by id") == \
            [(1, 10), (2, 20)]
        assert threading.active_count() < 50
    run_both(scenario)


def test_fault_point_statements_and_mo_ctl_fault():
    def scenario(pkg):
        s = pkg.session()
        s.execute("set fault_point = 'commit.before:return:skip:times=1'")
        s.execute("create table probe (id bigint primary key)")
        s.execute("insert into probe values (1)")
        st = json.loads(
            s.execute("select mo_ctl('fault','status')").rows()[0][0])
        pkg.note("status", st)
        assert st["commit.before"]["times"] == 1
        assert st["commit.before"]["fired"] == 1
        s.execute("set fault_point_clear = 'commit.before'")
        assert pkg.note("cleared", json.loads(s.execute(
            "select mo_ctl('fault','status')").rows()[0][0])) == {}
        f0 = pkg.M.fault_fired.get(point="scan.before")
        pkg.rows(s, "select mo_ctl('fault','arm:scan.before:sleep:0')")
        pkg.rows(s, "select * from probe")
        pkg.rows(s, "select mo_ctl('fault','clear')")
        assert pkg.note("fired", pkg.M.fault_fired.get(
            point="scan.before") - f0) == 1
        assert "mo_fault_triggered_total" in pkg.M.REGISTRY.render()
        for bad in ("set fault_point = 'x:explode'",
                    "select mo_ctl('fault','arm:nope')",
                    "select mo_ctl('fault','bogus')"):
            with pytest.raises(Exception) as ei:
                s.execute(bad)
            pkg.note(bad, type(ei.value).__name__)
    run_both(scenario)


def test_commit_before_fault_fails_the_commit():
    def scenario(pkg):
        s = pkg.session()
        s.execute("create table cb (id bigint primary key)")
        s.execute("set fault_point = 'commit.before:return:fail:times=1'")
        f0 = pkg.M.txn_commits.get(outcome="fault")
        with pytest.raises(RuntimeError, match="injected commit failure"):
            s.execute("insert into cb values (1)")
        pkg.note("fault commits", pkg.M.txn_commits.get(outcome="fault")
                 - f0)
        s.execute("insert into cb values (2)")
        assert pkg.rows(s, "select id from cb") == [(2,)]
    run_both(scenario)


def test_wal_append_fault_fails_a_commit_cleanly():
    """A failed WAL append fails the commit before it applies: nothing
    of it is visible, and the next commit lands."""
    def scenario(pkg):
        eng = pkg.Engine(pkg.fs.MemoryFS())
        s = pkg.session(eng)
        s.execute("create table w (id bigint primary key, v bigint)")
        s.execute("insert into w values (1, 10)")
        pkg.fault.INJECTOR.add("wal.append", "return", "fail", times=1)
        with pytest.raises(IOError, match="wal.append"):
            s.execute("insert into w values (2, 20)")
        pkg.fault.INJECTOR.clear()
        assert pkg.rows(s, "select id, v from w order by id") == [(1, 10)]
        s.execute("insert into w values (3, 30)")
        assert pkg.rows(s, "select id, v from w order by id") == \
            [(1, 10), (3, 30)]
        eng2 = pkg.Engine.open(eng.fs)
        assert pkg.rows(pkg.session(eng2),
                        "select id, v from w order by id") == \
            [(1, 10), (3, 30)]
    run_both(scenario)


def test_scheduler_isolates_rewrite_fault_and_backs_off():
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        s.execute("insert into t values (1)")
        s.execute("insert into t values (2)")
        sched = pkg.merge_sched.MergeScheduler(eng)
        sched.min_segments = 2
        f0 = pkg.M.merge_tasks.get(kind="compact", outcome="failed")
        ok0 = pkg.M.merge_tasks.get(kind="compact", outcome="ok")
        pkg.fault.INJECTOR.add("merge.rewrite", "panic", times=1)
        try:
            summary = sched.run_cycle()
        finally:
            pkg.fault.INJECTOR.clear()
        assert pkg.note("failed", summary["failed"]) == [
            {"table": "t", "error": "RuntimeError: fault point "
             "'merge.rewrite' panic", "attempt": 1}]
        assert pkg.M.merge_tasks.get(kind="compact",
                                     outcome="failed") == f0 + 1
        assert sched._next_try["t"] > 0
        s.execute("insert into t values (3)")
        sched._next_try["t"] = time.monotonic() + 60
        assert "t" in sched.run_cycle()["skipped"]
        sched._next_try["t"] = 0.0
        summary = sched.run_cycle()
        assert any(m["table"] == "t" and m["kept"] == 3
                   for m in summary["merged"])
        assert pkg.M.merge_tasks.get(kind="compact",
                                     outcome="ok") == ok0 + 1
        assert "t" not in sched._fails and "t" not in sched._last_errors
        assert pkg.rows(s, "select id from t order by id") == \
            [(1,), (2,), (3,)]
    run_both(scenario)


def test_merge_swap_fault_under_concurrent_writers():
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table t (id bigint)")
        s.execute("insert into t values (-1)")
        s.execute("insert into t values (-2)")
        sched = pkg.merge_sched.MergeScheduler(eng)
        sched.min_segments = 2
        errors = []

        def writer():
            ws = pkg.session(eng)
            try:
                for i in range(30):
                    ws.execute(f"insert into t values ({i})")
                    time.sleep(0.001)
            except Exception as e:   # noqa: BLE001 — asserted below
                errors.append(e)
        f0 = pkg.M.merge_tasks.get(kind="compact", outcome="failed")
        pkg.fault.INJECTOR.add("merge.swap", "panic", times=1)
        th = threading.Thread(target=writer)
        th.start()
        try:
            merged = False
            deadline = time.monotonic() + 20
            while not merged and time.monotonic() < deadline:
                sched._next_try.pop("t", None)
                merged = bool(sched.run_cycle()["merged"])
                time.sleep(0.002)
        finally:
            th.join()
            pkg.fault.INJECTOR.clear()
        assert not errors and merged
        assert pkg.M.merge_tasks.get(kind="compact",
                                     outcome="failed") == f0 + 1
        got = sorted(r[0] for r in s.execute("select id from t").rows())
        assert pkg.note("ids", got) == sorted([-1, -2] + list(range(30)))
    run_both(scenario)


def test_mo_ctl_merge_scheduler_surface():
    def scenario(pkg):
        s = pkg.session()
        s.execute("create table t (id bigint)")
        for i in range(4):
            s.execute(f"insert into t values ({i})")
        s.execute("create snapshot pin")
        st = json.loads(s.execute(
            "select mo_ctl('merge','status')").rows()[0][0])
        assert st["running"] is False
        pkg.note("status keys", sorted(st))
        assert any(c["table"] == "t" for c in st["candidates"])
        run = json.loads(s.execute(
            "select mo_ctl('merge','run')").rows()[0][0])
        assert any(m["table"] == "t" for m in run["merged"])
        st2 = json.loads(s.execute(
            "select mo_ctl('merge','status')").rows()[0][0])
        assert st2["cycles"] >= 1 and "t" in st2["fences"]
        s.execute("drop snapshot pin")
        gc = json.loads(s.execute(
            "select mo_ctl('merge','gc')").rows()[0][0])
        assert pkg.note("released", gc["released"]) == 1
        pkg.rows(s, "select mo_ctl('merge','pause')")
        pkg.rows(s, "select mo_ctl('merge','resume')")
        pkg.rows(s, "select mo_ctl('merge')")
        pkg.rows(s, "select mo_ctl('merge', 't')")
    run_both(scenario)


# ------------------------------------------------------------ mo_ctl text
def test_mo_ctl_commands_match_reference_text():
    """Each ported command answers with the reference's text (a JSON
    answer: with its keys)."""
    def scenario(pkg):
        s = pkg.session(pkg.Engine(pkg.fs.MemoryFS()))
        s.execute("create table m (id bigint, v bigint)")
        s.execute("insert into m values (1, 2)")
        s.execute("insert into m values (3, 4)")
        for cmd in ("'checkpoint'", "'flush'", "'merge', 'm'",
                    "'merge', 'nosegs'", "'serving','clear'",
                    "'serving','plan:off'", "'serving','plan:on'",
                    "'serving','result:on'", "'serving','result:off'",
                    "'serving','slots:0'", "'serving','account_slots:0'",
                    "'fusion','clear'", "'trace','clear'",
                    "'keys','clear'", "'keys','audit:on'",
                    "'keys','audit:off'", "'fault','clear'"):
            try:
                out = s.execute(f"select mo_ctl({cmd})").rows()
            except Exception as e:   # noqa: BLE001 — the class is compared
                out = type(e).__name__
            pkg.note(cmd, out)
        for cmd in ("'serving'", "'fusion','status'", "'trace'",
                    "'keys'", "'fault'"):
            got = json.loads(s.execute(f"select mo_ctl({cmd})").rows()[0][0])
            pkg.note(cmd, sorted(got))
        assert s.execute("select mo_ctl('metrics')").rows()[0][0] \
            .startswith("# HELP")
        for bad in ("'nope'", "'serving','bogus'", "'fusion','bogus'",
                    "'metrics','bogus'", "'keys','bogus'"):
            with pytest.raises(Exception) as ei:
                s.execute(f"select mo_ctl({bad})")
            pkg.note(bad, type(ei.value).__name__)
    run_both(scenario)


@pytest.mark.parametrize("cmd", ["lint", "san", "qa", "crash", "mview",
                                 "rpc", "udf"])
def test_mo_ctl_over_modules_not_ported_names_the_roadmap(cmd):
    """A command over a module the port lacks names the ROADMAP; `mview`
    and `udf` are ported (their modules are mview/ and udf/): their
    status answers and an unknown subcommand names the known ones.
    `rpc` is ported with the fabric (cluster/): on an engine that is not
    a CN replica it answers the breakers alone, as the JAX package's
    does."""
    s = TSession(device="cpu")
    if cmd == "rpc":
        out = json.loads(s.execute("select mo_ctl('rpc')").rows()[0][0])
        assert sorted(out) == ["breakers"]
        return
    if cmd in ("mview", "udf"):
        assert isinstance(json.loads(s.execute(
            f"select mo_ctl('{cmd}')").rows()[0][0]), dict)
        with pytest.raises(BindError, match=f"unknown {cmd} subcommand"):
            s.execute(f"select mo_ctl('{cmd}','bogus')")
        return
    with pytest.raises(BindError, match=r"ROADMAP\.md, section A"):
        s.execute(f"select mo_ctl('{cmd}')")


def test_mo_ctl_elsewhere_than_the_select_list_raises():
    s = TSession(device="cpu")
    s.execute("create table x (a bigint)")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        s.execute("select a from x where mo_ctl('fusion') = 'x'")


# -------------------------------------------------- KILL and processlist
def test_processlist_kill_and_terminated_connection():
    def scenario(pkg):
        s = pkg.session()
        other = pkg.session(s.catalog)
        pl = s.execute("show processlist")
        pkg.note("columns", pl.column_names)
        ids = [r[0] for r in pl.rows()]
        assert s.conn_id in ids and other.conn_id in ids
        with pytest.raises(Exception) as ei:
            s.execute("kill query 99999")
        pkg.note("unknown", type(ei.value).__name__)
        s.execute(f"kill {other.conn_id}")
        with pytest.raises(pkg.queryservice.QueryKilled):
            other.execute("select 1")
        other.close()
        assert other.conn_id not in [r[0] for r in s.execute(
            "show processlist").rows()]
    run_both(scenario)


def test_kill_lands_between_batches():
    """A KILL QUERY flagged while a query streams its batches stops it
    at the next batch with QueryKilled; the session answers after."""
    def scenario(pkg):
        s = pkg.session()
        s.execute("create table kb (id bigint)")
        s.execute("insert into kb values " + ", ".join(
            f"({i})" for i in range(64)))
        s.variables["batch_rows"] = 8
        s.variables["plan_fusion"] = 0
        procs = s._procs
        real = procs.check_killed
        seen = []

        def check(cid):
            seen.append(cid)
            if len(seen) == 2:
                procs.kill(cid, query_only=True)
            return real(cid)
        procs.check_killed = check
        try:
            with pytest.raises(pkg.queryservice.QueryKilled):
                s.execute("select id from kb where id >= 0")
        finally:
            procs.check_killed = real
        pkg.note("batches pulled", len(seen))
        assert pkg.rows(s, "select count(*) from kb") == [(64,)]
    run_both(scenario)


def test_analyze_table_answers_and_bumps_stats_gen():
    def scenario(pkg):
        s = pkg.session()
        s.execute("create table an (id bigint, v bigint)")
        s.execute("insert into an values (1, 1), (2, 2), (3, 3)")
        g0 = getattr(s.catalog, "stats_gen", 0)
        r = s.execute("analyze table an")
        pkg.note("columns", r.column_names)
        pkg.note("rows", r.rows())
        assert s.catalog.stats_gen == g0 + 1
    run_both(scenario)


# -------------------------------------------------------- EXPLAIN ANALYZE
_OP_LINE = re.compile(r"^(\s*)(\w+)  rows=(\d+) batches=(\d+) time=")
_FRAG_LINE = re.compile(r"^(\s*)fragment (f\d+) \[([^\]]*)\] mode=(\w+)")


def _analyze_shape(text):
    out = []
    for line in text.split("\n"):
        m = _OP_LINE.match(line)
        if m:
            out.append((len(m[1]), m[2], int(m[3]), int(m[4])))
            continue
        m = _FRAG_LINE.match(line)
        assert m, line
        out.append((len(m[1]), m[2], m[3], m[4]))
    return out


def test_explain_analyze_q3_equals_reference(monkeypatch):
    """EXPLAIN ANALYZE of Q3, fused, over 4 probe batches: the same
    operators with the same rows and batches, and fragment lines naming
    the same fragments, chains and modes as the JAX session's."""
    from matrixone_tpu.frontend import Session as JSession
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    js = JSession()
    jtpch.load_lineitem(js.catalog, 4000, seed=3)
    jtpch.load_tpch_q3(js.catalog, 1000, seed=3)
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    shapes = []
    for s in (js, ts):
        s.variables["batch_rows"] = 1024
        shapes.append(_analyze_shape(
            s.execute("explain analyze " + jtpch.Q3_SQL).text))
    want, got = shapes
    assert got == want
    assert any(len(x) == 4 and x[3] == "fused" for x in got)
    assert got[0][1:] == ("TopKOp", 10, 1)
