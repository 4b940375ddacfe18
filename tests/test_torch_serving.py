"""The port's serving layer (matrixone_tpu_torch/serving) against the JAX
package's, on the CPU.

The scenarios of tests/test_serving_plan_cache.py (all but the tenant
one: accounts are not ported), test_serving_result_cache.py (all but the
privileges one), test_serving_staleness.py and test_serving_admission.py
(all but the per-account one) run through both packages on the same
statements (`torch_serving_pkgs.run_both`): the rows, the cache outcomes
and the counter deltas each step records must be equal.

Then compiled-tree reuse over TPC-H Q1, Q3, Q6 and 5c's float GROUP BY
at sf 0.01, fused (MO_FUSION_MIN_ROWS=0) and per-operator: a warm-up and
three runs with other parameter values each (a string parameter in Q3,
whose literal the fused probe bakes into its runtime key); the rows
equal a session with the plan cache off and the JAX session's, and the
three runs take the cached tree twice (`tree_hit`).
"""

import datetime
import threading
import time

import numpy as np
import pytest

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage.engine import TableMeta as JMeta
from matrixone_tpu.utils import tpch as jtpch
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.serving import serving_for as t_serving_for
from matrixone_tpu_torch.utils import metrics as TM
from torch_serving_pkgs import run_both

PT_DDL = ("create table pt (id bigint primary key, grp varchar(8),"
          " val bigint, price decimal(10,2), d date)")
PT_ROWS = ("insert into pt values"
           " (1, 'a', 10, 1.50, date '2024-01-01'),"
           " (2, 'a', 20, 2.25, date '2024-02-01'),"
           " (3, 'b', 30, 3.00, date '2024-03-01'),"
           " (4, 'b', 40, 4.75, date '2024-04-01')")


def _pt(pkg):
    s = pkg.session()
    s.execute(PT_DDL)
    s.execute(PT_ROWS)
    return s


def _hits(pkg):
    return pkg.M.plan_cache_ops.get(outcome="hit")


def _rhits(pkg):
    return pkg.M.result_cache_ops.get(outcome="hit")


# ------------------------------------------------------- normalization
NORMALIZE_CASES = [
    "select a from t where b = 5 and c = 'x' and d < 1.5",
    "select a from t where b = 7 limit 10 offset 2",
    "select date_add(d, interval 3 day) from t",
    "select * from t as of timestamp 12345",
    "select cast(v as decimal(10,2)) from t where v = 9",
    "select * from t where d >= date '2024-01-01'",
    "select now()", "select rand() * 5", "select a, uuid() from t",
    "select a from t", "SELECT v FROM pt WHERE id = 3",
    "select   v  from pt\n where id = 99",
    "select a from t where b = ? and c = 7",
    "select x from t where y = -3 and z = 'it''s'",
]


@pytest.mark.parametrize("sql", NORMALIZE_CASES)
def test_normalize_matches_reference(sql):
    """The template, the slots and the nondeterminism flag of each
    statement equal the reference's (structural literals, LIMIT and
    OFFSET, INTERVAL, AS OF, DATE and type arguments, stay literal)."""
    def scenario(pkg):
        n = pkg.plan_cache.normalize(sql)
        pkg.note(sql, (n.template, n.slots, n.nondet, n.n_stmts))
    run_both(scenario)


def test_normalize_contract():
    def scenario(pkg):
        norm = pkg.plan_cache.normalize
        n = norm("select a from t where b = 5 and c = 'x' and d < 1.5")
        assert n.template.count("?") == 3
        assert [s[1] for s in n.slots] == [5, "x", 1.5]
        n = norm("select a from t where b = 7 limit 10 offset 2")
        assert "limit 10" in n.template and "offset 2" in n.template
        assert norm("select now()").nondet
        assert norm("SELECT v FROM pt WHERE id = 3").template == \
            norm("select   v  from pt\n where id = 99").template
        n = norm("select a from t where b = ? and c = 7")
        assert [s[0] for s in n.slots] == ["c", "x"]
        assert n.full_params([42]) == [42, 7]
        with pytest.raises((IndexError, ValueError)):
            n.full_params([])
        with pytest.raises(ValueError):
            n.full_params([1, 2])
    run_both(scenario)


# ------------------------------------------------------- plan cache hits
def test_repeated_adhoc_hits_and_matches_cold():
    def scenario(pkg):
        s = _pt(pkg)
        pkg.serving.serving_for(s.catalog).plan_cache.clear()
        q = "select grp, val from pt where id = {} order by val"
        cold = {i: pkg.rows(s, q.format(i)) for i in (1, 2, 3, 4)}
        h0 = _hits(pkg)
        warm = {i: pkg.rows(s, q.format(i)) for i in (1, 2, 3, 4)}
        pkg.note("hits", _hits(pkg) - h0)
        assert warm == cold and warm[3] == [("b", 30)]
    run_both(scenario)


def test_prepared_statement_hits():
    def scenario(pkg):
        s = _pt(pkg)
        h0 = _hits(pkg)
        got = [pkg.rows(s, "select val from pt where id = ?", [k])
               for k in (2, 4, 1)]
        assert got == [[(20,)], [(40,)], [(10,)]]
        assert pkg.note("hits", _hits(pkg) - h0) >= 1
    run_both(scenario)


def test_param_values_patch_into_aggregates():
    def scenario(pkg):
        s = _pt(pkg)
        q = ("select grp, sum(val) from pt where val >= {} group by grp"
             " order by grp")
        assert pkg.rows(s, q.format(15)) == [("a", 20), ("b", 70)]
        pkg.rows(s, q.format(25))
        h0 = _hits(pkg)
        assert pkg.rows(s, q.format(35)) == [("b", 40)]
        assert pkg.note("hits", _hits(pkg) - h0) == 1
    run_both(scenario)


def test_decimal_scale_change_stays_correct():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select id from pt where price > {} order by id"
        assert pkg.rows(s, q.format("2.50")) == [(3,), (4,)]
        assert pkg.rows(s, q.format("3.5")) == [(4,)]
        assert pkg.rows(s, q.format("2.50")) == [(3,), (4,)]
    run_both(scenario)


def test_string_params():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select sum(val) from pt where grp = '{}'"
        assert pkg.rows(s, q.format("a")) == [(30,)]
        pkg.rows(s, q.format("b"))
        h0 = _hits(pkg)
        assert pkg.rows(s, q.format("b")) == [(70,)]
        assert pkg.rows(s, q.format("a")) == [(30,)]
        assert pkg.note("hits", _hits(pkg) - h0) == 2
    run_both(scenario)


# ---------------------------------------------------------- invalidation
def test_ddl_invalidates():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select val from pt where id = 1"
        pkg.rows(s, q)
        pkg.rows(s, q)
        h0 = _hits(pkg)
        pkg.rows(s, q)
        pkg.note("hits", _hits(pkg) - h0)
        inv0 = pkg.M.plan_cache_ops.get(outcome="invalidated")
        s.execute("create table other (x bigint primary key)")
        pkg.rows(s, q)
        assert pkg.note("invalidated", pkg.M.plan_cache_ops.get(
            outcome="invalidated") - inv0) >= 1
    run_both(scenario)


def test_analyze_invalidates():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select val from pt where id = 2"
        pkg.rows(s, q)
        pkg.rows(s, q)
        inv0 = pkg.M.plan_cache_ops.get(outcome="invalidated")
        pkg.rows(s, "analyze table pt")
        assert pkg.rows(s, q) == [(20,)]
        assert pkg.note("invalidated", pkg.M.plan_cache_ops.get(
            outcome="invalidated") - inv0) >= 1
    run_both(scenario)


def test_drop_and_recreate_table_reuses_nothing_stale():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select val from pt where id = 1"
        assert pkg.rows(s, q) == [(10,)]
        pkg.rows(s, q)
        s.execute("drop table pt")
        s.execute(PT_DDL)
        s.execute("insert into pt values"
                  " (1, 'z', 999, 1.00, date '2020-01-01')")
        assert pkg.rows(s, q) == [(999,)]
    run_both(scenario)


# ------------------------------------------------------------- bypasses
def test_in_txn_bypasses_plan_cache():
    def scenario(pkg):
        s = _pt(pkg)
        q = "select val from pt where id = 1"
        pkg.rows(s, q)
        h0 = _hits(pkg)
        s.execute("begin")
        try:
            assert pkg.rows(s, q) == [(10,)]
            assert pkg.note("hits", _hits(pkg) - h0) == 0
        finally:
            s.execute("rollback")
    run_both(scenario)


def test_subquery_statements_are_uncacheable():
    def scenario(pkg):
        s = _pt(pkg)
        q = ("select grp from pt where val = "
             "(select max(val) from pt) limit 1")
        r1 = pkg.rows(s, q)
        h0 = _hits(pkg)
        assert pkg.rows(s, q) == r1 == [("b",)]
        assert pkg.note("hits", _hits(pkg) - h0) == 0
    run_both(scenario)


def test_uncacheable_tombstone_expires_on_ddl():
    def scenario(pkg):
        s = _pt(pkg)
        pc = pkg.serving.serving_for(s.catalog).plan_cache
        key = ("plan", "t", "select ?", ("i",), ())
        pc.mark_uncacheable(key, ddl_gen=3, stats_gen=1)
        assert pc.lookup(key, 3, 1, [1]) == ("uncacheable", None)
        assert pc.lookup(key, 3, 1, [1]) == ("uncacheable", None)
        inv0 = pkg.M.plan_cache_ops.get(outcome="invalidated")
        assert pc.lookup(key, 4, 1, [1]) == ("miss", None)
        assert pkg.note("invalidated", pkg.M.plan_cache_ops.get(
            outcome="invalidated") - inv0) == 1
        pc.mark_uncacheable(key, ddl_gen=4, stats_gen=1)
        assert pc.lookup(key, 4, 2, [1]) == ("miss", None)
    run_both(scenario)


def test_nondeterministic_bypass():
    def scenario(pkg):
        s = _pt(pkg)
        r1 = s.execute("select now()").rows()
        time.sleep(0.01)
        r2 = s.execute("select now()").rows()
        assert r1[0][0] <= r2[0][0]
        h0 = _hits(pkg)
        s.execute("select now()")
        assert pkg.note("hits", _hits(pkg) - h0) == 0
    run_both(scenario)


def test_mo_ctl_serving_status_and_clear():
    import json

    def scenario(pkg):
        s = _pt(pkg)
        s.execute("select val from pt where id = 1")
        st = json.loads(s.execute(
            "select mo_ctl('serving','status')").rows()[0][0])
        pkg.note("sections", sorted(st))
        pkg.note("admission keys", sorted(st["admission"]))
        assert st["plan_cache"]["enabled"] is True
        s.execute("select mo_ctl('serving','clear')")
        st2 = json.loads(s.execute(
            "select mo_ctl('serving','status')").rows()[0][0])
        assert pkg.note("entries", st2["plan_cache"]["entries"]) == 0
    run_both(scenario)


def test_plan_cache_off_knob():
    def scenario(pkg):
        s = _pt(pkg)
        sv = pkg.serving.serving_for(s.catalog)
        pkg.rows(s, "select mo_ctl('serving','plan:off')")
        try:
            q = "select val from pt where id = 1"
            pkg.rows(s, q)
            h0 = _hits(pkg)
            assert pkg.rows(s, q) == [(10,)]
            assert pkg.note("hits", _hits(pkg) - h0) == 0
            assert not sv.plan_cache.enabled
        finally:
            pkg.rows(s, "select mo_ctl('serving','plan:on')")
    run_both(scenario)


# ------------------------------------------------------------ result cache
def _rc(pkg):
    s = pkg.session()
    s.execute("create table rc (id bigint primary key, v bigint,"
              " tag varchar(8))")
    s.execute("insert into rc values (1, 10, 'x'), (2, 20, 'y'),"
              " (3, 30, 'x')")
    s.execute("select mo_ctl('serving','result:on')")
    return s


def test_result_hit_serves_identical_rows():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select tag, sum(v) from rc group by tag order by tag"
        cold = pkg.rows(s, q)
        h0 = _rhits(pkg)
        assert pkg.rows(s, q) == cold == [("x", 40), ("y", 20)]
        assert pkg.note("hits", _rhits(pkg) - h0) == 1
    run_both(scenario)


def test_commit_between_identical_queries_yields_fresh_rows():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select sum(v) from rc"
        assert pkg.rows(s, q) == [(60,)]
        pkg.rows(s, q)
        s.execute("insert into rc values (4, 40, 'z')")
        assert pkg.rows(s, q) == [(100,)]
        s.execute("update rc set v = 11 where id = 1")
        assert pkg.rows(s, q) == [(101,)]
        s.execute("delete from rc where id = 4")
        assert pkg.rows(s, q) == [(61,)]
    run_both(scenario)


def test_other_table_commit_keeps_entry():
    def scenario(pkg):
        s = _rc(pkg)
        s.execute("create table unrelated (x bigint primary key)")
        q = "select sum(v) from rc"
        pkg.rows(s, q)
        pkg.rows(s, q)
        h0 = _rhits(pkg)
        s.execute("insert into unrelated values (1)")
        assert pkg.rows(s, q) == [(60,)]
        assert pkg.note("hits", _rhits(pkg) - h0) == 1
    run_both(scenario)


def test_as_of_snapshot_immutable_and_cacheable():
    def scenario(pkg):
        s = _rc(pkg)
        s.execute("create snapshot s1")
        q = "select sum(v) from rc as of snapshot 's1'"
        assert pkg.rows(s, q) == [(60,)]
        s.execute("insert into rc values (9, 900, 'w')")
        assert pkg.rows(s, q) == [(60,)]
        h0 = _rhits(pkg)
        assert pkg.rows(s, q) == [(60,)]
        assert pkg.note("hits", _rhits(pkg) - h0) == 1
        s.execute("insert into rc values (10, 1000, 'w')")
        h1 = _rhits(pkg)
        assert pkg.rows(s, q) == [(60,)]
        assert pkg.note("hits", _rhits(pkg) - h1) == 1
        assert pkg.rows(s, "select sum(v) from rc") == [(1960,)]
    run_both(scenario)


def test_future_as_of_is_not_immortal():
    def scenario(pkg):
        s = _rc(pkg)
        fut = s.catalog.committed_ts + 10 ** 15
        q = f"select sum(v) from rc as of timestamp {fut}"
        assert s.execute(q).rows() == [(60,)]
        s.execute(q)
        s.execute("insert into rc values (11, 40, 'f')")
        assert pkg.note("fresh", s.execute(q).rows()) == [(100,)]
    run_both(scenario)


def test_read_your_writes_in_txn_bypasses():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select sum(v) from rc"
        pkg.rows(s, q)
        pkg.rows(s, q)
        s.execute("begin")
        try:
            s.execute("insert into rc values (5, 500, 'q')")
            assert pkg.rows(s, q) == [(560,)]
        finally:
            s.execute("rollback")
        assert pkg.rows(s, q) == [(60,)]
    run_both(scenario)


def test_nondeterministic_never_cached():
    def scenario(pkg):
        s = _rc(pkg)
        r1 = s.execute("select rand()").rows()
        r2 = s.execute("select rand()").rows()
        assert pkg.note("differ", r1 != r2)
    run_both(scenario)


def test_params_key_entries_separately():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select v from rc where id = ?"
        assert pkg.rows(s, q, [1]) == [(10,)]
        assert pkg.rows(s, q, [2]) == [(20,)]
        h0 = _rhits(pkg)
        assert pkg.rows(s, q, [1]) == [(10,)]
        assert pkg.rows(s, q, [2]) == [(20,)]
        assert pkg.note("hits", _rhits(pkg) - h0) == 2
    run_both(scenario)


def test_equal_params_of_different_types_key_separately():
    def scenario(pkg):
        s = _rc(pkg)

        def typed(sql):
            r = s.execute(sql)
            col = next(iter(r.batch.columns.values()))
            return r.rows(), col.dtype.oid.name
        cold_i = typed("select 1 + 0")
        cold_f = typed("select 1.0 + 0")
        assert cold_i[1] != cold_f[1]
        assert typed("select 1 + 0") == cold_i
        assert typed("select 1.0 + 0") == cold_f
        pkg.note("typed", (cold_i, cold_f))
    run_both(scenario)


def test_byte_budget_lru_eviction():
    def scenario(pkg):
        s = _rc(pkg)
        sv = pkg.serving.serving_for(s.catalog)
        sv.result_cache.max_bytes = 6000
        sv.result_cache.clear()
        ev0 = pkg.M.result_cache_evictions.get()
        for i in range(1, 4):
            for _ in range(2):
                pkg.rows(s, f"select v, tag from rc where id <= {i}"
                            f" order by id")
        st = sv.result_cache.stats()
        assert st["bytes"] <= 6000 and st["entries"] <= 3
        assert pkg.M.result_cache_evictions.get() >= ev0
    run_both(scenario)


def test_shrinking_budget_evicts_immediately():
    def scenario(pkg):
        s = _rc(pkg)
        sv = pkg.serving.serving_for(s.catalog)
        for i in range(1, 4):
            pkg.rows(s, f"select v, tag from rc where id <= {i}")
        assert pkg.note("entries", sv.result_cache.stats()["entries"]) == 3
        sv.result_cache.set_max_bytes(1)
        st = sv.result_cache.stats()
        assert st["entries"] == 0 and st["bytes"] == 0
        for i in range(1, 4):
            pkg.rows(s, f"select v from rc where id = {i}")
        pkg.rows(s, "select mo_ctl('serving','result:64')")
        assert sv.result_cache.max_bytes == 64 << 20
    run_both(scenario)


def test_oversized_result_not_cached():
    def scenario(pkg):
        s = _rc(pkg)
        sv = pkg.serving.serving_for(s.catalog)
        sv.result_cache.max_bytes = 1024
        sv.result_cache.clear()
        pkg.rows(s, "select * from rc")
        pkg.rows(s, "select * from rc")
        assert pkg.note("entries", sv.result_cache.stats()["entries"]) == 0
    run_both(scenario)


def test_result_cache_off_by_default():
    def scenario(pkg):
        s = pkg.session()
        s.execute("create table d0 (x bigint primary key)")
        assert not pkg.note("enabled", pkg.serving.serving_for(
            s.catalog).result_cache.enabled)
    run_both(scenario)


def test_trace_records_cache_hit_and_queue_wait():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select sum(v) from rc"
        s.execute(q)
        s.execute(q)
        rows = s.execute(
            "select statement, cache_hit, queue_wait_ms from"
            " system_statement_info order by stmt_id").rows()
        hits = pkg.note("hits", [c for stmt, c, _ in rows if stmt == q])
        assert "result" in hits
        assert all(w is not None and w >= 0 for _, _, w in rows)
    run_both(scenario)


def test_merge_orphans_entries():
    def scenario(pkg):
        s = _rc(pkg)
        q = "select sum(v) from rc"
        s.execute("insert into rc values (7, 70, 'm')")
        pkg.rows(s, q)
        pkg.rows(s, q)
        pkg.rows(s, "select mo_ctl('merge', 'rc')")
        assert pkg.rows(s, q) == [(130,)]
    run_both(scenario)


def test_result_hit_is_a_host_copy():
    """A hit returns the host batch the first run copied off the
    executor: numpy columns a later execution of the same statement
    (whose fused graph, on the card, rewrites its outputs) cannot
    change."""
    s = TSession(device="cpu")
    s.execute("create table hc (id bigint primary key, v bigint)")
    s.execute("insert into hc values (1, 5), (2, 6)")
    s.execute("select mo_ctl('serving','result:on')")
    q = "select v from hc where id = 2"
    first = s.execute(q)
    assert isinstance(first.batch.columns["v"].data, np.ndarray)
    hit = s.execute(q)
    assert hit.batch is first.batch and hit.rows() == [(6,)]
    s.execute("select v from hc where id = 1")
    assert hit.rows() == [(6,)]


# ------------------------------------------------------------- staleness
def test_concurrent_writers_never_serve_stale_reads():
    def scenario(pkg):
        eng = pkg.Engine()
        s = pkg.session(eng)
        s.execute("create table ctr (id bigint primary key, v bigint)")
        s.execute("insert into ctr values (1, 0), (2, 0)")
        s.execute("select mo_ctl('serving','result:on')")
        s.execute("select sum(v) from ctr")
        stop = threading.Event()
        errors = []

        def writer(row):
            sw = pkg.session(eng)
            try:
                for _ in range(12):
                    sw.execute(f"update ctr set v = v + 1 where id = {row}")
            except Exception as e:       # noqa: BLE001 — asserted below
                errors.append(f"writer: {e!r}")
            finally:
                sw.close()

        def reader():
            sr = pkg.session(eng)
            try:
                last = -1
                while not stop.is_set():
                    (total,), = sr.execute("select sum(v) from ctr").rows()
                    if total < last:
                        errors.append(f"sum went back: {last} -> {total}")
                        return
                    last = total
            except Exception as e:       # noqa: BLE001
                errors.append(f"reader: {e!r}")
            finally:
                sr.close()

        writers = [threading.Thread(target=writer, args=(r,))
                   for r in (1, 2)]
        readers = [threading.Thread(target=reader) for _ in range(2)]
        for t in readers + writers:
            t.start()
        for t in writers:
            t.join(60)
        stop.set()
        for t in readers:
            t.join(30)
        assert not errors, errors
        assert pkg.rows(s, "select sum(v) from ctr") == [(24,)]
        assert pkg.rows(s, "select sum(v) from ctr") == [(24,)]
    run_both(scenario)


def test_cache_on_vs_off_lockstep_identical():
    script = [
        "select g, sum(v) from t group by g order by g",
        "insert into t values (3, 7, 'a')",
        "select g, sum(v) from t group by g order by g",
        "select g, sum(v) from t group by g order by g",
        "update t set v = v * 10 where g = 'a'",
        "select g, sum(v) from t group by g order by g",
        "delete from t where id = 2",
        "select g, sum(v) from t group by g order by g",
        "select count(*) from t",
    ]

    def scenario(pkg):
        def build(on):
            s = pkg.session()
            s.execute("create table t (id bigint primary key, v bigint,"
                      " g varchar(4))")
            s.execute("insert into t values (1, 5, 'a'), (2, 6, 'b')")
            if on:
                s.execute("select mo_ctl('serving','result:on')")
            else:
                pkg.serving.serving_for(s.catalog).result_cache.max_bytes = 0
            return s
        a, b = build(True), build(False)
        for stmt in script:
            ra = pkg.rows(a, stmt)
            assert ra == b.execute(stmt).rows(), stmt
        assert pkg.serving.serving_for(
            a.catalog).result_cache.stats()["entries"] > 0
    run_both(scenario)


# ------------------------------------------------------------- admission
_OUTCOMES = ("admitted", "shed_capacity", "shed_timeout", "shed_deadline",
             "killed")


def _adm_snapshot(pkg):
    return {(lane, oc): pkg.M.admission_total.get(lane=lane, outcome=oc)
            for lane in ("interactive", "background") for oc in _OUTCOMES}


def _adm_delta(pkg, before):
    after = _adm_snapshot(pkg)
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


def _rig(pkg):
    eng = pkg.Engine()
    s = pkg.session(eng)
    s.execute("create table a (id bigint primary key, v bigint)")
    s.execute("insert into a values (1, 1), (2, 2)")
    s.execute("select v from a where id = 1")
    sv = pkg.serving.serving_for(eng)
    sv.admission.slots = 1
    sv.admission.queue_ms = 8000
    sv.admission.bg_queue_ms = 150
    return eng, s, sv


def test_saturated_bg_sheds_interactive_completes():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        before = _adm_snapshot(pkg)
        tk = sv.admission.acquire(account="sys")
        outcomes = []

        def bg():
            sb = pkg.session(eng)
            sb.variables["query_priority"] = "background"
            try:
                sb.execute("select v from a where id = 1")
                outcomes.append("bg-ran")
            except pkg.serving.AdmissionRejected as e:
                assert getattr(e, "retryable", False)
                outcomes.append("bg-shed")
            finally:
                sb.close()

        def inter():
            si = pkg.session(eng)
            try:
                outcomes.append(("int", si.execute(
                    "select v from a where id = 2").rows()))
            finally:
                si.close()
        t1 = threading.Thread(target=bg)
        t2 = threading.Thread(target=inter)
        t1.start()
        t2.start()
        t1.join(10)
        time.sleep(0.1)
        tk.release()
        t2.join(30)
        assert "bg-shed" in outcomes and ("int", [(2,)]) in outcomes
        pkg.note("outcomes", sorted(map(str, outcomes)))
        pkg.note("delta", _adm_delta(pkg, before))
        assert sv.admission.running == 0
        assert sum(len(q) for q in sv.admission._queues.values()) == 0
    run_both(scenario)


def test_kill_removes_queued_query():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        tk = sv.admission.acquire(account="sys")
        sb = pkg.session(eng)
        out = []

        def victim():
            try:
                sb.execute("select v from a where id = 1")
                out.append("ran")
            except pkg.queryservice.QueryKilled:
                out.append("killed")
        t = threading.Thread(target=victim)
        t.start()
        time.sleep(0.3)
        pl = {p["Id"]: p["State"] for p in s._procs.processlist()}
        assert pkg.note("state", pl[sb.conn_id]) == "queued"
        s.execute(f"kill query {sb.conn_id}")
        t.join(10)
        tk.release()
        sb.close()
        assert pkg.note("out", out) == ["killed"]
    run_both(scenario)


def test_deadline_caps_queue_wait():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        tk = sv.admission.acquire(account="sys")
        sb = pkg.session(eng)
        t0 = time.monotonic()
        with pkg.deadline_scope(0.3):
            with pytest.raises(pkg.serving.AdmissionRejected):
                sb.execute("select v from a where id = 1")
        assert time.monotonic() - t0 < 5.0
        tk.release()
        sb.close()
    run_both(scenario)


def test_expired_deadline_sheds_immediately():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        before = _adm_snapshot(pkg)
        with pkg.deadline_scope(0.01):
            time.sleep(0.05)
            with pytest.raises(pkg.serving.AdmissionRejected):
                sv.admission.acquire(account="sys")
        pkg.note("delta", _adm_delta(pkg, before))
    run_both(scenario)


def test_bg_not_starved_by_quota_blocked_interactive():
    def scenario(pkg):
        adm = pkg.admission.AdmissionController(
            slots=4, queue_ms=3000, bg_queue_ms=2000, account_slots=1)
        t_a = adm.acquire(account="acct1")
        blocked = []

        def quota_blocked():
            t = adm.acquire(account="acct1")
            blocked.append("ran")
            t.release()
        th = threading.Thread(target=quota_blocked)
        th.start()
        time.sleep(0.15)
        t0 = time.monotonic()
        t_bg = adm.acquire(account="acct2", lane="background")
        assert time.monotonic() - t0 < 1.0
        t_bg.release()
        t_a.release()
        th.join(5)
        assert pkg.note("blocked", blocked) == ["ran"]
    run_both(scenario)


def test_queue_capacity_shed():
    def scenario(pkg):
        adm = pkg.admission.AdmissionController(slots=1, queue_ms=5000,
                                                max_queue=0)
        tk = adm.acquire(account="sys")
        with pytest.raises(pkg.serving.AdmissionRejected) as ei:
            adm.acquire(account="sys")
        assert "retry" in str(ei.value)
        tk.release()
    run_both(scenario)


def test_control_statements_bypass_admission():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        tk = sv.admission.acquire(account="sys")
        before = _adm_snapshot(pkg)
        s.execute("set foo = 1")
        s.execute("show tables")
        s.execute("select mo_ctl('serving','status')")
        pkg.note("delta", _adm_delta(pkg, before))
        tk.release()
    run_both(scenario)


def test_disabled_admission_is_zero_cost():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        sv.admission.slots = 0
        assert not sv.admission.enabled
        assert pkg.rows(s, "select v from a where id = 1") == [(1,)]
    run_both(scenario)


def test_disabled_acquire_release_keeps_accounting():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        sv.admission.slots = 0
        tk = sv.admission.acquire(account="sys")
        tk.release()
        assert sv.admission.running == 0
        assert sv.admission._by_account == {}
        sv.admission.slots = 1
        tk = sv.admission.acquire(account="sys")
        assert sv.admission.running == 1
        tk.release()
        assert sv.admission.running == 0
    run_both(scenario)


def test_mo_ctl_slots_knob():
    def scenario(pkg):
        eng, s, sv = _rig(pkg)
        pkg.rows(s, "select mo_ctl('serving','slots:7')")
        assert sv.admission.slots == 7
        pkg.rows(s, "select mo_ctl('serving','account_slots:3')")
        assert sv.admission.account_slots == 3
        pkg.rows(s, "select mo_ctl('serving','slots:1')")
        sv.admission.slots = 0
    run_both(scenario)


# ------------------------------------------- compiled-tree reuse, TPC-H
N_LINEITEM = 60000         # TPC-H sf 0.01
EPOCH = datetime.date(1970, 1, 1)

#: (SQL with `?` parameters, the warm-up's values, three runs' values)
TPCH_PARAM = {
    "q1": (jtpch.Q1_SQL.replace(
        "where l_shipdate", "where l_quantity >= ? and l_shipdate"),
        [1], [[3], [10], [25]]),
    "q3": (jtpch.Q3_SQL.replace("'BUILDING'", "?"),
           ["BUILDING"], [["MACHINERY"], ["AUTOMOBILE"], ["BUILDING"]]),
    "q6": (jtpch.Q6_SQL.replace("0.05 and 0.07", "? and ?")
           .replace("< 24", "< ?"),
           [0.05, 0.07, 24], [[0.02, 0.04, 30], [0.06, 0.08, 12],
                              [0.01, 0.09, 40]]),
    "group_by": ("select grp, sum(xi), sum(xn) from v where id >= ?"
                 " group by grp order by grp",
                 [0], [[100], [7000], [31000]]),
}


def _v_table(n, seed):
    rng = np.random.default_rng(seed)
    ids = np.arange(n, dtype=np.int64)
    return {"id": ids, "grp": ids % 1000,
            "xi": rng.integers(0, 16, n).astype(np.float32),
            "xn": rng.standard_normal(n).astype(np.float32)}


@pytest.fixture(scope="module")
def tpch_sessions():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_FUSION_MIN_ROWS", "0")
    js = JSession()
    js.variables["plan_fusion"] = 0
    jtpch.load_lineitem(js.catalog, N_LINEITEM, seed=3)
    jtpch.load_tpch_q3(js.catalog, N_LINEITEM // 4, seed=3)
    js.catalog.create_table(JMeta(
        "v", [("id", jdt.INT64), ("grp", jdt.INT64), ("xi", jdt.FLOAT32),
              ("xn", jdt.FLOAT32)], ["id"]))
    js.catalog.get_table("v").insert_numpy(_v_table(N_LINEITEM, 5))
    eng = convert.tables_from_numpy(convert.tables_to_numpy(js.catalog))
    yield js, eng
    mp.undo()


def _close_rows(got, want):
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not np.isclose(a, b, rtol=1e-4, atol=1e-3):
                    return False
            elif a != b:
                return False
    return True


@pytest.mark.parametrize("path", ["fused", "per_operator"])
@pytest.mark.parametrize("query", sorted(TPCH_PARAM))
def test_tree_reuse_equals_fresh_compile(tpch_sessions, query, path):
    """A cached tree, re-parameterized in place and retargeted, computes
    what a fresh compile computes, three parameter values running; the
    three runs take the tree twice."""
    js, eng = tpch_sessions
    sql, warm, runs = TPCH_PARAM[query]
    sv = t_serving_for(eng)
    sv.plan_cache.clear()
    cached = TSession(catalog=eng, device="cpu")
    cached.variables["plan_fusion"] = 1 if path == "fused" else 0
    cached.execute(sql, warm)
    t0 = TM.plan_cache_ops.get(outcome="tree_hit")
    got = [cached.execute(sql, p).rows() for p in runs]
    assert TM.plan_cache_ops.get(outcome="tree_hit") - t0 == 2
    sv.plan_cache.enabled = False
    try:
        fresh = TSession(catalog=eng, device="cpu")
        fresh.variables["plan_fusion"] = cached.variables["plan_fusion"]
        want = [fresh.execute(sql, p).rows() for p in runs]
    finally:
        sv.plan_cache.enabled = True
    assert got == want
    ref = [js.execute(sql, p).rows() for p in runs]
    for g, r in zip(got, ref):
        assert _close_rows(g, r), (g[:3], r[:3])
    assert len({str(g) for g in got}) == 3     # the values mattered


def test_graph_ownership_under_contention():
    """Sixteen threads, more than the cores, claim a fragment key's step
    graph and release it 300 times each with a tiny switch interval: no
    graph is ever held by two executions at once, an execution keeps
    the graph it holds, and a graph is made only when every one of the
    slot's graphs is held (at most 16)."""
    import sys
    from matrixone_tpu_torch.vm import graphs as G

    class FakeGraph:
        def __init__(self):
            self.owner = None
            self.holders = 0

        def release(self):
            self.owner = None

    entry = {"graphs": {}, "spares": {}}
    errors = []
    made = []

    def new_graph():
        g = FakeGraph()
        made.append(g)
        return g

    def worker():
        for _ in range(300):
            token = object()
            g = G.claim_in(entry, "step", new_graph, token)
            g.holders += 1
            if g.holders != 1 or g.owner is not token:
                errors.append("shared")
            if G.claim_in(entry, "step", new_graph, token) is not g:
                errors.append("not kept")
            g.holders -= 1
            g.release()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert 1 <= len(made) <= 16
    assert len(G.entry_graphs(entry)) == len(made)


def test_entry_graphs_while_slots_are_claimed():
    """Four threads claim both slots of fresh fragment entries (a scalar
    aggregate's `step0` and `stepN`, the second slot's first claim
    adding a key to the entry's spares) while another thread lists
    `entry_graphs` of every entry, as a capture's byte bound does, and
    yields at each step of its walk: the lister never sees an entry
    change under it, and every entry ends with its two graphs."""
    import sys
    from matrixone_tpu_torch.vm import graphs as G

    class YieldingDict(dict):
        def values(self):
            for v in super().values():
                time.sleep(1e-4)
                yield v

    class FakeGraph:
        owner = None

        def release(self):
            self.owner = None

    entries, errors = [], []
    done = threading.Event()

    def lister():
        while not done.is_set():
            try:
                for e in entries[-4:]:       # those being claimed
                    G.entry_graphs(e)
            except Exception as exc:  # noqa: BLE001 - reported below
                errors.append(repr(exc))
                return

    def claimer():
        for _ in range(200):
            e = {"graphs": {}, "spares": YieldingDict()}
            entries.append(e)
            token = object()
            for slot in ("step0", "stepN"):
                g = G.claim_in(e, slot, FakeGraph, token)
                time.sleep(1e-4)                # the step runs
                g.release()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        reader = threading.Thread(target=lister)
        reader.start()
        threads = [threading.Thread(target=claimer) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        done.set()
        reader.join(60)
    finally:
        sys.setswitchinterval(old)
    assert not reader.is_alive()
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:3]
    assert len(entries) == 800
    assert all(len(G.entry_graphs(e)) == 2 for e in entries)


def test_fragment_cache_drops_free_spares_before_entries(monkeypatch):
    """Past the byte bound, a capture first drops the spare graphs no
    execution owns (oldest entries first), and evicts whole entries only
    if that is not enough: the keys every execution needs keep their
    graphs while concurrent executions come and go."""
    from types import SimpleNamespace
    from matrixone_tpu_torch.vm import fusion as TF

    def graph(owner=None):
        return SimpleNamespace(held_bytes=100, replays=1, owner=owner,
                               active=owner is not None)
    monkeypatch.setattr(TF.FragmentCompileCache, "max_held_bytes",
                        staticmethod(lambda device: 500))
    cache = TF.FragmentCompileCache(max_entries=64)
    ev0 = TM.fusion_graphs.get(event="evict")
    a = cache.entry(("a",))
    owned = graph(owner=object())
    a["graphs"]["step"] = graph()
    a["spares"]["step"] = [graph(), owned]
    b = cache.entry(("b",))
    b["graphs"]["step"] = graph()
    b["spares"]["step"] = [graph(), graph()]
    cache.note_capture(None)
    assert cache.stats()["entries"] == 2
    assert a["spares"]["step"] == [owned]
    assert len(b["spares"]["step"]) == 2
    assert cache.stats()["held_bytes"] == 500
    assert TM.fusion_graphs.get(event="evict") - ev0 == 1
    # still over: the rest of the free spares go, then entries
    monkeypatch.setattr(TF.FragmentCompileCache, "max_held_bytes",
                        staticmethod(lambda device: 250))
    cache.note_capture(None)
    assert b["spares"]["step"] == [] and a["spares"]["step"] == [owned]
    assert cache._lru.lookup(("a",)) is not None     # pinned: owned
    assert cache.stats()["held_bytes"] == 300
