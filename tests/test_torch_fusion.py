"""The port's fused plan fragments (vm/fusion.py) against its per-operator
path and the JAX package's fused path, on the CPU.

The statements are tests/test_fusion.py's that need no plan cache, no
UDF and no `mo_ctl`; each one is held by `torch_fusion_lockstep.lockstep`
(the port's fused rows equal its unfused rows bit for bit, equal the JAX
package's fused rows exactly, floats within rtol 1e-4 / atol 1e-3, and
both packages draw the same fragment boundaries and count the same
`fusion_exec` modes).  The `fusion_env` fixture sets MO_FUSION_MIN_ROWS=0
in both packages so every batch takes the fused path, and restores the
fusion knobs after each test.  Then the cases: multi-batch carry with
LIMIT, dictionary growth into a degraded run, DDL recreate, literals that
share one cached step, the kill switch, MO_NARROW_ENCODINGS=1 against the
reference under the same flag, the key auditor armed over the script,
and three join cases (duplicate fan-out past `max_matches`, a CBO-swapped
semi/anti stream, TPC-H Q3 against its oracle; the other join, window
and top-k cases are in tests/test_torch_fusion_join.py).
"""

import datetime
import os

import numpy as np
import pytest

from matrixone_tpu_torch.utils import keys
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.vm import fusion as TF
from matrixone_tpu_torch.vm.compile import compile_plan, iter_ops
from torch_fusion_lockstep import (RTOL, ATOL, fusion_env,  # noqa: F401
                                   lockstep, probe_build_setup, run,
                                   sessions)
from torch_scripts import same_outcome


def _t_setup():
    rng = np.random.default_rng(7)
    gs = ["aa", "bb", "cc", None]
    rows = []
    for i in range(200):
        g = gs[int(rng.integers(0, 4))]
        gtxt = "null" if g is None else f"'{g}'"
        v = "null" if i % 11 == 0 else str(int(rng.integers(-5, 50)))
        d = f"{float(rng.random() * 10):.4f}"
        day = 1 + int(rng.integers(0, 27))
        q = f"{float(rng.random() * 100):.2f}"
        rows.append(f"({gtxt}, {v}, {d}, '1995-03-{day:02d}', {q})")
    return ["create table t (g varchar(4), v bigint, d double, "
            "dt date, q decimal(15,2))",
            "insert into t values " + ",".join(rows)]


@pytest.fixture(scope="module")
def tsess():
    return sessions(_t_setup())


BREADTH = [
    # the Q1 shape: pushed date filter, dense dict-key group-by,
    # decimal-exact sums, averages, count(*)
    "select g, count(*) c, sum(q) sq, avg(q) aq, sum(v) sv, avg(d) ad"
    " from t where dt <= date '1995-03-20' group by g order by g",
    # scalar aggregates incl. min/max/stddev over a filter
    "select count(*), sum(v), avg(d), min(d), max(v), stddev_samp(d),"
    " var_pop(d) from t where v > 3",
    # projection arithmetic + CASE + IS NULL
    "select v + 1 a, d * 2 - 1 b, case when v > 10 then d else -d end c,"
    " v is null nn from t where d > 1.5 order by v, d",
    # string predicates (dict LUTs baked per content)
    "select v from t where g like 'a%' and v is not null order by v",
    "select v, g from t where g in ('aa', 'cc') order by v, g",
    "select v from t where g >= 'bb' order by v",
    # string CASE group key + bool group key
    "select case when v > 10 then 'hi' else 'lo' end k, count(*) n,"
    " sum(q) sq from t group by k order by k",
    "select d > 5 k, count(*) n from t group by k order by k",
    # limit / offset streams through the fused chain
    "select v from t where d > 1 order by v, d limit 7",
    "select v from t where d > 1 order by v, d limit 5 offset 3",
    # distinct / topk tails consuming a fused stream
    "select distinct g from t where v > 0 order by g",
    "select v, d from t where v is not null order by d limit 4",
    # date function family
    "select year(dt) y, month(dt) m, count(*) n from t"
    " group by y, m order by y, m",
    # empty result + all-NULL group behavior
    "select g, sum(v) s from t where d > 99 group by g order by g",
]


@pytest.mark.parametrize("sql", BREADTH)
def test_fused_lockstep_breadth(tsess, fusion_env, sql):
    lockstep(*tsess, sql)


def test_eager_below_threshold_same_rows(tsess, fusion_env):
    """Below MO_FUSION_MIN_ROWS a fragment runs its original chain
    (mode eager), in both packages alike."""
    fusion_env["MO_FUSION_MIN_ROWS"] = "1000000000"
    for sql in BREADTH[:4]:
        lockstep(*tsess, sql)
    _, modes = run(tsess[1], BREADTH[0], fused=True)
    assert modes["eager"] > 0 and modes["fused"] == 0


def test_session_variable_disables_fusion(tsess, fusion_env):
    """`SET plan_fusion = 0` gives the per-operator tree, fusion on
    gives fragments, and EXPLAIN marks them."""
    t = tsess[1]
    sql = "select g, count(*) from t where v > 1 group by g"
    assert "fragment=f" in t.execute("explain " + sql).text
    t.execute("set plan_fusion = 0")
    try:
        op = compile_plan(t.plan(sql), t._ctx())
        assert not any(isinstance(o, TF.FusedFragmentOp)
                       for o in iter_ops(op))
        assert "fragment=" not in t.execute("explain " + sql).text
    finally:
        t.execute("set plan_fusion = 1")
    op = compile_plan(t.plan(sql), t._ctx())
    assert any(isinstance(o, TF.FusedFragmentOp) for o in iter_ops(op))


def test_fusion_is_the_default(tsess):
    """With no knob set the fusion pass runs (MO_PLAN_FUSION defaults
    to on, as the reference's does)."""
    saved = os.environ.pop("MO_PLAN_FUSION", None)
    try:
        t = tsess[1]
        op = compile_plan(t.plan(BREADTH[0]), t._ctx())
        assert any(isinstance(o, TF.FusedFragmentOp) for o in iter_ops(op))
    finally:
        if saved is not None:
            os.environ["MO_PLAN_FUSION"] = saved


def test_multi_batch_carry_and_limit(fusion_env):
    """Five scan chunks through one fragment: the aggregate and top-k
    carries fold across batches (the tail chunk bucketed differently),
    and a fused LIMIT stops pulling once satisfied."""
    rng = np.random.default_rng(3)
    vals = ",".join(
        f"('{'ab'[int(rng.integers(0, 2))]}', {int(rng.integers(0, 99))},"
        f" {float(rng.random()):.5f})" for _ in range(5000))
    j, t = sessions(["create table mb (g varchar(2), v bigint, d double)",
                     "insert into mb values " + vals,
                     "set batch_rows = 1024"])
    for sql in (
            "select g, count(*) c, sum(v) sv, avg(d) ad from mb"
            " where d > 0.25 group by g order by g",
            "select sum(v) s, min(d) mn, max(d) mx from mb where v > 10",
            "select v from mb where d > 0.5 order by v, d limit 9",
            "select v, d from mb order by d desc limit 6",
            "select v from mb limit 3 offset 2"):
        lockstep(j, t, sql)


def test_union_dict_growth_degrades(fusion_env):
    """A group-key dictionary growing mid-stream (union arms with other
    string sets) degrades the fused aggregate to the general path with
    the partials folded in, in both packages alike."""
    j, t = sessions([
        "create table u1 (g varchar(4), v bigint)",
        "create table u2 (g varchar(4), v bigint)",
        "insert into u1 values ('aa',1),('bb',2),('aa',3)",
        "insert into u2 values ('cc',10),('dd',20),('aa',30)"])
    sql = ("select g, sum(v) s, count(*) n from "
           "(select g, v from u1 union all select g, v from u2) q "
           "group by g order by g")
    lockstep(j, t, sql)
    _, modes = run(t, sql, fused=True)
    assert modes["degraded"] == 1


def test_dict_growth_invalidates_lut(fusion_env):
    """New strings entering a scanned dictionary key a new step: the
    baked LIKE LUT is never served stale."""
    j, t = sessions(_t_setup())
    sql = "select count(*) from t where g like 'z%'"
    assert lockstep(j, t, sql) == [(0,)]
    for s in (j, t):
        s.execute("insert into t values ('zz', 1, 1.0, '1995-03-01', 1.0)")
    assert lockstep(j, t, sql) == [(1,)]


def test_ddl_recreate_rekeys(fusion_env):
    """DROP + recreate with another column type keys a new step."""
    j, t = sessions(["create table inv (a bigint, b bigint)",
                     "insert into inv values (1, 10), (2, 20)"])
    q = "select sum(b) s from inv where a > 0"
    assert lockstep(j, t, q) == [(30,)]
    m0 = TM.fusion_compile.get(outcome="miss")
    for s in (j, t):
        s.execute("drop table inv")
        s.execute("create table inv (a bigint, b double)")
        s.execute("insert into inv values (1, 1.5), (2, 2.25)")
    assert lockstep(j, t, q) == [(3.75,)]
    assert TM.fusion_compile.get(outcome="miss") > m0


def test_literal_values_share_one_step(tsess, fusion_env):
    """Lifted literals: statements that differ only in literal values
    reuse one cached step (one graph on the card)."""
    j, t = tsess
    first = "select sum(v) s, count(*) c from t where v > 1 and d > 0.5"
    lockstep(j, t, first)
    m0 = TM.fusion_compile.get(outcome="miss")
    for hi in (5, 9, 1):
        lockstep(j, t, f"select sum(v) s, count(*) c from t where v > "
                       f"{hi} and d > 0.5")
    assert TM.fusion_compile.get(outcome="miss") == m0


def test_untraceable_agg_arg_is_barrier(fusion_env):
    """A host-LUT aggregate argument (a string function) keeps the
    grouped aggregate on the per-operator path, so a grown dictionary
    behind the LUT is never served stale."""
    j, t = sessions([
        "create table sl (k varchar(2), s varchar(16))",
        "insert into sl values ('a','xy'),('a','pqr'),('b','z')"])
    q = "select k, sum(length(s)) n from sl group by k order by k"
    assert lockstep(j, t, q) == [("a", 5), ("b", 1)]
    for s in (j, t):
        s.execute("insert into sl values ('b','longerstring')")
    assert lockstep(j, t, q) == [("a", 5), ("b", 13)]
    op = compile_plan(t.plan(q), t._ctx())
    assert any(type(o).__name__ == "AggOp" for o in iter_ops(op))


def test_plan_fusion_kill_switch_bit_identical(tsess, fusion_env):
    """MO_PLAN_FUSION=0 in both packages: the per-operator rows, equal
    to the fused ones."""
    j, t = tsess
    for sql in BREADTH[:3]:
        want, _ = run(t, sql, fused=True)
        got, modes = run(t, sql, fused=False)
        assert got == want and sum(modes.values()) == 0


def test_narrow_encodings_against_reference(tsess, fusion_env):
    """MO_NARROW_ENCODINGS=1: FLOAT32 aggregate lanes round to bf16 in
    the fused grouped terminal of both packages; the port's rows equal
    the reference's under the same flag (float columns within the
    stated tolerance)."""
    fusion_env["MO_NARROW_ENCODINGS"] = "1"
    j, t = sessions([
        "create table nf (g varchar(2), x float, y double)",
        "insert into nf values " + ",".join(
            f"('{'abc'[i % 3]}', {i * 0.37:.3f}, {i * 0.11:.3f})"
            for i in range(300))])
    sql = ("select g, sum(x) sx, avg(x) ax, sum(y) sy, count(*) n from nf"
           " group by g order by g")
    t1, _ = run(t, sql, fused=True)
    j1, _ = run(j, sql, fused=True)
    assert same_outcome(t1, j1, RTOL, ATOL), (t1, j1)
    # the lanes really narrowed: the f32 sums differ from the unfused
    t0, _ = run(t, sql, fused=False)
    assert [r[1] for r in t1[2]] != [r[1] for r in t0[2]]
    assert [r[3] for r in t1[2]] == [r[3] for r in t0[2]]


def test_profile_times_each_step(tsess, fusion_env):
    """MO_FUSION_PROFILE=1 adds each step's seconds to
    fusion_step_seconds (the reference's diagnostic counter)."""
    fusion_env["MO_FUSION_PROFILE"] = "1"
    s0 = TM.fusion_step_seconds.get(kind="device")
    d0 = TM.fusion_dispatch.get(kind="step")
    run(tsess[1], BREADTH[0], fused=True)
    assert TM.fusion_step_seconds.get(kind="device") > s0
    assert TM.fusion_dispatch.get(kind="step") > d0


def test_key_auditor_finds_nothing(tsess, fusion_env):
    """The capture/key auditor armed over the lockstep script (with a
    shape-preserving dictionary rotation) reports no finding."""
    j, t = tsess
    keys.clear()
    with keys.armed_scope():
        for sql in BREADTH:
            run(t, sql, fused=True)
            run(t, sql, fused=True)
        _, t2 = sessions(_t_setup())
        t2.execute("delete from t where g = 'aa'")
        t2.execute("insert into t values ('ab', 1, 1.0, '1995-03-01', 1.0)")
        for sql in BREADTH[3:6]:
            run(t2, sql, fused=True)
    rep = keys.report()
    assert rep["findings"] == 0, rep["findings_list"]
    assert "vm/fusion.py:fragment" in rep["sites"]
    assert TM.key_audits.get(outcome="ok") > 0


def test_duplicate_fanout_doubles_lanes(fusion_env):
    """Past max_matches duplicates the fused probe re-runs the same batch
    with doubled lanes: the same rows, also with a grouped carry above
    the join (its carry must not take the overflowed batch's partials)."""
    j, t = sessions(probe_build_setup() + [
        "create table dup (k bigint, x bigint)",
        "insert into dup values " + ",".join(
            f"({i % 3},{i})" for i in range(60))])
    lockstep(j, t, "select probe.id, dup.x from probe join dup"
                   " on probe.k = dup.k order by probe.id, dup.x")
    lockstep(j, t, "select probe.tag, sum(dup.x) s, count(*) n from probe"
                   " join dup on probe.k = dup.k group by probe.tag"
                   " order by probe.tag")


def test_semi_anti_over_swapped_join_stream(fusion_env):
    """A CBO side swap makes the join node's declared schema order differ
    from the probe chain's physical column order; the fused semi/anti
    stream must map columns by the chain's order."""
    j, t = sessions(probe_build_setup() + [
        "create table nat (nk bigint, nname varchar(12))",
        "insert into nat values (1,'alpha'),(2,'beta')"])
    sql = ("select count(*) c from build, probe, nat"
           " where build.k = probe.k and build.w % 2 = nk"
           " and nname = 'alpha'"
           " and exists (select 1 from probe p2 where p2.k = probe.k"
           "             and p2.id <> probe.id)"
           " and not exists (select 1 from probe p3 where"
           "             p3.k = probe.k and p3.v > probe.v)")
    lockstep(j, t, sql)


def test_q3_shape_against_oracle(fusion_env):
    """A TPC-H Q3 (join + grouped aggregate + top-k) over three probe
    batches: the fused rows equal the unfused ones, the JAX package's and
    the integer-domain oracle, and no step falls off the fused path."""
    from matrixone_tpu.utils import tpch as JT
    from matrixone_tpu_torch import convert
    from matrixone_tpu_torch.frontend import Session as TSession
    from matrixone_tpu_torch.utils import tpch as TT
    j, _ = sessions(["set batch_rows = 8192"])
    arrays = JT.load_lineitem(j.catalog, 20_000, seed=2)
    q3data = JT.load_tpch_q3(j.catalog, 4_000, seed=2)
    t = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(j.catalog)), device="cpu")
    t.execute("set batch_rows = 8192")
    e0 = TM.fusion_dispatch.get(kind="eager")
    got = lockstep(j, t, TT.Q3_SQL)
    assert TM.fusion_dispatch.get(kind="eager") == e0
    exp = JT.q3_oracle(arrays, q3data)
    assert len(got) == len(exp) > 0
    epoch = datetime.date(1970, 1, 1)
    for g, e in zip(got, exp):
        assert g[0] == e[0]
        assert round(g[1] * 10000) == e[1]
        assert (g[2] - epoch).days == e[2]


def test_step_graph_copies_a_rewritten_output_again():
    """A graph's replay rewrites its outputs in place without bumping
    their `_version`.  An input fed back from one (the LIMIT counters)
    is copied in at every call; only an input the caller names stable
    (a probe's build side) is skipped while it is the same tensor,
    unchanged, and copied again once it changes."""
    import torch
    from torch.utils._pytree import tree_flatten
    from matrixone_tpu_torch.vm.graphs import StepGraph
    seen = torch.tensor(3, dtype=torch.int64)
    build = torch.arange(4)
    g = StepGraph(lambda s, b: (s, b), stable=(1,))
    flat, spec = tree_flatten((seen, build))
    static = [torch.zeros((), dtype=torch.int64),
              torch.zeros(4, dtype=torch.int64)]
    g._bind(flat, spec, static)
    g._load(flat)
    assert int(static[0]) == 3 and static[1].tolist() == [0, 1, 2, 3]
    # a replay's write: same tensor, same version, a new value
    v_seen, v_build = seen._version, build._version
    seen.data.fill_(9)
    build.data.fill_(5)
    assert (seen._version, build._version) == (v_seen, v_build)
    g._load(flat)
    assert int(static[0]) == 9
    assert static[1].tolist() == [0, 1, 2, 3]
    # an in-place write that bumps the version is copied again
    build.add_(1)
    g._load(flat)
    assert static[1].tolist() == [6, 6, 6, 6]
    g.release()
    build.data.fill_(2)
    g._load(flat)
    assert static[1].tolist() == [2, 2, 2, 2]


def test_fragment_cache_bounds_its_graphs_pools(monkeypatch):
    """Past the byte bound on what cached graphs hold (250 bytes here),
    a capture evicts the least recently used entries, never the newest
    nor one an execution still runs, and counts their graphs as
    evicted."""
    from types import SimpleNamespace
    monkeypatch.setattr(TF.FragmentCompileCache, "max_held_bytes",
                        staticmethod(lambda device: 250))
    cache = TF.FragmentCompileCache(max_entries=64)
    ev0 = TM.fusion_graphs.get(event="evict")
    for i in range(5):
        e = cache.entry(("k", i))
        e["graphs"]["step"] = SimpleNamespace(held_bytes=100, replays=1,
                                              active=False)
        if i == 3:
            cache.entry(("k", 1))            # refreshed: now newer than 2
        cache.note_capture(None)
    st = cache.stats()
    assert st["entries"] == 2 and st["held_bytes"] == 200
    assert TM.fusion_graphs.get(event="evict") - ev0 == 3
    assert cache._lru.lookup(("k", 4)) is not None
    assert cache._lru.lookup(("k", 1)) is not None
    # an entry an execution still runs stays, and so does the newest
    cache._lru.lookup(("k", 1))["graphs"]["step"].active = True
    e = cache.entry(("big",))
    e["graphs"]["step"] = SimpleNamespace(held_bytes=400, replays=1,
                                          active=False)
    cache.note_capture(None)
    assert cache._lru.lookup(("k", 4)) is None
    assert cache.stats()["entries"] == 2
