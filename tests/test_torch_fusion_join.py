"""The port's join, window and top-k fragments (vm/fusion_join.py,
vm/fusion_window.py, the fused top-k terminal of vm/fusion.py) against
its per-operator path and the JAX package's fused path, on the CPU.

The statements are tests/test_fusion_join.py's that need no plan cache,
no Grace spill (not ported: a build side past the budget raises in the
port) and no motrace; each one is held by
`torch_fusion_lockstep.lockstep` (the port's fused rows equal its unfused
rows bit for bit, equal the JAX package's fused rows exactly, floats
within rtol 1e-4 / atol 1e-3, and both packages draw the same fragment
boundaries and count the same `fusion_exec` modes).  The `fusion_env`
fixture sets MO_FUSION_MIN_ROWS=0 in both packages and restores the
fusion knobs after each test.  Cases: several probe batches, the kill
switches, empty build and probe sides, semi and anti joins, a window
fragment and framed windows as barriers, and the top-k terminal over
more than three batches.  Duplicate fan-out, a CBO-swapped semi/anti
stream and TPC-H Q3 are in tests/test_torch_fusion.py.
"""

import pytest

from matrixone_tpu_torch.vm import fusion_join as TFJ
from matrixone_tpu_torch.vm import fusion_window as TFW
from matrixone_tpu_torch.vm.compile import compile_plan, iter_ops
from torch_fusion_lockstep import (fusion_env, lockstep,  # noqa: F401
                                   probe_build_setup, run, sessions)


@pytest.fixture(scope="module")
def jsess():
    return sessions(probe_build_setup())


@pytest.fixture(scope="module")
def jsess_batched():
    """The same tables, scanned in 128-row batches (7 probe batches)."""
    return sessions(probe_build_setup() + ["set batch_rows = 128"])


JOIN_QUERIES = [
    # numeric keys with NULLs and duplicate fan-out on both sides
    "select probe.id, build.w from probe join build on probe.k = build.k"
    " order by probe.id, build.w",
    "select probe.id, build.name from probe left join build"
    " on probe.k = build.k order by probe.id, build.name",
    "select id from probe where exists"
    " (select 1 from build where build.k = probe.k) order by id",
    "select id from probe where not exists"
    " (select 1 from build where build.k = probe.k) order by id",
    # dict-string key: the probe-side translation LUT path
    "select probe.id, build.w from probe join build"
    " on probe.tag = build.name order by probe.id, build.w",
    # residual ON predicate filtering match lanes pre-null-extension
    "select probe.id, build.w from probe left join build"
    " on probe.k = build.k and build.w > 60"
    " order by probe.id, build.w",
    # the fused probe->filter->project->agg chain
    "select build.name, sum(probe.v) s, count(*) n from probe"
    " join build on probe.k = build.k where probe.d > 1.0"
    " group by build.name order by build.name",
]


@pytest.mark.parametrize("sql", JOIN_QUERIES)
def test_join_fragment_lockstep(jsess, fusion_env, sql):
    lockstep(*jsess, sql)


@pytest.mark.parametrize("sql", JOIN_QUERIES[:4] + JOIN_QUERIES[6:])
def test_join_fragment_lockstep_multi_batch(jsess_batched, fusion_env,
                                            sql):
    lockstep(*jsess_batched, sql)


def test_join_forms_probe_fragment(jsess, fusion_env):
    """The equi-join becomes a FusedJoinProbeOp carrying the grouped
    aggregate above it; the original JoinOp survives inside as the
    degradation ladder."""
    t = jsess[1]
    op = compile_plan(t.plan(JOIN_QUERIES[-1]), t._ctx())
    frags = [o for o in iter_ops(op)
             if isinstance(o, TFJ.FusedJoinProbeOp)]
    assert frags and frags[0]._agg_op is not None
    assert "join=build+probe" in frags[0].node_roles.values()


@pytest.mark.parametrize("knob", ["MO_FUSION_JOIN", "MO_FUSION_TOPK",
                                  "MO_FUSION_WINDOW"])
def test_kill_switches_bit_identical(jsess, fusion_env, knob):
    """Each kill switch, set in both packages, keeps the same rows (and
    the same boundaries: the join is a barrier again under
    MO_FUSION_JOIN=0)."""
    j, t = jsess
    sql = JOIN_QUERIES[-1]
    want, _ = run(t, sql, fused=True)
    fusion_env[knob] = "0"
    assert lockstep(j, t, sql) == want[2]
    if knob == "MO_FUSION_JOIN":
        op = compile_plan(t.plan(sql), t._ctx())
        assert not [o for o in iter_ops(op)
                    if isinstance(o, TFJ.FusedJoinProbeOp)]


@pytest.mark.parametrize("sql", [
    # empty build side (a filter no build row passes)
    "select probe.id, build.w from probe join build on probe.k = build.k"
    " and build.w > 100000 order by probe.id",
    "select probe.id, build.w from probe left join build"
    " on probe.k = build.k and build.w > 100000 order by probe.id",
    "select id from probe where not exists (select 1 from build where"
    " build.k = probe.k and build.w > 100000) order by id",
    # empty probe side
    "select probe.id, build.w from probe join build on probe.k = build.k"
    " where probe.v > 1000 order by probe.id",
    "select id from probe where v > 1000 and exists"
    " (select 1 from build where build.k = probe.k) order by id",
])
def test_empty_sides(jsess, fusion_env, sql):
    lockstep(*jsess, sql)


WINDOW_QUERIES = [
    "select id, row_number() over (partition by tag order by v, id) rn"
    " from probe order by id",
    "select id, rank() over (partition by tag order by v) rk,"
    " dense_rank() over (order by v) dr from probe order by id",
    "select id, sum(v) over (partition by tag) s,"
    " count(*) over (partition by tag) n from probe order by id",
    "select id, ntile(4) over (order by id) nt from probe order by id",
    # window output feeding a fused filter/project tail
    "select id, rk from (select id, rank() over (partition by tag"
    " order by v) rk from probe) q where rk <= 3 order by id",
]


@pytest.mark.parametrize("sql", WINDOW_QUERIES)
def test_window_fragment_lockstep(jsess, fusion_env, sql):
    lockstep(*jsess, sql)
    t = jsess[1]
    op = compile_plan(t.plan(sql), t._ctx())
    assert [o for o in iter_ops(op) if isinstance(o, TFW.FusedWindowOp)]


@pytest.mark.parametrize("sql", [
    "select id, sum(v) over (partition by tag order by id rows"
    " between 1 preceding and current row) s from probe order by id",
    "select id, lag(v) over (partition by tag order by id) l"
    " from probe order by id",
])
def test_framed_windows_stay_barriers(jsess, fusion_env, sql):
    lockstep(*jsess, sql)
    t = jsess[1]
    op = compile_plan(t.plan(sql), t._ctx())
    assert not [o for o in iter_ops(op)
                if isinstance(o, TFW.FusedWindowOp)]


TOPK_QUERIES = [
    "select v, d from probe where v is not null order by d, v limit 7",
    "select v, d from probe order by v desc, d limit 5 offset 4",
    # heavy ties: the carry's (keys, global row index) total order must
    # reproduce the host path's stable-sort tiebreak
    "select k, v from probe order by k limit 9",
    "select id, v from probe order by v desc limit 100",
]


@pytest.mark.parametrize("sql", TOPK_QUERIES)
def test_topk_terminal_lockstep(jsess, fusion_env, sql):
    lockstep(*jsess, sql)


@pytest.mark.parametrize("sql", TOPK_QUERIES)
def test_topk_terminal_multi_batch(jsess_batched, fusion_env, sql):
    lockstep(*jsess_batched, sql)
