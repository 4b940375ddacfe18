"""The port's Grace spills against the JAX package's, on the CPU.

The scenarios of tests/test_join_spill.py (inner, left, semi, anti and
an aggregate over a join with `join_build_budget` 64, the duplicate
fan-out re-run inside a partition, TPC-H Q3 with a forced spill) and of
tests/test_spill.py (a GROUP BY past `max_device_groups`, with AVG and
NULLs) run through the JAX session and the port's
`Session(device="cpu")`, each on its own engine.  Both spill: the JAX
package's `mo_join_spill_total` and the port's counter of the same name
move.  A spilled join routes each row to the reference's partition (the
unsigned remainder of the same 64-bit key hash), so a join without
ORDER BY gives the reference's rows in the reference's order; spilled
GROUP BYs stream out partition by partition, in the reference's order
too.  Every value here is an integer, a string or an average of
integers: all are compared exactly.
"""

import numpy as np
import pytest

from matrixone_tpu.utils import metrics as JM
from matrixone_tpu.utils import tpch_full as JT
from matrixone_tpu.vm import operators as JO
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.utils import tpch_full as TT
from matrixone_tpu_torch.vm import join as TJ
from matrixone_tpu_torch.vm import operators as TO
from torch_compare import reference_env, run_step, session  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_env")


def _rig_statements():
    """tests/test_join_spill.py's tables: duplicates on k, NULL keys and
    strings on both sides."""
    rows = []
    for i in range(3000):
        k = "NULL" if i % 11 == 7 else str(i % 40)
        rows.append(f"({i},{k},'t{i % 5}',{i % 100})")
    drows = []
    for i in range(600):
        k = "NULL" if i % 13 == 5 else str(i % 55)
        drows.append(f"({k},'n{i % 7}',{i})")
    return ["create table f (id bigint primary key, k bigint,"
            " tag varchar(8), v bigint)",
            f"insert into f values {', '.join(rows)}",
            "create table d (k bigint, name varchar(8), w bigint)",
            f"insert into d values {', '.join(drows)}"]


@pytest.fixture(scope="module")
def rig(reference_env):  # noqa: F811
    sessions = {pkg: session(pkg) for pkg in ("jax", "port")}
    for st in _rig_statements():
        for s in sessions.values():
            s.execute(st)
    return sessions


QUERIES = [
    ("inner", "select f.id, d.w from f join d on f.k = d.k"
              " order by f.id, d.w"),
    ("left", "select f.id, d.name from f left join d on f.k = d.k"
             " order by f.id, d.name"),
    ("semi", "select f.id from f where exists"
             " (select 1 from d where d.k = f.k) order by f.id"),
    ("anti", "select f.id from f where not exists"
             " (select 1 from d where d.k = f.k) order by f.id"),
    ("agg-over-join", "select d.name, sum(f.v), count(*) from f"
                      " join d on f.k = d.k group by d.name"
                      " order by d.name"),
    # no ORDER BY: the partitions' order is the reference's
    ("inner-unordered", "select f.id, d.w, d.name from f join d"
                        " on f.k = d.k"),
    ("left-unordered", "select f.id, f.tag, d.w from f left join d"
                       " on f.k = d.k"),
    ("varchar-key", "select f.id, d.w from f join d on f.tag = d.name"),
]


def _spilled(sess, sql, budget):
    sess.variables["join_build_budget"] = budget
    try:
        return run_step(sess, sql)
    finally:
        sess.variables.pop("join_build_budget", None)


@pytest.mark.parametrize("kind,sql", QUERIES, ids=[k for k, _ in QUERIES])
def test_spilled_join_equals_the_reference(rig, kind, sql):
    """Spilled rows equal the JAX session's spilled rows and the port's
    unspilled rows; both packages' spill counters move."""
    j0, t0 = JM.join_spills.get(), TM.join_spills.get()
    want = _spilled(rig["jax"], sql, 64)
    got = _spilled(rig["port"], sql, 64)
    assert JM.join_spills.get() > j0, "the reference never spilled"
    assert TM.join_spills.get() > t0, "the port never spilled"
    assert got[0] == "ok", got
    assert got == want
    unspilled = run_step(rig["port"], sql)
    if "order by" in sql:
        assert got == unspilled
    else:
        assert sorted(got[2]) == sorted(unspilled[2])


def test_spill_survives_overflow_rerun(rig):
    """Duplicate fan-out overflow (max_matches doubling) inside a
    spilled partition still re-runs correctly."""
    sql = ("select f.k, count(*) from f join d on f.k = d.k"
           " group by f.k order by f.k")
    t0 = TM.join_spills.get()
    got = _spilled(rig["port"], sql, 16)
    assert TM.join_spills.get() > t0
    assert got == _spilled(rig["jax"], sql, 16)
    assert got == run_step(rig["port"], sql)


def test_spill_writes_and_cleans_up_its_chunks(rig, monkeypatch, tmp_path):
    """A spill writes its partitions as .npz chunks in a temporary
    directory, counts their bytes, and removes the directory when the
    join is done."""
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    b0 = TM.spill_bytes.get(kind="join")
    p0 = TM.spill_partitions.get(kind="join")
    got = _spilled(rig["port"], QUERIES[0][1], 64)
    assert got[0] == "ok"
    assert TM.spill_bytes.get(kind="join") > b0
    assert TM.spill_partitions.get(kind="join") - p0 >= 16
    assert list(tmp_path.iterdir()) == []


def test_partition_is_the_unsigned_remainder():
    """unsigned_mod reads the int64 bit patterns as uint64, as the
    reference's `h % uint64(P)` does, at the join's partition count."""
    import torch
    p = TJ.JoinOp.SPILL_PARTITIONS
    rng = np.random.default_rng(p)
    h = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max,
                     5000, dtype=np.int64)
    h[:4] = [-1, np.iinfo(np.int64).min, 0, np.iinfo(np.int64).max]
    want = (h.view(np.uint64) % np.uint64(p)).astype(np.int64)
    got = TJ.unsigned_mod(torch.from_numpy(h), p).numpy()
    assert np.array_equal(got, want)


def test_tpch_q3_with_forced_spill(reference_env):  # noqa: F811
    """Q3 with a 128-row build budget: the port spills, and its rows
    equal sqlite3's and the JAX session's (spilled too)."""
    jsess = session("jax")
    tables = JT.load_tpch(jsess.catalog, sf=0.004, seed=1)
    port = session("port", catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(jsess.catalog)))
    conn = TT.to_sqlite(tables)
    sql = TT.QUERIES[3]
    before = TM.join_spills.get()
    want = _spilled(jsess, sql, 128)
    port.variables["join_build_budget"] = 128
    try:
        TT.run_compare(port, conn, 3)
        got = run_step(port, sql)
    finally:
        port.variables.pop("join_build_budget", None)
        conn.close()
    assert TM.join_spills.get() > before, "Q3 never spilled a join"
    assert got[0] == want[0] == "ok"
    assert TT.normalize_rows(got[2]) == TT.normalize_rows(want[2])


# ------------------------------------------------------- group-by spill

def _fill_statements(n, n_groups, seed=7):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, n_groups, n)
    keys[:n_groups] = np.arange(n_groups)
    vals = rng.integers(0, 1000, n)
    rows = ",".join(f"({k},{v})" for k, v in zip(keys, vals))
    return ["create table big (k bigint, v bigint)",
            f"insert into big values {rows}"], keys, vals


def _tiny(monkeypatch, max_groups, max_device_groups, parts):
    """Wrap both packages' AggOp.__init__ to a tiny device budget, as
    tests/test_spill.py does."""
    for mod in (JO, TO):
        orig = mod.AggOp.__init__

        def tiny(self, node, child, _orig=orig, **kw):
            kw["max_groups"] = max_groups
            kw["max_device_groups"] = max_device_groups
            kw["spill_partitions"] = parts
            _orig(self, node, child, **kw)
        monkeypatch.setattr(mod.AggOp, "__init__", tiny)


@pytest.mark.parametrize("sql", [
    "select k, count(*), sum(v), min(v), max(v) from big group by k",
    "select k, count(*), sum(v), min(v), max(v) from big group by k"
    " order by k",
], ids=["unordered", "ordered"])
def test_grace_spill_group_by_equals_the_reference(monkeypatch, sql):
    """6000 groups through a 1024-group device budget in 8 partitions:
    rows equal the JAX session's, in its order, and the oracle's."""
    _tiny(monkeypatch, 256, 1024, 8)
    steps, keys, vals = _fill_statements(20_000, 6_000)
    outs = []
    a0 = TM.agg_spills.get()
    for pkg in ("jax", "port"):
        s = session(pkg)
        for st in steps:
            s.execute(st)
        outs.append(run_step(s, sql))
    want, got = outs
    assert TM.agg_spills.get() > a0, "the port never spilled"
    assert got[0] == "ok"
    assert got == want
    oracle = {}
    for k, v in zip(keys.tolist(), vals.tolist()):
        c, sm, mn, mx = oracle.get(k, (0, 0, None, None))
        oracle[k] = (c + 1, sm + v, v if mn is None else min(mn, v),
                     v if mx is None else max(mx, v))
    assert len(got[2]) == len(oracle)
    for k, c, sm, mn, mx in got[2]:
        assert (c, sm, mn, mx) == oracle[k]


def test_spill_with_avg_and_nulls(monkeypatch):
    """A spilled GROUP BY with AVG, COUNT(v) over NULLs and COUNT(*)."""
    _tiny(monkeypatch, 64, 256, 4)
    rows = []
    for k in range(500):
        rows.append(f"({k}, {k * 3})")
        rows.append(f"({k}, null)")
    steps = ["create table bn (k int, v int)",
             "insert into bn values " + ",".join(rows)]
    sql = ("select k, avg(v), count(v), count(*) from bn group by k "
           "order by k")
    outs = []
    for pkg in ("jax", "port"):
        s = session(pkg)
        for st in steps:
            s.execute(st)
        outs.append(run_step(s, sql))
    want, got = outs
    assert got == want
    assert len(got[2]) == 500
    for k, av, cv, cs in got[2]:
        assert (float(av), cv, cs) == (float(k * 3), 1, 2)


def test_group_by_past_the_budget_of_one_partition_raises(monkeypatch):
    """Past the device budget even within one spill partition, both
    packages raise the same error class."""
    _tiny(monkeypatch, 16, 16, 2)
    steps, _k, _v = _fill_statements(400, 200)
    sql = "select k, count(*) from big group by k"
    outs = []
    for pkg in ("jax", "port"):
        s = session(pkg)
        for st in steps:
            s.execute(st)
        outs.append(run_step(s, sql))
    assert outs[0][0] == "err"
    assert outs[1] == outs[0]


def test_fused_join_hands_its_spill_to_the_join_op():
    """With fusion on (every batch fused), an over-budget build leaves
    the fused join for the original JoinOp, which spills: the rows equal
    the per-operator path's and the JAX session's spilled rows."""
    import os
    saved = {k: os.environ.get(k) for k in ("MO_PLAN_FUSION",
                                            "MO_FUSION_MIN_ROWS")}
    os.environ.pop("MO_PLAN_FUSION", None)
    os.environ["MO_FUSION_MIN_ROWS"] = "0"
    try:
        port = session("port")
        for st in _rig_statements():
            port.execute(st)
        sql = ("select d.name, sum(f.v), count(*) from f join d"
               " on f.k = d.k group by d.name order by d.name")
        fb0 = TM.fusion_exec.get(mode="fallback")
        t0 = TM.join_spills.get()
        got = _spilled(port, sql, 64)
        assert TM.join_spills.get() > t0
        assert TM.fusion_exec.get(mode="fallback") > fb0
        port.execute("set plan_fusion = 0")
        assert got == _spilled(port, sql, 64)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    jax = session("jax")
    for st in _rig_statements():
        jax.execute(st)
    assert got == _spilled(jax, sql, 64)
