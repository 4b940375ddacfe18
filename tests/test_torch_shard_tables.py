"""The port's device-shard SQL executor over tables made by hand, on the
CPU, against its own local path and the JAX package's sharded path.

The counterparts of tests/test_shard_exec.py's tests over small tables
(the rest, over the TPC-H corpus, are in tests/test_torch_shard_exec.py;
the rig both share is tests/torch_shard_rig.py).  The JAX session runs
over its conftest's 8 virtual CPU devices, the port under
`simulated_slots(8)`, each given the same DDL and inserts:

  * the general merge at 8 shards counted once and by kind, the dense
    psum merge;
  * an open transaction, a ShardDegrade inside a shard: local rows, no
    merge; a card fault inside a shard surfaces instead of degrading;
  * `PARTITION BY HASH(col) SHARDS n` read co-partitioned (0 rows
    shuffled), the GROUP BY over an unpartitioned table, a shuffle join
    (the rows moved are the reference's), and the merge site audited by
    the key auditor.

Rows equal the JAX package's sharded rows: exactly for integers, within
rtol 1e-4 / atol 1e-3 for floats.
"""

import numpy as np
import pytest

from matrixone_tpu.utils import metrics as JM
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.parallel import dist_query as DQ
from matrixone_tpu_torch.utils import metrics as M
from torch_shard_rig import (  # noqa: F401  (fixtures)
    assert_rows_close as _assert_rows_close, both as _both,
    merged_statements as _merged_statements, merges as _merges,
    one_torch_thread, sharded as _sharded, slots)


@pytest.fixture(scope="module")
def multi(slots):
    """A table whose rows arrived in 8 inserts: 8 segments, so the chunk
    round robin spreads them over the shards.  (JAX session, port
    session.)"""
    return _both(
        "create table mb (id bigint primary key, g bigint,"
        " f varchar(4), v bigint, d double)",
        *("insert into mb values " + ",".join(
            f"({i},{i % 9},'f{i % 3}',{i % 50},{(i % 13) * 0.25})"
            for i in range(lo, lo + 400)) for lo in range(0, 3200, 400)))


def test_general_merge_once_by_kind(multi):
    js, s = multi
    sql = ("select g, count(*), sum(v), avg(v) from mb"
           " group by g order by g")
    local = s.execute(sql).rows()
    g0 = M.exchange_partial_merge.get(kind="general")
    before = _merges()
    got = _sharded(s, 8, sql)
    assert got == local
    assert _merges() - before == 1
    assert M.exchange_partial_merge.get(kind="general") == g0 + 1
    _assert_rows_close(got, _sharded(js, 8, sql), exact_cols={0, 1, 2})


def test_dense_merge_psum(multi):
    """Dict-coded group keys take the dense path in each shard (the
    fused dense terminal's carry) and merge with one psum."""
    js, s = multi
    sql = ("select f, count(*), sum(v), avg(d) from mb"
           " group by f order by f")
    local = s.execute(sql).rows()
    d0 = M.exchange_partial_merge.get(kind="dense")
    before = _merges()
    got = _sharded(s, 4, sql)
    assert [r[:3] for r in got] == [r[:3] for r in local]
    np.testing.assert_allclose([r[3] for r in got], [r[3] for r in local],
                               rtol=0, atol=1e-9)
    assert M.exchange_partial_merge.get(kind="dense") == d0 + 1
    assert _merges() - before == 1
    _assert_rows_close(got, _sharded(js, 4, sql), exact_cols={0, 1, 2})



# ------------------------------------------------------- degrade ladder

def test_degrade_open_txn(slots):
    s = TSession(device="cpu")
    s.execute("create table tx (a bigint primary key, b bigint)")
    s.execute("insert into tx values " +
              ",".join(f"({i},{i % 3})" for i in range(100)))
    s.execute("set query_shards = 4")
    s.execute("set dist_min_rows = 0")
    before = _merged_statements()
    s.execute("begin")
    try:
        got = s.execute("select b, count(*) from tx group by b"
                        " order by b").rows()
    finally:
        s.execute("commit")
    assert [r[1] for r in got] == [34, 33, 33]
    assert _merged_statements() == before
    # outside the transaction the same statement shards
    assert s.execute("select b, count(*) from tx group by b"
                     " order by b").rows() == got
    assert _merged_statements() == before + 1


def test_shard_degrade_runs_local(multi, monkeypatch):
    """A ShardDegrade inside a shard (here: divergent dictionaries) runs
    the statement on one device, with the local rows (the JAX package's
    sharded rows)."""
    js, s = multi
    sql = "select f, sum(v) from mb group by f order by f"
    local = s.execute(sql).rows()
    before = _merged_statements()

    def diverge(kds, nkeys):
        raise DQ.ShardDegrade("divergent group-key dictionaries")

    monkeypatch.setattr(DQ, "_merge_key_dicts", diverge)
    got = _sharded(s, 4, sql)
    assert got == local
    assert _merged_statements() == before
    assert got == _sharded(js, 4, sql)


def test_card_fault_in_a_shard_surfaces(multi, monkeypatch):
    """Out of memory (or a failed launch) inside a shard is not a reason
    to degrade: it raises to the caller."""
    from matrixone_tpu_torch.vm import operators as O
    _js, s = multi
    sql = "select g, sum(v) from mb group by g order by g"
    real = O.AggOp._partial_vals

    def oom(self, *a, **k):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(O.AggOp, "_partial_vals", oom)
    with pytest.raises(RuntimeError, match="out of memory"):
        _sharded(s, 4, sql)
    monkeypatch.setattr(O.AggOp, "_partial_vals", real)
    assert _sharded(s, 4, sql) == s.execute(sql).rows()


# --------------------------------------------------- partitioned tables

def test_shards_ddl_and_co_partitioned_read(slots):
    js, s = _both(
        "create table ph (id bigint primary key, g bigint,"
        " v bigint) partition by hash(g) shards 4",
        *("insert into ph values " + ",".join(
            f"({i},{i % 11},{i % 7})" for i in range(lo, lo + 400))
          for lo in range(0, 2000, 400)))
    spec = s.catalog.get_table("ph").meta.partition
    assert spec.kind == "hash" and spec.column == "g" \
        and spec.n_parts == 4
    sql = "select g, count(*), sum(v) from ph group by g order by g"
    local = s.execute(sql).rows()
    shuffled0 = M.exchange_shuffle_rows.get()
    got = _sharded(s, 4, sql)
    assert got == local
    assert M.exchange_shuffle_rows.get() == shuffled0
    explain = _sharded(s, 4, "explain " + sql, text=True)
    assert "exchange=local" in explain
    assert got == _sharded(js, 4, sql)
    assert explain == _sharded(js, 4, "explain " + sql, text=True)


def test_implicit_repartition_and_shuffle_join(slots, monkeypatch):
    """No PARTITION DDL: a GROUP BY over an unpartitioned table shards
    its scan, and a join of two big scans on their keys shuffles both
    sides through the read-side hash route (the rows it moves are
    counted); each answers the local rows and the JAX package's."""
    monkeypatch.setenv("MO_SHUFFLE_BUILD_ROWS", "100")
    js, s = _both(
        "create table up (id bigint primary key, g bigint, v bigint)",
        "create table uq (k bigint primary key, w bigint)",
        "insert into up values " + ",".join(
            f"({i},{i % 11},{i % 7})" for i in range(2000)),
        "insert into uq values " + ",".join(
            f"({i},{i % 5})" for i in range(2000)))
    for sql in ("select g, count(*), sum(v) from up group by g order by g",
                "select w, count(*), sum(v) from up, uq where id = k"
                " group by w order by w"):
        local = s.execute(sql).rows()
        shuffled0 = M.exchange_shuffle_rows.get()
        jshuffled0 = JM.exchange_shuffle_rows.get()
        got = _sharded(s, 4, sql)
        assert got == local
        assert got == _sharded(js, 4, sql)
        # the rows moved are the reference's (none for the GROUP BY,
        # whose scan takes the chunk stride; both sides for the join)
        assert M.exchange_shuffle_rows.get() - shuffled0 == \
            JM.exchange_shuffle_rows.get() - jshuffled0
    assert M.exchange_shuffle_rows.get() > shuffled0
    explain = _sharded(s, 4, "explain " + sql, text=True)
    assert "exchange=shuffle" in explain
    assert explain == _sharded(js, 4, "explain " + sql, text=True)


def test_merge_site_audited(multi):
    from matrixone_tpu_torch.utils import keys as keyaudit
    with keyaudit.armed_scope():
        _sharded(multi[1], 4, "select g, sum(v) from mb group by g"
                           " order by g")
        recs = [k for (site, k) in keyaudit._RECORDS
                if site == DQ.SITE_MERGE]
    assert recs, "the merge did not audit"
