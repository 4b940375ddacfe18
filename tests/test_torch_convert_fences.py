"""`convert.tables_to_numpy` / `tables_from_numpy` carry a merged
table's fences, so an AS OF read before the merge answers on the
carried table as on the original (ROADMAP.md, section C, fixed): a
table merged in the port, carried there and back, and one merged in
the JAX package, carried into the port."""

import numpy as np

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session
from torch_compare import reference_env  # noqa: F401


def _merged_session(s=None):
    s = s if s is not None else Session(device="cpu")
    s.execute("create table t (id int primary key, v varchar(8))")
    s.execute("insert into t values (1, 'a')")
    before = s.catalog.committed_ts
    s.execute("insert into t values (2, 'b')")
    mid = s.catalog.committed_ts
    s.execute("delete from t where id = 1")
    assert s.catalog.merge_table("t", min_segments=1, checkpoint=False) > 0
    s.execute("insert into t values (3, 'c')")
    return s, before, mid


def _reads(s, stamps):
    return [s.execute(f"select id, v from t as of timestamp {ts} "
                      f"order by id").rows() for ts in stamps] + \
        [s.execute("select id, v from t order by id").rows()]


def test_as_of_before_a_merge_survives_the_carry_both_ways():
    s, before, mid = _merged_session()
    t = s.catalog.get_table("t")
    assert len(t.fences) == 1
    stamps = [before, mid, t.fences[0].merge_ts - 1, t.fences[0].merge_ts,
              s.catalog.committed_ts]
    want = _reads(s, stamps)
    assert want[0] == [(1, "a")] and want[1] == [(1, "a"), (2, "b")]
    carried = convert.tables_to_numpy(s.catalog)
    assert len(carried["t"]["fences"]) == 1
    eng = convert.tables_from_numpy(carried)
    back = convert.tables_from_numpy(convert.tables_to_numpy(eng))
    for e in (eng, back):
        c = e.get_table("t")
        assert [f.merge_ts for f in c.fences] == [f.merge_ts
                                                  for f in t.fences]
        assert c.last_merge_ts == t.last_merge_ts
        assert _reads(Session(catalog=e, device="cpu"), stamps) == want
        np.testing.assert_array_equal(
            c.fetch_rows(np.array([0]), ["id"])[0]["id"], [1])


def test_a_table_merged_in_the_reference_reads_alike_in_the_port(
        reference_env):  # noqa: F811
    j, before, mid = _merged_session(JSession())
    t = j.catalog.get_table("t")
    assert len(t.fences) == 1
    stamps = [before, mid, t.fences[0].merge_ts - 1, t.fences[0].merge_ts,
              j.catalog.committed_ts]
    want = _reads(j, stamps)
    assert want[0] == [(1, "a")] and want[1] == [(1, "a"), (2, "b")]
    eng = convert.tables_from_numpy(convert.tables_to_numpy(j.catalog))
    c = eng.get_table("t")
    assert [f.merge_ts for f in c.fences] == [f.merge_ts for f in t.fences]
    assert c.last_merge_ts == t.last_merge_ts
    assert _reads(Session(catalog=eng, device="cpu"), stamps) == want
