"""The port's partitioned tables against the JAX package's, on the CPU.

The scenarios of tests/test_partition.py but its restart (the port has
no WAL or checkpoint yet): the unit level (`assign_partitions`, `prune`
and `build_spec` of both packages on the same inputs give the same
answers) and the statements (RANGE and HASH tables, SHOW PARTITIONS,
pruned and unpruned sums, TRUNCATE PARTITION under a snapshot, DROP
PARTITION and the remapped layout, an insert out of range, decimal
literals against an integer partition key), run through the JAX session
and the port's `Session(device="cpu")` with `tests/torch_compare.py`:
the same rows, `affected` counts and exception classes.  Every value is
an integer or a string: compared exactly.
"""

import numpy as np
import pytest

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.sql import expr as jexpr
from matrixone_tpu.storage import partition as jpart
from matrixone_tpu_torch.container import dtypes as tdt
from matrixone_tpu_torch.sql import expr as texpr
from matrixone_tpu_torch.storage import partition as tpart
from matrixone_tpu_torch.utils import metrics as TM
from torch_compare import (assert_same, reference_env,  # noqa: F401
                           session)

pytestmark = pytest.mark.usefixtures("reference_env")


def test_assign_range_hash_and_null_equal_the_reference():
    rng = np.random.default_rng(3)
    keys = rng.integers(-10 ** 6, 10 ** 12, 4000)
    keys[:7] = [-5, 0, 9, 10, 19, 20, 10 ** 12]
    val = rng.random(4000) < 0.9
    for kind, bounds, names in (("range", [10, 20, None], ["a", "b", "c"]),
                                ("hash", [], ["p0", "p1", "p2", "p3"])):
        want = jpart.assign_partitions(
            jpart.PartitionSpec(kind, "k", names, bounds), keys, val)
        got = tpart.assign_partitions(
            tpart.PartitionSpec(kind, "k", names, bounds), keys, val)
        assert np.array_equal(got, want)
    with pytest.raises(tpart.PartitionError):
        tpart.assign_partitions(tpart.PartitionSpec("range", "k", ["p0"],
                                                    [10]),
                                np.array([11]), np.array([True]))


def _pred(E, D, op, v, lit_type):
    return [E.BoundFunc(op, [E.BoundCol("t.k", D.INT64),
                             E.BoundLiteral(v, getattr(D, lit_type))],
                        D.BOOL)]


@pytest.mark.parametrize("kind", ["range", "hash"])
def test_prune_equals_the_reference(kind):
    """Every comparison against integer and fractional literals, and a
    conjunction, prunes to the same partition sets."""
    bounds = [10, 20, None] if kind == "range" else []
    names = ["p0", "p1", "p2"] if kind == "range" else ["p0", "p1", "p2",
                                                          "p3"]
    js = jpart.PartitionSpec(kind, "k", list(names), list(bounds))
    ts = tpart.PartitionSpec(kind, "k", list(names), list(bounds))
    qmap = {"t.k": "k"}
    cases = [(op, v, t) for op in ("eq", "lt", "le", "gt", "ge")
             for v, t in ((5, "INT64"), (10, "INT64"), (19, "INT64"),
                          (20, "INT64"), (7, "INT64"), (10.5, "FLOAT64"),
                          (19.5, "FLOAT64"), (10.0, "FLOAT64"))]
    for op, v, t in cases:
        want = jpart.prune(js, _pred(jexpr, jdt, op, v, t), qmap)
        got = tpart.prune(ts, _pred(texpr, tdt, op, v, t), qmap)
        assert got == want, (kind, op, v)
    both_j = _pred(jexpr, jdt, "ge", 10, "INT64") + \
        _pred(jexpr, jdt, "lt", 20, "INT64")
    both_t = _pred(texpr, tdt, "ge", 10, "INT64") + \
        _pred(texpr, tdt, "lt", 20, "INT64")
    assert tpart.prune(ts, both_t, qmap) == jpart.prune(js, both_j, qmap)


def test_build_spec_equals_the_reference():
    jschema = [("k", jdt.INT64), ("s", jdt.VARCHAR), ("d", jdt.DATE)]
    tschema = [("k", tdt.INT64), ("s", tdt.VARCHAR), ("d", tdt.DATE)]
    for raw in ({"kind": "range", "column": "s", "parts": []},
                {"kind": "range", "column": "k",
                 "parts": [("a", 10), ("b", 5)]},
                {"kind": "range", "column": "x", "parts": []}):
        with pytest.raises(jpart.PartitionError):
            jpart.build_spec(raw, jschema)
        with pytest.raises(tpart.PartitionError):
            tpart.build_spec(raw, tschema)
    raw = {"kind": "range", "column": "d",
           "parts": [("a", "2020-01-01"), ("b", None)]}
    assert tpart.build_spec(raw, tschema).to_json() == \
        jpart.build_spec(raw, jschema).to_json()
    assert tpart.build_spec(raw, tschema).bounds[0] == 18262


RANGE_DDL = ("create table pt (k int, v int) partition by range(k) ("
             "partition p0 values less than (100),"
             "partition p1 values less than (200),"
             "partition pmax values less than (maxvalue))")

SCRIPTS = {
    "range_end_to_end": [
        RANGE_DDL,
        "insert into pt values "
        + ",".join(f"({i},{i})" for i in range(0, 300, 10)),
        "show partitions from pt",
        "select sum(v) sv from pt",
        "select sum(v) sv from pt where k < 100",
        "select count(*), sum(v) from pt where k >= 100 and k < 200",
        "select k, v from pt where k > 150 order by k",
    ],
    "hash_routing": [
        "create table ph (k int, v int) partition by hash(k) partitions 4",
        "insert into ph values "
        + ",".join(f"({i},{i})" for i in range(1000)),
        "show partitions from ph",
        "select sum(v) sv from ph where k = 77",
        "select count(*) from ph where k < 500",
    ],
    "truncate_mvcc": [
        "create table tp (k int, v int) partition by range(k) ("
        "partition a values less than (10),"
        "partition b values less than (maxvalue))",
        "insert into tp values (1,1),(2,2),(11,11),(12,12)",
        "create snapshot before_trunc",
        "alter table tp truncate partition a",
        "select count(*) c from tp",
        "select count(*) c from tp as of snapshot before_trunc",
        "show partitions from tp",
        "!alter table tp truncate partition zz",
    ],
    "drop_remap": [
        "create table dp (k int, v int) partition by range(k) ("
        "partition a values less than (10),"
        "partition b values less than (20),"
        "partition c values less than (maxvalue))",
        "insert into dp values (5,1),(15,2),(25,3)",
        "alter table dp drop partition a",
        "show partitions from dp",
        "select sum(v) sv from dp where k >= 20",
        "select sum(v) sv from dp where k < 20",
        # MySQL: the next range partition absorbs the dropped range
        "insert into dp values (5, 9)",
        "show partitions from dp",
        "!alter table dp drop partition zz",
    ],
    "drop_refused": [
        "create table dh (k int) partition by hash(k) partitions 2",
        "insert into dh values (1),(2),(3)",
        "!alter table dh drop partition p0",
        "select count(*) from dh",
        "create table d1 (k int) partition by range(k) ("
        "partition only values less than (maxvalue))",
        "insert into d1 values (1)",
        "!alter table d1 drop partition only",
        "select count(*) from d1",
        "create table np (k int)",
        "!show partitions from np",
    ],
    "out_of_range_insert": [
        "create table po (k int) partition by range(k) ("
        "partition a values less than (10))",
        "!insert into po values (10)",
        "insert into po values (9), (null)",
        "show partitions from po",
    ],
    "decimal_literals": [
        "create table pm (k bigint, v bigint) partition by range(k) ("
        "partition p0 values less than (10), "
        "partition p1 values less than (20), "
        "partition p2 values less than (maxvalue))",
        "insert into pm values "
        + ",".join(f"({i % 30},{i})" for i in range(300)),
        "select count(*) from pm where k > 18.5",
        "select count(*) from pm where k < 10.5",
        "select count(*) from pm where k >= 19.5",
        "select count(*) from pm where k <= 9.5",
    ],
    "date_ranges": [
        "create table od (d date, x bigint) partition by range(d) ("
        "partition y92 values less than ('1993-01-01'),"
        "partition y93 values less than ('1994-01-01'),"
        "partition ymax values less than (maxvalue))",
        "insert into od values ('1992-03-01', 1), ('1992-12-31', 2),"
        " ('1993-01-01', 4), ('1993-06-30', 8), ('1995-01-01', 16)",
        "select count(*), sum(x) from od where d >= date '1993-01-01'"
        " and d < date '1994-01-01'",
        "select count(*), sum(x) from od where d < date '1993-01-01'",
        "show partitions from od",
    ],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_partition_script_equals_the_reference(name):
    assert_same(SCRIPTS[name])


def test_pruning_skips_the_other_partitions_segments():
    """The scan of a filtered partitioned table reads only the matching
    partition's segment (tests/test_partition.py counts rows scanned;
    the port counts segments read and pruned)."""
    port = session("port")
    port.execute("create table pp (k int, v int) partition by range(k) ("
                 "partition a values less than (1000),"
                 "partition b values less than (maxvalue))")
    port.execute("insert into pp values "
                 + ",".join(f"({i},1)" for i in range(500)))
    port.execute("insert into pp values "
                 + ",".join(f"({i},2)" for i in range(1000, 1500)))
    r0 = TM.scan_segments.get(outcome="read")
    p0 = TM.scan_segments.get(outcome="pruned")
    assert port.execute("select count(*) c from pp where k >= 1000"
                        ).rows() == [(500,)]
    assert TM.scan_segments.get(outcome="read") - r0 == 1
    assert TM.scan_segments.get(outcome="pruned") - p0 == 1
    assert port.execute("select count(*) c from pp").rows() == [(1000,)]
    assert TM.scan_segments.get(outcome="pruned") - p0 == 1


def test_convert_carries_the_partition_spec_and_segments():
    """A JAX engine's partitioned table carried across keeps its spec and
    each segment's partition, so the port's scan prunes it alike."""
    from matrixone_tpu_torch import convert
    jax = session("jax")
    for st in SCRIPTS["range_end_to_end"][:2]:
        jax.execute(st)
    eng = convert.tables_from_numpy(convert.tables_to_numpy(jax.catalog))
    t = eng.get_table("pt")
    assert t.meta.partition.to_json() == \
        jax.catalog.get_table("pt").meta.partition.to_json()
    assert [s.part_id for s in t.segments] == \
        [s.part_id for s in jax.catalog.get_table("pt").segments]
    port = session("port", catalog=eng)
    sql = "select sum(v) from pt where k >= 200"
    assert port.execute(sql).rows() == jax.execute(sql).rows()
