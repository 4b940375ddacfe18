"""The padding canary on the port (utils/qa.py), on the CPU.

The canary cases of tests/test_moqa.py (:355 the poison and the audit,
:448 the isolated capture), with the port's poison values held to the
JAX package's; the upload hook (`container/device.from_numpy` poisons the
padded tail only when armed); and Q1-, ORDER BY/LIMIT- and GROUP
BY-shaped queries over an odd-sized table, fused and per-operator,
armed against unarmed: bit-identical rows and zero findings.
"""

import numpy as np
import pytest
import torch

from matrixone_tpu.utils import qa as jqa
from matrixone_tpu_torch.container import device as tdev, dtypes as tdt
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.utils import qa


def test_canary_poisoning_and_audit():
    assert not qa.armed()
    z = qa.pad_fill(np.dtype(np.float64), (4,))
    assert (z == 0).all()
    with qa.armed_scope():
        p = qa.pad_fill(np.dtype(np.float64), (4,))
        assert np.isnan(p).all()
        pi = qa.pad_fill(np.dtype(np.int64), (4,))
        assert (pi == qa.canary_value(np.dtype(np.int64))).all()
        before = len(qa.findings())
        qa.audit_host_column(
            "c", np.asarray([1.0, float("nan")]),
            np.asarray([True, True]))
        assert len(qa.findings()) == before + 1
        assert qa.findings()[-1].rule == "canary-in-result"
    assert not qa.armed()
    # the same poison as the reference's, dtype by dtype
    for d in (np.int8, np.int16, np.int32, np.int64, np.uint8, np.bool_,
              np.float32, np.float64):
        got, want = qa.canary_value(np.dtype(d)), jqa.canary_value(
            np.dtype(d))
        assert (got is None) == (want is None)
        if got is not None:
            assert np.array_equal(np.asarray(got), np.asarray(want),
                                  equal_nan=d in (np.float32, np.float64))


def test_canary_capture_isolated_and_repeatable():
    bad = np.asarray([float("nan")]), np.asarray([True])
    for _ in range(2):
        with qa.capture() as probe:
            qa.audit_host_column("cap_col", *bad)
            assert len(probe.findings()) == 1
    assert all(f.where != "column 'cap_col'" for f in qa.findings())


def test_upload_poisons_the_padded_tail_only_when_armed():
    arrays = {"i": np.arange(5, dtype=np.int64),
              "f": np.arange(5, dtype=np.float64),
              "c": np.arange(5, dtype=np.int32)}
    dtypes = {"i": tdt.INT64, "f": tdt.FLOAT64, "c": tdt.INT32}
    plain = tdev.from_numpy(arrays, dtypes, n_rows=5, pad_to=8,
                            device="cpu")
    assert all((c.data[5:] == 0).all() for c in plain.columns.values())
    with qa.armed_scope():
        b = tdev.from_numpy(arrays, dtypes, n_rows=5, pad_to=8,
                            device="cpu")
        # a column already on the device takes the same poison
        on_dev = tdev.from_numpy({"i": torch.arange(5)}, {"i": tdt.INT64},
                                 n_rows=5, pad_to=8, device="cpu")
    assert torch.isnan(b.columns["f"].data[5:]).all()
    for name, col in (("i", b.columns["i"]), ("c", b.columns["c"]),
                      ("i", on_dev.columns["i"])):
        want = qa.canary_value(col.data.numpy().dtype)
        assert (col.data[5:] == int(want)).all(), name
    for col in b.columns.values():
        assert torch.equal(col.data[:5], plain.columns[
            [k for k, v in b.columns.items() if v is col][0]].data[:5])
        assert not col.validity[5:].any()


def test_result_audit_finds_a_leaked_pad_row():
    """An operator that let a padded row through reaches the host with
    the canary in a valid cell: the result audit records it (numbers) or
    drops the out-of-dictionary code (strings)."""
    from matrixone_tpu_torch.container import from_device
    with qa.armed_scope(), qa.capture() as probe:
        b = tdev.from_numpy({"v": np.arange(3, dtype=np.int64)},
                            {"v": tdt.INT64}, n_rows=3, pad_to=4,
                            device="cpu")
        b.n_rows = torch.tensor(4, dtype=torch.int32)   # the leak
        b.columns["v"].validity[:] = True
        from_device(b)
        s = tdev.from_numpy({"s": np.arange(3, dtype=np.int32)},
                            {"s": tdt.INT32}, n_rows=3, pad_to=4,
                            device="cpu")
        s.n_rows = torch.tensor(4, dtype=torch.int32)
        s.columns["s"].validity[:] = True
        out = from_device(s, {"s": ["a", "b", "c"]},
                          schema={"s": tdt.varchar(4)})
    assert [f.rule for f in probe.findings()] == ["canary-in-result"] * 2
    assert out.columns["s"].to_pylist() == ["a", "b", "c", None]


QUERIES = (
    # Q1-shaped: dense small-key grouped terminal, decimal and f64 lanes
    ("select flag, status, sum(qty) sq, sum(price) sp, avg(disc) ad, "
     "count(*) c from qa_li where ship <= 30 group by flag, status "
     "order by flag, status", True),
    # ORDER BY / LIMIT
    ("select id, price from qa_li where disc > 0.02 order by price desc, "
     "id limit 7 offset 3", True),
    # GROUP BY over an integer key, f32 sums (the segment sum's shape)
    ("select grp, sum(xf), sum(qty), min(price), max(id) from qa_li "
     "group by grp order by grp", True),
    ("select min(disc), max(qty), avg(price), count(*) from qa_li", False),
)


@pytest.fixture(scope="module")
def qa_session():
    """An odd-sized table (997 rows: every batch has a padded tail)."""
    rng = np.random.default_rng(7)
    n = 997
    s = TSession(device="cpu")
    s.execute("create table qa_li (id bigint, flag varchar(1), status "
              "varchar(1), qty decimal(10,2), price double, disc double, "
              "ship int, grp bigint, xf float)")
    rows = []
    for i in range(n):
        rows.append(
            f"({i}, '{'ANR'[i % 3]}', '{'FO'[i % 2]}', "
            f"{rng.integers(1, 5000) / 100:.2f}, "
            f"{rng.normal(1000, 300):.4f}, {rng.integers(0, 10) / 100}, "
            f"{rng.integers(0, 60)}, {i % 13}, "
            f"{rng.normal(0, 1):.3f})")
    s.execute("insert into qa_li values " + ", ".join(rows))
    yield s
    s.close()


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "perop"])
def test_engine_shapes_bit_identical_armed(qa_session, fused, monkeypatch):
    monkeypatch.setenv("MO_FUSION_MIN_ROWS", "0")
    s = qa_session
    s.variables["plan_fusion"] = 1 if fused else 0
    s.variables["batch_rows"] = 256        # several batches, one ragged
    try:
        for sql, ordered in QUERIES:
            want = s.execute(sql).rows()
            with qa.armed_scope(), qa.capture() as probe:
                got = s.execute(sql).rows()
            if not ordered:
                got, want = sorted(got, key=repr), sorted(want, key=repr)
            assert repr(got) == repr(want), (sql, got, want)
            assert probe.findings() == [], [f.format()
                                            for f in probe.findings()]
    finally:
        s.variables.pop("plan_fusion", None)
        s.variables["batch_rows"] = 1 << 20
