"""The port's window functions against the JAX package's, on the CPU.

Every query of tests/test_window.py (and the window case of
tests/test_builtins_r5.py) runs through the JAX session and the port's
`Session(device="cpu")`, each on its own engine built by the same
CREATE/INSERT script (`tests/torch_compare.py`), error paths included
(the same exception class).  Added: a window over more than 65536
partitions (past `WindowOp.max_partitions`, in several scan batches) and
a window over a table with tombstones and two segments.

Tolerance: ranks, counts, integer and decimal sums, min/max and string
values are equal exactly.  Float sums and averages may differ by
rtol 1e-4 / atol 1e-3 (the reference's float tolerance,
tests/test_pallas_kernels.py): the port's segmented scan adds in
another order than XLA's scan tree.
"""

import numpy as np
import pytest
import torch

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.storage.engine import TableMeta as JMeta
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.vm import window as W
from torch_compare import assert_same, reference_env  # noqa: F401
from torch_scripts import WINDOW

pytestmark = pytest.mark.usefixtures("reference_env")

RTOL, ATOL = 1e-4, 1e-3


@pytest.mark.parametrize("name", list(WINDOW))
def test_window_script_equals_reference(name):
    assert_same(WINDOW[name], RTOL, ATOL)


def test_window_over_more_than_65536_partitions():
    """70000 partitions (past WindowOp.max_partitions = 65536) in five
    scan batches: group_ids clips only its representative rows, so
    every partition keeps its own id."""
    n, parts = 120_000, 70_000
    rng = np.random.default_rng(23)
    g = np.concatenate([np.arange(parts),
                        rng.integers(0, parts, n - parts)])
    rng.shuffle(g)
    js = JSession()
    js.catalog.create_table(JMeta(
        "big", [("id", jdt.INT64), ("g", jdt.INT64), ("v", jdt.INT64)],
        ["id"]))
    js.catalog.get_table("big").insert_numpy(
        {"id": np.arange(n, dtype=np.int64), "g": g.astype(np.int64),
         "v": rng.integers(-1000, 1000, n).astype(np.int64)})
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    sql = """select id, g, rn, rk, cs, c from (select id, g,
        row_number() over (partition by g order by id) rn,
        rank() over (partition by g order by v desc) rk,
        sum(v) over (partition by g order by id) cs,
        count(*) over (partition by g) c from big) q
        where id % 997 = 0 or rn = 3 order by id"""
    summary = """select count(*), sum(rn), max(rn), sum(rk), sum(cs) from
        (select row_number() over (partition by g order by id) rn,
        rank() over (partition by g order by v) rk,
        sum(v) over (partition by g order by id) cs from big) q"""
    for s in (js, ts):
        s.execute("set batch_rows = 32768")
    for q in (sql, summary):
        want = js.execute(q).rows()
        got = ts.execute(q).rows()
        assert got == want, (q, got[:5], want[:5])
    assert ts.execute("""select count(*) from (select row_number() over
        (partition by g order by id) rn from big) q where rn = 1""").rows() \
        == [(parts,)]


# ------------------------------------------------------ the scan itself

@pytest.mark.parametrize("n", [1, 2, 5, 1024, 1031])
def test_seg_scan_equals_a_per_segment_loop(n):
    rng = np.random.default_rng(n)
    seg = np.cumsum(rng.random(n) < 0.2)
    vals = rng.integers(-100, 100, n)
    for combine, npf in ((torch.add, np.add), (torch.maximum, np.maximum),
                         (torch.minimum, np.minimum)):
        got = W._seg_scan(torch.from_numpy(vals), torch.from_numpy(seg),
                          combine).numpy()
        want = vals.copy()
        for i in range(1, n):
            if seg[i] == seg[i - 1]:
                want[i] = npf(want[i - 1], vals[i])
        np.testing.assert_array_equal(got, want)
