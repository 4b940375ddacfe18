"""Shared rig of the port's device-shard SQL tests
(tests/test_torch_shard_exec.py, tests/test_torch_shard_tables.py):
torch single-threaded, 8 simulated slots with every batch fused, a JAX
session beside a port session, and the sharded-statement helpers."""

import numpy as np
import pytest
import torch

from matrixone_tpu.frontend.session import Session as JSession
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.parallel import dist_query as DQ
from matrixone_tpu_torch.parallel.mesh import simulated_slots
from matrixone_tpu_torch.utils import metrics as M


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Autouse in each module that imports it.  The suite runs six test
    processes at once (xdist): torch's own thread pool in each would
    oversubscribe the cores, and these tests' many small ops per shard
    are what it slows most."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def slots():
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_FUSION_MIN_ROWS", "0")
    with simulated_slots(8):
        yield
    mp.undo()


def both(*statements):
    """A JAX session and a port session, each given the same statements
    in order."""
    js, ts = JSession(), TSession(device="cpu")
    for sql in statements:
        js.execute(sql)
        ts.execute(sql)
    return js, ts


def merges() -> int:
    return DQ._MERGE_CALLS["count"]


KINDS = ("dense", "general", "single", "empty", "scalar", "topk", "join")


def merged_statements() -> float:
    return sum(M.exchange_partial_merge.get(kind=k) for k in KINDS)


def sharded(s, n, sql, text=False):
    s.execute(f"set query_shards = {n}")
    s.execute("set dist_min_rows = 0")
    try:
        r = s.execute(sql)
        return r.text if text else r.rows()
    finally:
        s.execute("set query_shards = 0")
        s.execute("set dist_min_rows = 100000")


def assert_rows_close(got, want, exact_cols):
    """Equal row counts; columns in `exact_cols` exactly, the others
    within the reference's f32 tolerance (rtol 1e-4, atol 1e-3)."""
    assert len(got) == len(want)
    for c in range(len(want[0]) if want else 0):
        g = [r[c] for r in got]
        w = [r[c] for r in want]
        if c in exact_cols:
            assert g == w, c
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-3)
