"""The port's FULL OUTER, cross and non-equi joins, UNION, SAMPLE, FILL
and time_bucket against the JAX package's, on the CPU.

The scripts of tests/test_operator_breadth.py and `test_union`,
`test_union_in_derived_table` and `test_cross_join_count` of
tests/test_sql.py run through the JAX session and the port's
`Session(device="cpu")`, each on its own engine (`tests/torch_compare.py`):
the same rows, `affected` counts and exception classes.  Added: a
non-equi inner and left join, a UNION of varchar columns with different
dictionaries, UNION in a CTE, and SAMPLE over two scan
batches.

SAMPLE draws its keys on the host from `np.random.default_rng(seed)`,
one `random(padded_len, float32)` per batch, where the binder takes each
Sample node's seed from a module counter: both packages' counters are
reset before each script, so the sampled rows themselves must be equal.

The JAX package raises a TypeError on a LEFT JOIN whose ON has no
equi-key (its hash of no key columns is None); the port runs it, and
that case is held against sqlite3 instead (ROADMAP.md, section C).

Tolerance: every value here is an integer, a string or a float sum of
a few exact values; all are compared exactly.
"""

import itertools
import sqlite3

import pytest

from matrixone_tpu.container import device as jdevice
from matrixone_tpu.sql import binder as jbinder, parser as jparser
from matrixone_tpu_torch.container.device import bucket_length
from matrixone_tpu_torch.sql import binder as tbinder, parser as tparser
from torch_compare import (assert_same, reference_env,  # noqa: F401
                           run_step, session)
from torch_scripts import LEFT_NON_EQUI_DDL, LEFT_NON_EQUI_QUERIES, SETOPS

pytestmark = pytest.mark.usefixtures("reference_env")


def _reset_seeds():
    jbinder._sample_seed = itertools.count(1)
    tbinder._sample_seed = itertools.count(1)


@pytest.mark.parametrize("name", list(SETOPS))
def test_setops_script_equals_reference(name):
    assert_same(SETOPS[name], reset=_reset_seeds)


@pytest.mark.parametrize("n", [0, 1, 904, 1024, 1025, 4096, 5000,
                               1 << 20, (1 << 20) + 1, 6_000_000])
def test_padded_lengths_equal_the_reference(n):
    """A sample's draws follow the padded batch lengths."""
    assert bucket_length(n) == jdevice.bucket_length(n)


def test_sample_seeds_advance_as_the_reference():
    """Each bound Sample node takes the next seed of its package's
    counter; over one script both counters hand out the same seeds."""
    def seeds(node):
        out = [node.seed] if type(node).__name__ == "Sample" else []
        for attr in ("child", "left", "right"):
            if hasattr(node, attr):
                out += seeds(getattr(node, attr))
        for c in getattr(node, "children", []) or []:
            out += seeds(c)
        return out

    sql = ["select count(*) from (select id from ind sample 10 percent) a,"
           " (select id from ind sample 5 rows) b where a.id = b.id",
           "select id from ind sample 3 rows union all"
           " select id from ind sample 1 percent"]
    got = {}
    for pkg, binder, parser in (("jax", jbinder, jparser),
                                ("port", tbinder, tparser)):
        _reset_seeds()
        s = session(pkg)
        s.execute("create table ind (id int primary key)")
        got[pkg] = [seeds(binder.Binder(s.catalog).bind_statement(
            parser.parse_one(q))) for q in sql]
    assert got["port"] == got["jax"] == [[1, 2], [3, 4]]


def test_left_non_equi_join_equals_sqlite():
    """LEFT JOIN whose ON has no equi-key: each left row meets every
    right row, the ON decides, unmatched left rows are null-extended."""
    lite = sqlite3.connect(":memory:")
    port = session("port")
    for st in LEFT_NON_EQUI_DDL:
        lite.execute(st)
        assert run_step(port, st)[0] == "ok"
    for q in LEFT_NON_EQUI_QUERIES:
        want = [tuple(r) for r in lite.execute(q).fetchall()]
        got = run_step(port, q)
        assert got[0] == "ok", (q, got)
        assert got[2] == want, (q, got[2], want)
