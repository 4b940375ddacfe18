"""The port's hash join against the JAX package, on the CPU.

`build_sorted_hash` and `expand_probe` (kernel 4's caller) run on the
same seeded inputs in both packages — duplicate build keys past
`max_matches` (the overflow flag and the re-run with a doubled budget),
NULL keys on both sides, padded batches — and must agree bit for bit.
Then joins run from SQL text through both sessions over the same
tables (the JAX package on its per-operator path, MO_PLAN_FUSION=0,
with its Pallas kernels in interpret mode, MO_HAND_KERNELS=1): inner,
left, semi and anti joins, empty build and probe sides.  FULL OUTER's
build-row tracking is held bit for bit too; its SQL cases, with cross
and non-equi joins, are in tests/test_torch_setops.py.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrixone_tpu.container import dtypes as jdt
from matrixone_tpu.container.device import DeviceBatch as JBatch
from matrixone_tpu.container.device import DeviceColumn as JCol
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.sql.expr import BoundCol as JBoundCol
from matrixone_tpu.vm import join as JJ
from matrixone_tpu.vm.exprs import ExecBatch as JEx
from matrixone_tpu_torch import convert
from matrixone_tpu_torch.container import dtypes as tdt
from matrixone_tpu_torch.container.device import DeviceBatch as TBatch
from matrixone_tpu_torch.container.device import DeviceColumn as TCol
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql.expr import BoundCol as TBoundCol
from matrixone_tpu_torch.vm import join as TJ
from matrixone_tpu_torch.vm.exprs import ExecBatch as TEx


def _side(prefix, keys, key_valid, live, padded):
    """One join side as (JAX ExecBatch, port ExecBatch, schema names):
    a key column and a payload column, padded to `padded` rows."""
    n = len(keys)
    k = np.zeros(padded, np.int64)
    k[:n] = keys
    kv = np.zeros(padded, bool)
    kv[:n] = key_valid
    p = np.arange(padded, dtype=np.int64) * 10 + 7
    pv = np.zeros(padded, bool)
    pv[:n] = True
    mask = np.arange(padded) < live
    names = (f"{prefix}.k", f"{prefix}.p")
    jb = JBatch({names[0]: JCol(jnp.asarray(k), jnp.asarray(kv), jdt.INT64),
                 names[1]: JCol(jnp.asarray(p), jnp.asarray(pv), jdt.INT64)},
                jnp.asarray(n, jnp.int32))
    tb = TBatch({names[0]: TCol(torch.from_numpy(k), torch.from_numpy(kv),
                                tdt.INT64),
                 names[1]: TCol(torch.from_numpy(p), torch.from_numpy(pv),
                                tdt.INT64)},
                torch.tensor(n, dtype=torch.int32))
    return (JEx(jb, {}, jnp.asarray(mask)), TEx(tb, {}, torch.from_numpy(mask)),
            names)


def _nodes(kind, lnames, rnames):
    def node(col):
        return SimpleNamespace(
            kind=kind, residual=None,
            left=SimpleNamespace(schema=[(n, None) for n in lnames]),
            right=SimpleNamespace(schema=[(n, None) for n in rnames]),
            left_keys=[col(lnames[0], jdt.INT64 if col is JBoundCol
                           else tdt.INT64)],
            right_keys=[col(rnames[0], jdt.INT64 if col is JBoundCol
                            else tdt.INT64)])
    return node(JBoundCol), node(TBoundCol)


def _inputs(seed):
    rng = np.random.default_rng(seed)
    nb, np_ = 900, 3000
    bkeys = rng.integers(0, 400, nb)
    bkeys[:7] = 42                       # 7 duplicates > max_matches 4
    bkeys[7:19] = 99                     # 12 duplicates > 8
    bvalid = rng.random(nb) < 0.9        # NULL build keys
    pkeys = rng.integers(0, 450, np_)
    pkeys[:50] = 42
    pvalid = rng.random(np_) < 0.85      # NULL probe keys
    return bkeys, bvalid, pkeys, pvalid


@pytest.mark.parametrize("kind", ["inner", "left"])
def test_build_and_expand_probe_bit_identical(kind):
    bkeys, bvalid, pkeys, pvalid = _inputs(3)
    jbuild, tbuild, rnames = _side("b", bkeys, bvalid, 880, 1024)
    jprobe, tprobe, lnames = _side("a", pkeys, pvalid, 2990, 4096)
    jnode, tnode = _nodes(kind, lnames, rnames)
    jbk, jbd = JJ.build_key_columns(jnode, jbuild)
    tbk, tbd = TJ.build_key_columns(tnode, tbuild)
    jsh, jorder, jbvalid = JJ.build_sorted_hash(jbk, jbuild.mask)
    tsh, torder, tbvalid = TJ.build_sorted_hash(tbk, tbuild.mask)
    assert np.array_equal(tsh.numpy(), np.asarray(jsh).view(np.int64))
    assert np.array_equal(torder.numpy(), np.asarray(jorder))
    assert np.array_equal(tbvalid.numpy(), np.asarray(jbvalid))
    jpk = JJ.probe_key_columns(jnode, jprobe, jbd)
    tpk = TJ.probe_key_columns(tnode, tprobe, tbd)
    jph, jpv = JJ.hash_valid_keys(jpk, jprobe.mask)
    tph, tpv = TJ.hash_valid_keys(tpk, tprobe.mask)
    assert np.array_equal(tph.numpy(), np.asarray(jph).view(np.int64))
    overflows = []
    for mm in (4, 8, 16):
        jout, jov, _ = JJ.expand_probe(jnode, jprobe, jbuild, jsh, jorder,
                                       jph, jpv, jpk, jbk, mm)
        tout, tov, _ = TJ.expand_probe(tnode, tprobe, tbuild, tsh, torder,
                                       tph, tpv, tpk, tbk, mm)
        assert bool(tov) == bool(jov)
        overflows.append(bool(tov))
        m = np.asarray(jout.mask)
        assert np.array_equal(tout.mask.numpy(), m)
        assert int(tout.batch.n_rows) == int(jout.batch.n_rows)
        for name in lnames + rnames:
            jc, tc = jout.batch.columns[name], tout.batch.columns[name]
            assert np.array_equal(tc.validity.numpy()[m],
                                  np.asarray(jc.validity)[m])
            assert np.array_equal(tc.data.numpy()[m],
                                  np.asarray(jc.data)[m])
    # 12 duplicates: 4 and 8 lanes overflow, 16 holds them all
    assert overflows == [True, True, False]


def test_full_expand_probe_and_build_matched_bit_identical():
    """FULL OUTER: the probe lanes as a left join's, and the build rows
    matched so far, across the overflow re-runs."""
    bkeys, bvalid, pkeys, pvalid = _inputs(5)
    jbuild, tbuild, rnames = _side("b", bkeys, bvalid, 880, 1024)
    jprobe, tprobe, lnames = _side("a", pkeys, pvalid, 2990, 4096)
    jnode, tnode = _nodes("full", lnames, rnames)
    jbk, jbd = JJ.build_key_columns(jnode, jbuild)
    tbk, tbd = TJ.build_key_columns(tnode, tbuild)
    jsh, jorder, _ = JJ.build_sorted_hash(jbk, jbuild.mask)
    tsh, torder, _ = TJ.build_sorted_hash(tbk, tbuild.mask)
    jpk = JJ.probe_key_columns(jnode, jprobe, jbd)
    tpk = TJ.probe_key_columns(tnode, tprobe, tbd)
    jph, jpv = JJ.hash_valid_keys(jpk, jprobe.mask)
    tph, tpv = TJ.hash_valid_keys(tpk, tprobe.mask)
    jbm = jnp.zeros(1024, jnp.bool_)
    tbm = torch.zeros(1024, dtype=torch.bool)
    for mm in (4, 16):
        jout, jov, jbm = JJ.expand_probe(jnode, jprobe, jbuild, jsh, jorder,
                                         jph, jpv, jpk, jbk, mm, jbm)
        tout, tov, tbm = TJ.expand_probe(tnode, tprobe, tbuild, tsh, torder,
                                         tph, tpv, tpk, tbk, mm, tbm)
        assert bool(tov) == bool(jov)
        assert np.array_equal(tout.mask.numpy(), np.asarray(jout.mask))
        assert np.array_equal(tbm.numpy(), np.asarray(jbm))
    assert 0 < int(tbm.sum()) < 880


def test_collapse_semi_anti_bit_identical():
    bkeys, bvalid, pkeys, pvalid = _inputs(4)
    jbuild, tbuild, rnames = _side("b", bkeys, bvalid, 900, 1024)
    jprobe, tprobe, lnames = _side("a", pkeys, pvalid, 3000, 4096)
    for kind in ("semi", "anti"):
        jnode, tnode = _nodes(kind, lnames, rnames)
        jbk, jbd = JJ.build_key_columns(jnode, jbuild)
        tbk, tbd = TJ.build_key_columns(tnode, tbuild)
        jsh, jorder, _ = JJ.build_sorted_hash(jbk, jbuild.mask)
        tsh, torder, _ = TJ.build_sorted_hash(tbk, tbuild.mask)
        jpk = JJ.probe_key_columns(jnode, jprobe, jbd)
        tpk = TJ.probe_key_columns(tnode, tprobe, tbd)
        jph, jpv = JJ.hash_valid_keys(jpk, jprobe.mask)
        tph, tpv = TJ.hash_valid_keys(tpk, tprobe.mask)
        jout, _, _ = JJ.expand_probe(jnode, jprobe, jbuild, jsh, jorder,
                                     jph, jpv, jpk, jbk, 16)
        tout, _, _ = TJ.expand_probe(tnode, tprobe, tbuild, tsh, torder,
                                     tph, tpv, tpk, tbk, 16)
        jc = JJ.collapse_semi_anti(jnode, jprobe, jout.mask, 16)
        tc = TJ.collapse_semi_anti(tnode, tprobe, tout.mask, 16)
        assert np.array_equal(tc.mask.numpy(), np.asarray(jc.mask))


# ------------------------------------------------------------- from SQL
@pytest.fixture(scope="module")
def sessions():
    """Both sessions over the same tables: a probe side with NULL keys,
    a build side with duplicate keys (past max_matches) and NULL keys,
    and an empty table."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MO_PLAN_FUSION", "0")
    mp.setenv("MO_HAND_KERNELS", "1")
    js = JSession()
    js.execute("create table a (id bigint primary key, k bigint, v int)")
    js.execute("create table b (id bigint primary key, k bigint, w int)")
    js.execute("create table e (id bigint primary key, k bigint, w int)")
    rng = np.random.default_rng(9)
    rows_a = []
    for i in range(600):
        k = "null" if i % 13 == 0 else str(int(rng.integers(0, 60)))
        rows_a.append(f"({i}, {k}, {int(rng.integers(0, 1000))})")
    rows_b = []
    for i in range(200):
        k = ("null" if i % 17 == 0 else "7" if i < 11
             else str(int(rng.integers(0, 80))))
        rows_b.append(f"({i}, {k}, {int(rng.integers(0, 1000))})")
    js.execute("insert into a values " + ", ".join(rows_a))
    js.execute("insert into b values " + ", ".join(rows_b))
    ts = TSession(catalog=convert.tables_from_numpy(
        convert.tables_to_numpy(js.catalog)), device="cpu")
    ts.variables["batch_rows"] = js.variables["batch_rows"] = 256
    yield js, ts
    mp.undo()


_JOINS = [
    "select a.id, a.k, v, b.id, w from a join b on a.k = b.k "
    "order by a.id, b.id",
    "select a.id, v, b.id, w from a left join b on a.k = b.k "
    "order by a.id, b.id",
    "select a.id, v, w from a join b on a.k = b.k and v < w "
    "order by a.id, w",
    "select a.id from a where exists (select 1 from b where b.k = a.k) "
    "order by a.id",
    "select a.id from a where not exists (select 1 from b where b.k = a.k) "
    "order by a.id",
    "select a.id, w from a join e on a.k = e.k order by a.id",
    "select a.id, w from a left join e on a.k = e.k order by a.id",
    "select b.id, v from b join a on a.k = b.k where a.v < 0 "
    "order by b.id",
    "select b.k, count(*), sum(v) from a join b on a.k = b.k "
    "group by b.k order by b.k",
]


@pytest.mark.parametrize("sql", _JOINS)
def test_join_rows_equal_reference(sessions, sql):
    js, ts = sessions
    want = js.execute(sql).rows()
    got = ts.execute(sql).rows()
    assert got == want
