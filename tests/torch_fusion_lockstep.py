"""Lockstep of the fused plan fragments: the port's against its own
per-operator path and against the JAX package's fused path, on the CPU
(shared by tests/test_torch_fusion.py and tests/test_torch_fusion_join.py).

Both packages read the same fusion knobs from the environment
(MO_PLAN_FUSION, MO_FUSION_MIN_ROWS, MO_FUSION_JOIN, MO_FUSION_WINDOW,
MO_FUSION_TOPK, MO_NARROW_ENCODINGS); the `fusion_env` fixture sets
MO_FUSION_MIN_ROWS=0 in both, so every batch takes the fused path, as
tests/test_fusion.py does for the JAX package, and restores the knobs
after the test.  The JAX side runs its Pallas kernels in interpret mode
(MO_HAND_KERNELS=1), as the other tests/test_torch_*.py files do.

One lockstep statement holds three things:

  * the port's fused rows equal its unfused rows, bit for bit;
  * they equal the JAX package's fused rows: exactly, except floats
    within rtol 1e-4 / atol 1e-3;
  * both packages draw the same fragment boundaries (the plan node
    kinds of each fragment and their roles) and count the same
    `fusion_exec` modes.
"""

import os

import pytest

from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.utils import metrics as JM
from matrixone_tpu.vm import fusion as JF
from matrixone_tpu.vm.compile import compile_plan as jcompile
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.vm import fusion as TF
from matrixone_tpu_torch.vm.compile import compile_plan as tcompile
from torch_scripts import run_step, same_outcome

RTOL, ATOL = 1e-4, 1e-3
MODES = ("fused", "eager", "fallback", "degraded")
KNOBS = ("MO_PLAN_FUSION", "MO_FUSION_MIN_ROWS", "MO_FUSION_JOIN",
         "MO_FUSION_WINDOW", "MO_FUSION_TOPK", "MO_NARROW_ENCODINGS",
         "MO_FUSION_PROFILE", "MO_HAND_KERNELS")


@pytest.fixture()
def fusion_env():
    """MO_FUSION_MIN_ROWS=0 (every batch fused) and the reference's
    Pallas kernels in interpret mode; every knob restored after."""
    saved = {k: os.environ.get(k) for k in KNOBS}
    os.environ["MO_FUSION_MIN_ROWS"] = "0"
    os.environ["MO_HAND_KERNELS"] = "1"
    os.environ.pop("MO_PLAN_FUSION", None)
    yield os.environ
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def sessions(setup):
    """(JAX session, port session), each on its own engine, both after
    the same setup statements."""
    j, t = JSession(), TSession(device="cpu")
    for sql in setup:
        j.execute(sql)
        t.execute(sql)
    return j, t


def _exec_counts(metrics) -> dict:
    return {m: metrics.fusion_exec.get(mode=m) for m in MODES}


def run(sess, sql, fused: bool):
    """-> (outcome, fusion_exec mode counts of this run)."""
    metrics = TM if isinstance(sess, TSession) else JM
    os.environ["MO_PLAN_FUSION"] = "1" if fused else "0"
    before = _exec_counts(metrics)
    out = run_step(sess, sql)
    after = _exec_counts(metrics)
    return out, {m: after[m] - before[m] for m in MODES}


def _plan_nodes(node, out):
    out[id(node)] = node
    for attr in ("child", "left", "right"):
        c = getattr(node, attr, None)
        if c is not None and hasattr(c, "schema"):
            _plan_nodes(c, out)
    for c in getattr(node, "children", None) or []:
        _plan_nodes(c, out)
    return out


def _jax_plan(sess, sql):
    from matrixone_tpu.sql.binder import Binder
    from matrixone_tpu.sql.parser import parse
    sel = parse(sql)[0]
    sess._prepare_select(sel)
    node = Binder(sess.catalog).bind_statement(sel)
    return sess._cbo(node)


def boundaries(pkg, sess, sql) -> list:
    """[(fragment id, node kinds, roles)] of the compiled plan, with
    fusion on."""
    os.environ["MO_PLAN_FUSION"] = "1"
    if pkg == "jax":
        node = _jax_plan(sess, sql)
        op, fus = jcompile(node, sess._ctx()), JF
    else:
        node = sess.plan(sql)
        op, fus = tcompile(node, sess._ctx()), TF
    nodes = _plan_nodes(node, {})
    fmap, roles = fus.fragment_map(op), fus.fragment_roles(op)
    frags: dict = {}
    for nid, fid in fmap.items():
        kind = type(nodes[nid]).__name__ if nid in nodes else "?"
        frags.setdefault(fid, []).append((kind, roles.get(nid, "")))
    return sorted((fid, sorted(v)) for fid, v in frags.items())


def lockstep(j, t, sql, check_boundaries=True):
    """Hold one statement (module docstring); -> the port's rows."""
    t0, _ = run(t, sql, fused=False)
    t1, t_modes = run(t, sql, fused=True)
    assert t0[0] == "ok", (sql, t0)
    assert t1 == t0, f"port fused differs from unfused for {sql!r}"
    j1, j_modes = run(j, sql, fused=True)
    assert same_outcome(t1, j1, RTOL, ATOL), (sql, t1[2][:5], j1)
    assert t_modes == j_modes, (sql, t_modes, j_modes)
    if check_boundaries:
        assert boundaries("port", t, sql) == boundaries("jax", j, sql), sql
    return t1[2]


def probe_build_setup():
    """tests/test_fusion_join.py's probe and build tables."""
    rows = []
    for i in range(900):
        k = "NULL" if i % 11 == 7 else str(i % 40)
        rows.append(f"({i},{k},'t{i % 5}',{i % 100},{i % 13}.5)")
    brows = []
    for i in range(180):
        k = "NULL" if i % 13 == 5 else str(i % 55)
        brows.append(f"({k},'n{i % 7}',{i})")
    return ["create table probe (id bigint primary key, k bigint,"
            " tag varchar(8), v bigint, d double)",
            f"insert into probe values {', '.join(rows)}",
            "create table build (k bigint, name varchar(8), w bigint)",
            f"insert into build values {', '.join(brows)}"]
