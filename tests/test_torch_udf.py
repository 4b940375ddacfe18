"""User-defined functions on the port against the JAX package's, on the
CPU.

The cases of tests/test_udf.py outside the offload, worker, replica and
tenant ones, each run through both packages statement by statement
(`torch_compare.assert_same`: rows, `affected` and the exception's class
name; a `!` step must raise in the reference), with the tier labels that
EXPLAIN prints held equal; then the tier label of every body those cases
define, and a hypothesis test of generated elementwise bodies over the
torch-backed `jnp` (udf/jnp.py) on int64, f64 and f32 columns with NULLs
at every padded length up to 64, through both executors.  The JAX side
runs its per-operator path with its Pallas kernels in interpret mode.
Tolerances: f64 results rtol 1e-12 (1e-9 where a body calls a
transcendental function), f32 rtol 1e-5; tiers, NULL masks and integers
exactly.
"""

import json
import re

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings, strategies as st

from matrixone_tpu.container import device as jdev, dtypes as jdt
from matrixone_tpu.frontend import Session as JSession
from matrixone_tpu.sql import binder as jbinder
from matrixone_tpu.sql.expr import BoundCol as JCol
from matrixone_tpu.storage import engine as jengine, fileservice as jfs
from matrixone_tpu.udf import catalog as jucat, executor as jexec
from matrixone_tpu.utils import metrics as JM
from matrixone_tpu.vm.exprs import ExecBatch as JExecBatch
from matrixone_tpu_torch.container import device as tdev, dtypes as tdt
from matrixone_tpu_torch.frontend import Session as TSession
from matrixone_tpu_torch.sql import binder as tbinder
from matrixone_tpu_torch.sql.expr import BoundCol as TCol
from matrixone_tpu_torch.storage import engine as tengine, \
    fileservice as tfs
from matrixone_tpu_torch.udf import catalog as tucat, executor as texec
from matrixone_tpu_torch.utils import metrics as TM
from matrixone_tpu_torch.vm.exprs import ExecBatch as TExecBatch
from torch_compare import assert_same, reference_env  # noqa: F401
from torch_scripts import (UDF_BINARY, UDF_LEAVES, UDF_REFERENCE_BODIES,
                           UDF_TIER, UDF_UNARY, run_step)

SETUP = ["create table t (a bigint, b double)",
         "insert into t values (1, 1.5), (2, 2.5), (3, 3.5), (4, null)"]


@pytest.fixture(autouse=True)
def _env(reference_env):        # noqa: F811 — the shared fixture
    yield


def mk(name="f", body="x * 2.0 + y", props="", aggregate=False,
       args="(x DOUBLE, y BIGINT)", ret="DOUBLE", replace=False):
    kw = "aggregate function" if aggregate else "function"
    rep = "or replace " if replace else ""
    return (f"create {rep}{kw} {name}{args} returns {ret} "
            f"language python {props} as $$ {body} $$")


def _session(pkg, eng=None):
    if pkg == "jax":
        return JSession() if eng is None else JSession(catalog=eng)
    return TSession(catalog=eng, device="cpu")


def _udf_notes(text: str) -> list:
    return re.findall(r"UdfCall \w+ \[\w+\]", text)


def both(steps, explain=(), rtol=None):
    """`steps` through both packages (SETUP first); each EXPLAIN of
    `explain` must name the same UDF calls and tiers.  -> the port's
    session."""
    got, port = assert_same(SETUP + list(steps), rtol=rtol, atol=0.0)
    for q in explain:
        notes = []
        for pkg in ("jax", "port"):
            s = _session(pkg)
            for st_ in SETUP + [x.lstrip("!") for x in steps]:
                run_step(s, st_)
            notes.append(_udf_notes(s.execute(f"explain {q}").text))
        assert notes[0] == notes[1] and notes[0], (q, notes)
    return port


# ------------------------------------------------------------- surface

def test_scalar_udf_jit_tier_and_nulls():
    both([mk(), "select f(b, a) from t",
          "select a from t where f(b, a) > 5"],
         explain=["select f(b, a) from t"])


def test_udf_arg_coercion_and_arity():
    both([mk(name="sq", body="x * x", args="(x DOUBLE)"),
          "select sq(a) from t where a = 3",
          "!select sq(a, b) from t"])


def test_row_tier_fallback_for_nontraceable_body():
    body = "if x > 2.0:\n    return x * 10.0\nreturn x"
    r0 = {"jax": JM.udf_rows.get(tier="row"),
          "port": TM.udf_rows.get(tier="row")}
    both([mk(name="steppy", args="(x DOUBLE)", body=body),
          "select steppy(b) from t"],
         explain=["select steppy(b) from t"])
    assert JM.udf_rows.get(tier="row") > r0["jax"]
    assert TM.udf_rows.get(tier="row") > r0["port"]


def test_device_fault_in_body_surfaces_and_keeps_the_jit_tier(monkeypatch):
    """Out of memory inside a jit-tier body is the card's failure, not a
    body the tier cannot run: it surfaces, no row loop runs, the cache
    entry keeps its jit tier and the next call takes it.  Torch's text of
    a failed launch counts as such a failure on the card only."""
    import torch
    from matrixone_tpu_torch.udf import jnp as tjnp

    def oom(*_a, **_k):
        raise torch.cuda.OutOfMemoryError(
            "CUDA out of memory. Tried to allocate 1.00 GiB")
    texec.COMPILE_CACHE.clear()
    s = _session("port")
    for st_ in SETUP:
        s.execute(st_)
    s.execute(mk(name="ex1", body="jnp.exp(x)", args="(x DOUBLE)"))
    fails = texec.COMPILE_CACHE.stats()["trace_failures"]
    rows = TM.udf_rows.get(tier="row")
    with monkeypatch.context() as mp:
        mp.setattr(tjnp, "exp", oom)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            s.execute("select ex1(b) from t")
    assert TM.udf_rows.get(tier="row") == rows
    assert texec.COMPILE_CACHE.stats()["trace_failures"] == fails
    assert texec.COMPILE_CACHE.stats()["jit_failed"] == 0
    assert _udf_notes(s.execute("explain select ex1(b) from t").text) \
        == ["UdfCall ex1 [jit]"]
    texec.COMPILE_CACHE.clear()      # the entry compiled the patched exp
    jit = TM.udf_rows.get(tier="jit")
    got = s.execute("select ex1(b) from t where b is not null").rows()
    assert np.allclose([r[0] for r in got], np.exp([1.5, 2.5, 3.5]),
                       rtol=1e-12, atol=0.0)
    assert TM.udf_rows.get(tier="jit") > jit
    launch = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    assert texec._device_fault(launch, torch.device("cuda"))
    assert not texec._device_fault(launch, torch.device("cpu"))
    assert not texec._device_fault(
        RuntimeError("The size of tensor a (4) must match the size of "
                     "tensor b (3)"), torch.device("cuda"))


def test_aggregate_udf_and_limit_offset_order_by():
    both([mk(name="sumsq", body="jnp.sum(x * x)", args="(x DOUBLE)",
             aggregate=True),
          "select sumsq(b) from t", "select sumsq(b) from t where a < 3",
          "!select a, sumsq(b) from t group by a",
          mk(name="tot", body="jnp.sum(x)", args="(x DOUBLE)",
             aggregate=True),
          "select tot(b) from t limit 0",
          "select tot(b) from t limit 5 offset 1",
          "select tot(b) from t limit 5", "!select tot(b) from t order by 1",
          mk(name="p90", body="jnp.percentile(x, 90.0)", args="(x DOUBLE)",
             aggregate=True),
          "select p90(b) from t", "select p90(a) from t where a > 1"],
         explain=["select sumsq(b) from t"], rtol=1e-12)


def test_unbounded_loops_and_overflow_are_clean():
    both(["!" + mk(name="spin", args="(x DOUBLE)",
                   body="while True:\n    pass\nreturn 0.0"),
          mk(name="bigr", body="float(len(range(int(x))))",
             args="(x DOUBLE)", props="properties ('vectorized'='false')"),
          "select bigr(b) from t where a = 1",
          "insert into t values (9, 1e9)",
          "!select bigr(b) from t where a = 9",
          mk(name="toobig", body="2 ** 70", args="(x DOUBLE)",
             ret="BIGINT", props="properties ('vectorized'='false')"),
          "!select toobig(b) from t where a = 1"],
         explain=["select bigr(b) from t"])


def test_jit_tier_casts_to_integers_as_the_reference():
    """A float result into a BIGINT or INT: NaN gives 0 and a value past
    the type's range saturates, as the reference's cast does."""
    both(["insert into t values (5, 5e30), (6, -7.9), (7, 0.0)",
          mk(name="ni", body="jnp.log(x) * 0.0 + x / 0.0",
             args="(x DOUBLE)", ret="BIGINT"),
          mk(name="c32", body="x * 1e9", args="(x DOUBLE)", ret="INT"),
          "select a, ni(b), c32(b) from t order by a"],
         explain=["select ni(b) from t"])


def test_create_or_replace_and_drop():
    both([mk(name="g", body="x + 1.0", args="(x DOUBLE)"),
          "select g(b) from t where a=1",
          "!" + mk(name="g", body="x + 2.0", args="(x DOUBLE)"),
          mk(name="g", body="x + 2.0", args="(x DOUBLE)", replace=True),
          "select g(b) from t where a=1", "show functions",
          "drop function g", "!select g(b) from t", "!drop function g",
          "drop function if exists g",
          # OR REPLACE that only reorders the arguments misses the
          # compile cache: the first parameter is now y
          mk(name="d", body="x - y", args="(x DOUBLE, y DOUBLE)"),
          "select d(b, a) from t where a=2",
          mk(name="d", body="x - y", args="(y DOUBLE, x DOUBLE)",
             replace=True),
          "select d(b, a) from t where a=2"])


def test_row_tier_skips_filtered_rows_and_catalog_is_queryable():
    both(["insert into t values (5, 0.0)",
          mk(name="inv", body="1.0 / x", args="(x DOUBLE)",
             props="properties ('vectorized'='false')"),
          "select inv(b) from t where b <> 0",
          mk(name="q1f", body="x", args="(x DOUBLE)"),
          "select name, kind from system_udf where name = 'q1f'"],
         rtol=1e-12)


def test_sandbox_rejections_and_runtime_errors():
    steps = ["!" + mk(name="evil", body=b, args="(x DOUBLE)") for b in (
        "import os\nreturn 1.0", "().__class__", "open('/etc/passwd')",
        "x.__dict__", "getattr(x, 'foo')",
        "np.fromfile('/etc/passwd', dtype=np.uint8).sum() + x",
        "(x * 0).tofile('/tmp/pwn')\nreturn x",
        "np.lib.format.open_memmap('/tmp/pwn')",
        "jnp.save('/tmp/pwn', x)\nreturn x")]
    steps += ["!" + mk(name="broken", body="x +* 2", args="(x DOUBLE)"),
              "!" + mk(name="abs", body="x", args="(x DOUBLE)"),
              "!" + mk(name="sfn", body="x", args="(x VARCHAR(8))"),
              mk(name="oops", body="x + undefined_name", args="(x DOUBLE)"),
              "!select oops(b) from t"]
    both(steps)
    # the messages name the construct, as the reference's do
    s = TSession(device="cpu")
    for body, msg in (("import os\nreturn 1.0", "Import"),
                      ("x.__dict__", "__dict__"),
                      ("jnp.save('/tmp/pwn', x)\nreturn x", "'save'")):
        with pytest.raises(tbinder.BindError, match=msg):
            s.execute(mk(name="evil", body=body, args="(x DOUBLE)"))


def test_udf_survives_restart_via_wal_and_checkpoint():
    for pkg, eng_mod, fs_mod in (("jax", jengine, jfs),
                                 ("port", tengine, tfs)):
        fs = fs_mod.MemoryFS()
        s = _session(pkg, eng_mod.Engine(fs))
        s.execute("create table r (x double)")
        s.execute("insert into r values (2.0), (3.0)")
        s.execute(mk(name="dbl", body="x * 2.0", args="(x DOUBLE)"))
        eng2 = eng_mod.Engine.open(fs)
        assert _session(pkg, eng2).execute(
            "select dbl(x) from r").rows() == [(4.0,), (6.0,)]
        eng2.checkpoint()
        s3 = _session(pkg, eng_mod.Engine.open(fs))
        assert s3.execute("select dbl(x) from r").rows() == [(4.0,),
                                                              (6.0,)]
        assert any(r[0] == "dbl" for r in
                   s3.execute("show functions").rows())


def test_drop_function_invalidates_cached_plan_and_nondet_bypasses():
    from matrixone_tpu.serving import serving_for as jserving
    from matrixone_tpu_torch.serving import serving_for as tserving
    for pkg, eng_mod, serving_for, M in (
            ("jax", jengine, jserving, JM), ("port", tengine, tserving, TM)):
        eng = eng_mod.Engine()
        s = _session(pkg, eng)
        sv = serving_for(eng)
        sv.plan_cache.enabled = True
        sv.clear()
        s.execute("create table pc (a bigint, b double)")
        s.execute("insert into pc values (1, 2.0)")
        s.execute(mk(name="pf", body="x * 3.0", args="(x DOUBLE)"))
        q = "select pf(b) from pc where a = 1"
        for _ in range(3):
            assert s.execute(q).rows() == [(6.0,)]
        hits0 = M.plan_cache_ops.get(outcome="hit")
        assert s.execute(q).rows() == [(6.0,)]
        assert M.plan_cache_ops.get(outcome="hit") > hits0
        g0 = eng.ddl_gen
        s.execute("drop function pf")
        assert eng.ddl_gen > g0
        with pytest.raises(Exception, match="unknown function"):
            s.execute(q)
        s.execute(mk(name="pf", body="x * 3.0", args="(x DOUBLE)"))
        for _ in range(3):
            assert s.execute(q).rows() == [(6.0,)]
        s.execute(mk(name="pf", body="x * 5.0", args="(x DOUBLE)",
                     replace=True))
        assert s.execute(q).rows() == [(10.0,)]
        # a nondeterministic UDF bypasses the result cache
        sv.result_cache.max_bytes = 16 << 20
        s.execute(mk(name="noisy", args="(x DOUBLE)",
                     body="x + np.random.uniform(0.0, 1e6)",
                     props="properties ('deterministic'='false',"
                           "'vectorized'='false')"))
        vals = {s.execute("select noisy(b) from pc").rows()[0][0]
                for _ in range(4)}
        assert len(vals) > 1
        sv.result_cache.max_bytes = 0
        sv.clear()


def test_mo_ctl_udf_and_explain_analyze():
    s = TSession(device="cpu")
    for st_ in SETUP:
        s.execute(st_)
    s.execute(mk(name="mf", body="x * 2.0", args="(x DOUBLE)"))
    s.execute("select mf(b) from t")
    st_ = json.loads(s.execute("select mo_ctl('udf','status')")
                     .rows()[0][0])
    assert st_["functions"] >= 1 and st_["compile_cache"]["entries"] >= 1
    s.execute("select mo_ctl('udf','clear')")
    assert texec.COMPILE_CACHE.stats()["entries"] == 0
    with pytest.raises(tbinder.BindError, match="unknown udf subcommand"):
        s.execute("select mo_ctl('udf','bogus')")
    s.execute(mk(name="ef", body="x + 0.0", args="(x DOUBLE)"))
    txt = s.execute("explain analyze select ef(b) from t").text
    line = [ln for ln in txt.splitlines() if "UdfCall ef" in ln
            and "rows=" in ln]
    assert line and "rows=4" in line[0], txt


def test_offload_raises_naming_the_transport(monkeypatch):
    s = TSession(device="cpu")
    for st_ in SETUP:
        s.execute(st_)
    s.execute(mk(name="rf", body="x + 1.0", args="(x DOUBLE)"))
    monkeypatch.setenv("MO_UDF_OFFLOAD", "1")
    monkeypatch.setenv("MO_UDF_WORKER", "127.0.0.1:1")
    with pytest.raises(NotImplementedError, match="gRPC"):
        s.execute("select rf(b) from t")


# ------------------------------------------------- the executors directly

PKGS = {
    "jax": dict(dt=jdt, dev=jdev, binder=jbinder, col=JCol,
                ucat=jucat, exec=jexec, batch=JExecBatch),
    "port": dict(dt=tdt, dev=tdev, binder=tbinder, col=TCol,
                 ucat=tucat, exec=texec, batch=TExecBatch)}
ARGS = (("x", "INT64", "a"), ("y", "FLOAT64", "b"), ("z", "FLOAT32", "c"))


def _columns(n: int, seed: int):
    rng = np.random.default_rng(seed)
    a = rng.integers(-50, 50, n).astype(np.int64)
    b = np.round(rng.normal(0, 3, n), 3)
    c = np.round(rng.normal(0, 2, n), 2).astype(np.float32)
    valid = {k: rng.random(n) > 0.2 for k in "abc"}
    return {"a": a, "b": b, "c": c}, valid


def run_executor(pkg: str, body: str, n: int, pad: int, seed: int):
    """One call of `pkg`'s eval_udf_call over a batch of n rows padded to
    `pad` -> (values, validity, tier)."""
    P = PKGS[pkg]
    arrays, valid = _columns(n, seed)
    dtypes = {nm: getattr(P["dt"], t) for _a, t, nm in ARGS}
    kw = {"device": "cpu"} if pkg == "port" else {}
    db = P["dev"].from_numpy(arrays, dtypes, valid, n_rows=n, pad_to=pad,
                             **kw)
    ex = P["batch"](batch=db, dicts={}, mask=db.row_mask())
    u = P["ucat"].UdfMeta("g", "scalar", [a for a, _t, _n in ARGS],
                          [dtypes[nm] for _a, _t, nm in ARGS],
                          P["dt"].FLOAT64, "python", body, True, True)
    call = P["binder"]._bind_udf_call(
        u, [P["col"](nm, dtypes[nm]) for _a, _t, nm in ARGS])
    col = P["exec"].eval_udf_call(call, ex)
    tier = P["exec"].expected_tier(call)
    return np.asarray(col.data)[:n], np.asarray(col.validity)[:n], tier


def assert_executors_agree(body: str, n: int, pad: int, seed: int = 0):
    """-> the tier both took, or "error" when both raised the same
    class."""
    try:
        got = run_executor("port", body, n, pad, seed)
    except Exception as e:   # noqa: BLE001 — then the reference must too
        with pytest.raises(Exception) as ref:
            run_executor("jax", body, n, pad, seed)
        assert type(ref.value).__name__ == type(e).__name__, (body, e,
                                                              ref.value)
        return "error"
    want = run_executor("jax", body, n, pad, seed)
    assert got[2] == want[2], (body, got[2], want[2])
    assert np.array_equal(got[1], want[1]), body
    v = want[1]
    rtol = (1e-5 if "z" in body else
            1e-9 if re.search(r"exp|log|sqrt|tanh|sin|cos", body)
            else 1e-12)
    np.testing.assert_allclose(got[0][v], want[0][v], rtol=rtol,
                               atol=1e-300 if rtol < 1e-5 else 1e-6,
                               equal_nan=True, err_msg=body)
    return got[2]


@pytest.mark.parametrize("body", UDF_REFERENCE_BODIES)
def test_reference_bodies_take_the_reference_tier(body):
    assert assert_executors_agree(body, 7, 16, seed=3) in ("jit", "row",
                                                           "error")


def test_every_padded_length_up_to_64():
    body = "jnp.where(x > 0, jnp.sqrt(y * y + 1.0), -x) + y // 2.0 - x % 3"
    for pad in range(1, 65):
        assert assert_executors_agree(body, (pad * 5) // 7, pad,
                                      seed=pad) == "jit"


def test_shim_dtypes_match_jax_x64():
    """The shim's result dtypes against JAX's with x64 on, for the
    operations whose torch defaults differ."""
    import jax.numpy as jnp_ref
    import torch

    from matrixone_tpu_torch.udf import jnp as shim
    cols = {"int32": np.array([1, -2, 3], np.int32),
            "int64": np.array([1, -2, 3], np.int64),
            "float32": np.array([1.5, -2., 3.], np.float32),
            "float64": np.array([1.5, -2., 3.]),
            "bool": np.array([True, False, True])}
    ops = {
        "div": lambda m, x: x / x, "mul_f": lambda m, x: x * 2.0,
        "add_i": lambda m, x: x + 1, "sqrt": lambda m, x: m.sqrt(x),
        "exp": lambda m, x: m.exp(x), "sum": lambda m, x: m.sum(x),
        "mean": lambda m, x: m.mean(x), "floordiv": lambda m, x: x // 2,
        "mod": lambda m, x: x % 3, "where_w": lambda m, x:
            m.where(x > 0, 1, 0) * x, "isnan": lambda m, x: m.isnan(x),
        "round_py": lambda m, x: round(x), "minimum": lambda m, x:
            m.minimum(x, 1.5), "clip": lambda m, x: m.clip(x, 0, 2),
        "abs": lambda m, x: m.abs(x), "pow2": lambda m, x: x ** 2,
        "powf": lambda m, x: x ** 0.5}
    for cname, arr in cols.items():
        for oname, op in ops.items():
            try:
                want = op(jnp_ref, jnp_ref.asarray(arr))
            except Exception as e:   # noqa: BLE001 — both must refuse
                with pytest.raises(Exception):
                    op(shim, shim.Array(torch.from_numpy(arr)))
                continue
            got = op(shim, shim.Array(torch.from_numpy(arr)))
            assert str(got.dtype) == str(want.dtype), (cname, oname,
                                                       got.dtype,
                                                       want.dtype)
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-6, err_msg=(cname, oname))


# ------------------------------------------------------------ hypothesis

def _exprs():
    return st.recursive(
        st.sampled_from(UDF_LEAVES),
        lambda inner: st.one_of(
            st.builds(lambda f, e: f.format(e), st.sampled_from(UDF_UNARY),
                      inner),
            st.builds(lambda f, a, b: f.format(a, b),
                      st.sampled_from(UDF_BINARY), inner, inner)),
        max_leaves=6)


@settings(max_examples=30, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(expr=_exprs(), wrap=st.sampled_from(UDF_TIER),
       pad=st.integers(1, 64), seed=st.integers(0, 1 << 16))
def test_generated_bodies_agree(expr, wrap, pad, seed):
    body = wrap.format(expr)
    tier = assert_executors_agree(body, pad - pad // 4, pad, seed)
    assert tier in ("error", "jit" if wrap == "{}" else "row"), (body, tier)
