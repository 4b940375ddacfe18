"""The port's remaining expression functions against the JAX package's,
on the CPU.

The function cases of tests/test_builtins_r5.py and
tests/test_builtins_r6.py that this slice ports (the numeric-to-string
family, `date_add_unit`, `timestampadd`/`timestampdiff`, `makedate`, the
period functions, `bit_count`, `rand`) run through the JAX session and
the port's `Session(device="cpu")`, each on its own engine built by the
same script (`tests/torch_compare.py`), together with `time_bucket`,
`to_datetime` (through datetime arithmetic) and the five row-wise vector
distances.  Added: dates before 1970 for every floor division,
`bit_count` of negatives and INT64_MIN, and `rand(seed)` over a column.

Tolerance: every value is exact except the vector distances, which are
f64 folds of the same f32 inputs in the same order (rtol 1e-12,
atol 1e-12).  `uuid()` is random: it is held by format and
distinctness, as the reference's own test holds it.
"""

import re

import pytest

from torch_compare import (assert_same, reference_env,  # noqa: F401
                           run_step, session)
from torch_scripts import BUILTINS, D_TABLE

pytestmark = pytest.mark.usefixtures("reference_env")

@pytest.mark.parametrize("name", list(BUILTINS))
def test_function_case_equals_reference(name):
    tol = (1e-12, 1e-12) if name == "vector_distances" else (None, None)
    assert_same(BUILTINS[name], *tol)


_UUID = re.compile(r"^[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}"
                   r"-[0-9a-f]{12}$")


def test_uuid_is_a_fresh_v4_uuid_per_row():
    s = session("port")
    for st in D_TABLE:
        s.execute(st)
    got = run_step(s, "select id, uuid() from d order by id")
    assert got[0] == "ok"
    ids = [u for _, u in got[2]]
    assert len(ids) == 6 and len(set(ids)) == 6
    assert all(_UUID.match(u) for u in ids), ids
    again = [u for _, u in s.execute("select id, uuid() from d").rows()]
    assert not set(again) & set(ids)


def test_llm_embed_and_udf_calls_still_raise_not_ported(monkeypatch):
    """llm_embed is ported: without an endpoint both packages raise
    LLMError naming `llm_endpoint`.  A function the port lacks still
    raises EvalError "not yet ported"."""
    from matrixone_tpu_torch.vm import exprs as TE
    from matrixone_tpu_torch.container import dtypes as dt
    from matrixone_tpu_torch.sql.expr import BoundFunc, BoundLiteral
    monkeypatch.delenv("MO_LLM_ENDPOINT", raising=False)
    outs = []
    for pkg in ("jax", "port"):
        s = session(pkg)
        for st in D_TABLE:
            s.execute(st)
        outs.append(run_step(s, "select llm_embed(s) from d"))
    assert outs[0] == outs[1] == ("err", "LLMError")
    e = BoundFunc("no_such_function", [BoundLiteral("x", dt.VARCHAR)],
                  dt.vecf32(4))
    with pytest.raises(TE.EvalError, match="not yet ported"):
        TE._eval_func(e, None)
