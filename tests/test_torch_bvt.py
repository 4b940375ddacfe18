"""The BVT golden-SQL corpus (`tests/bvt/cases`) through the port.

Each case runs on a fresh port `Session(device="cpu")`, as
`tests/test_bvt.py` runs it through the JAX package's session, and its
output must equal the committed `.result` golden byte for byte.  The
statement splitter and the result formatter are the JAX package's
(`matrixone_tpu.utils.bvt`, host-only code); the loop is written here so
that a `-- @tpch` directive loads the port's `tpch_full.load_tpch` and a
`-- @session name` directive opens a second port session on the same
engine.

A case the port cannot pass yet is a strict xfail that names the
ROADMAP.md section A step that unblocks it and the first line where its
output differs: the slice that ports the step must take the mark away.
"""

from __future__ import annotations

import difflib
import os

import pytest

from matrixone_tpu.utils import bvt
from matrixone_tpu_torch.frontend import Session

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bvt",
                    "cases")
CASES = bvt.iter_cases(ROOT)

_ACCOUNTS = ("account_lifecycle", "cross_tenant_access_denied",
             "dml_privileges", "drop_account_cleans_tables",
             "grant_create_priv", "grant_revoke_select", "isolation_tables",
             "nonadmin_cannot_manage", "role_stacking",
             "show_processlist_scoped")
_ACCOUNTS2 = ("drop_user_role", "revoke_priv", "show_grants",
              "sys_only_accounts")
_PARQUET = "no step: not queued, parquet needs pyarrow, which the card lacks"
#: case -> why the port does not give its golden yet: the ROADMAP.md
#: section A step, and the first differing line with the statement or
#: reader the port does not have there
XFAIL = {
    "errors2/iceberg_errors": "step 5; line 5: the iceberg reader",
    "load/external_parquet": f"{_PARQUET}; line 5: the parquet reader",
    "load/parquet_basic": f"{_PARQUET}; line 5: the parquet reader",
    "pubstage/publication_lifecycle": "step 5; line 8: ShowPublications",
    "stream2/dynamic_table_refresh": "step 5; line 8: CreateDynamicTable",
    "stream2/source_table_ddl": "step 5; line 2: CreateSource",
    **{f"tenant/{c}": "step 5; line 2: CreateAccount" for c in _ACCOUNTS},
    **{f"tenant2/{c}": "step 5; line 2: CreateAccount" for c in _ACCOUNTS2},
}


def _rel(p):
    return os.path.relpath(p, ROOT)[:-4]


def run_case(text: str) -> str:
    """The port's run of one case, in `bvt.run_case`'s output format."""
    from matrixone_tpu_torch.utils.tpch_full import load_tpch
    base = Session(device="cpu")
    sessions = {"default": base}
    cur = base
    out = []
    try:
        for item in bvt.split_statements(text):
            if isinstance(item, tuple) and item[0] == "tpch":
                load_tpch(base.catalog, sf=item[1], seed=0)
                out += [f"-- @tpch {item[1]}", ""]
                continue
            if isinstance(item, tuple) and item[0] == "session":
                _k, name, login = item
                out.append(f"-- @session {name}"
                           + (f" {login}" if login else ""))
                if login is not None:
                    # the case ends here: logins need accounts
                    out.append("ERROR NotImplementedError: accounts are "
                               "not ported yet (ROADMAP.md, section A, "
                               "step 5)")
                    break
                if name not in sessions:
                    sessions[name] = Session(catalog=base.catalog,
                                             device="cpu")
                cur = sessions[name]
                out.append("")
                continue
            out.append("> " + " ".join(item.split()))
            try:
                out.extend(bvt._fmt_result(cur.execute(item)))
            except Exception as e:       # noqa: BLE001 (errors are golden)
                msg = " ".join(str(e).split())
                out.append(f"ERROR {type(e).__name__}: {msg}")
            out.append("")
    finally:
        for s in sessions.values():
            s.close()
    return "\n".join(out).rstrip() + "\n"


def _params():
    for c in CASES:
        rel = _rel(c)
        marks = ([pytest.mark.xfail(reason=XFAIL[rel], strict=True)]
                 if rel in XFAIL else [])
        yield pytest.param(c, id=rel, marks=marks)


@pytest.mark.parametrize("case", list(_params()))
def test_bvt_case_on_port(case):
    with open(case) as f:
        text = f.read()
    with open(case[:-4] + ".result") as f:
        golden = f.read()
    got = run_case(text)
    if got != golden:
        diff = "\n".join(difflib.unified_diff(
            golden.splitlines(), got.splitlines(), "golden", "port",
            lineterm=""))
        raise AssertionError(f"BVT mismatch for {_rel(case)}:\n{diff}")


def test_xfail_list_names_real_cases():
    """Every strict xfail names a case of the corpus and its ROADMAP
    step, so a renamed case cannot leave a stale mark behind."""
    rels = {_rel(c) for c in CASES}
    assert set(XFAIL) <= rels, sorted(set(XFAIL) - rels)
    assert all("step" in why for why in XFAIL.values())
