"""UDF catalog: the `system_udf` table and the registry derived from it
(the port's copy of `matrixone_tpu/udf/catalog.py`).

Reference analogue: MatrixOne's `mo_user_defined_function` catalog table
(frontend CREATE FUNCTION writes a row; the planner resolves calls
against it). Same shape here: definitions live in an ordinary MVCC table,
so durability and restart replay ride the commit and WAL funnels that
already exist — no parallel persistence path to drift.

The in-memory registry is a cache DERIVED from the table, keyed by the
table's version (last_commit_ts, segments, tombstones): any commit,
local or replayed, invalidates it.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, List, Optional

import numpy as np

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.dtypes import DType
from matrixone_tpu_torch.udf.sandbox import UdfError, compile_body

UDF_TABLE = "system_udf"

_SCHEMA = [
    ("name", dt.varchar(128)),
    ("kind", dt.varchar(16)),          # 'scalar' | 'aggregate'
    ("arg_names", dt.TEXT),            # json: ["x", "y"]
    ("arg_types", dt.TEXT),            # json: [[oid,width,scale,dim],...]
    ("ret_type", dt.TEXT),             # json: [oid,width,scale,dim]
    ("language", dt.varchar(16)),
    ("body", dt.TEXT),
    ("deterministic", dt.INT64),
    ("vectorized", dt.INT64),
    ("created_ts", dt.INT64),
]

#: SQL types a UDF argument/result may use: the dialect is numeric
#: jax.numpy over columns — decimals (scaled-int storage would leak into
#: the body) and varchars (dictionary codes would) are rejected at CREATE
_NUMERIC_OIDS = frozenset({
    dt.TypeOid.BOOL, dt.TypeOid.INT8, dt.TypeOid.INT16, dt.TypeOid.INT32,
    dt.TypeOid.INT64, dt.TypeOid.FLOAT32, dt.TypeOid.FLOAT64,
})


@dataclasses.dataclass
class UdfMeta:
    name: str
    kind: str                        # 'scalar' | 'aggregate'
    arg_names: List[str]
    arg_types: List[DType]
    ret_type: DType
    language: str
    body: str
    deterministic: bool
    vectorized: bool
    created_ts: int = 0

    @property
    def body_hash(self) -> str:
        # arg_names participate: OR REPLACE that only reorders/renames
        # same-typed arguments must MISS the compile cache (the compiled
        # function binds arguments positionally by these names)
        return hashlib.sha1(
            f"{self.name}|{','.join(self.arg_names)}|{self.body}"
            .encode()).hexdigest()

    def signature(self) -> str:
        args = ", ".join(f"{n} {t}" for n, t in
                         zip(self.arg_names, self.arg_types))
        return f"{self.name}({args}) returns {self.ret_type}"


def _dtype_json(d: DType) -> list:
    return [d.oid.value, d.width, d.scale, d.dim]


def _dtype_from(v: list) -> DType:
    return DType(dt.TypeOid(v[0]), width=v[1], scale=v[2], dim=v[3])


_RESERVED: Optional[frozenset] = None


def reserved_function_names() -> frozenset:
    """Builtin surface a UDF must not shadow: kernel names, aggregates,
    window functions, and the binder's sugar rewrites. Computed once —
    this sits on the per-FuncCall bind path."""
    global _RESERVED
    if _RESERVED is not None:
        return _RESERVED
    from matrixone_tpu_torch.sql import binder as B
    from matrixone_tpu_torch.sql.parser import AGG_FUNCS
    sugar = {
        "pi", "version", "connection_id", "last_insert_id", "user",
        "current_user", "session_user", "system_user", "database",
        "schema", "now", "current_timestamp", "sysdate",
        "localtimestamp", "utc_timestamp", "curdate", "current_date",
        "utc_date", "curtime", "current_time", "log", "llm_embed",
        "llm_chat", "hex", "timestampadd", "timestampdiff", "adddate",
        "subdate", "char", "maketime", "if", "ifnull", "nullif",
        "isnull", "load_file", "date_add", "date_sub", "mo_ctl",
        "match", "match_against", "sample", "rand", "uuid",
    }
    _RESERVED = frozenset(set(B._SCALAR_FUNCS) | set(AGG_FUNCS)
                          | set(B.WINDOW_ONLY_FUNCS) | sugar)
    return _RESERVED


def validate_meta(u: UdfMeta) -> None:
    """CREATE-time validation: name, types, and a trial sandbox compile
    so a broken body errors at CREATE, not at first call."""
    if not u.name.isidentifier() or u.name.startswith("_"):
        raise UdfError(f"bad function name {u.name!r}")
    if u.name.lower() in reserved_function_names():
        raise UdfError(
            f"function name {u.name!r} shadows a builtin function")
    if u.language.lower() != "python":
        raise UdfError(f"unsupported LANGUAGE {u.language!r}; "
                       f"only PYTHON is implemented")
    if u.kind not in ("scalar", "aggregate"):
        raise UdfError(f"bad function kind {u.kind!r}")
    if len(u.arg_names) != len(set(u.arg_names)):
        raise UdfError(f"udf {u.name!r}: duplicate argument names")
    for t in list(u.arg_types) + [u.ret_type]:
        if t.oid not in _NUMERIC_OIDS:
            raise UdfError(
                f"udf {u.name!r}: type {t} is not supported; UDF "
                f"arguments and results must be numeric or bool")
    compile_body(u.name, u.body, u.arg_names)


# ---------------------------------------------------------------- table

def table_meta():
    from matrixone_tpu_torch.storage.engine import TableMeta
    return TableMeta(UDF_TABLE, list(_SCHEMA), ["name"])


def ensure_table(catalog) -> None:
    """Create system_udf if absent."""
    if UDF_TABLE not in catalog.tables:
        catalog.create_table(table_meta(), if_not_exists=True)


def is_udf_table(name: str) -> bool:
    """True for the catalog table and an account's `acct$system_udf`."""
    return name == UDF_TABLE or name.endswith("$" + UDF_TABLE)


# ------------------------------------------------------------- registry

def _table_version(t) -> tuple:
    return (t.last_commit_ts, len(t.segments), len(t.tombstones))


def _has_udf_table(catalog) -> bool:
    """Cheap existence check: this sits on the per-FuncCall bind path."""
    tables = getattr(catalog, "tables", None)
    return tables is not None and UDF_TABLE in tables


def registry_for(catalog) -> Dict[str, UdfMeta]:
    """name -> UdfMeta for every function visible through `catalog`.
    Cached on the underlying table object, invalidated by version."""
    if not _has_udf_table(catalog):
        return {}
    from matrixone_tpu_torch.mview.catalog import scan_rows
    t = catalog.get_table(UDF_TABLE)
    version = _table_version(t)
    cached = getattr(t, "_udf_registry", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    reg: Dict[str, UdfMeta] = {}
    for row in scan_rows(t, _SCHEMA):
        try:
            u = UdfMeta(
                name=row["name"], kind=row["kind"] or "scalar",
                arg_names=list(json.loads(row["arg_names"] or "[]")),
                arg_types=[_dtype_from(x) for x in
                           json.loads(row["arg_types"] or "[]")],
                ret_type=_dtype_from(json.loads(row["ret_type"])),
                language=row["language"] or "python",
                body=row["body"] or "",
                deterministic=bool(row["deterministic"]),
                vectorized=bool(row["vectorized"]),
                created_ts=row["created_ts"] or 0)
        except (KeyError, TypeError, ValueError):
            continue          # malformed row: skip, never poison binds
        reg[u.name.lower()] = u
    t._udf_registry = (version, reg)
    return reg


def lookup(catalog, name: str) -> Optional[UdfMeta]:
    low = name.lower()
    if low in reserved_function_names():
        return None               # builtins always win
    return registry_for(catalog).get(low)


def gids_for_name(catalog, name: str) -> np.ndarray:
    """Global row ids of the function's row(s) (DROP / OR REPLACE)."""
    from matrixone_tpu_torch.mview.catalog import gids_named
    return gids_named(catalog.get_table(UDF_TABLE), name)


def row_batch(u: UdfMeta, created_ts: int):
    """One-row host Batch for the insert side of CREATE FUNCTION."""
    from matrixone_tpu_torch.container.batch import Batch
    vals = {
        "name": [u.name.lower()], "kind": [u.kind],
        "arg_names": [json.dumps(u.arg_names)],
        "arg_types": [json.dumps([_dtype_json(t) for t in u.arg_types])],
        "ret_type": [json.dumps(_dtype_json(u.ret_type))],
        "language": [u.language.lower()], "body": [u.body],
        "deterministic": [int(u.deterministic)],
        "vectorized": [int(u.vectorized)],
        "created_ts": [int(created_ts)],
    }
    return Batch.from_pydict(vals, dict(_SCHEMA))


# ---------------------------------------------------- serving integration

def nondet_names(catalog) -> frozenset:
    """Names of registered NON-deterministic UDFs — fed to statement
    normalization so their statements bypass the plan/result caches the
    same way now()/rand() do."""
    return frozenset(n for n, u in registry_for(catalog).items()
                     if not u.deterministic)


def sync_serving(catalog, state) -> None:
    """Keep the serving plan-cache's dynamic nondet set in step with the
    registry (cheap: registry_for is version-cached)."""
    try:
        names = nondet_names(catalog)
    except Exception:       # noqa: BLE001 — registry unreadable: caches
        return              # simply see no UDF nondet names this round
    state.plan_cache.set_dynamic_nondet(names)
