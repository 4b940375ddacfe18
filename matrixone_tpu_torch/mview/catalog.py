"""Materialized-view catalog: the `system_mview` table and the registry
derived from it.

The port of `matrixone_tpu/mview/catalog.py`: definitions live in an
ordinary MVCC table, so durability and restart replay ride the commit
and WAL funnels that already exist.  The in-memory registry is a cache
derived from the table and keyed by its version: any commit invalidates
it.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, List, Optional

import numpy as np

from matrixone_tpu_torch.container import dtypes as dt

MVIEW_TABLE = "system_mview"

_SCHEMA = [
    ("name", dt.varchar(128)),
    ("sql", dt.TEXT),                  # the defining SELECT, verbatim
    ("mode", dt.varchar(16)),          # 'incremental' | 'full'
    ("source", dt.varchar(128)),       # single-table source ('' for full)
    ("created_ts", dt.INT64),
]


@dataclasses.dataclass
class MViewDef:
    name: str
    sql: str
    mode: str                          # 'incremental' | 'full'
    source: str                        # source table name ('' when full)
    created_ts: int = 0

    @property
    def def_hash(self) -> str:
        """Content key of the definition: the delta step cache and the
        runtime state key on it, so a drop and re-create under the same
        name never serves the old definition's state or steps."""
        return hashlib.sha1(
            f"{self.name}|{self.mode}|{self.sql}".encode()).hexdigest()


def table_meta():
    from matrixone_tpu_torch.storage.engine import TableMeta
    return TableMeta(MVIEW_TABLE, list(_SCHEMA), ["name"])


def ensure_table(catalog) -> None:
    if MVIEW_TABLE not in catalog.tables:
        catalog.create_table(table_meta(), if_not_exists=True)


def is_mview_table(name: str) -> bool:
    """True for the catalog table and an account's `acct$system_mview`."""
    return name == MVIEW_TABLE or name.endswith("$" + MVIEW_TABLE)


# ------------------------------------------------------------- registry

def _table_version(t) -> tuple:
    return (t.last_commit_ts, len(t.segments), len(t.tombstones))


def scan_rows(t, schema) -> List[dict]:
    """Every visible row of a small catalog table as {column: value}
    (strings decoded, integers as int, NULL as None)."""
    cols = [c for c, _ in schema]
    rows: List[dict] = []
    for arrays, validity, dicts, n in t.iter_chunks(cols, 1 << 16):
        for i in range(n):
            row = {}
            for c, d in schema:
                if not validity[c][i]:
                    row[c] = None
                elif d.is_varlen:
                    row[c] = dicts[c][int(arrays[c][i])]
                else:
                    row[c] = int(arrays[c][i])
            rows.append(row)
    return rows


def gids_named(t, name: str) -> np.ndarray:
    """Global row ids of a catalog table's rows whose `name` is `name`
    (case-insensitive): the delete side of DROP and OR REPLACE."""
    from matrixone_tpu_torch.storage.engine import ROWID
    out = []
    for arrays, validity, dicts, n in t.iter_chunks([ROWID, "name"],
                                                    1 << 16):
        d = dicts["name"]
        for i in range(n):
            if validity["name"][i] and \
                    d[int(arrays["name"][i])].lower() == name.lower():
                out.append(int(arrays[ROWID][i]))
    return np.asarray(out, np.int64)


def registry_for(catalog) -> Dict[str, MViewDef]:
    """name -> MViewDef for every view in `catalog`, cached on the
    catalog table and invalidated by its version."""
    tables = getattr(catalog, "tables", None)
    if tables is None or MVIEW_TABLE not in tables:
        return {}
    t = catalog.get_table(MVIEW_TABLE)
    version = _table_version(t)
    cached = getattr(t, "_mview_registry", None)
    if cached is not None and cached[0] == version:
        return cached[1]
    reg: Dict[str, MViewDef] = {}
    for row in scan_rows(t, _SCHEMA):
        if row["name"] is None:
            continue              # malformed row: never poison binds
        d = MViewDef(name=row["name"], sql=row["sql"] or "",
                     mode=row["mode"] or "full", source=row["source"] or "",
                     created_ts=row["created_ts"] or 0)
        reg[d.name.lower()] = d
    t._mview_registry = (version, reg)
    return reg


def lookup(catalog, name: str) -> Optional[MViewDef]:
    return registry_for(catalog).get(name.lower())


def gids_for_name(catalog, name: str) -> np.ndarray:
    """Global row ids of the view's catalog row(s) (DROP)."""
    return gids_named(catalog.get_table(MVIEW_TABLE), name)


def row_batch(d: MViewDef, created_ts: int):
    """One-row host Batch: the insert side of CREATE MATERIALIZED VIEW."""
    from matrixone_tpu_torch.container.batch import Batch
    vals = {"name": [d.name.lower()], "sql": [d.sql], "mode": [d.mode],
            "source": [d.source], "created_ts": [int(created_ts)]}
    return Batch.from_pydict(vals, dict(_SCHEMA))
