"""SQL AST (reference: pkg/sql/parsers/tree — redesigned, minimal dataclasses).

The reference generates its parser from a 15k-line goyacc grammar
(`parsers/dialect/mysql/mysql_sql.y`); this project uses a hand-written
recursive-descent parser over a small AST — the grammar subset grows with
the engine instead of importing MySQL's full surface up front.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple


class Node:
    pass


# ----------------------------------------------------------------- exprs

@dataclasses.dataclass
class Literal(Node):
    value: object            # int | float | str | bool | None
    kind: str                # 'int' | 'float' | 'str' | 'bool' | 'null'


@dataclasses.dataclass
class DateLiteral(Node):
    days: int                # days since unix epoch


@dataclasses.dataclass
class IntervalLiteral(Node):
    value: int
    unit: str                # 'day' | 'month' | 'year'


@dataclasses.dataclass
class ColumnRef(Node):
    name: str
    table: Optional[str] = None


@dataclasses.dataclass
class BinaryOp(Node):
    op: str                  # + - * / % and or = != < <= > >= like
    left: Node
    right: Node


@dataclasses.dataclass
class UnaryOp(Node):
    op: str                  # - not
    operand: Node


@dataclasses.dataclass
class WindowSpec(Node):
    partition_by: List[Node] = dataclasses.field(default_factory=list)
    order_by: List["OrderItem"] = dataclasses.field(default_factory=list)
    #: explicit frame: ("rows", lo, hi) with bounds
    #: ("unbounded_preceding"|"unbounded_following"|"current"|
    #:  "preceding"|"following", k_or_None); None = SQL default frame
    frame: Optional[tuple] = None


@dataclasses.dataclass
class FuncCall(Node):
    name: str
    args: List[Node]
    distinct: bool = False
    star: bool = False       # count(*)
    window: Optional[WindowSpec] = None   # fn(...) OVER (...)


@dataclasses.dataclass
class Cast(Node):
    expr: Node
    type_name: str
    type_args: Tuple[int, ...] = ()


@dataclasses.dataclass
class Case(Node):
    whens: List[Tuple[Node, Node]]
    else_: Optional[Node]


@dataclasses.dataclass
class InList(Node):
    expr: Node
    items: List[Node]
    negated: bool = False


@dataclasses.dataclass
class Between(Node):
    expr: Node
    low: Node
    high: Node
    negated: bool = False


@dataclasses.dataclass
class IsNull(Node):
    expr: Node
    negated: bool = False


@dataclasses.dataclass
class Star(Node):
    table: Optional[str] = None


@dataclasses.dataclass
class Subquery(Node):
    select: "Select"


@dataclasses.dataclass
class Exists(Node):
    select: "Select"
    negated: bool = False


@dataclasses.dataclass
class Param(Node):
    index: int               # ? placeholders for prepared statements


@dataclasses.dataclass
class SysVar(Node):
    name: str                # @@name (session scope)


@dataclasses.dataclass
class ShowVariables(Node):
    like: Optional[str] = None


# ------------------------------------------------------------ statements

@dataclasses.dataclass
class SelectItem(Node):
    expr: Node
    alias: Optional[str] = None


@dataclasses.dataclass
class TableRef(Node):
    name: str
    alias: Optional[str] = None
    snapshot: Optional[str] = None       # AS OF SNAPSHOT 'name'
    as_of_ts: Optional[int] = None       # AS OF TIMESTAMP <hlc>


@dataclasses.dataclass
class SubqueryRef(Node):
    select: "Select"
    alias: str


@dataclasses.dataclass
class Join(Node):
    kind: str                # 'inner' | 'left' | 'right' | 'full' | 'cross'
    left: Node
    right: Node
    on: Optional[Node] = None


@dataclasses.dataclass
class SampleRef(Node):
    """FROM t SAMPLE n ROWS | SAMPLE p PERCENT (colexec/sample analogue)."""
    child: Node
    value: float
    unit: str                # 'rows' | 'percent'


@dataclasses.dataclass
class OrderItem(Node):
    expr: Node
    descending: bool = False


@dataclasses.dataclass
class Select(Node):
    items: List[SelectItem]
    from_: Optional[Node] = None
    where: Optional[Node] = None
    group_by: List[Node] = dataclasses.field(default_factory=list)
    having: Optional[Node] = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    distinct: bool = False
    ctes: List[Tuple[str, "Select"]] = dataclasses.field(
        default_factory=list)          # WITH name AS (select ...)
    semijoins: List["SemiJoinSpec"] = dataclasses.field(
        default_factory=list)          # decorrelated EXISTS predicates
    # GROUP BY ... FILL(PREV | LINEAR | VALUE, x): (mode, const_or_None)
    fill: Optional[Tuple[str, Optional[float]]] = None


@dataclasses.dataclass
class SemiJoinSpec(Node):
    """A decorrelated [NOT] EXISTS: semi/anti-join the outer plan against
    `select` on outer_keys[i] = the i-th projected column of `select`;
    `residual` (if any) references outer columns + projected residual
    columns of `select` and must hold for a pair to count as a match."""
    select: "Select"
    outer_keys: List[Node]
    n_keys: int
    residual: Optional[Node]
    negated: bool
    alias: str               # unique tag; projected cols are {alias}_k{i}


@dataclasses.dataclass
class Union(Node):
    selects: List["Select"]
    alls: List[bool]         # alls[i]: UNION ALL between selects[i], [i+1]
    order_by: List["OrderItem"] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None


@dataclasses.dataclass
class ColumnDef(Node):
    name: str
    type_name: str
    type_args: Tuple[int, ...] = ()
    not_null: bool = False
    primary_key: bool = False
    default: Optional[Node] = None
    auto_increment: bool = False


@dataclasses.dataclass
class CreateTable(Node):
    name: str
    columns: List[ColumnDef]
    primary_key: List[str] = dataclasses.field(default_factory=list)
    if_not_exists: bool = False
    # raw PARTITION BY parse: {"kind":"hash","column",...,"n"} |
    # {"kind":"range","column",...,"parts":[(name, bound|None), ...]}
    partition_by: Optional[dict] = None


@dataclasses.dataclass
class DropTable(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class CreateIndex(Node):
    name: str
    table: str
    columns: List[str]
    using: Optional[str] = None          # 'ivfflat' | 'hnsw' | 'fulltext' ...
    options: dict = dataclasses.field(default_factory=dict)  # lists=..., op_type=...


@dataclasses.dataclass
class Insert(Node):
    table: str
    columns: List[str]
    rows: Optional[List[List[Node]]] = None   # VALUES
    select: Optional[Select] = None           # INSERT ... SELECT


@dataclasses.dataclass
class Delete(Node):
    table: str
    where: Optional[Node] = None


@dataclasses.dataclass
class Update(Node):
    table: str
    assignments: List[Tuple[str, Node]]
    where: Optional[Node] = None


@dataclasses.dataclass
class Explain(Node):
    stmt: Node
    analyze: bool = False


@dataclasses.dataclass
class ShowTables(Node):
    pass


@dataclasses.dataclass
class CreateSnapshot(Node):
    name: str


@dataclasses.dataclass
class DropSnapshot(Node):
    name: str


@dataclasses.dataclass
class ShowSnapshots(Node):
    pass


@dataclasses.dataclass
class ShowTrace(Node):
    """SHOW TRACE — recent motrace span trees (utils/motrace.py)."""
    pass


@dataclasses.dataclass
class ShowAccounts(Node):
    pass


@dataclasses.dataclass
class RestoreTable(Node):
    table: str
    snapshot: str


@dataclasses.dataclass
class ShowCreateTable(Node):
    name: str


@dataclasses.dataclass
class ShowColumns(Node):
    name: str


@dataclasses.dataclass
class ShowIndexes(Node):
    name: str


@dataclasses.dataclass
class AnalyzeTable(Node):
    name: str


@dataclasses.dataclass
class AlterPartition(Node):
    table: str
    action: str              # 'truncate' | 'drop'
    part: str


@dataclasses.dataclass
class ShowPartitions(Node):
    name: str


@dataclasses.dataclass
class ShowProcesslist(Node):
    pass


@dataclasses.dataclass
class Kill(Node):
    conn_id: int
    query_only: bool = False     # KILL QUERY id vs KILL id (connection)


@dataclasses.dataclass
class LoadData(Node):
    path: str                    # local path | file:// | fs:// | stage://
    table: str
    fmt: str                     # 'csv' | 'parquet' (from suffix if '')


@dataclasses.dataclass
class CreateStage(Node):
    name: str
    url: str


@dataclasses.dataclass
class DropStage(Node):
    name: str


@dataclasses.dataclass
class ShowStages(Node):
    pass


@dataclasses.dataclass
class CreateExternalTable(Node):
    name: str
    columns: List["ColumnDef"]
    location: str
    fmt: str
    snapshot: Optional[int] = None   # iceberg time travel


@dataclasses.dataclass
class CreatePublication(Node):
    name: str
    tables: List[str]


@dataclasses.dataclass
class DropPublication(Node):
    name: str


@dataclasses.dataclass
class ShowPublications(Node):
    pass


@dataclasses.dataclass
class CreateSource(Node):
    name: str
    columns: List["ColumnDef"]


@dataclasses.dataclass
class CreateDynamicTable(Node):
    name: str
    select: Node
    sql_text: str            # the defining SELECT, verbatim (re-run on
                             # every refresh)


@dataclasses.dataclass
class RefreshDynamicTable(Node):
    name: str


@dataclasses.dataclass
class CreateMaterializedView(Node):
    """CREATE MATERIALIZED VIEW name AS SELECT ... — persisted in the
    system_mview catalog; maintainable shapes update incrementally from
    commit deltas, the rest full-refresh (matrixone_tpu/mview)."""
    name: str
    select: Node
    sql_text: str            # the defining SELECT, verbatim


@dataclasses.dataclass
class DropMaterializedView(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class ShowMaterializedViews(Node):
    pass


@dataclasses.dataclass
class RefreshMaterializedView(Node):
    name: str


@dataclasses.dataclass
class CreateFunction(Node):
    """CREATE [OR REPLACE] [AGGREGATE] FUNCTION f(x FLOAT, ...)
    RETURNS FLOAT LANGUAGE PYTHON [PROPERTIES ('k'='v', ...)]
    AS $$ body $$ (reference: mo_user_defined_function DDL)."""
    name: str
    args: List[Tuple[str, str, Tuple[int, ...]]]  # (name, type, targs)
    ret_type: str
    ret_args: Tuple[int, ...]
    language: str
    body: str
    properties: dict = dataclasses.field(default_factory=dict)
    or_replace: bool = False
    aggregate: bool = False


@dataclasses.dataclass
class DropFunction(Node):
    name: str
    if_exists: bool = False


@dataclasses.dataclass
class ShowFunctions(Node):
    pass


@dataclasses.dataclass
class SetVariable(Node):
    name: str
    value: Node


# ---- accounts / users / roles / privileges (frontend/authenticate.go)
@dataclasses.dataclass
class CreateAccount(Node):
    name: str
    admin_user: str
    admin_password: str
    if_not_exists: bool = False


@dataclasses.dataclass
class DropAccount(Node):
    name: str


@dataclasses.dataclass
class CreateUser(Node):
    name: str
    password: str
    if_not_exists: bool = False


@dataclasses.dataclass
class DropUser(Node):
    name: str


@dataclasses.dataclass
class CreateRole(Node):
    name: str


@dataclasses.dataclass
class DropRole(Node):
    name: str


@dataclasses.dataclass
class GrantPriv(Node):
    privs: list          # ["select", ...]
    obj: str             # table name or "*"
    role: str


@dataclasses.dataclass
class RevokePriv(Node):
    privs: list
    obj: str
    role: str


@dataclasses.dataclass
class GrantRole(Node):
    role: str
    user: str


@dataclasses.dataclass
class RevokeRole(Node):
    role: str
    user: str


@dataclasses.dataclass
class ShowGrants(Node):
    user: "str | None" = None


@dataclasses.dataclass
class BeginTxn(Node):
    pass


@dataclasses.dataclass
class CommitTxn(Node):
    pass


@dataclasses.dataclass
class RollbackTxn(Node):
    pass
