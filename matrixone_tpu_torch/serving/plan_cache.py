"""Plan cache: normalize statements (literals -> parameters) and reuse
bound+optimized plans, and their compiled operator trees, across
executions.

The port's copy of `matrixone_tpu/serving/plan_cache.py`.
Reference analogue: the frontend's prepared-statement plan reuse plus
`pkg/sql/plan/function` plan caching — a repeated ad-hoc point query and
a prepared statement both skip parse -> bind -> optimize and jump to a
cached plan with fresh parameter values patched in.

Design (and why it is safe):

  * `normalize(sql)` works on the LEXER token stream: literal tokens
    become `?`, their values become the parameter list, and the rebuilt
    template text is the cache key.  Structural literal positions the
    parser demands a literal token for (LIMIT/OFFSET counts, INTERVAL
    counts, AS OF TIMESTAMP/SNAPSHOT, DATE '...' literals, type args
    like decimal(10,2), LIKE patterns) are skipped; if a position is
    missed anyway, parsing the template FAILS and the statement is
    recorded non-cacheable — never silently mis-planned.
  * the cached artifact is the bound+optimized plan where every literal
    that came from a parameter carries a `_param_idx` tag (threaded
    through `_substitute_params` -> `_bind_literal`).  On a hit the plan
    is deep-copied and each tagged literal re-derives its value through
    the SAME bind transform (`_bind_literal(_param_literal(v))`); a
    dtype change (e.g. a float parameter with a different decimal
    scale) rejects the hit instead of patching a wrong-typed value.
  * storing VERIFIES the tags: every parameter index must surface in
    the plan as a tagged literal.  Any bind-time transform that folds,
    coerces or absorbs a parameter (constant folding, IN-list value
    extraction, vector index rewrites baking the query vector into a
    VectorTopK node) loses the tag, fails verification, and marks the
    template non-cacheable — correctness degrades to the normal path,
    never to a stale constant.
  * keys carry (tenant scope, template, parameter type signature, cbo
    flag) and entries pin (ddl_gen, stats_gen): any DDL or ANALYZE
    orphans the plan.

  * the compiled operator tree of the last completed execution rides
    its plan entry (`take_tree` pops it, `put_tree` stores it back) and
    `rebind_tree` patches the new parameter values into the tree's
    tagged literals in place.  A fused fragment holds the very same
    BoundLiteral objects as the plan: a lifted literal reaches its CUDA
    graph through the values it reads at each step, and a baked one
    enters the fragment's runtime key at each batch, so a patched value
    re-keys instead of replaying the old graph.  vm/compile.py
    `retarget_tree` then resets every operator's per-execution state.

`MO_PLAN_CACHE=0` disables; `MO_PLAN_CACHE_SIZE` bounds entries (LRU).
`set_dynamic_nondet` takes the names of the nondeterministic UDFs
(`udf/catalog.sync_serving`, before each statement is normalized).
"""

from __future__ import annotations

import copy
import dataclasses
import threading
from collections import OrderedDict
from typing import List, Optional, Tuple

from matrixone_tpu_torch.sql.lexer import LexError, Token, tokenize

#: template noted once but not yet activated (see template_ast)
_SEEN = object()

#: type names whose parenthesized args are structural (decimal(10,2));
#: mirrors binder._TYPE_NAMES keys that take args
_TYPE_ARG_NAMES = {"decimal", "numeric", "char", "varchar", "vecf32",
                   "vecf64"}

#: keyword contexts whose FOLLOWING literal must stay literal: the
#: parser consumes a literal token there (no expression allowed)
_SKIP_AFTER_KW = {"limit", "offset", "interval", "snapshot", "date",
                  "timestamp", "like", "lists", "op_type", "using"}

#: function calls whose result depends on time/session/randomness —
#: results (and bind-time-folded plans) must never be cached
NONDET_FUNCS = frozenset({
    "now", "current_timestamp", "sysdate", "localtimestamp",
    "utc_timestamp", "curdate", "current_date", "utc_date", "curtime",
    "current_time", "rand", "uuid", "connection_id", "last_insert_id",
    "user", "current_user", "session_user", "system_user", "database",
    "schema", "mo_ctl", "llm_chat", "llm_embed", "load_file",
    "match_against", "sample",
})


@dataclasses.dataclass
class Normalized:
    """One statement reduced to its shape.  `slots` records, per `?` in
    the template, whether the value comes from the client's parameter
    list (a pre-existing `?` — prepared statements) or was extracted
    from a literal; `full_params` merges both in template order."""
    template: str                 # literal-free SQL text (cache key)
    slots: list                   # ("c",) client | ("x", value) extracted
    nondet: bool                  # references a non-deterministic func
    n_stmts: int = 1

    def full_params(self, client: Optional[list]) -> list:
        client = list(client or [])
        out, ci = [], 0
        for s in self.slots:
            if s[0] == "c":
                out.append(client[ci])     # IndexError -> caller bails
                ci += 1
            else:
                out.append(s[1])
        if ci != len(client):
            raise ValueError("parameter arity mismatch")
        return out

    def sig_for(self, full: list) -> Tuple[str, ...]:
        return tuple(_param_sig(p) for p in full)


def _param_sig(v) -> str:
    """Type signature of one parameter value — floats carry the decimal
    scale `repr` would bind to, so 0.5 and 0.05 key different plans
    (their bound dtypes differ: decimal64(18,1) vs (18,2))."""
    if v is None:
        return "n"
    if isinstance(v, bool):
        return "b"
    if isinstance(v, int):
        return "i"
    if isinstance(v, float):
        text = repr(v)
        if "e" not in text.lower() and "." in text:
            frac = text.split(".", 1)[1]
            if len(frac) <= 8:
                return f"d{len(frac)}"
        return "f"
    if isinstance(v, str):
        return "s"
    return type(v).__name__


def _render(tokens: List[Token]) -> str:
    """Tokens back to canonical SQL text (keywords lowercased, comments
    and whitespace gone — raises the hit rate across formatting)."""
    out = []
    for t in tokens:
        if t.kind == "eof":
            break
        if t.kind == "str":
            out.append("'" + t.value.replace("\\", "\\\\")
                       .replace("'", "''") + "'")
        elif t.kind == "ident":
            out.append(f"`{t.value}`")
        elif t.kind == "sysvar":
            out.append(f"@@{t.value}")
        else:
            out.append(t.value)
    return " ".join(out)


def normalize(sql: str,
              extra_nondet: frozenset = frozenset()
              ) -> Optional[Normalized]:
    """Parameterize one statement's literals. Returns None when the text
    cannot be normalized (lex error) — callers fall back to raw SQL.
    `extra_nondet` adds dynamically-registered nondeterministic function
    names (UDFs) to the static NONDET_FUNCS set."""
    try:
        tokens = tokenize(sql)
    except LexError:
        return None
    n_stmts = 1 + sum(1 for i, t in enumerate(tokens)
                      if t.kind == "op" and t.value == ";"
                      and tokens[i + 1].kind != "eof")
    out: List[Token] = []
    slots: list = []
    nondet = False
    type_depth = 0          # >0: inside decimal(...)-style type args
    skip_next_literal = False
    for i, t in enumerate(tokens):
        nxt = tokens[i + 1] if i + 1 < len(tokens) else None
        if t.kind == "ident" and nxt is not None \
                and nxt.kind == "op" and nxt.value == "(":
            low = t.value.lower()
            if low in NONDET_FUNCS or low in extra_nondet:
                nondet = True
            if low in _TYPE_ARG_NAMES:
                type_depth += 1     # consume literals until the ")"
        if t.kind == "kw":
            if t.value in NONDET_FUNCS and nxt is not None \
                    and nxt.kind == "op" and nxt.value == "(":
                nondet = True
            if t.value in _SKIP_AFTER_KW:
                skip_next_literal = True
                out.append(t)
                continue
        if type_depth and t.kind == "op" and t.value == ")":
            type_depth -= 1
        if t.kind == "op" and t.value == "?":
            slots.append(("c",))        # client-supplied parameter
            out.append(t)
            continue
        if t.kind == "op" and t.value == "=" and skip_next_literal:
            out.append(t)               # `lists = 2`: the skip context
            continue                    # survives the option's "="
        if t.kind in ("int", "float", "str"):
            if skip_next_literal or type_depth:
                out.append(t)
                skip_next_literal = False
                continue
            if t.kind != "str" and out and out[-1].kind == "op" \
                    and out[-1].value in ("-", "+") \
                    and not (len(out) > 1 and (
                        out[-2].kind in ("ident", "int", "float", "str",
                                         "sysvar")
                        or (out[-2].kind == "op"
                            and out[-2].value in (")", "?"))
                        or (out[-2].kind == "kw" and out[-2].value in
                            ("null", "true", "false", "end")))):
                # unary sign: the parser folds `-1` into one literal;
                # `- ?` would bind as neg() and break literal-only
                # positions (lag/lead defaults, sample counts) — keep
                # signed literals literal
                out.append(t)
                continue
            if t.kind == "float":
                # parameterize only text that round-trips through the
                # param path (repr): "0.050" / "1e3" would re-bind at a
                # different decimal scale or dtype than the raw parse —
                # those stay literal in the template
                try:
                    ok = repr(float(t.value)) == t.value
                except ValueError:
                    ok = False
                if not ok:
                    out.append(t)
                    continue
                slots.append(("x", float(t.value)))
            elif t.kind == "int":
                slots.append(("x", int(t.value)))
            else:
                slots.append(("x", t.value))
            out.append(Token("op", "?", t.pos))
            continue
        skip_next_literal = False
        out.append(t)
    return Normalized(template=_render(out), slots=slots,
                      nondet=nondet, n_stmts=n_stmts)


# --------------------------------------------------------------- plans

def iter_plan_values(node, _seen=None):
    """Every dataclass/list/tuple-reachable object in a plan tree —
    generic so new node kinds are covered by construction."""
    if _seen is None:
        _seen = set()
    if id(node) in _seen:
        return
    _seen.add(id(node))
    yield node
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        for f in dataclasses.fields(node):
            v = getattr(node, f.name, None)
            if isinstance(v, (list, tuple)):
                for x in v:
                    if isinstance(x, (list, tuple)):
                        for y in x:
                            yield from iter_plan_values(y, _seen)
                    elif _walkable(x):
                        yield from iter_plan_values(x, _seen)
            elif _walkable(v):
                yield from iter_plan_values(v, _seen)


def _walkable(v) -> bool:
    return dataclasses.is_dataclass(v) and not isinstance(v, type)


def tagged_literals(plan) -> dict:
    """param index -> [BoundLiteral] that carry its value in the plan."""
    from matrixone_tpu_torch.sql.expr import BoundLiteral
    found: dict = {}
    for v in iter_plan_values(plan):
        if isinstance(v, BoundLiteral):
            idx = getattr(v, "_param_idx", None)
            if idx is not None:
                found.setdefault(idx, []).append(v)
    return found


def plan_is_cacheable(plan, n_params: int) -> bool:
    """Verify the plan can be re-parameterized: every parameter index
    surfaces as a tagged literal, and no node bakes values outside the
    literal protocol (vector/fulltext rewrites copy the query constant
    into plain node fields).  Plans calling a NON-deterministic UDF take
    the same uncacheable-tombstone path (normalization already flags
    them by name; this is the backstop for bodies that turn
    nondeterministic via OR REPLACE between normalize and store)."""
    from matrixone_tpu_torch.sql import plan as P
    from matrixone_tpu_torch.sql.expr import BoundUdfCall
    for v in iter_plan_values(plan):
        if isinstance(v, (P.VectorTopK, P.FulltextTopK, P.Materialized)):
            return False
        if isinstance(v, BoundUdfCall) and not v.deterministic:
            return False
    if n_params == 0:
        return True
    found = tagged_literals(plan)
    return set(found) == set(range(n_params))


class _Entry:
    __slots__ = ("plan", "n_params", "ddl_gen", "stats_gen", "cacheable",
                 "tables", "tree", "tree_vars")

    def __init__(self, plan, n_params, ddl_gen, stats_gen,
                 cacheable=True, tables=()):
        self.plan = plan
        self.n_params = n_params
        self.ddl_gen = ddl_gen
        self.stats_gen = stats_gen
        self.cacheable = cacheable
        self.tables = tuple(tables)
        #: compiled operator tree of the LAST completed execution (the
        #: {"op", "plan"} pair) — popped on take, stored back after a
        #: successful run, same identity-guard discipline as the result
        #: cache: a concurrent taker finds None and rebuilds
        self.tree = None
        self.tree_vars = None


class PlanCache:
    """LRU of (scope, template, sig, cbo) -> bound+optimized plan."""

    def __init__(self, max_entries: int = 256, enabled: bool = True):
        self.max_entries = max_entries
        self.enabled = enabled
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._norm_cache: "OrderedDict[str, Optional[Normalized]]" = \
            OrderedDict()
        #: dynamically-registered nondeterministic function names (UDFs)
        self.dynamic_nondet: frozenset = frozenset()
        # template text -> parsed AST; _SEEN: noted once, not yet
        # activated; False: template does not parse (a literal landed in
        # a structural position) — raw path serves it
        self._ast_cache: "OrderedDict[str, object]" = OrderedDict()

    def template_ast(self, template: str):
        """Second-occurrence activation: the FIRST sight of a template
        only notes it (returns None -> the raw parse path runs with zero
        added cost); a repeat parses and caches the template AST.  The
        suite-shaped workload (thousands of one-shot statements) thus
        never pays template machinery; serving workloads (repeats)
        activate on the second execution and hit from the third."""
        with self._lock:
            hit = self._ast_cache.get(template, None)
            if hit is None:
                self._ast_cache[template] = _SEEN
                while len(self._ast_cache) > 1024:
                    self._ast_cache.popitem(last=False)
                return None
            self._ast_cache.move_to_end(template)
            if hit not in (_SEEN, False):
                return hit
            if hit is False:
                return None
        from matrixone_tpu_torch.sql.parser import parse
        try:
            stmts = parse(template)
            node = stmts[0] if len(stmts) == 1 else False
        except Exception:        # noqa: BLE001 — any parse/lex failure
            node = False         # means "serve via the raw SQL text"
        with self._lock:
            self._ast_cache[template] = node
            while len(self._ast_cache) > 1024:
                self._ast_cache.popitem(last=False)
        return node if node is not False else None

    def set_dynamic_nondet(self, names: frozenset) -> None:
        """Swap the dynamic nondet set (CREATE/DROP FUNCTION with
        'deterministic'='false'); cached Normalized entries carry stale
        nondet flags, so the normalization cache resets with it."""
        with self._lock:
            if self.dynamic_nondet == names:
                return
            self.dynamic_nondet = names
            self._norm_cache.clear()

    # ------------------------------------------------------- normalize
    def normalized(self, sql: str) -> Optional[Normalized]:
        """normalize() with a small raw-text LRU in front: the common
        serving workload repeats byte-identical statements."""
        _MISS = object()
        with self._lock:
            hit = self._norm_cache.get(sql, _MISS)
            if hit is not _MISS:
                self._norm_cache.move_to_end(sql)
                return hit
        norm = normalize(sql, self.dynamic_nondet)
        with self._lock:
            self._norm_cache[sql] = norm
            while len(self._norm_cache) > 512:
                self._norm_cache.popitem(last=False)
        return norm

    # ----------------------------------------------------------- cache
    def lookup(self, key: tuple, ddl_gen: int, stats_gen: int,
               params: list):
        """-> ("hit", plan) | ("uncacheable", None) | ("miss", None).
        A hit returns a fresh deep copy with parameter values patched."""
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            e = self._entries.get(key)
            if e is not None:
                self._entries.move_to_end(key)
        if e is None:
            M.plan_cache_ops.inc(outcome="miss")
            return "miss", None
        if e.ddl_gen != ddl_gen or e.stats_gen != stats_gen:
            # gen check runs first so uncacheable tombstones expire too:
            # the DDL that made a template uncacheable (e.g. a vector
            # index) may have been reverted since.  Pop only OUR stale
            # entry — a concurrent store() may have already replaced it
            # with a fresh current-gen plan
            with self._lock:
                if self._entries.get(key) is e:
                    self._entries.pop(key)
            M.plan_cache_ops.inc(outcome="invalidated")
            return "miss", None
        if not e.cacheable:
            M.plan_cache_ops.inc(outcome="uncacheable")
            return "uncacheable", None
        plan = self._instantiate(e, params)
        if plan is None:
            M.plan_cache_ops.inc(outcome="miss")
            return "miss", None
        M.plan_cache_ops.inc(outcome="hit")
        return "hit", plan

    @staticmethod
    def _instantiate(e: _Entry, params: list):
        from matrixone_tpu_torch.frontend.session import _param_literal
        from matrixone_tpu_torch.sql import ast
        from matrixone_tpu_torch.sql.binder import _bind_literal
        plan = copy.deepcopy(e.plan)
        if e.n_params == 0:
            return plan
        found = tagged_literals(plan)
        for idx in range(e.n_params):
            lits = found.get(idx)
            if not lits:
                return None
            try:
                src = _param_literal(params[idx])
                if not isinstance(src, ast.Literal):
                    return None     # date params re-bind the long way
                fresh = _bind_literal(src)
            except Exception:       # noqa: BLE001 — full re-bind instead
                return None
            for lit in lits:
                if lit.dtype != fresh.dtype:
                    return None     # type signature drift: full re-bind
                lit.value = fresh.value
        return plan

    # ---------------------------------------------- compiled op trees
    def take_tree(self, key: tuple, ddl_gen: int, stats_gen: int,
                  vars_sig) -> Optional[dict]:
        """Pop the cached compiled operator tree for this plan key.
        POP semantics (not peek): operator trees hold per-execution
        state and must never run concurrently — a second taker finds
        None and compiles its own tree.  Gen or session-variable drift
        drops the tree (the plan entry itself is invalidated by the
        ordinary lookup path)."""
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            e = self._entries.get(key)
            if e is None or e.tree is None:
                return None
            tree, e.tree = e.tree, None
            if e.ddl_gen != ddl_gen or e.stats_gen != stats_gen \
                    or e.tree_vars != vars_sig:
                return None           # stale: dropped, caller rebuilds
        M.plan_cache_ops.inc(outcome="tree_hit")
        return tree

    def put_tree(self, key: tuple, tree: dict, ddl_gen: int,
                 stats_gen: int, vars_sig) -> None:
        """Store a compiled tree back after a successful execution —
        only onto the entry it was built against (same gens); a raced
        DDL orphans the tree along with the plan."""
        with self._lock:
            e = self._entries.get(key)
            if e is None or not e.cacheable \
                    or e.ddl_gen != ddl_gen or e.stats_gen != stats_gen:
                return
            e.tree = tree
            e.tree_vars = vars_sig

    @staticmethod
    def rebind_tree(tree: dict, params: list):
        """Patch fresh parameter values into a cached compiled tree's
        tagged literals IN PLACE (the operator tree references the same
        BoundLiteral objects as its plan).  Returns the operator root,
        or None when the tree cannot be safely re-parameterized (the
        caller rebuilds; the popped tree is discarded)."""
        from matrixone_tpu_torch.sql import ast
        from matrixone_tpu_torch.sql.binder import BindError, _bind_literal
        op, plan = tree["op"], tree["plan"]
        if not params:
            return op
        from matrixone_tpu_torch.frontend.session import _param_literal
        found = tagged_literals(plan)
        if set(found) != set(range(len(params))):
            return None
        for idx, v in enumerate(params):
            try:
                src = _param_literal(v)
                if not isinstance(src, ast.Literal):
                    return None       # date params re-bind the long way
                fresh = _bind_literal(src)
            except BindError:
                return None
            for lit in found[idx]:
                if lit.dtype != fresh.dtype:
                    return None       # dtype drift: full rebuild
                lit.value = fresh.value
        return op

    def store(self, key: tuple, plan, n_params: int, ddl_gen: int,
              stats_gen: int, tables=()) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        if plan is not None and not plan_is_cacheable(plan, n_params):
            self.mark_uncacheable(key, ddl_gen, stats_gen)
            return
        entry = _Entry(copy.deepcopy(plan), n_params, ddl_gen,
                       stats_gen, tables=tables)
        with self._lock:
            self._entries[key] = entry
            self._entries.move_to_end(key)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            M.plan_cache_entries.set(len(self._entries))

    def mark_uncacheable(self, key: tuple, ddl_gen: int = 0,
                         stats_gen: int = 0) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            self._entries[key] = _Entry(None, 0, ddl_gen, stats_gen,
                                        cacheable=False)
            while len(self._entries) > self.max_entries:
                self._entries.popitem(last=False)
            M.plan_cache_entries.set(len(self._entries))

    def clear(self) -> None:
        from matrixone_tpu_torch.utils import metrics as M
        with self._lock:
            self._entries.clear()
            self._norm_cache.clear()
            self._ast_cache.clear()
            M.plan_cache_entries.set(0)

    def stats(self) -> dict:
        from matrixone_tpu_torch.utils import metrics as M
        hits = M.plan_cache_ops.get(outcome="hit")
        misses = M.plan_cache_ops.get(outcome="miss")
        with self._lock:
            n = len(self._entries)
        return {"entries": n, "hits": int(hits), "misses": int(misses),
                "uncacheable": int(
                    M.plan_cache_ops.get(outcome="uncacheable")),
                "invalidated": int(
                    M.plan_cache_ops.get(outcome="invalidated")),
                "hit_rate": (hits / (hits + misses)
                             if hits + misses else 0.0),
                "enabled": self.enabled}
