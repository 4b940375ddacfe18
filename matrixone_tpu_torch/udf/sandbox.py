"""Restricted Python dialect for UDF bodies (the port's copy of
`matrixone_tpu/udf/sandbox.py`).

Reference analogue: `pkg/udf/pythonservice/pyserver` executes user Python
in a worker process; here the body runs INSIDE the engine process (the
jit tier calls it once over whole columns on the session's device), so
the dialect is validated and frozen rather than trusted:

  * the body is a sequence of simple statements ending in an expression
    or `return` — `def __udf__(args): body` compiled with `compile()`;
  * the AST is whitelist-checked BEFORE compilation: no imports, no
    underscore-prefixed names or attributes (blocks every
    `().__class__.__mro__` builtins escape), no exec/eval/open/getattr,
    and no numpy file-I/O attributes (np.fromfile/save/tofile/np.lib/
    ...) — the modules in the namespace are real, so their I/O surface
    is denied by attribute name;
  * the namespace is frozen: `jnp` (the port's torch-backed namespace,
    `udf/jnp.py`, holding only its listed names), `np`, `math` plus a
    tiny builtins allowlist — `__import__` is absent, so even a name
    that slips through cannot import;
  * every loop is bounded: `while` is not in the dialect and `range()`
    is capped, because the per-call deadline can only fire BETWEEN row
    evaluations — an unbounded loop inside a body would be
    un-interruptible.

Failures surface as UdfError with the offending construct named — never
a raw SyntaxError traceback into a SQL session.
"""

from __future__ import annotations

import ast as pyast
import math
import textwrap
from typing import Callable, List


class UdfError(ValueError):
    """User-function failure (definition or execution). A ValueError so
    sessions surface it like any bind/eval error."""


#: statement/expression node kinds the dialect accepts
_ALLOWED_NODES = (
    pyast.Module, pyast.FunctionDef, pyast.arguments, pyast.arg,
    pyast.Return, pyast.Assign, pyast.AugAssign, pyast.AnnAssign,
    # no pyast.While: an unbounded loop cannot be interrupted by the
    # per-call deadline (checks run BETWEEN rows, never inside a body),
    # so one `while True` would wedge a session or worker thread forever;
    # `for` stays — its trip count is bounded by its iterable, and the
    # namespace's range() is capped
    pyast.Expr, pyast.If, pyast.IfExp, pyast.For,
    pyast.Break, pyast.Continue, pyast.Pass,
    pyast.BoolOp, pyast.BinOp, pyast.UnaryOp, pyast.Compare,
    pyast.Call, pyast.keyword, pyast.Attribute, pyast.Subscript,
    pyast.Slice, pyast.Name, pyast.Load, pyast.Store, pyast.Constant,
    pyast.Tuple, pyast.List, pyast.Dict, pyast.Set,
    pyast.ListComp, pyast.GeneratorExp, pyast.comprehension,
    pyast.Lambda, pyast.Starred,
    pyast.Add, pyast.Sub, pyast.Mult, pyast.Div, pyast.FloorDiv,
    pyast.Mod, pyast.Pow, pyast.MatMult, pyast.LShift, pyast.RShift,
    pyast.BitOr, pyast.BitXor, pyast.BitAnd,
    pyast.UAdd, pyast.USub, pyast.Invert, pyast.Not,
    pyast.And, pyast.Or, pyast.Eq, pyast.NotEq, pyast.Lt, pyast.LtE,
    pyast.Gt, pyast.GtE, pyast.Is, pyast.IsNot, pyast.In, pyast.NotIn,
)

#: attribute names that must never be accessed on ANY object — the
#: namespace hands bodies the real np/jnp modules, whose file-I/O
#: surface (np.fromfile/np.save/ndarray.tofile/np.lib.format...) would
#: otherwise void the "no open, no file I/O" guarantee.  Attribute
#: access is always an ast.Attribute node (aliasing doesn't hide it),
#: so an AST-level deny list closes every route to these.
_FORBIDDEN_ATTRS = {
    "fromfile", "tofile", "load", "save", "savez", "savez_compressed",
    "loadtxt", "savetxt", "genfromtxt", "fromregex", "memmap",
    "DataSource", "lib", "ctypeslib", "f2py", "testing",
    "dump", "dumps",
}

#: names that must never resolve, even if a host version existed
_FORBIDDEN_NAMES = {
    "__import__", "eval", "exec", "compile", "open", "input",
    "globals", "locals", "vars", "dir", "getattr", "setattr",
    "delattr", "type", "super", "object", "memoryview", "breakpoint",
    "exit", "quit",
}

#: largest range() a body may build — with `while` out of the dialect,
#: this bounds every loop's trip count, so the per-call deadline always
#: gets a chance to fire between rows
_RANGE_CAP = 1 << 24


def _safe_range(*args):
    r = range(*args)
    if len(r) > _RANGE_CAP:
        raise UdfError(
            f"range of {len(r)} exceeds the UDF loop cap ({_RANGE_CAP})")
    return r


#: builtins the dialect keeps (numeric helpers only)
_SAFE_BUILTINS = {
    "abs": abs, "min": min, "max": max, "len": len, "range": _safe_range,
    "float": float, "int": int, "bool": bool, "sum": sum,
    "round": round, "enumerate": enumerate, "zip": zip, "tuple": tuple,
    "list": list, "True": True, "False": False, "None": None,
}


def _validate(tree: pyast.AST, name: str) -> None:
    for node in pyast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise UdfError(
                f"udf {name!r}: {type(node).__name__} is not allowed in "
                f"the UDF dialect")
        if isinstance(node, pyast.Attribute):
            if node.attr.startswith("_"):
                raise UdfError(
                    f"udf {name!r}: attribute {node.attr!r} is not "
                    f"allowed (underscore attributes are sandboxed out)")
            if node.attr in _FORBIDDEN_ATTRS:
                raise UdfError(
                    f"udf {name!r}: attribute {node.attr!r} is not "
                    f"allowed (file I/O is sandboxed out)")
        if isinstance(node, pyast.Name):
            if node.id in _FORBIDDEN_NAMES or node.id.startswith("__"):
                raise UdfError(
                    f"udf {name!r}: name {node.id!r} is not allowed in "
                    f"the UDF dialect")


def compile_body(name: str, body: str, arg_names: List[str]) -> Callable:
    """-> python function(arg arrays/scalars) implementing the body.

    The body is either a single expression or a statement suite whose
    result is `return`ed; a suite without an explicit return whose LAST
    statement is an expression returns that expression (SQL users write
    `x * 2`, not `return x * 2`).
    """
    import numpy as np

    from matrixone_tpu_torch.udf import jnp
    for a in arg_names:
        if a.startswith("_") or not a.isidentifier():
            raise UdfError(f"udf {name!r}: bad argument name {a!r}")
    src = textwrap.dedent(body).strip()
    if not src:
        raise UdfError(f"udf {name!r}: empty body")
    try:
        tree = pyast.parse(src)
    except SyntaxError as e:
        raise UdfError(f"udf {name!r}: body does not parse: {e.msg} "
                       f"(line {e.lineno})")
    _validate(tree, name)     # forbidden constructs error by NAME, not
    # as a confusing missing-return complaint
    if tree.body and isinstance(tree.body[-1], pyast.Expr):
        # implicit return of the trailing expression
        tree.body[-1] = pyast.Return(value=tree.body[-1].value)
    has_return = any(isinstance(n, pyast.Return)
                     for n in pyast.walk(tree))
    if not has_return:
        raise UdfError(
            f"udf {name!r}: body must end in an expression or return")
    fn_def = pyast.FunctionDef(
        name="__udf__",
        args=pyast.arguments(
            posonlyargs=[], args=[pyast.arg(arg=a) for a in arg_names],
            kwonlyargs=[], kw_defaults=[], defaults=[]),
        body=tree.body, decorator_list=[])
    mod = pyast.Module(body=[fn_def], type_ignores=[])
    pyast.fix_missing_locations(mod)
    code = compile(mod, filename=f"<udf:{name}>", mode="exec")
    glob = {"jnp": jnp.namespace(), "np": np, "math": math,
            "__builtins__": dict(_SAFE_BUILTINS)}
    local: dict = {}
    exec(code, glob, local)       # noqa: S102 — AST-validated, frozen ns
    return local["__udf__"]
