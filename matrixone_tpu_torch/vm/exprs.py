"""Expression evaluation over device batches.

The port of the core of `matrixone_tpu/vm/exprs.py`: columns, literals,
casts, CASE, IN lists, IS NULL and the `ops/scalar.py` arithmetic,
logic, comparisons (decimal-exact) and math functions.  Every other
expression — LIKE and the string, JSON, date, distance, geo and LLM
functions — raises `EvalError("not yet ported: ...")` (ROADMAP.md,
section A).

Varchar columns arrive as dictionary codes + a host-side dictionary
(ExecBatch.dicts): string comparisons with a literal are evaluated on
the *dictionary* (host, tiny) and become a boolean LUT gather on the
codes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import DeviceBatch, DeviceColumn
from matrixone_tpu_torch.container.dtypes import DType
from matrixone_tpu_torch.ops import scalar as S
from matrixone_tpu_torch.sql.expr import (BoundCase, BoundCast, BoundCol,
                                          BoundExpr, BoundFunc, BoundInList,
                                          BoundIsNull, BoundLiteral)


@dataclasses.dataclass
class ExecBatch:
    """A batch mid-pipeline: device columns + host dictionaries + row mask.

    `mask` folds the batch row_mask with every filter applied so far —
    operators consume masks instead of compacting (ops/filter.py rationale).
    """
    batch: DeviceBatch
    dicts: Dict[str, List[str]]
    mask: torch.Tensor

    @property
    def padded_len(self) -> int:
        # the mask always has the true padded length — batch.padded_len
        # degenerates to 1 when every column is a const (literal-only
        # projections)
        return self.mask.shape[0]

    @property
    def device(self) -> torch.device:
        return self.mask.device


class EvalError(ValueError):
    pass


def _is_varchar(dtype: DType) -> bool:
    return dtype.is_varlen


def _dict_of(e: BoundExpr, ex: ExecBatch) -> Optional[List[str]]:
    """Dictionary of a varchar-valued expression: a column's, or a CASE
    over string literals.  (The string functions that make dictionaries
    in the reference are not ported yet.)"""
    if isinstance(e, BoundCol):
        return ex.dicts.get(e.name)
    if isinstance(e, BoundCase) and e.dtype.is_varlen:
        return case_string_dict(e)
    return None


def lut_gather(lut: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """lut[codes] on the codes' device, codes clipped into the LUT (a
    narrow int8/int16 code tensor indexes like an int32 one)."""
    idx = torch.clamp(codes.to(torch.int64), 0, len(lut) - 1)
    return torch.from_numpy(np.ascontiguousarray(lut)).to(codes.device)[idx]


def eval_expr(e: BoundExpr, ex: ExecBatch) -> DeviceColumn:
    dev = ex.device
    if isinstance(e, BoundCol):
        return ex.batch.columns[e.name]
    if isinstance(e, BoundLiteral):
        if e.value is None:
            return DeviceColumn.const_null(e.dtype, dev)
        if e.dtype.is_vector:
            data = torch.tensor([e.value], dtype=e.dtype.torch_dtype,
                                device=dev)
            return DeviceColumn(data, torch.ones((1,), dtype=torch.bool,
                                                 device=dev), e.dtype)
        if _is_varchar(e.dtype):
            # const string column: code 0 into a single-entry dictionary
            # (the projection attaches the dict via expr_output_dict)
            col = DeviceColumn.const(0, dt.INT32, dev)
            return DeviceColumn(col.data, col.validity, e.dtype)
        return DeviceColumn.const(e.value, e.dtype, dev)
    if isinstance(e, BoundCast):
        return S.cast(eval_expr(e.arg, ex), e.dtype)
    if isinstance(e, BoundIsNull):
        col = eval_expr(e.arg, ex)
        return S.isnotnull(col) if e.negated else S.isnull(col)
    if isinstance(e, BoundCase):
        if _is_varchar(e.dtype):
            return _eval_case_strings(e, ex)
        # every branch coerces to the CASE's bound result type BEFORE
        # the select (mixed int/double/decimal branches otherwise mix
        # scaled decimal ints with floats)
        else_col = (S.cast(eval_expr(e.else_, ex), e.dtype)
                    if e.else_ is not None
                    else DeviceColumn.const_null(e.dtype, dev))
        out = else_col
        for cond, val in reversed(e.whens):
            out = S.case_when(eval_expr(cond, ex),
                              S.cast(eval_expr(val, ex), e.dtype), out)
        return out
    if isinstance(e, BoundInList):
        arg = eval_expr(e.arg, ex)
        d = _dict_of(e.arg, ex)
        if d is not None:
            code_of = {s: i for i, s in enumerate(d)}
            codes = [code_of[v] for v in e.values if v in code_of]
            if not codes:
                base = DeviceColumn(torch.zeros(arg.data.shape,
                                                dtype=torch.bool,
                                                device=dev),
                                    arg.validity, dt.BOOL)
            else:
                base = S.in_list(arg, codes)
        else:
            base = S.in_list(arg, list(e.values))
        return S.logical_not(base) if e.negated else base
    if isinstance(e, BoundFunc):
        return _eval_func(e, ex)
    raise EvalError(f"not yet ported: expression {type(e).__name__}")


_SIMPLE = {
    "add": S.add, "sub": S.sub, "mul": S.mul, "div": S.div, "mod": S.mod,
    "and": S.logical_and, "or": S.logical_or,
    "abs": S.abs_, "floor": S.floor, "ceil": S.ceil, "sqrt": S.sqrt,
    "exp": S.exp, "ln": S.ln, "sin": S.sin, "cos": S.cos, "power": S.power,
    "coalesce": S.coalesce,
    "tan": S.tan, "asin": S.asin, "acos": S.acos, "atan": S.atan,
    "atan2": S.atan2, "cot": S.cot, "degrees": S.degrees,
    "radians": S.radians, "log2": S.log2, "log10": S.log10,
    "sign": S.sign, "greatest": S.greatest, "least": S.least,
}

_CMP = {"eq": S.eq, "ne": S.ne, "lt": S.lt, "le": S.le, "gt": S.gt,
        "ge": S.ge}


def case_string_dict(e: BoundCase) -> List[str]:
    """Deterministic dictionary for a CASE with string-literal branches
    (ProjectOp uses the same function to attach the output dictionary)."""
    out: List[str] = []
    branches = [v for _, v in e.whens] + ([e.else_] if e.else_ else [])
    for v in branches:
        if isinstance(v, BoundLiteral) and isinstance(v.value, str):
            if v.value not in out:
                out.append(v.value)
        elif v is not None:
            raise EvalError("string CASE branches must be literals for now")
    return out or [""]


def _eval_case_strings(e: BoundCase, ex: ExecBatch) -> DeviceColumn:
    d = case_string_dict(e)
    code_of = {s: i for i, s in enumerate(d)}

    def code_col(v) -> DeviceColumn:
        if v is None or (isinstance(v, BoundLiteral) and v.value is None):
            return DeviceColumn.const_null(dt.INT32, ex.device)
        return DeviceColumn.const(code_of[v.value], dt.INT32, ex.device)

    out = code_col(e.else_)
    for cond, val in reversed(e.whens):
        out = S.case_when(eval_expr(cond, ex), code_col(val), out)
    # tag with the SQL string type; dict attached by the projection
    return DeviceColumn(out.data, out.validity, e.dtype)


def _eval_func(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    op = e.op
    if op in _CMP:
        return _eval_compare(e, ex)
    if op == "not":
        return S.logical_not(eval_expr(e.args[0], ex))
    if op == "neg":
        return S.neg(eval_expr(e.args[0], ex))
    if op == "round":
        a = eval_expr(e.args[0], ex)
        digits = e.args[1].value if len(e.args) > 1 else 0
        return S.round_(a, int(digits))
    if op == "truncate":
        a = eval_expr(e.args[0], ex)
        digits = e.args[1].value if len(e.args) > 1 else 0
        return S.truncate(a, int(digits))
    if op in _SIMPLE:
        args = [eval_expr(a, ex) for a in e.args]
        return _SIMPLE[op](*args)
    raise EvalError(f"not yet ported: function {op}")


def _eval_compare(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    a_raw, b_raw = e.args
    a_dict, b_dict = _dict_of(a_raw, ex), _dict_of(b_raw, ex)
    a_is_str_lit = isinstance(a_raw, BoundLiteral) and _is_varchar(a_raw.dtype)
    b_is_str_lit = isinstance(b_raw, BoundLiteral) and _is_varchar(b_raw.dtype)
    if a_is_str_lit and b_is_str_lit:
        la, lb = str(a_raw.value), str(b_raw.value)
        hit = {"eq": la == lb, "ne": la != lb, "lt": la < lb,
               "le": la <= lb, "gt": la > lb, "ge": la >= lb}[e.op]
        return DeviceColumn.const(bool(hit), dt.BOOL, ex.device)
    if a_dict is not None or b_dict is not None or a_is_str_lit or b_is_str_lit:
        # string comparison: evaluate on the dictionary, gather on codes
        if a_dict is not None and (b_is_str_lit or b_dict is not None):
            col_e, other = a_raw, b_raw
            d = a_dict
            flip = False
        elif b_dict is not None and a_is_str_lit:
            col_e, other = b_raw, a_raw
            d = b_dict
            flip = True
        else:
            raise EvalError("unsupported string comparison")
        col = eval_expr(col_e, ex)
        if isinstance(other, BoundLiteral):
            lit = str(other.value)
            op = e.op
            if flip:
                op = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le"}.get(op, op)
            cmp_fn = {"eq": lambda s: s == lit, "ne": lambda s: s != lit,
                      "lt": lambda s: s < lit, "le": lambda s: s <= lit,
                      "gt": lambda s: s > lit, "ge": lambda s: s >= lit}[op]
            lut = np.array([cmp_fn(s) for s in d], dtype=np.bool_)
            return DeviceColumn(lut_gather(lut, col.data), col.validity,
                                dt.BOOL)
        # column vs column over the SAME dictionary (same table column)
        other_col = eval_expr(other, ex)
        if _dict_of(other, ex) is d and e.op in ("eq", "ne"):
            return _CMP[e.op](col, other_col)
        raise EvalError("cross-dictionary string comparison not supported yet")
    return _CMP[e.op](eval_expr(a_raw, ex), eval_expr(b_raw, ex))
