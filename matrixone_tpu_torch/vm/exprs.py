"""Expression evaluation over device batches.

The port of `matrixone_tpu/vm/exprs.py`: columns, literals, casts,
CASE, IN lists, IS NULL, LIKE, the `ops/scalar.py` arithmetic, logic,
comparisons (decimal-exact) and math functions, the date functions
(`year`/`month`/`day`, the `_DATE_FUNCS` family, `date_add_unit`,
`timestampadd`/`timestampdiff`, `makedate`, the period functions,
`time_bucket`, `to_datetime`), the string functions (`vm/strfuncs.py`),
the numeric-to-string functions (`_NUM2STR_FUNCS`), the row-wise vector
distances, `bit_count`, `rand`, `uuid` and `llm_embed`.  A UDF call
evaluates through `udf/executor.eval_udf_call`.

Varchar columns arrive as dictionary codes + a host-side dictionary
(ExecBatch.dicts): string predicates are evaluated on the *dictionary*
(host, tiny) and become code-space operations on the device — `eq` is
a code compare, LIKE is a host regex over distinct values turned into
a boolean LUT gather, and a string function re-encodes the dictionary
and gathers the new codes.
"""

from __future__ import annotations

import dataclasses
import datetime as _dtm
import math as _math
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from matrixone_tpu_torch.container import dtypes as dt
from matrixone_tpu_torch.container.device import (DeviceBatch, DeviceColumn,
                                                  to_device)
from matrixone_tpu_torch.container.dtypes import DType
from matrixone_tpu_torch.ops import distance as D, hash as H
from matrixone_tpu_torch.ops import scalar as S
from matrixone_tpu_torch.sql.expr import (BoundCase, BoundCast, BoundCol,
                                          BoundExpr, BoundFunc, BoundInList,
                                          BoundIsNull, BoundLike,
                                          BoundLiteral, BoundUdfCall)
from matrixone_tpu_torch.vm.strfuncs import (_COLPOS, _STRING_FUNCS,
                                             EvalError, _apply_string_func)


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


#: literal lifting (vm/fusion.py): inside a fused step, selected numeric
#: literals evaluate to input tensors instead of baked constants, so one
#: cached step (one CUDA graph) serves every value of the same plan
#: shape.  The binding is thread-local and active only while a step runs.
_LIFT_TLS = __import__("threading").local()


class lifted_literal_scope:
    """Bind {id(BoundLiteral): [1]-shaped tensor} for the duration of a
    fused step; nests (the previous map is restored on exit)."""

    def __init__(self, mapping: Dict[int, object]):
        self._mapping = mapping

    def __enter__(self):
        self._prev = getattr(_LIFT_TLS, "map", None)
        _LIFT_TLS.map = self._mapping
        return self

    def __exit__(self, *exc):
        _LIFT_TLS.map = self._prev
        return False


def _is_varchar(dtype: DType) -> bool:
    return dtype.is_varlen


def _dict_of(e: BoundExpr, ex: ExecBatch) -> Optional[List[str]]:
    """Dictionary of a varchar-valued expression (recursive: columns,
    string-function results, CASE over string literals)."""
    if isinstance(e, BoundCol):
        return ex.dicts.get(e.name)
    if isinstance(e, BoundCase) and e.dtype.is_varlen:
        return case_string_dict(e)
    if isinstance(e, BoundFunc) and e.op == "monthname":
        return list(_MONTH_NAMES)
    if isinstance(e, BoundFunc) and e.op == "dayname":
        return list(_DAY_NAMES)
    if isinstance(e, BoundFunc) and e.dtype.is_varlen \
            and e.op in _STRING_FUNCS:
        return string_func_final_dict(e, ex)
    if isinstance(e, BoundFunc) and e.op in _NUM2STR_FUNCS:
        return num2str_final_dict(e, ex)
    if isinstance(e, BoundFunc) and e.op == "uuid":
        return uuid_dict(ex)
    return None


def lut_gather(lut: np.ndarray, codes: torch.Tensor) -> torch.Tensor:
    """lut[codes] on the codes' device, codes clipped into the LUT (a
    narrow int8/int16 code tensor indexes like an int32 one)."""
    idx = torch.clamp(codes.to(torch.int64), 0, len(lut) - 1)
    return to_device(lut, codes.device)[idx]


def eval_expr(e: BoundExpr, ex: ExecBatch) -> DeviceColumn:
    dev = ex.device
    if isinstance(e, BoundCol):
        return ex.batch.columns[e.name]
    if isinstance(e, BoundLiteral):
        lifted = getattr(_LIFT_TLS, "map", None)
        if lifted is not None:
            v = lifted.get(id(e))
            if v is not None:
                # fused step: the literal is one of the step's inputs
                return DeviceColumn(v, torch.ones((1,), dtype=torch.bool,
                                                  device=dev), e.dtype)
        if e.value is None:
            return DeviceColumn.const_null(e.dtype, dev)
        if e.dtype.is_vector:
            # through to_device: a fused step's capture takes no copy
            # from pageable host memory
            data = to_device(np.asarray([e.value],
                                        dtype=e.dtype.np_dtype), dev)
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
    if isinstance(e, BoundLike):
        arg = eval_expr(e.arg, ex)
        d = _dict_of(e.arg, ex)
        if d is None:
            raise EvalError("LIKE requires a varchar column")
        rx = _like_regex(e.pattern)
        lut = np.array([bool(rx.match(s)) for s in d], dtype=np.bool_)
        if e.negated:
            lut = ~lut
        return DeviceColumn(lut_gather(lut, arg.data), arg.validity, dt.BOOL)
    if isinstance(e, BoundUdfCall):
        from matrixone_tpu_torch.udf.executor import eval_udf_call
        return eval_udf_call(e, ex)
    if isinstance(e, BoundFunc):
        return _eval_func(e, ex)
    raise EvalError(f"not yet ported: expression {type(e).__name__}")


def _string_arg_info(e, ex, want_col: bool = True):
    """-> (col DeviceColumn|None, dict, literals list) for a string
    function call: at most one dict-coded column operand; an all-literal
    call treats the first literal as the subject. want_col=False skips the
    device evaluation (dictionary derivation only)."""
    col = None
    col_ast = None
    d = None
    lits = []
    for a in e.args:
        if isinstance(a, BoundLiteral):
            v = a.value
            if v is not None and a.dtype.oid == dt.TypeOid.DECIMAL64:
                v = v / 10 ** a.dtype.scale   # surface the REAL value,
            lits.append(v)                    # never the scaled integer
            continue
        src = _dict_of(a, ex)
        if src is None:
            raise EvalError(
                f"string function {e.op} needs a varchar column or literal "
                f"arguments")
        if col_ast is not None:
            raise EvalError(
                f"string function {e.op} over two columns not supported yet")
        col_ast = a
        d = src
        lits.append(_COLPOS)       # placeholder for the column position
    if col_ast is None:
        # all-literal call: the first literal is the subject string. A
        # NULL subject stays None in lits so the NULL-propagation rule
        # fires (left(NULL, 2) is NULL, not '')
        if not lits:
            raise EvalError(f"string function {e.op} needs arguments")
        d = [str(lits[0]) if lits[0] is not None else ""]
        if lits[0] is not None:
            lits[0] = _COLPOS
    elif want_col:
        col = eval_expr(col_ast, ex)
    return col, d, lits


def string_func_output_dict(e: BoundFunc, ex: ExecBatch):
    """Transformed dictionary for a varchar-result string function
    (no device work: dictionaries + literals only). Entries may be None
    (SQL NULL results, e.g. unhex of garbage)."""
    _, d, lits = _string_arg_info(e, ex, want_col=False)
    return [_apply_string_func(e.op, s, lits) for s in d]


def _eval_string_func(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    col, d, lits = _string_arg_info(e, ex)
    if col is None:
        # all-literal subject: a const code-0 column over the 1-entry dict
        col = DeviceColumn(torch.zeros((1,), dtype=torch.int32,
                                       device=ex.device),
                           torch.ones((1,), dtype=torch.bool,
                                      device=ex.device), dt.VARCHAR)
    vals = [_apply_string_func(e.op, s, lits) for s in d]
    nulls = np.asarray([v is None for v in vals], dtype=np.bool_)
    validity = col.validity
    if nulls.any():
        validity = validity & ~lut_gather(nulls, col.data)
    if not e.dtype.is_varlen:
        # result type decides the LUT dtype: the binder already typed
        # the call (INT64 for length/instr/..., BOOL for regexp_like/...)
        npdt = (np.bool_ if e.dtype.oid == dt.TypeOid.BOOL
                else e.dtype.np_dtype)
        lut = np.asarray([0 if v is None else v for v in vals],
                         dtype=npdt)
        return DeviceColumn(lut_gather(lut, col.data), validity, e.dtype)
    # varchar result: re-encode to the transformed value space so
    # GROUP BY upper(x) groups by VALUE, not by original code
    uniq = {}
    remap = np.empty(len(vals), np.int32)
    for i, v in enumerate(vals):
        remap[i] = uniq.setdefault("" if v is None else str(v), len(uniq))
    return DeviceColumn(lut_gather(remap, col.data), validity, e.dtype)


def string_func_final_dict(e: BoundFunc, ex: ExecBatch):
    """Dict matching _eval_string_func's re-encoded code space."""
    out_dict = string_func_output_dict(e, ex)
    uniq = {}
    for v in out_dict:
        uniq.setdefault("" if v is None else str(v), len(uniq))
    return list(uniq)


#: numeric input -> string output: evaluated over the column's UNIQUE
#: values on the host (O(distinct)), gathered on the device — the same
#: cost model as the dictionary-level string functions
_NUM2STR_FUNCS = {"date_format", "sec_to_time", "inet_ntoa",
                  "format_num", "hex_int",
                  "char_fn", "make_set", "export_set", "maketime"}

#: MySQL date_format codes -> strftime (%e/%c handled inline: no-pad
#: forms are platform-dependent in strftime)
_MYSQL_FMT = {
    "%Y": "%Y", "%y": "%y", "%m": "%m", "%d": "%d", "%H": "%H",
    "%h": "%I", "%i": "%M", "%s": "%S", "%f": "%f", "%M": "%B",
    "%b": "%b", "%W": "%A", "%a": "%a", "%j": "%j", "%p": "%p",
    "%T": "%H:%M:%S", "%r": "%I:%M:%S %p", "%%": "%%",
}


def _round_bigint(v, dtype) -> int:
    """MySQL: round a numeric argument to BIGINT. Integers never
    round-trip through float (2^53 truncates a BIGINT's low bits);
    decimals round half away from zero in the exact scaled-integer
    domain; floats round half away from zero (Python's round() is
    banker's: hex(254.5) would give 'FE')."""
    if dtype is not None and dtype.oid == dt.TypeOid.DECIMAL64:
        scale = 10 ** dtype.scale
        sv = int(v)
        q, r = divmod(abs(sv), scale)
        if 2 * r >= scale:
            q += 1
        return -q if sv < 0 else q
    if isinstance(v, (int, np.integer)) or (
            dtype is not None and dtype.is_integer):
        return int(v)
    x = float(v)
    n = _math.floor(abs(x) + 0.5)
    return -n if x < 0 else n


def _date_format(fmt: str, base: "_dtm.datetime") -> str:
    out = []
    i = 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt):
            code = fmt[i:i + 2]
            i += 2
            if code == "%e":
                out.append(str(base.day))
            elif code == "%c":
                out.append(str(base.month))
            elif code in _MYSQL_FMT:
                out.append(base.strftime(_MYSQL_FMT[code]))
            else:
                out.append(code[1])
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _num2str_value(op, v, lits, dtype) -> Optional[str]:
    """One unique input value -> output string (None = SQL NULL)."""
    if op == "hex_int":
        n = _round_bigint(v, dtype)
        if n < 0:                        # unsigned 64-bit view (MySQL)
            n &= 0xFFFFFFFFFFFFFFFF
        return format(n, "X")
    if op == "inet_ntoa":
        n = int(v)
        if n < 0 or n > 0xFFFFFFFF:
            return None
        return ".".join(str((n >> s) & 0xFF) for s in (24, 16, 8, 0))
    if op == "sec_to_time":
        n = int(v)
        sign = "-" if n < 0 else ""
        n = abs(n)
        return f"{sign}{n // 3600:02d}:{n % 3600 // 60:02d}:{n % 60:02d}"
    if op == "format_num":
        nd = int(lits[1]) if len(lits) > 1 and lits[1] is not None else 0
        x = float(v)
        if dtype is not None and dtype.oid == dt.TypeOid.DECIMAL64:
            x = x / 10 ** dtype.scale      # stored scaled (exact int)
        return f"{x:,.{max(nd, 0)}f}"
    if op == "char_fn":
        n = _round_bigint(v, dtype)
        if n < 0:
            return None
        bs = n.to_bytes(max((n.bit_length() + 7) // 8, 1), "big")
        return bs.decode("utf-8", "replace")
    if op == "make_set":
        # NULL strings are skipped (MySQL), but the bit mask rounds
        bits = _round_bigint(v, dtype)
        return ",".join(str(s) for i, s in enumerate(lits[1:])
                        if s is not None and bits & (1 << i))
    if op == "export_set":
        # MySQL: a NULL on/off/separator/count argument -> NULL result
        if any(x is None for x in lits[1:5]):
            return None
        bits = _round_bigint(v, dtype)
        on = str(lits[1]) if len(lits) > 1 else "1"
        off = str(lits[2]) if len(lits) > 2 else "0"
        sep = str(lits[3]) if len(lits) > 3 else ","
        width = _round_bigint(lits[4], None) if len(lits) > 4 else 64
        return sep.join(on if bits & (1 << i) else off
                        for i in range(max(0, min(width, 64))))
    if op == "maketime":
        h = _round_bigint(v, dtype)
        m = (_round_bigint(lits[1], None)
             if len(lits) > 1 and lits[1] is not None else -1)
        s = (_round_bigint(lits[2], None)
             if len(lits) > 2 and lits[2] is not None else -1)
        if not (0 <= m < 60 and 0 <= s < 60):
            return None
        sign = "-" if h < 0 else ""
        return f"{sign}{abs(h):02d}:{m:02d}:{s:02d}"
    if op == "date_format":
        fmt = str(lits[1]) if len(lits) > 1 else "%Y-%m-%d"
        if dtype is not None and _is_datetime(dtype):
            base = _dtm.datetime(1970, 1, 1) \
                + _dtm.timedelta(microseconds=int(v))
        else:
            base = _dtm.datetime(1970, 1, 1) + _dtm.timedelta(days=int(v))
        return _date_format(fmt, base)
    raise EvalError(op)


def _unscaled_literal(a):
    """Literal argument value with decimals unscaled to their real
    magnitude (stored scaled: 3.7 at scale 1 is the integer 37)."""
    if not isinstance(a, BoundLiteral):
        return None
    v = a.value
    if v is not None and a.dtype.oid == dt.TypeOid.DECIMAL64:
        return v / 10 ** a.dtype.scale
    return v


def _num2str_parts(e: BoundFunc, ex: ExecBatch):
    """(col, inverse codes, formatted uniques) for a numeric->string
    function — shared by eval and dictionary derivation so codes and
    dictionary entries always line up.  Cached per (expression, batch):
    the projection asks for the dictionary AND the values."""
    cache = ex.__dict__.setdefault("_num2str_cache", {})
    key = id(e)
    if key not in cache:
        col = eval_expr(e.args[0], ex)
        uniq, inv = np.unique(col.data.cpu().numpy(), return_inverse=True)
        lits = [None] + [_unscaled_literal(a) for a in e.args[1:]]
        strs = [_num2str_value(e.op, u, lits, e.args[0].dtype)
                for u in uniq]
        cache[key] = (col, inv, strs)
    return cache[key]


def num2str_final_dict(e: BoundFunc, ex: ExecBatch):
    _col, _inv, strs = _num2str_parts(e, ex)
    uniq = {}
    for v in strs:
        uniq.setdefault("" if v is None else str(v), len(uniq))
    return list(uniq)


def _eval_num2str(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    col, inv, strs = _num2str_parts(e, ex)
    uniq = {}
    remap = np.empty(len(strs), np.int32)
    nulls = np.empty(len(strs), np.bool_)
    for i, v in enumerate(strs):
        remap[i] = uniq.setdefault("" if v is None else str(v), len(uniq))
        nulls[i] = v is None
    inv = inv.reshape(-1)
    codes = torch.from_numpy(remap[inv]).to(ex.device)
    validity = col.validity & torch.from_numpy(~nulls[inv]).to(ex.device)
    return DeviceColumn(codes, validity, e.dtype)


def uuid_dict(ex: ExecBatch):
    """uuid() dictionary: one fresh v4 uuid per row position, cached on
    the batch so the codes and the projection's dictionary agree."""
    import uuid as _uuid
    cache = ex.__dict__.get("_uuid_dict")
    if cache is None or len(cache) != ex.padded_len:
        cache = [str(_uuid.uuid4()) for _ in range(ex.padded_len)]
        ex.__dict__["_uuid_dict"] = cache
    return cache


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
    if op in _DATE_FUNCS:
        return _eval_date_func(e, ex)
    if op == "time_bucket":
        if not isinstance(e.args[1], BoundLiteral):
            raise EvalError("time_bucket width must be a literal")
        width = int(e.args[1].value)
        if width <= 0:
            raise EvalError("time_bucket width must be positive")
        a = eval_expr(e.args[0], ex)
        out = (a.data.to(torch.int64) // width) * width   # window start
        return DeviceColumn(out.to(a.data.dtype), a.validity, e.dtype)
    if op == "date_add_days":
        a = eval_expr(e.args[0], ex)
        delta = eval_expr(e.args[1], ex)
        da, db, valid = S._broadcast2(a, delta)
        return DeviceColumn(da.to(torch.int32) + db.to(torch.int32),
                            valid, dt.DATE)
    if op in ("year", "month", "day"):
        a = eval_expr(e.args[0], ex)
        y, m, d = _civil_from_days(a.data.to(torch.int64))
        out = {"year": y, "month": m, "day": d}[op]
        return DeviceColumn(out.to(torch.int32), a.validity, dt.INT32)
    if op in ("l2_distance", "l2_distance_sq", "cosine_distance",
              "inner_product", "cosine_similarity"):
        return _eval_distance(e, ex)
    if op in _STRING_FUNCS:
        return _eval_string_func(e, ex)
    if op in _NUM2STR_FUNCS:
        return _eval_num2str(e, ex)
    if op == "date_add_unit":
        return _eval_date_add_unit(e, ex)
    if op in ("timestampadd", "timestampdiff"):
        return _eval_timestamp_fn(e, ex)
    if op in ("makedate", "period_add", "period_diff"):
        return _eval_period_fn(e, ex)
    if op == "to_datetime":
        a = eval_expr(e.args[0], ex)
        data = a.data.to(torch.int64)
        if a.dtype.oid == dt.TypeOid.DATE:
            data = data * _US_PER_DAY
        return DeviceColumn(data, a.validity, dt.DATETIME)
    if op == "bit_count":
        a = eval_expr(e.args[0], ex)
        return DeviceColumn(_popcount64(a.data.to(torch.int64)),
                            a.validity, dt.INT64)
    if op == "rand":
        n = ex.padded_len
        seed = (int(e.args[0].value) if e.args
                and isinstance(e.args[0], BoundLiteral) else None)
        vals = torch.from_numpy(np.random.default_rng(seed).random(n))
        return DeviceColumn(vals.to(ex.device),
                            torch.ones((n,), dtype=torch.bool,
                                       device=ex.device), dt.FLOAT64)
    if op == "uuid":
        n = ex.padded_len
        return DeviceColumn(torch.arange(n, dtype=torch.int32,
                                         device=ex.device),
                            torch.ones((n,), dtype=torch.bool,
                                       device=ex.device), e.dtype)
    if op == "llm_embed":
        return _eval_llm_embed(e, ex)
    if op in _SIMPLE:
        args = [eval_expr(a, ex) for a in e.args]
        return _SIMPLE[op](*args)
    raise EvalError(f"not yet ported: function {op}")


def _eval_llm_embed(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    """llm_embed(text) -> vecf32: one endpoint call per DISTINCT
    dictionary entry; the embeddings gather on the device by code."""
    from matrixone_tpu_torch import llm as _llm
    from matrixone_tpu_torch.frontend.session import current_session
    sess = current_session()
    variables = sess.variables if sess else None
    dim = e.dtype.dim
    arg = e.args[0]
    d = _dict_of(arg, ex)
    if d is None:
        if isinstance(arg, BoundLiteral) and isinstance(arg.value, str):
            vec = _llm.embed(arg.value, dim, variables)
            return DeviceColumn(
                to_device(np.asarray([vec], np.float32), ex.device),
                torch.ones((1,), dtype=torch.bool, device=ex.device),
                e.dtype)
        raise EvalError("llm_embed() needs a varchar column or literal")
    col = eval_expr(arg, ex)
    mat = np.zeros((max(len(d), 1), dim), np.float32)
    for i, s in enumerate(d):
        mat[i] = _llm.embed(s, dim, variables)
    return DeviceColumn(lut_gather(mat, col.data), col.validity, e.dtype)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each int64's 64-bit pattern (Hacker's Delight).  The
    masks clear the bits an arithmetic shift brings in, the products
    wrap as uint64 products do, and the last shift is logical."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    return H._shr(x * 0x0101010101010101, 56)


def _eval_distance(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    a = eval_expr(e.args[0], ex)
    b = eval_expr(e.args[1], ex)
    da, db, valid = S._broadcast2(a, b)
    fn = {"l2_distance": D.l2_distance_rowwise,
          "l2_distance_sq": lambda x, y: D.l2_distance_rowwise(x, y) ** 2,
          "cosine_distance": D.cosine_distance_rowwise,
          "inner_product": D.inner_product_rowwise,
          "cosine_similarity":
              lambda x, y: 1.0 - D.cosine_distance_rowwise(x, y),
          }[e.op]
    return DeviceColumn(fn(da, db), valid, dt.FLOAT64)


def _micros(col: DeviceColumn, data: torch.Tensor) -> torch.Tensor:
    """Epoch microseconds of a DATE (days) or DATETIME/TIMESTAMP."""
    return data.to(torch.int64) * (1 if _is_datetime(col.dtype)
                                   else _US_PER_DAY)


def _eval_date_add_unit(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    """date_add/date_sub with any interval unit.  Calendar units go
    through the civil decomposition with MySQL day clamping (Jan 31 +
    1 month = Feb 28); time units ride microseconds."""
    a = eval_expr(e.args[0], ex)
    n = int(e.args[1].value)
    unit = str(e.args[2].value)
    micros = _micros(a, a.data)
    if unit in ("microsecond", "second", "minute", "hour"):
        mult = {"microsecond": 1, "second": 1_000_000,
                "minute": 60_000_000, "hour": 3_600_000_000}[unit]
        return DeviceColumn(micros + n * mult, a.validity, dt.DATETIME)
    days = micros // _US_PER_DAY
    tod = micros - days * _US_PER_DAY
    if unit in ("day", "week"):
        nd = days + n * (7 if unit == "week" else 1)
    else:
        months = {"month": n, "quarter": 3 * n, "year": 12 * n}[unit]
        y, m, d = _civil_from_days(days)
        tot = y * 12 + (m - 1) + months
        ny, nm = tot // 12, tot % 12 + 1
        # clamp to the target month's length (MySQL semantics)
        mlen = _days_from_civil(ny + (nm == 12).to(ny.dtype),
                                torch.where(nm == 12, 1, nm + 1), 1) \
            - _days_from_civil(ny, nm, 1)
        nd = _days_from_civil(ny, nm, torch.minimum(d, mlen))
    if e.dtype.oid == dt.TypeOid.DATETIME:
        return DeviceColumn(nd * _US_PER_DAY + tod, a.validity,
                            dt.DATETIME)
    return DeviceColumn(nd.to(torch.int32), a.validity, dt.DATE)


def _eval_timestamp_fn(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    unit = str(e.args[0].value).lower().rstrip("s")
    if e.op == "timestampadd":
        inner = BoundFunc("date_add_unit",
                          [e.args[2], BoundLiteral(int(e.args[1].value),
                                                   dt.INT64),
                           BoundLiteral(unit, dt.VARCHAR)], dt.DATETIME)
        return _eval_date_add_unit(inner, ex)
    # timestampdiff(unit, a, b) = (b - a) in unit, truncated
    a = eval_expr(e.args[1], ex)
    b = eval_expr(e.args[2], ex)
    da, db, valid = S._broadcast2(a, b)
    ua, ub = _micros(a, da), _micros(b, db)
    diff = ub - ua
    if unit in ("microsecond", "second", "minute", "hour", "day", "week"):
        div = {"microsecond": 1, "second": 1_000_000,
               "minute": 60_000_000, "hour": 3_600_000_000,
               "day": _US_PER_DAY, "week": 7 * _US_PER_DAY}[unit]
        out = torch.sign(diff) * (torch.abs(diff) // div)
        return DeviceColumn(out, valid, dt.INT64)
    days_a = ua // _US_PER_DAY
    days_b = ub // _US_PER_DAY
    ya, ma, dda = _civil_from_days(days_a)
    yb, mb, ddb = _civil_from_days(days_b)
    months = (yb * 12 + mb) - (ya * 12 + ma)
    # a partial month does not count (MySQL truncation): compare
    # (day of month, time of day) lexicographically, not just the day
    toa = ua - days_a * _US_PER_DAY
    tob = ub - days_b * _US_PER_DAY
    b_before_a = (ddb < dda) | ((ddb == dda) & (tob < toa))
    a_before_b = (ddb > dda) | ((ddb == dda) & (tob > toa))
    months = months - ((months > 0) & b_before_a).to(torch.int64) \
        + ((months < 0) & a_before_b).to(torch.int64)
    div = {"month": 1, "quarter": 3, "year": 12}.get(unit)
    if div is None:
        raise EvalError(f"unsupported timestampdiff unit {unit!r}")
    out = torch.sign(months) * (torch.abs(months) // div)
    return DeviceColumn(out, valid, dt.INT64)


def _eval_period_fn(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    a = eval_expr(e.args[0], ex)
    b = eval_expr(e.args[1], ex)
    da, db, valid = S._broadcast2(a, b)
    if e.op == "makedate":
        y = da.to(torch.int64)
        doy = db.to(torch.int64)
        jan1 = _days_from_civil(y, torch.ones_like(y), 1)
        return DeviceColumn((jan1 + doy - 1).to(torch.int32),
                            valid & (doy >= 1), dt.DATE)
    pa = da.to(torch.int64)
    mo_a = (pa // 100) * 12 + pa % 100 - 1
    if e.op == "period_add":
        tot = mo_a + db.to(torch.int64)
        return DeviceColumn((tot // 12) * 100 + tot % 12 + 1, valid,
                            dt.INT64)
    pb = db.to(torch.int64)
    mo_b = (pb // 100) * 12 + pb % 100 - 1
    return DeviceColumn(mo_a - mo_b, valid, dt.INT64)


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


def _like_regex(pattern: str) -> "re.Pattern":
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return re.compile("^" + "".join(out) + "$", re.DOTALL)


# ------------------------------------------------------------------ dates
# Every `//` and `%` below is floor division on int64 tensors (torch's
# `//` floors, `%` takes the divisor's sign), as jnp's are: dates before
# 1970 are negative epoch days.

_MONTH_NAMES = ["January", "February", "March", "April", "May", "June",
                "July", "August", "September", "October", "November",
                "December"]
_DAY_NAMES = ["Monday", "Tuesday", "Wednesday", "Thursday", "Friday",
              "Saturday", "Sunday"]

_DATE_FUNCS = {"weekofyear", "to_seconds",
               "weekday", "dayofweek", "dayofyear", "quarter", "week",
               "last_day", "to_days", "from_days", "datediff", "hour",
               "minute", "second", "date", "unix_timestamp",
               "from_unixtime", "monthname", "dayname",
               "microsecond", "yearweek"}

_US_PER_DAY = 86_400_000_000


def _is_datetime(dtype: DType) -> bool:
    return dtype.oid in (dt.TypeOid.DATETIME, dt.TypeOid.TIMESTAMP)


def _days_col(col: DeviceColumn) -> torch.Tensor:
    """Epoch days from a DATE (days) or DATETIME/TIMESTAMP (micros)."""
    if _is_datetime(col.dtype):
        return col.data.to(torch.int64) // _US_PER_DAY
    return col.data.to(torch.int64)


def _days_from_civil(y, m, d):
    """Inverse of _civil_from_days (Hinnant, public domain)."""
    y = y - (m <= 2).to(y.dtype)
    era = torch.where(y >= 0, y, y - 399) // 400
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


def _civil_from_days(z: torch.Tensor):
    """Epoch days -> (year, month, day); Howard Hinnant's civil algorithm
    (public domain), integer-only so it runs on the device."""
    z = z + 719468
    era = torch.where(z >= 0, z, z - 146096) // 146097
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _sunday_weeks(days, y, m, d):
    """MySQL week mode 0 (Sunday-start weeks, week 0 before the year's
    first Sunday) of `days`, a date in year `y`."""
    jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
    doy = days - jan1 + 1
    jan1_dow_sun0 = (jan1 + 4) % 7
    first_sunday_doy = 1 + (7 - jan1_dow_sun0) % 7
    return torch.where(doy < first_sunday_doy, 0,
                       (doy - first_sunday_doy) // 7 + 1)


def _eval_date_func(e: BoundFunc, ex: ExecBatch) -> DeviceColumn:
    op = e.op
    a = eval_expr(e.args[0], ex)
    if op == "datediff":
        b = eval_expr(e.args[1], ex)
        da, db, valid = S._broadcast2(a, b)
        out = (_days_col(DeviceColumn(da, valid, a.dtype))
               - _days_col(DeviceColumn(db, valid, b.dtype)))
        return DeviceColumn(out.to(torch.int64), valid, dt.INT64)
    if op == "from_days":
        out = a.data.to(torch.int64) - 719528
        return DeviceColumn(out.to(torch.int32), a.validity, dt.DATE)
    if op == "from_unixtime":
        out = a.data.to(torch.int64) * 1_000_000
        return DeviceColumn(out, a.validity, dt.DATETIME)
    if op in ("hour", "minute", "second"):
        us = a.data.to(torch.int64)
        sec_of_day = (us // 1_000_000) % 86_400
        out = {"hour": sec_of_day // 3600,
               "minute": (sec_of_day // 60) % 60,
               "second": sec_of_day % 60}[op]
        return DeviceColumn(out.to(torch.int32), a.validity, dt.INT32)
    days = _days_col(a)
    if op == "date":
        return DeviceColumn(days.to(torch.int32), a.validity, dt.DATE)
    if op == "to_days":
        return DeviceColumn(days + 719528, a.validity, dt.INT64)
    if op == "to_seconds":
        # MySQL TO_SECONDS: seconds since year 0 = TO_DAYS*86400 + time
        base = (days + 719528) * 86_400
        if _is_datetime(a.dtype):
            us = a.data.to(torch.int64)
            base = base + (us - (us // _US_PER_DAY) * _US_PER_DAY) \
                // 1_000_000
        return DeviceColumn(base, a.validity, dt.INT64)
    if op == "weekofyear":
        # ISO-8601 week number (MySQL week(d, 3)): the week containing
        # this date's Thursday, numbered within that Thursday's year
        th = days + 3 - (days + 3) % 7      # Monday-start week's Thursday
        ty, tm, td = _civil_from_days(th)
        jan1 = _days_from_civil(ty, torch.ones_like(tm), torch.ones_like(td))
        wk = (th - jan1) // 7 + 1
        return DeviceColumn(wk.to(torch.int32), a.validity, dt.INT32)
    if op == "unix_timestamp":
        if _is_datetime(a.dtype):
            out = a.data.to(torch.int64) // 1_000_000
        else:
            out = days * 86_400
        return DeviceColumn(out, a.validity, dt.INT64)
    if op == "weekday":        # 0 = Monday (1970-01-01 was a Thursday)
        return DeviceColumn(((days + 3) % 7).to(torch.int32),
                            a.validity, dt.INT32)
    if op == "dayofweek":      # 1 = Sunday
        return DeviceColumn(((days + 4) % 7 + 1).to(torch.int32),
                            a.validity, dt.INT32)
    if op == "dayname":
        return DeviceColumn(((days + 3) % 7).to(torch.int32),
                            a.validity, e.dtype)
    y, m, d = _civil_from_days(days)
    if op == "monthname":
        return DeviceColumn((m - 1).to(torch.int32), a.validity, e.dtype)
    if op == "quarter":
        return DeviceColumn(((m + 2) // 3).to(torch.int32),
                            a.validity, dt.INT32)
    if op == "dayofyear":
        jan1 = _days_from_civil(y, torch.ones_like(m), torch.ones_like(d))
        return DeviceColumn((days - jan1 + 1).to(torch.int32),
                            a.validity, dt.INT32)
    if op == "week":           # MySQL default mode 0: Sunday-start weeks
        wk = _sunday_weeks(days, y, m, d)
        return DeviceColumn(wk.to(torch.int32), a.validity, dt.INT32)
    if op == "last_day":
        ny = torch.where(m == 12, y + 1, y)
        nm = torch.where(m == 12, 1, m + 1)
        out = _days_from_civil(ny, nm, torch.ones_like(d)) - 1
        return DeviceColumn(out.to(torch.int32), a.validity, dt.DATE)
    if op == "microsecond":
        if _is_datetime(a.dtype):
            us = a.data.to(torch.int64) % 1_000_000
        else:
            us = torch.zeros_like(a.data, dtype=torch.int64)
        return DeviceColumn(us.to(torch.int32), a.validity, dt.INT32)
    if op == "yearweek":       # mode 0: YYYYWW, week-0 days belong to
        # the previous year's last week (MySQL yearweek semantics)
        wk = _sunday_weeks(days, y, m, d)
        pwk = _sunday_weeks(days, y - 1, m, d)
        out = torch.where(wk > 0, y * 100 + wk, (y - 1) * 100 + pwk)
        return DeviceColumn(out.to(torch.int64), a.validity, dt.INT64)
    raise EvalError(op)
